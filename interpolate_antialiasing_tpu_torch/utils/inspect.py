"""What a call does on the card, without guessing: the port of
``interpolate_antialiasing_tpu.utils.inspect``.

  * :func:`kernel_report` — the route ``resize`` takes for a call (which
    hand-written kernel, how many launches, with which tile plan), its
    per-axis taps and windows, its MACs and bytes, and the least time the
    card could take for it (:func:`bound_of`), without running the call.  The
    route comes from the same functions ``resize`` and the kernel wrappers
    decide with (``ops.resize._resize_route`` / ``_plane_kernel`` /
    ``_axis_method``, ``ops.cuda_resize.resize2d_plan``,
    ``ops.pil_exact._plan_2pass`` / ``_plan_axis``), so it cannot drift.
  * :func:`sharded_report` — the halo plan and wire bytes that size a mesh.
  * :func:`lower_text` — the aten operators a call dispatches, with the
    hand-written kernels' launches among them: what the call "lowers" to
    (the JAX package gives StableHLO here).
  * :func:`compiled_text` — what ran on the card: the device kernels a call
    launched, and for the hand-written ones their ``ptxas -v`` lines and
    their SASS.
  * :func:`bound_of` — the yardstick of every bound in ``PERF.md`` and
    ``chip_smoke.py``: bytes over the card's memory rate or operations over
    its float32 rate, whichever is the larger.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess

import numpy as np
import torch

__all__ = ["KernelReport", "kernel_report", "sharded_report", "lower_text",
           "compiled_text", "bound_of", "launch_counts", "HBM_BYTES_PER_S",
           "CUDA_CORE_OPS_PER_S"]

# the card's peaks (H100 SXM datasheet, at 700 W): device memory, and float32
# outside the tensor cores, the rate at which the int32 multiply-adds of the
# integer kernels are counted too
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def bound_of(nbytes: int, macs: int) -> dict:
    """The least time the card could take: the bytes the function must move
    (each input, tables included, read once; each output written once) over
    the memory rate, or its operations (two per multiply-add, counting the
    taps these tables weight) over the peak rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * macs / CUDA_CORE_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": int(nbytes), "ops": int(2 * macs)}


def launch_counts() -> dict:
    """Every hand-written kernel's launch count so far in this process, by
    kernel name (each wrapper adds one where it launches its kernel and
    nowhere else)."""
    from ..ops import crop_cuda as cc
    from ..ops import cuda_resize as cr
    from ..ops import pil_exact as pe

    return {"pil_resample_2pass": pe.launches, "resample2d": cr.launches_2d,
            "resample_axis": cr.launches_axis, "crop_tables": cc.launches_crop_tables,
            "crop_resample": cc.launches_crop, "crop_f32": cc.launches_crop_f32,
            "pil_resample_axis": pe.launches_axis,
            "resample2d_fused": cr.launches_2d_fused,
            "resample_axis_fused": cr.launches_axis_fused}


@dataclasses.dataclass
class KernelReport:
    """Route, plan, geometry and cost of one ``resize`` call (per plane:
    per ``[H, W]`` image channel, as the JAX report counts)."""

    in_shape: tuple
    out_hw: tuple
    mode: str
    dtype: str
    out_dtype: str
    # the passes in launch order, as IA_TPU_DEBUG=1 names them, " + "-joined
    route: str
    launches: dict  # hand-written kernel -> launches per call
    n_sm: int  # SMs the tile plans assume
    n_sm_assumed: bool  # no card: the H100's 132 SMs
    planes: int
    plan: dict | None  # kernel A's plan (the Pillow kernel's too), where it runs
    axes: list  # per pass: taps, window, density, MACs, the axis plan
    total_mmacs: float  # MACs executed per plane, millions
    total_useful_mmacs: float  # nonzero taps only, per plane, millions
    hbm_mbytes: float  # image in + image out (the output at its own dtype)
    table_mbytes: float  # the weight tables the kernels read
    bound_ms: float  # bound_of(): all those bytes, or the useful MACs of all planes
    bound_by: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def __str__(self) -> str:
        sms = f"{self.n_sm} SMs" + (" (assumed: no card)" if self.n_sm_assumed else "")
        launches = ", ".join(f"{k} x{v}" for k, v in self.launches.items()) or "none"
        lines = [
            f"resize {self.in_shape} -> {self.out_hw} mode={self.mode} "
            f"dtype={self.dtype}->{self.out_dtype} route={self.route}",
            f"  kernel launches per call: {launches}; plans for {sms}",
            f"  essential HBM traffic: {self.hbm_mbytes:.2f} MB + tables "
            f"{self.table_mbytes:.4f} MB; MACs/plane: {self.total_mmacs:.2f} M executed, "
            f"{self.total_useful_mmacs:.2f} M useful; bound {self.bound_ms:.4f} ms "
            f"({self.bound_by})",
        ]
        if self.plan is not None:
            lines.append("  plan: " + " ".join(f"{k}={v}" for k, v in self.plan.items()))
        for a in self.axes:
            win = "unstaged" if a["window"] is None else a["window"]
            lines.append(
                f"  axis {a['axis']} ({a['pass']}): {a['in_size']}->{a['out_size']} "
                f"ntaps={a['ntaps']} window={win} density={a['density']:.3f} "
                f"MACs={a['mmacs']:.2f}M useful={a['useful_mmacs']:.2f}M"
                + ("" if a.get("plan") is None
                   else " plan: " + " ".join(f"{k}={v}" for k, v in a["plan"].items())))
        return "\n".join(lines)


def _sms(device) -> tuple[int, bool]:
    """The SM count the plans take for ``device`` (None: the card where there
    is one), and whether it was assumed: the H100's where there is no card."""
    from ..ops import cuda_resize as cr

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type != "cuda":
        return cr._H100_SMS, True
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return cr._n_sm(dev), False


def _axis_entry(name: str, token: str, spec_in: int, spec_out: int, ntaps: int, nz: int,
                rows: int, exec_rows: int, exec_macs: float | None = None,
                window=None, plan=None) -> dict:
    """One pass of the report: ``rows`` per plane the pass runs over (the
    JAX report's: H for the W pass, the output width for the H pass),
    ``exec_rows`` the rows its kernel computes (kernel A recomputes a row
    tile's halo rows), ``nz`` the nonzero taps of its table."""
    return {"axis": name, "pass": token, "in_size": spec_in, "out_size": spec_out,
            "ntaps": ntaps, "window": window,
            "density": nz / (ntaps * spec_out) if ntaps * spec_out else 0.0,
            "mmacs": (exec_rows * spec_out * ntaps if exec_macs is None else exec_macs) / 1e6,
            "useful_mmacs": rows * nz / 1e6,
            "plan": None if plan is None else plan._asdict()}


def _plan2d_launches(plan, planes: int, oh: int, ow: int) -> int:
    """Launches of kernel A (or the Pillow kernel) over ``planes`` planes:
    the wrappers split a batch whose blocks pass gridDim.x's limit."""
    from .. import native
    from ..ops import cuda_resize as cr

    per_plane = -(-oh // plan.tile_r) * -(-ow // plan.tile_c)
    return len(native.plane_chunks(max(planes, 1), cr._INT_MAX // per_plane))


def _view3(shape: tuple, axis: int) -> tuple[int, int, int]:
    """``[outer, n, inner]`` of a pass over ``axis`` of ``shape``."""
    return math.prod(shape[:axis]), shape[axis], math.prod(shape[axis + 1:])


def kernel_report(
    in_shape,
    out_hw,
    mode: str = "bilinear",
    dtype=torch.uint8,
    antialias: bool = True,
    backend: str = "auto",
    output_dtype=None,
    align_corners: bool = False,
    scale_factors=None,
    data_format: str | None = None,
    device=None,
) -> KernelReport:
    """Route, plan, geometry and cost of ``resize(x, out_hw, mode, ...)`` for
    an ``x`` of ``in_shape`` and ``dtype``, without running it.

    ``route`` and ``launches`` are what ``resize`` launches on the card for
    exactly these arguments: ``pil_resample_2pass`` (kernel A over Pillow's
    tables), or two ``pil_resample_axis`` passes where no tile of it fits;
    ``resample2d``, or two ``resample_axis`` passes where no kernel-A tile
    fits; one ``resample_axis`` pass per axis (channels-last floats); and
    for float64 and the ``dense``/``gather``/``banded``/``xla`` backends the
    plain method of each pass (no kernel).  The plans are for ``device``'s
    SM count (None: the card, where there is one); without a card they
    assume the H100's 132 SMs and the report says so.  A CPU tensor runs the
    kernels' plain versions, so a CPU call shows the same route only where
    its plan does not depend on the card (the Pillow kernel's fallback runs
    on the card only); the tile plans assume 16-byte aligned tensors.

    Per pass (``axes``, W first): the table's taps, the staged window (None:
    the unstaged body), ``density`` (nonzero taps over ``ntaps *
    out_size``), ``mmacs`` executed per plane and ``useful_mmacs`` (nonzero
    taps per plane, the JAX report's definition).  ``hbm_mbytes`` is image
    in plus image out, the output at its own dtype (the JAX report counts it
    at the input's), ``table_mbytes`` the weight tables; ``bound_ms`` is
    :func:`bound_of` of both over the useful MACs of every plane.
    """
    from ..config import default_backend, default_pil_digits
    from ..ops import cuda_resize as cr
    from ..ops import pil_exact as pe
    from ..ops.resize import (
        _BACKENDS,
        _axes_for,
        _axis_method,
        _compute_dtype,
        _plane_kernel,
        _resize_route,
    )
    from ..ops.weights import banded_tiles, make_axis_spec

    in_shape = tuple(int(s) for s in in_shape)
    oh, ow = int(out_hw[0]), int(out_hw[1])
    ndim = len(in_shape)
    out_dtype = output_dtype if output_dtype is not None else dtype
    h_axis, w_axis = _axes_for(torch.empty(in_shape, dtype=dtype, device="meta"), data_format)
    H, W = in_shape[h_axis], in_shape[w_axis]
    planes = math.prod(in_shape) // max(H * W, 1)
    backend = backend or default_backend()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {_BACKENDS}")
    route = _resize_route(dtype, out_dtype, mode, antialias, align_corners, scale_factors,
                          backend)
    n_sm, assumed = _sms(device)
    isz = torch.empty(0, dtype=dtype).element_size()
    osz = torch.empty(0, dtype=out_dtype).element_size()
    axes, launches, plan, table_bytes = [], {}, None, 0

    def plan2d(kernel, plan, ntaps_w, nz_w, ntaps_h, nz_h):
        launches[kernel] = _plan2d_launches(plan, planes, oh, ow)
        exec_w = -(-oh // plan.tile_r) * plan.rows_cap
        axes.append(_axis_entry("W", kernel, W, ow, ntaps_w, nz_w, H, exec_w,
                                window=plan.cols_cap))
        axes.append(_axis_entry("H", kernel, H, oh, ntaps_h, nz_h, ow, ow,
                                window=plan.rows_cap))
        return plan._asdict()

    if route == "nearest_legacy" or (route.startswith("pil") and mode == "pil_nearest"):
        tokens = [mode]  # an index gather per axis, no kernel
    elif route.startswith("pil"):
        m = mode if route == "pil_exact" else ("box" if mode == "nearest" else mode)
        pb = pe._precision_bits(H, W, oh, ow, m, default_pil_digits())
        tw, th = pe._int_tables(W, ow, m, None, pb), pe._int_tables(H, oh, m, None, pb)
        table_bytes = sum(a.nbytes for a in (*tw, *th))
        nz_w, nz_h = (int(np.count_nonzero(t[1])) for t in (tw, th))
        p2 = pe._plan_2pass(tw, th, planes, H, W, n_sm)
        if p2 is not None:
            tokens = ["pil_resample_2pass"]
            plan = plan2d("pil_resample_2pass", p2, tw[1].shape[1], nz_w, th[1].shape[1], nz_h)
        else:
            tokens = ["pil_resample_axis"] * 2
            launches["pil_resample_axis"] = 2
            for name, t, n_in, n_out, nz, rows, view in (
                    ("W", tw, W, ow, nz_w, H, (planes * H, W, 1)),
                    ("H", th, H, oh, nz_h, ow, (planes, H, ow))):
                p = pe._plan_axis(t, view[0], n_in, view[2], n_sm, True)
                axes.append(_axis_entry(name, "pil_resample_axis", n_in, n_out, t[1].shape[1],
                                        nz, rows, rows, window=p and p.win, plan=p))
    else:
        sfh, sfw = scale_factors if scale_factors is not None else (None, None)
        spec_w = make_axis_spec(W, ow, mode, antialias, align_corners, sfw)
        spec_h = make_axis_spec(H, oh, mode, antialias, align_corners, sfh)
        cdtype = dtype if route == "u8_kernel" else _compute_dtype(dtype)
        kdtype = out_dtype if route == "u8_kernel" else cdtype
        tables = {"W": cr._tables(spec_w), "H": cr._tables(spec_h)}
        nz = {k: int(np.count_nonzero(t[1])) for k, t in tables.items()}
        csz = torch.empty(0, dtype=cdtype).element_size()
        if route == "u8_kernel" or _plane_kernel(cdtype, ndim, h_axis, w_axis, backend):
            table_bytes = sum(a.nbytes for t in tables.values() for a in t)
            p2 = cr.resize2d_plan(spec_h, spec_w, csz, planes, n_sm)
            if p2 is not None:
                tokens = ["resample2d"]
                plan = plan2d("resample2d", p2, spec_w.ntaps, nz["W"], spec_h.ntaps, nz["H"])
            else:
                tokens = ["resample_axis"] * 2
                launches["resample_axis"] = 2
                inter = cr.axes_inter_dtype(cdtype, kdtype)
                for name, spec, rows, view, sz in (
                        ("W", spec_w, H, (planes * H, W, 1), csz),
                        ("H", spec_h, ow, (planes, H, ow),
                         torch.empty(0, dtype=inter).element_size())):
                    p = cr._plan_axis_spec(spec, False, view[0], view[2], sz, n_sm, True)
                    axes.append(_axis_entry(name, "resample_axis", spec.in_size, spec.out_size,
                                            tables[name][1].shape[1], nz[name], rows, rows,
                                            window=p and p.win, plan=p))
        else:  # one pass per axis, W first, on the compute dtype
            tokens, shape = [], list(in_shape)
            for name, spec, axis, rows in (("W", spec_w, w_axis, H), ("H", spec_h, h_axis, ow)):
                method = _axis_method(spec, cdtype, backend)
                outer, _, inner = _view3(tuple(shape), axis)
                shape[axis] = spec.out_size
                ntaps = tables[name][1].shape[1]
                p, exec_macs = None, None
                if method == "pallas":
                    method = "resample_axis"
                    launches["resample_axis"] = launches.get("resample_axis", 0) + 1
                    table_bytes += sum(a.nbytes for a in tables[name])
                    p = cr._plan_axis_spec(spec, False, outer, inner, csz, n_sm, True)
                elif method == "dense":
                    exec_macs = rows * spec.in_size * spec.out_size
                elif method == "banded":
                    bt = banded_tiles(spec)
                    exec_macs = rows * bt.k_in * bt.out_padded
                tokens.append(method)
                axes.append(_axis_entry(name, method, spec.in_size, spec.out_size, ntaps,
                                        nz[name], rows, rows, exec_macs,
                                        window=p and p.win, plan=p))
    hbm = planes * (H * W * isz + oh * ow * osz)
    useful = sum(a["useful_mmacs"] for a in axes)
    b = bound_of(hbm + table_bytes, round(planes * useful * 1e6))
    return KernelReport(
        in_shape=in_shape, out_hw=(oh, ow), mode=mode, dtype=str(dtype).removeprefix("torch."),
        out_dtype=str(out_dtype).removeprefix("torch."), route=" + ".join(tokens),
        launches=launches, n_sm=n_sm, n_sm_assumed=assumed, planes=planes, plan=plan,
        axes=axes, total_mmacs=sum(a["mmacs"] for a in axes), total_useful_mmacs=useful,
        hbm_mbytes=hbm / 1e6, table_mbytes=table_bytes / 1e6, bound_ms=b["bound_ms"],
        bound_by=b["bound_by"])


def sharded_report(in_h: int, out_h: int, mode: str, n_shards: int,
                   width: int | None = None) -> dict:
    """Geometry and communication of the sharded H-split routes
    (``parallel/halo.py``): what an operator sizes a mesh with.

    The halo plan (halo rows, local block sizes, extended frame), the float
    plan's band geometry and the per-device wire bytes are the JAX report's,
    key for key (the plans are equal element for element).  In place of the
    JAX report's int8 digit tables, ``int_table_geometry`` gives the int32
    tables per shard that the port's ``pil_resample_axis`` reads.  Both
    routes exchange rows after their local W pass, so ``width`` is the
    output width: the float route ships float32 rows (4 B/px), the
    byte-exact route the uint8 intermediate (1 B/px)."""
    from ..parallel.halo import _int_halo_tables, plan_halo_banded

    plan = plan_halo_banded(in_h, out_h, mode, True, n_shards)
    rep = {
        "in_h": in_h,
        "out_h": out_h,
        "mode": mode,
        "n_shards": n_shards,
        "halo_rows": plan.halo,
        "local_in_rows": plan.hl,
        "local_out_rows": plan.ol,
        "extended_rows": plan.ext,
        "float_band_geometry": {
            "n_tiles": plan.n_tiles,
            "k_in": plan.k_in,
            "bands_bytes_per_shard": int(plan.bands[0].nbytes),
        },
    }
    _, starts, wsh = _int_halo_tables(in_h, out_h, mode, n_shards)
    rep["int_table_geometry"] = {
        "ntaps": int(wsh.shape[2]),
        "table_bytes_per_shard": int(starts[0].nbytes + wsh[0].nbytes),
    }
    if width is not None:
        # one exchange of `halo` rows each way
        rep["wire_bytes_per_device_float32"] = 2 * plan.halo * width * 4
        rep["wire_bytes_per_device_u8_exact"] = 2 * plan.halo * width
    return rep


def _describe(out) -> str:
    t = out[0] if isinstance(out, (tuple, list)) and out else out
    if isinstance(t, torch.Tensor):
        return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)} {t.device.type}"
    return ""


def lower_text(fn, *args) -> str:
    """The aten operators ``fn(*args)`` dispatches, one per line in order
    (with its first result's dtype, shape and device), and a ``launch <kernel>``
    line where a hand-written kernel was launched between two of them (its
    wrapper's count moved: the card only; a CPU tensor runs the kernels'
    plain versions, whose operators are listed instead).  The first line
    counts both.  The call runs once, on whatever device its tensors are."""
    from torch.utils._python_dispatch import TorchDispatchMode

    lines: list[str] = []
    n_ops = [0]
    seen = [launch_counts()]

    def mark():
        now = launch_counts()
        for k, v in now.items():
            lines.extend([f"launch {k}"] * (v - seen[0][k]))
        seen[0] = now

    class _Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            mark()
            out = func(*args, **(kwargs or {}))
            n_ops[0] += 1
            lines.append(f"{func}  -> {_describe(out)}".rstrip(" ->"))
            return out

    with _Record():
        fn(*args)
    mark()
    n_launch = sum(1 for ln in lines if ln.startswith("launch "))
    return "\n".join([f"# {n_ops[0]} aten ops, {n_launch} kernel launches"] + lines) + "\n"


def _functions(sass: str) -> dict:
    """``cuobjdump -sass`` output split by function: mangled name -> its
    block of text."""
    out, name, block = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(block)
            name, block = m.group(1), []
        if name:
            block.append(line)
    if name:
        out[name] = "\n".join(block)
    return out


def _ptxas_lines(log: str, mangled: str) -> list[str]:
    """The ``ptxas -v`` lines of one entry function (its compile line and
    the lines after it up to the next function)."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            on = f"'{mangled}'" in line or line.rstrip().endswith(mangled)
        if on:
            out.append(line)
    return out


def compiled_text(fn, *args) -> str:
    """What ``fn(*args)`` ran on the card: each device kernel it launched
    (torch.profiler, one call after one untimed call) with its launches and
    device microseconds, then, for each hand-written kernel among them, its
    ``ptxas -v`` lines (``native.ptxas_log()``) and its SASS (``cuobjdump
    -sass`` of the built library, that function only).  Raises where there
    is no card, or no ``cuobjdump`` or C++ demangler: there is nothing to
    show of the card without them."""
    from .. import native
    from .timing import _kernel_records

    if not torch.cuda.is_available():
        raise RuntimeError("compiled_text shows what ran on a CUDA card; there is none "
                           "(lower_text lists the operators on any device)")
    cuobjdump = native._cuda_tool("cuobjdump")
    demangler = native._cuda_tool("c++filt") or native._cuda_tool("cu++filt")
    if cuobjdump is None or demangler is None:
        raise RuntimeError("compiled_text needs cuobjdump (the CUDA toolkit) and a C++ "
                           "demangler (c++filt or cu++filt)")
    fn(*args)
    torch.cuda.synchronize()

    def run_once():
        fn(*args)
        torch.cuda.synchronize()

    kernels: dict = {}
    for e in _kernel_records(run_once):
        n, us = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    lib, log = native._lib_path(), native.ptxas_log()

    def sass(*fun) -> dict:
        return _functions(subprocess.run([cuobjdump, "-sass", *fun, str(lib)],
                                         capture_output=True, text=True, check=True).stdout)

    # the library's kernels by demangled name: from the build's ptxas log,
    # else from the whole library's SASS
    names = sorted(set(re.findall(r"Compiling entry function '([^']+)'", log))) or list(sass())
    plain = subprocess.run([demangler], input="\n".join(names), capture_output=True,
                           text=True, check=True).stdout.splitlines()
    by_demangled = {re.sub(r"\s+", "", d): m for d, m in zip(plain, names)}
    head = [f"# {len(kernels)} device kernels launched by one call (library {lib})"]
    body = []
    for name, (n, us) in kernels.items():
        mangled = by_demangled.get(re.sub(r"\s+", "", name))
        head.append(f"kernel {name}  launches={n} device_us={us:.3f}"
                    + ("  [hand-written]" if mangled else ""))
        if mangled:
            try:  # that function only, else the whole library's SASS
                block = sass("-fun", mangled).get(mangled)
            except subprocess.CalledProcessError:
                block = None
            block = block or sass().get(mangled, "(no SASS found)")
            body += ["", f"== {mangled}", *_ptxas_lines(log, mangled), block]
    return "\n".join(head + body) + "\n"
