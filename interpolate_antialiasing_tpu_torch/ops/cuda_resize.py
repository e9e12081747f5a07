"""Hand-written CUDA kernels of the float resize route (the port of
``interpolate_antialiasing_tpu.ops.pallas_resize``).

Two kernels, each with its wrapper, its plain PyTorch version and its
launch count (``native.launches``, under the name of its ``ia.native``
span); their host plans and tables are the shared plan layer's
(:mod:`.plans`):

  * **resample2d** (``csrc/resample2d.cu``): both separable passes of the
    trailing ``[H, W]`` plane in one launch, W pass into shared memory, then
    H pass.  Replaces ``_kernel_2pass`` (``resize2d_onekernel``) and serves
    the shapes of ``_kernel_2pass_streamed`` (``resize2d_streamed``).
    Wrapper :func:`resize2d`; plain version :func:`_resample2d_plain`; host
    plan ``plans.plan_rows`` (tiles sized for the batch and the card's SM
    count); count ``resample2d``.  On long launches of the tables route
    (many waves of tiles: 4K frames by the batch) its streaming twin
    (``csrc/resample2d_stream.cu``) walks down column strips instead, its
    input rows through a ring of copies in flight behind the math; host
    plan ``plans.plan2d_stream``, count ``resample2d_stream``.
  * **resample_axis** (``csrc/resample_axis.cuh``, entry
    ``csrc/resample_axis.cu``): one pass over any axis of any rank.
    Replaces ``_kernel_last`` / ``_kernel_mid`` (``resize_axis_pallas``) and
    serves the per-axis passes of ``_kernel_last_unrolled`` /
    ``_kernel_mid_unrolled`` (``resize2d_pallas``).  Wrapper
    :func:`resize_axis`; plain version :func:`_resample_axis_plain`; host
    plan ``plans.plan_axis_first`` (tiles per axis kind, sized for the
    shape and the card's SM count; the Pillow twin of the kernel and the
    crop passes plan with it too); count ``resample_axis``.

Each pass is given as an :class:`..weights.AxisSpec` (the forward matrix
``W``) or as :class:`..weights.Tables`: ``adjoint_tables(spec)`` runs the
same kernel over ``W^T``, which is how the backward pass of the resize runs
(the JAX package's ``resize2d_onekernel_transpose`` and
``resize_axis_transpose_pallas`` reuse their forward kernels over
transposed bands the same way).

``fused=True`` (the JAX package's keyword of ``resize_axis_pallas`` and
``resize2d_pallas``) synthesises each output's weights inside the kernel
from the spec's closed form instead of uploading tables: the same two
kernels, templated on the weight source (``csrc/ia_taps.cuh``), replace
``_kernel_last_fused`` / ``_kernel_mid_fused`` and the ``fused_spec``
branch of the unrolled kernels.  Counts ``resample_axis_fused`` and
``resample2d_fused``; plain versions :func:`_resample_axis_fused_plain`
and :func:`_resample2d_fused_plain`, over the weights
:func:`_synth_tables` builds with the kernel's float32 operations in the
kernel's order; host plans over the first taps the kernel synthesises
(:func:`_plan2d_synth`, :func:`plan_axis_spec`).  The JAX package's gate
applies: box, nearest, area and any border but ``renorm`` run the tables
(each pass gated on its own spec).

Both take uint8, float32 or bfloat16 and give uint8, float32 or bfloat16,
with float32 weights (the float64 tables cast once) and float32
sums, each product and each sum rounded in tap order
(:func:`.resize_xla.gather_reduce`), so a kernel and its plain version agree
bit for bit.  A uint8 store is ``floor(v + 0.5)`` clamped to [0, 255]; uint8 ->
uint8 puts the W pass result on the uint8 lattice the same way before the H
pass.  A CUDA tensor launches the kernel, and a failed build or launch
raises; a CPU tensor runs the plain version; any other device raises.
"""

from __future__ import annotations

import ctypes
import math
from functools import cache, lru_cache

import numpy as np
import torch

from .. import native
from ..config import debug_enabled
from ..utils.trace import span
from . import plans
from .filters import (
    hamming_filter,
    keys_cubic_filter,
    lanczos3_filter,
    lanczos5_filter,
    triangle_filter,
)
from .plans import Pass
from .resize_xla import gather_reduce, gather_reduce_weights
from .weights import AxisSpec, Tables

__all__ = ["resize2d", "resize_axis", "synth_applies"]

KERNEL_DTYPES = tuple(native.DTYPES)


@lru_cache(maxsize=1024)
def _plan2d_synth(spec_h: AxisSpec, spec_w: AxisSpec, itemsize: int = 4,
                  planes: int = 1, n_sm: int = plans.H100_SMS) -> plans.Plan2d | None:
    """``plans.plan_rows`` over the first taps the fused kernel synthesises."""
    return plans.plan_rows(_synth_first(spec_h), spec_h.ntaps, spec_h.in_size,
                           _synth_first(spec_w), spec_w.ntaps, spec_w.in_size,
                           itemsize, planes, n_sm)


def plan_axis_spec(spec: Pass, fused: bool, outer: int, inner: int, itemsize: int = 4,
                   n_sm: int = plans.H100_SMS, vec4: bool = False) -> plans.PlanAxis | None:
    """``plans.plan_axis_first`` over a pass's tables (``fused``: over the
    first taps the fused kernel synthesises)."""
    ntaps = spec.ntaps if fused else plans.tables(spec)[1].shape[1]
    return plans.plan_axis_first(_first_key(spec, fused), ntaps, spec.in_size, outer, inner,
                                 itemsize, n_sm, vec4, fused)


@cache
def _first_key(spec: Pass, fused: bool) -> bytes:
    """A pass's first taps (``fused``: the synthesised ones) as int64 bytes."""
    return plans.first_taps_key(_synth_first(spec) if fused else plans.tables(spec)[0])


# ---------------------------------------------------------------------------
# In-kernel weight synthesis: the spec's float32 constants, the host's first
# taps and the plain version's weights
# ---------------------------------------------------------------------------

# the JAX package's continuous filters -> (code of csrc/ia_taps.cuh, (c0, c1,
# c2)): a + 2, a + 3 and a of the Keys cubic; the order n of Lanczos-n
_SYNTH_FILTERS = {
    triangle_filter: (0, (0.0, 0.0, 0.0)),
    keys_cubic_filter: (1, (1.5, 2.5, -0.5)),
    hamming_filter: (2, (0.0, 0.0, 0.0)),
    lanczos3_filter: (3, (3.0, 0.0, 0.0)),
    lanczos5_filter: (3, (5.0, 0.0, 0.0)),
}
_PI_F32 = float(np.float32(np.pi))  # jnp.sinc's and jnp.pi * x's float32 pi
# Hamming's window constants, Pillow's float literals (ops/filters.py)
_HAMMING_A = float(np.float32(0.54))
_HAMMING_B = float(np.float32(0.46))


class _SynthSpec(ctypes.Structure):
    """The C struct ``ia::Synth`` (csrc/ia_taps.cuh)."""

    _fields_ = [(n, ctypes.c_int) for n in ("filter", "in_size", "ntaps", "align_corners")] + \
        [(n, ctypes.c_float) for n in ("scale", "invscale", "support", "offset",
                                       "c0", "c1", "c2")]


def synth_applies(spec: Pass) -> bool:
    """Whether ``fused=True`` synthesises this pass's weights: the JAX
    package's gate (``resize_axis_pallas``), continuous filters with the
    ``renorm`` border; box, nearest, area and the ``replicate`` and ``zero``
    borders run the tables (as does the a = -0.75 cubic, which only the
    ``replicate`` border uses)."""
    return (isinstance(spec, AxisSpec)
            and spec.mode not in ("box", "nearest", "area")
            and spec.border == "renorm"
            and spec.filter.fn in _SYNTH_FILTERS)


@cache
def _synth_consts(spec: AxisSpec) -> dict:
    """The spec's closed form as the kernel reads it: every Python float
    rounded to float32 once (as JAX's weak typing rounds ``spec.scale``
    and friends inside ``_synth_band``), as Python floats."""
    code, (c0, c1, c2) = _SYNTH_FILTERS[spec.filter.fn]
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    return dict(filter=code, in_size=spec.in_size, ntaps=spec.ntaps,
                align_corners=int(spec.align_corners), scale=f32(spec.scale),
                invscale=f32(spec.invscale), support=f32(spec.support),
                offset=f32(spec.span[0]) if spec.span is not None else 0.0,
                c0=f32(c0), c1=f32(c1), c2=f32(c2))


@cache
def _synth_struct(spec: AxisSpec) -> _SynthSpec:
    return _SynthSpec(**_synth_consts(spec))


@cache
def _synth_first(spec: AxisSpec) -> np.ndarray:
    """Each output's first tap, ``floor(center - support + 0.5)`` in
    float32 as the kernel computes it (numpy float32 rounds every
    operation): the host plans resample2d's row windows from it.
    Read-only (cached)."""
    c = _synth_consts(spec)
    f = np.float32
    o = np.arange(spec.out_size, dtype=np.float32)
    if spec.align_corners:
        center = f(c["scale"]) * o + f(0.5)
    else:
        center = f(c["scale"]) * (o + f(0.5)) + f(c["offset"])
    first = np.floor(center - f(c["support"]) + f(0.5)).astype(np.int64)
    first.setflags(write=False)
    return first


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sinc``: ``sin(pi x) / (pi x)`` with ``pi x`` rounded once, 1
    at 0 (``torch.sinc`` rounds otherwise)."""
    zero = x == 0.0
    px = torch.where(zero, 1.0, x * _PI_F32)
    return torch.where(zero, 1.0, torch.sin(px) / px)


def _synth_filter(code: int, consts: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel's ``synth_filter``: the JAX package's filters evaluated on
    float32 tensors, operation by operation.  Every constant is exact in
    float32, and every division is by a tensor (a division by a CPU scalar
    on the card multiplies by its reciprocal)."""
    ax = x.abs()
    if code == 0:  # triangle
        return torch.where(ax < 1.0, 1.0 - ax, 0.0)
    if code == 1:  # Keys cubic
        inner = ((ax * consts["c0"] - consts["c1"]) * ax) * ax + 1.0
        outer = (((ax - 5.0) * ax + 8.0) * ax - 4.0) * consts["c2"]
        return torch.where(ax < 1.0, inner, torch.where(ax < 2.0, outer, 0.0))
    if code == 2:  # Hamming
        px = torch.where(ax == 0.0, 1.0, x * _PI_F32)
        val = (torch.sin(px) / px) * (torch.cos(px) * _HAMMING_B + _HAMMING_A)
        val = torch.where(ax == 0.0, 1.0, val)
        return torch.where(ax < 1.0, val, 0.0)
    n = consts["c0"]  # Lanczos-n
    val = _sinc(x) * _sinc(x / torch.full_like(x, n))
    return torch.where(ax < n, val, 0.0)


def _synth_tables(spec: AxisSpec, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(first[out] int64, w[out, ntaps] float32)`` on ``device``: the
    weights the fused kernels synthesise (``csrc/ia_taps.cuh``), with the
    same float32 operations in the same order, so the plain version and the
    kernel agree bit for bit where their sin/cos agree.

    ``center = scale * (o + 0.5) + span[0]`` (``align_corners``: ``scale *
    o + 0.5``); tap ``k`` of ``ntaps`` from ``first = floor(center -
    support + 0.5)`` weighs ``filter((first + k - center + 0.5) *
    invscale)``, 0 off ``[0, in_size - 1]``; the taps' sum, in tap order
    (1 where it is 0), divides them: the JAX package's ``_synth_band`` per
    output."""
    c = _synth_consts(spec)
    o = torch.arange(spec.out_size, dtype=torch.float32, device=device)
    if spec.align_corners:
        center = o * c["scale"] + 0.5
    else:
        center = (o + 0.5) * c["scale"]
        if spec.span is not None:
            center = center + c["offset"]
    first = torch.floor(center - c["support"] + 0.5)
    pos = first[:, None] + torch.arange(spec.ntaps, dtype=torch.float32, device=device)
    arg = ((pos - center[:, None]) + 0.5) * c["invscale"]
    w = _synth_filter(c["filter"], c, arg)
    w = torch.where((pos >= 0.0) & (pos <= float(spec.in_size - 1)), w, 0.0)
    total = torch.zeros_like(center)
    for k in range(spec.ntaps):
        total = total + w[:, k]
    total = torch.where(total == 0.0, 1.0, total)
    return first.to(torch.int64), w / total[:, None]


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _quant_u8(v: torch.Tensor) -> torch.Tensor:
    """The uint8 lattice, kept in float: ``floor(v + 0.5)`` clamped to
    [0, 255] (not ``torch.round``, which rounds half to even)."""
    return torch.floor(v + 0.5).clamp_(0.0, 255.0)


def _store(v: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    if out_dtype == torch.uint8:
        return _quant_u8(v).to(torch.uint8)
    return v.to(out_dtype)  # bfloat16: round to nearest even


def _resample2d_plain(x3: torch.Tensor, spec_h: Pass, spec_w: Pass,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """resample2d's plain PyTorch version, on any device: ``x3[B, H, W]`` ->
    ``[B, OH, OW]``, W pass then H pass."""
    y = gather_reduce(x3, spec_w, 2, torch.float32)
    if x3.dtype == torch.uint8 and out_dtype == torch.uint8:
        y = _quant_u8(y)
    return _store(gather_reduce(y, spec_h, 1, torch.float32), out_dtype)


def _resample_axis_plain(x3: torch.Tensor, spec: Pass,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """resample_axis's plain PyTorch version, on any device:
    ``x3[outer, n_in, inner]`` -> ``[outer, n_out, inner]``."""
    return _store(gather_reduce(x3, spec, 1, torch.float32), out_dtype)


def _synth_pass(x3: torch.Tensor, spec: AxisSpec, axis: int) -> torch.Tensor:
    first, w = _synth_tables(spec, x3.device)
    return gather_reduce_weights(x3, first, w, axis, torch.float32)


def _resample2d_fused_plain(x3: torch.Tensor, spec_h: AxisSpec, spec_w: AxisSpec,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """The fused resample2d's plain PyTorch version, on any device:
    :func:`_resample2d_plain` over :func:`_synth_tables`' weights."""
    y = _synth_pass(x3, spec_w, 2)
    if x3.dtype == torch.uint8 and out_dtype == torch.uint8:
        y = _quant_u8(y)
    return _store(_synth_pass(y, spec_h, 1), out_dtype)


def _resample_axis_fused_plain(x3: torch.Tensor, spec: AxisSpec,
                               out_dtype: torch.dtype) -> torch.Tensor:
    """The fused resample_axis's plain PyTorch version, on any device."""
    return _store(_synth_pass(x3, spec, 1), out_dtype)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    """Validate a kernel call's dtypes and device; return the output dtype
    (float32 for uint8 input, else the input's, by default)."""
    if x.dtype not in native.DTYPES:
        raise ValueError(f"the resample kernels take {KERNEL_DTYPES}, got {x.dtype}")
    if out_dtype is None:
        out_dtype = torch.float32 if x.dtype == torch.uint8 else x.dtype
    if out_dtype not in native.DTYPES:
        raise ValueError(f"the resample kernels give {KERNEL_DTYPES}, got {out_dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"the resample kernels run on CUDA (kernel) or CPU (plain "
            f"version), not on {x.device}")
    return out_dtype


def _plan_args(plan: plans.Plan2d) -> tuple[int, ...]:
    """The plan as the C entry points take it: tile_r, tile_c, rows_cap,
    cols_cap, chunk, smem."""
    return plan[:6]


def occupancy_2d(plan: plans.Plan2d, in_dtype: torch.dtype, out_dtype: torch.dtype,
                 ntaps_w: int, ntaps_h: int, fused: bool = False) -> int:
    """Resident blocks per SM of resample2d's kernel (``fused``: the
    synthesising one) under ``plan`` on the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it (registers
    and shared memory both count).  Launches nothing; needs the card."""
    entry = "ia_resample2d_fused_occupancy" if fused else "ia_resample2d_occupancy"
    return native.occupancy(entry, native.DTYPES[in_dtype], native.DTYPES[out_dtype],
                            ntaps_w, ntaps_h, *_plan_args(plan))


def _resample2d_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    _, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    with span("ia.tables.resize2d"):
        xmin_w, w_w = plans.tables_on(spec_w, x3.device)
        ymin_h, w_h = plans.tables_on(spec_h, x3.device)
    quant = int(x3.dtype == torch.uint8 and out_dtype == torch.uint8)
    return native.launch_planes(
        "resample2d", x3, (OH, OW), out_dtype, plans.blocks_per_plane(plan, OH, OW),
        (native.DTYPES[x3.dtype], native.DTYPES[out_dtype]),
        (H, W, OH, OW, xmin_w.data_ptr(), w_w.data_ptr(), w_w.shape[1], ymin_h.data_ptr(),
         w_h.data_ptr(), w_h.shape[1], quant, *_plan_args(plan)))


def occupancy_stream(plan: plans.PlanStream, in_dtype: torch.dtype,
                     out_dtype: torch.dtype) -> int:
    """Resident blocks per SM of the streaming kernel under ``plan`` on the
    current card (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``).
    Launches nothing; needs the card."""
    return native.occupancy("ia_resample2d_stream_occupancy", native.DTYPES[in_dtype],
                            native.DTYPES[out_dtype], plan.ntaps, plan.seg, plan.stages,
                            plan.cols_cap, plan.smem)


def _resample2d_stream_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    _, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    with span("ia.tables.resize2d"):
        xmin_w, w_w = plans.stream_tables_on(spec_w, plan.ntaps, x3.device)
        ymin_h, w_h = plans.stream_tables_on(spec_h, plan.ntaps, x3.device)
    return native.launch_planes(
        "resample2d_stream", x3, (OH, OW), out_dtype, plans.blocks_per_plane(plan, OH, OW),
        (native.DTYPES[x3.dtype], native.DTYPES[out_dtype]),
        (H, W, OH, OW, xmin_w.data_ptr(), w_w.data_ptr(), ymin_h.data_ptr(), w_h.data_ptr(),
         plan.ntaps, plan.seg, plan.stages, plan.cols_cap, plan.smem))


def _axis_plan(x3: torch.Tensor, spec: Pass, fused: bool) -> plans.PlanAxis | None:
    outer, _, inner = x3.shape
    return plan_axis_spec(spec, fused, outer, inner, x3.element_size(),
                          plans.n_sm(x3.device), x3.data_ptr() % 4 == 0)


def occupancy_axis(plan: plans.PlanAxis, kind: str, in_dtype: torch.dtype,
                   out_dtype: torch.dtype, ntaps: int) -> int:
    """Resident blocks per SM of the axis kernel ``kind`` (``"table"``,
    ``"fused"`` or ``"pil"``, uint8 -> uint8) under ``plan`` on the current
    card, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it.
    Launches nothing; needs the card."""
    if kind == "pil":
        return native.occupancy("ia_pil_resample_axis_occupancy", ntaps, plan.vec, plan.smem)
    return native.occupancy("ia_resample_axis_occupancy", int(kind == "fused"),
                            native.DTYPES[in_dtype], native.DTYPES[out_dtype], ntaps,
                            plan.vec, plan.smem)


def _resample_axis_cuda(x3, spec, out_dtype) -> torch.Tensor:
    outer, n_in, inner = x3.shape
    out = torch.empty((outer, spec.out_size, inner), dtype=out_dtype,
                      device=x3.device)
    if out.numel() == 0:
        return out
    dev = x3.device
    xmin, w = plans.tables_on(spec, dev)
    plan = _axis_plan(x3, spec, False)
    native.launch("resample_axis", dev, x3.data_ptr(), out.data_ptr(),
                  native.DTYPES[x3.dtype], native.DTYPES[out_dtype], outer, n_in, inner,
                  spec.out_size, xmin.data_ptr(), w.data_ptr(), w.shape[1],
                  *plans.axis_launch_args(plan, _first_key(spec, False), n_in, dev))
    return out


def _resample2d_fused_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    _, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    sw, sh = _synth_struct(spec_w), _synth_struct(spec_h)
    quant = int(x3.dtype == torch.uint8 and out_dtype == torch.uint8)
    return native.launch_planes(
        "resample2d_fused", x3, (OH, OW), out_dtype, plans.blocks_per_plane(plan, OH, OW),
        (native.DTYPES[x3.dtype], native.DTYPES[out_dtype]),
        (H, W, OH, OW, ctypes.addressof(sw), ctypes.addressof(sh), quant, *_plan_args(plan)))


def _resample_axis_fused_cuda(x3, spec, out_dtype) -> torch.Tensor:
    outer, n_in, inner = x3.shape
    out = torch.empty((outer, spec.out_size, inner), dtype=out_dtype,
                      device=x3.device)
    if out.numel() == 0:
        return out
    dev = x3.device
    plan = _axis_plan(x3, spec, True)
    native.launch("resample_axis_fused", dev, x3.data_ptr(), out.data_ptr(),
                  native.DTYPES[x3.dtype], native.DTYPES[out_dtype], outer, n_in, inner,
                  spec.out_size, ctypes.addressof(_synth_struct(spec)),
                  *plans.axis_launch_args(plan, _first_key(spec, True), n_in, dev))
    return out


def _fused_gate(fused: bool, *specs: Pass) -> list[bool]:
    """Per pass, whether ``fused=True`` synthesises its weights; raises for
    :class:`..weights.Tables` (an adjoint's or a shard's tables have no
    closed form)."""
    if not fused:
        return [False] * len(specs)
    if any(isinstance(s, Tables) for s in specs):
        raise ValueError("fused=True synthesises a forward pass's weights from "
                         "its AxisSpec; Tables (an adjoint's or a shard's) have "
                         "no closed form")
    gate = [synth_applies(s) for s in specs]
    if debug_enabled() and not all(gate):
        print("[ia-tpu] fused=True: box/nearest/area or a non-renorm border "
              "runs the tables")
    return gate


def resize2d_plan(spec_h: Pass, spec_w: Pass, itemsize: int, planes: int, n_sm: int,
                  fused_h: bool = False,
                  fused_w: bool = False) -> plans.Plan2d | plans.PlanStream | None:
    """:func:`resize2d`'s launch decision for ``planes`` planes of
    ``itemsize``-byte elements on a card of ``n_sm`` SMs: kernel A's plan
    (over the synthesised first taps where both passes are fused), or None,
    where no tile fits or only one pass is fused: two resample_axis passes
    (W into :func:`axes_inter_dtype`, then H).  Over tables, a long launch
    takes the streaming kernel's plan where ``plans.plan2d_stream`` gives
    one."""
    if fused_h != fused_w:
        return None
    planes = max(1, planes)
    if fused_h:
        return _plan2d_synth(spec_h, spec_w, itemsize, planes, n_sm)
    return (plans.plan2d_stream(spec_h, spec_w, itemsize, planes, n_sm)
            or plans.plan2d(spec_h, spec_w, itemsize, planes, n_sm))


def axes_inter_dtype(in_dtype: torch.dtype, out_dtype: torch.dtype) -> torch.dtype:
    """The intermediate of :func:`resize2d`'s two-pass fallback: the uint8
    lattice for uint8 -> uint8 (as the kernel's), else float32."""
    return torch.uint8 if in_dtype == out_dtype == torch.uint8 else torch.float32


def resize2d(x: torch.Tensor, spec_h: Pass, spec_w: Pass,
             out_dtype: torch.dtype | None = None,
             fused: bool = False) -> torch.Tensor:
    """Separable 2-D resize of the trailing ``[H, W]`` axes of ``x`` (any
    leading axes) in one resample2d launch — the counterpart of the JAX
    package's ``resize2d_onekernel`` and ``resize2d_streamed``, and, over
    :func:`..weights.adjoint_tables`, of ``resize2d_onekernel_transpose``.
    The launch's tiles follow the batch and the card (``plans.plan_rows``);
    a long launch over tables walks column strips instead
    (:func:`resize2d_plan`, ``plans.plan2d_stream``).  Both give the plain
    version's bits for finite inputs.  An inf or NaN can spread to other
    outputs on the streaming kernel, whose in-axis tables drop and add taps
    of weight 0 (``0 * inf`` is NaN), so which outputs it reaches there
    depends on the batch through the plan.

    ``x`` is uint8, float32 or bfloat16; ``out_dtype`` uint8 (``floor(v +
    0.5)`` clamped), float32 or bfloat16, by default float32 for uint8 input
    and the input's dtype otherwise.  Where no output tile's row window fits
    a block's shared memory (``plans.plan2d``), the call runs two
    resample_axis passes instead, W then H, as the JAX package's
    ``resize2d_pallas`` fallback does; nothing raises for size.

    ``fused=True`` synthesises both passes' weights in the kernel (the JAX
    package's ``resize2d_pallas(fused=True)``), no tables uploaded, where
    both specs pass :func:`synth_applies`; the no-tile fallback then runs
    two fused resample_axis passes.  Where only one spec does, each pass
    runs on its own, W then H, with its own weights (the same sums as one
    launch: the intermediate is float32, or the uint8 lattice, either way).
    """
    out_dtype = _check(x, out_dtype)
    if x.ndim < 2 or x.shape[-2] != spec_h.in_size or x.shape[-1] != spec_w.in_size:
        raise ValueError(
            f"resize2d: trailing axes {tuple(x.shape[-2:])} != "
            f"({spec_h.in_size}, {spec_w.in_size})")
    with span("ia.tables.resize2d"):
        fused_h, fused_w = _fused_gate(fused, spec_h, spec_w)
        plan = resize2d_plan(spec_h, spec_w, x.element_size(), math.prod(x.shape[:-2]),
                             plans.n_sm(x.device), fused_h, fused_w)
    if plan is None:
        if debug_enabled():
            print("[ia-tpu] resample2d: no tile fits (or one pass fused), "
                  "two resample_axis passes")
        y = resize_axis(x, spec_w, -1, axes_inter_dtype(x.dtype, out_dtype),
                        fused=fused_w)
        return resize_axis(y, spec_h, -2, out_dtype, fused=fused_h)
    lead = x.shape[:-2]
    x3 = x.reshape(math.prod(lead), spec_h.in_size, spec_w.in_size).contiguous()
    if debug_enabled():
        kind = " (fused)" if fused_h else " (stream)" if isinstance(plan, plans.PlanStream) else ""
        print(f"[ia-tpu] resample2d{kind} "
              f"{x.dtype}->{out_dtype} ({x.device.type})")
    if x.device.type == "cuda":
        launch = (_resample2d_fused_cuda if fused_h else _resample2d_stream_cuda
                  if isinstance(plan, plans.PlanStream) else _resample2d_cuda)
        y = launch(x3, spec_h, spec_w, out_dtype, plan)
    elif fused_h:
        y = _resample2d_fused_plain(x3, spec_h, spec_w, out_dtype)
    else:
        y = _resample2d_plain(x3, spec_h, spec_w, out_dtype)
    return y.reshape(*lead, spec_h.out_size, spec_w.out_size)


def resize_axis(x: torch.Tensor, spec: Pass, axis: int,
                out_dtype: torch.dtype | None = None,
                fused: bool = False) -> torch.Tensor:
    """Resize ``axis`` of ``x`` (any rank) in one resample_axis launch — the
    counterpart of the JAX package's ``resize_axis_pallas`` (and, over
    :func:`..weights.adjoint_tables`, of ``resize_axis_transpose_pallas``).
    ``x`` is viewed as ``[outer, n_in, inner]``, so NCHW and NHWC both run
    without moves.  Dtypes as :func:`resize2d`.  ``fused=True`` synthesises
    the weights in the kernel where :func:`synth_applies` (the JAX
    package's ``fused=True``); a :class:`..weights.Tables` pass raises."""
    out_dtype = _check(x, out_dtype)
    axis = axis % x.ndim
    if x.shape[axis] != spec.in_size:
        raise ValueError(f"axis {axis} has {x.shape[axis]} != {spec.in_size}")
    fused, = _fused_gate(fused, spec)
    lead, trail = x.shape[:axis], x.shape[axis + 1:]
    x3 = x.reshape(math.prod(lead), spec.in_size, math.prod(trail)).contiguous()
    if debug_enabled():
        print(f"[ia-tpu] resample_axis{' (fused)' if fused else ''} axis={axis} "
              f"{spec.in_size}->{spec.out_size} {x.dtype}->{out_dtype} "
              f"({x.device.type})")
    if x.device.type == "cuda":
        launch = _resample_axis_fused_cuda if fused else _resample_axis_cuda
        y = launch(x3, spec, out_dtype)
    elif fused:
        y = _resample_axis_fused_plain(x3, spec, out_dtype)
    else:
        y = _resample_axis_plain(x3, spec, out_dtype)
    return y.reshape(*lead, spec.out_size, *trail)
