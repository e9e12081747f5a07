"""Bit-exact Pillow uint8 resize (MaxAbsE = 0 against PIL.Image.resize).

The port of ``interpolate_antialiasing_tpu.ops.pil_exact``: it emulates
Pillow's integer pipeline exactly (Pillow ``src/libImaging/Resample.c``,
8bpc path):

  * coefficients: double weights scaled by ``1 << PRECISION_BITS`` and
    rounded half-away-from-zero (``normalize_coeffs_8bpc``),
  * per-pass accumulate in int32 starting from ``1 << (PRECISION_BITS-1)``,
    then arithmetic-shift and clip to uint8 (``clip8``),
  * horizontal pass first, producing a *uint8 intermediate image*, then the
    vertical pass on that.

Both passes run in one hand-written CUDA kernel, the Pillow two-pass kernel
(kernel A, ``csrc/resample2d.cuh``, over Pillow's int32 tables; entry
``csrc/pil_resample.cu``, the counterpart of the JAX package's
``_kernel_2pass_pil``) through the wrapper :func:`_resample_2pass`, with
kernel A's tile plan (``cuda_resize._plan_rows``, one-byte elements and
intermediate; :func:`_plan_2pass`).  Where no tile fits a block's shared
memory, the wrapper runs two ``pil_resample_axis`` passes instead
(:func:`_resample_2pass_axes`).  Its plain PyTorch version,
:func:`_resample_2pass_plain`, computes the same bytes with tensor ops; the
wrapper takes it for tensors on the CPU.  One pass over one axis runs the
``pil_resample_axis`` kernel (``csrc/resample_axis.cuh`` over Pillow's
int32 tables, entry ``csrc/pil_resample_axis.cu``; the counterpart of
``digit_pass_mid_dynamic``) through :func:`_resample_axis`, plain version
:func:`_resample_axis_plain`, with the tile plan of the float axis kernel
(``cuda_resize._plan_axis``): the sharded byte-exact route's shard-local
passes.

The host tables (``_int_tables``, ``_int_matrix``, ``_nearest_indices``,
``_needs_clip``) are copied expression for expression from the JAX package,
so both packages quantise the same float64 weights to the same integers.
"""

from __future__ import annotations

import math
from functools import cache, lru_cache
from typing import Sequence

import numpy as np
import torch

from ..config import debug_enabled
from ..utils.trace import builds, span, spanned
from . import cuda_resize as cr
from .weights import make_axis_spec, pil_box_f32

__all__ = ["resize_pil_exact", "reduce_pil_exact", "PRECISION_BITS"]

PRECISION_BITS = 32 - 8 - 2  # Pillow Resample.c

# Launches of the pil_resample_2pass and pil_resample_axis CUDA kernels:
# :func:`_resample_2pass` and :func:`_resample_axis` each add one per kernel
# launch and nowhere else, so a run can show that its main path went through
# the kernel.
launches = 0
launches_axis = 0

_PIL_AUTO_METHODS = ("bilinear", "bicubic", "box", "nearest", "lanczos3",
                     "hamming")


@cache
def _int_matrix(
    in_size: int, out_size: int, mode: str,
    span: tuple[float, float] | None = None,
    pb: int = PRECISION_BITS,
) -> np.ndarray:
    """Dense [out, in] int32 coefficient matrix, Pillow-normalised
    (normalize_coeffs_8bpc: trunc(w * 2^pb ± 0.5), i.e. round half away
    from zero).  Scatter of the banded :func:`_int_tables` — the
    quantisation itself lives there, once."""
    xmin, Wb = _int_tables(in_size, out_size, mode, span, pb)
    ntaps = Wb.shape[1]
    K = np.zeros((out_size, in_size), np.int32)
    rows = np.repeat(np.arange(out_size), ntaps)
    cols = (xmin[:, None].astype(np.int64) + np.arange(ntaps)[None, :]).reshape(-1)
    keep = (cols >= 0) & (cols < in_size)
    K[rows[keep], cols[keep]] = Wb.reshape(-1)[keep]
    return K


@cache
def _nearest_indices(
    in_size: int, out_size: int,
    span: tuple[float, float] | None = None,
) -> np.ndarray:
    """Pillow NEAREST source indices: Image.resize(NEAREST) goes through the
    incremental affine scaler (ImagingScaleAffine), which starts at
    ``xin = 0.5 * a`` and truncates after repeated ``xin += a`` float64
    additions — the accumulation drift is observable and must be reproduced
    addition-by-addition for bit parity.  With a resize ``box``, the affine
    coefficients become ``a = (hi - lo) / out`` and the start
    ``lo + 0.5 * a``, with the box coords rounded through C float and the
    span length subtracted in float32 before the double divide (see
    :func:`..weights.pil_box_f32`)."""
    if span is not None:
        lo, _, span_len = pil_box_f32(*span)
    else:
        lo, span_len = 0.0, float(in_size)
    a = span_len / out_size
    xin = lo + a * 0.5
    idx = np.empty(out_size, np.int32)
    for o in range(out_size):
        idx[o] = min(max(int(xin), 0), in_size - 1)
        xin += a
    return idx


@cache
def _needs_clip(in_size: int, out_size: int, mode: str) -> bool:
    """Whether the clip in Pillow's clip8 can actually fire for this axis.

    For a NON-NEGATIVE coefficient row the accumulator is provably in range
    (``acc >> 22 in [0, 255]``); negative lobes (bicubic/lanczos) genuinely
    overshoot.  The port's kernel clips unconditionally (the clip is cheap
    there); the predicate is kept as the JAX package's documented
    table property.
    """
    K = _int_matrix(in_size, out_size, mode)
    if K.min() < 0:
        return True
    assert K.astype(np.int64).sum(axis=1).max() <= (1 << PRECISION_BITS) + (
        1 << 12
    ), "colsum slack assumption violated"
    return False


@cache
@builds
def _int_tables(
    in_size: int, out_size: int, mode: str,
    span: tuple[float, float] | None = None,
    pb: int = PRECISION_BITS,
):
    """Banded Pillow coefficients: ``(xmin[out] int32, Wb[out, ntaps]
    int32)``, the normalize_coeffs_8bpc quantisation of the float64
    :func:`..weights.compute_tables` weights.  Returned arrays are
    read-only (they are cached)."""
    from .weights import compute_tables

    spec = make_axis_spec(in_size, out_size, mode, antialias=True, span=span)
    xmin, _, w = compute_tables(spec, dtype=np.float64)
    scaled = w * (1 << pb)
    Wb = np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int32)
    xmin = xmin.astype(np.int32)
    for a in (xmin, Wb):
        a.setflags(write=False)
    return xmin, Wb


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------


@lru_cache(maxsize=256)
@builds
def _table_tensor(data: bytes, shape: tuple[int, ...],
                  device: torch.device) -> torch.Tensor:
    return torch.frombuffer(bytearray(data), dtype=torch.int32).reshape(
        shape).to(device)


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int32 host table as a tensor on ``device``, uploaded once per
    distinct content and device."""
    def upload():
        c = np.ascontiguousarray(a, dtype=np.int32)
        return _table_tensor(c.tobytes(), c.shape, device)

    return cr._memo(a, device, upload)


def _pass_last_int_banded(
    x_u8: torch.Tensor, xmin: torch.Tensor, Wb: torch.Tensor,
    pb: int = PRECISION_BITS,
) -> torch.Tensor:
    """uint8 [..., in] -> uint8 [..., out]: one Pillow fixed-point pass along
    the last axis, ``clip8(2^(pb-1) + sum_k Wb[:, k] * x[..., xmin + k])``
    with tap indices clamped to the axis (zero-padded taps carry weight 0,
    so the clamp never contributes)."""
    in_size = x_u8.shape[-1]
    acc = torch.full((*x_u8.shape[:-1], Wb.shape[0]), 1 << (pb - 1),
                     dtype=torch.int32, device=x_u8.device)
    for k in range(Wb.shape[1]):
        idx = (xmin.long() + k).clamp(0, in_size - 1)
        acc += x_u8.index_select(-1, idx).to(torch.int32) * Wb[:, k]
    return (acc >> pb).clamp_(0, 255).to(torch.uint8)


def _resample_2pass_plain(x3: torch.Tensor, tw, th,
                          pb: int = PRECISION_BITS) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: uint8 [B, H, W] ->
    uint8 [B, oh, ow], W pass then H pass on the uint8 intermediate."""
    dev = x3.device
    y = _pass_last_int_banded(x3, _on(tw[0], dev), _on(tw[1], dev), pb)
    y = _pass_last_int_banded(y.transpose(-1, -2), _on(th[0], dev),
                              _on(th[1], dev), pb)
    return y.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------


def _check_tables(name: str, tables, in_size: int, pb: int) -> None:
    xmin, Wb = tables
    if xmin.ndim != 1 or Wb.ndim != 2 or Wb.shape[0] != xmin.shape[0]:
        raise ValueError(
            f"{name} tables must be xmin[out] and Wb[out, ntaps], got "
            f"{xmin.shape} and {Wb.shape}")
    if Wb.shape[0] < 1 or Wb.shape[1] < 1 or in_size < 1:
        raise ValueError(f"{name} axis is empty: in={in_size}, Wb={Wb.shape}")
    # Pillow's accumulator is int32 and so is the kernel's: the largest
    # |acc| any uint8 row can reach must stay below 2^31.
    worst = 255 * cr._memo(
        Wb, "row sum", lambda: int(np.abs(Wb.astype(np.int64)).sum(axis=1).max()))
    if worst + (1 << (pb - 1)) >= 1 << 31:
        raise ValueError(
            f"{name} coefficients can overflow the int32 accumulator "
            f"(255 * max row sum|Wb| + 2^{pb - 1} = "
            f"{worst + (1 << (pb - 1))} >= 2^31)")


@lru_cache(maxsize=1024)
@builds
def _plan_2pass_keyed(first_h: bytes, ntaps_h: int, H: int, first_w: bytes, ntaps_w: int,
                      W: int, planes: int, n_sm: int) -> cr.Plan2d | None:
    return cr._plan_rows(np.frombuffer(first_h, np.int64), ntaps_h, H,
                         np.frombuffer(first_w, np.int64), ntaps_w, W, 1, planes, n_sm,
                         inter_size=1)


def _plan_2pass(tw, th, planes: int, H: int, W: int,
                n_sm: int = cr._H100_SMS) -> cr.Plan2d | None:
    """The Pillow two-pass kernel's plan (kernel A's, ``cuda_resize.
    _plan_rows``, for one-byte elements and a one-byte intermediate) over
    the ``(xmin, Wb)`` tables of the W and H passes, for ``planes`` planes
    of ``[H, W]`` on a card of ``n_sm`` SMs; None where no tile fits a
    block's shared memory (the wrapper then runs two pil_resample_axis
    passes).  Cached per table, shape and card."""
    return _plan_2pass_keyed(cr._first_taps_key(th[0]), th[1].shape[1], H,
                             cr._first_taps_key(tw[0]), tw[1].shape[1], W, planes, n_sm)


def _resample_2pass_axes(x3: torch.Tensor, tw, th, pb: int) -> torch.Tensor:
    """Both Pillow passes as two pil_resample_axis passes (W, then H on the
    uint8 intermediate): the same int32 sums, so the same bytes as the
    two-pass kernel.  Its route where no tile fits."""
    return _resample_axis(_resample_axis(x3, tw, 2, pb), th, 1, pb)


def _resample_2pass_cuda(x3: torch.Tensor, tw, th, pb: int) -> torch.Tensor:
    global launches
    from .. import native

    B, H, W = x3.shape
    OW, ntaps_w = tw[1].shape
    OH, ntaps_h = th[1].shape
    dev = x3.device
    out = torch.empty((B, OH, OW), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    with span("ia.tables.pil"):
        plan = _plan_2pass(tw, th, B, H, W, cr._n_sm(dev))
        if plan is not None:
            xmin_w, wb_w = _on(tw[0], dev), _on(tw[1], dev)
            ymin_h, wb_h = _on(th[0], dev), _on(th[1], dev)
    if plan is None:
        if debug_enabled():
            print("[ia-tpu] pil_resample_2pass: no tile fits, two "
                  "pil_resample_axis passes")
        return _resample_2pass_axes(x3, tw, th, pb)
    lib = native.build()
    # every block is on gridDim.x: a batch whose block count would pass
    # its 2^31 - 1 limit takes several launches
    per_plane = -(-OH // plan.tile_r) * -(-OW // plan.tile_c)
    with torch.cuda.device(dev):
        for b0, n in native.plane_chunks(B, cr._INT_MAX // per_plane):
            with span("ia.native.pil_resample_2pass"):
                err = lib.ia_pil_resample_2pass(
                    x3.data_ptr() + b0 * H * W, out.data_ptr() + b0 * OH * OW,
                    n, H, W, OH, OW,
                    xmin_w.data_ptr(), wb_w.data_ptr(), ntaps_w,
                    ymin_h.data_ptr(), wb_h.data_ptr(), ntaps_h,
                    pb, *plan[:6], torch.cuda.current_stream(dev).cuda_stream,
                )
                if err != 0:
                    raise RuntimeError(
                        f"pil_resample_2pass launch failed: cudaError {err}")
                launches += 1
    return out


def _resample_2pass(x3: torch.Tensor, tw, th,
                    pb: int = PRECISION_BITS) -> torch.Tensor:
    """uint8 ``x3[B, H, W]`` -> uint8 ``[B, oh, ow]``: both Pillow passes.

    ``tw``/``th`` are the ``(xmin, Wb)`` int32 host tables of the W and H
    axes (:func:`_int_tables`).  A CUDA tensor goes through the
    ``pil_resample_2pass`` kernel (two ``pil_resample_axis`` launches where
    no tile of it fits: :func:`_plan_2pass`); a CPU tensor through the
    plain version; any other device raises.
    """
    if not isinstance(x3, torch.Tensor) or x3.dtype != torch.uint8 or x3.ndim != 3:
        raise ValueError("pil_resample_2pass takes a uint8 [B, H, W] tensor")
    if not x3.is_contiguous():
        raise ValueError("pil_resample_2pass takes a contiguous tensor")
    if not 1 <= pb <= 30:
        raise ValueError(f"precision bits must lie in [1, 30], got {pb}")
    _check_tables("W", tw, x3.shape[2], pb)
    _check_tables("H", th, x3.shape[1], pb)
    if x3.device.type == "cuda":
        return _resample_2pass_cuda(x3, tw, th, pb)
    if x3.device.type == "cpu":
        return _resample_2pass_plain(x3, tw, th, pb)
    raise ValueError(
        f"pil_resample_2pass runs on CUDA (kernel) or CPU (plain version), "
        f"not on {x3.device}")


# ---------------------------------------------------------------------------
# One Pillow pass over one axis: the pil_resample_axis kernel (the sharded
# byte-exact route's shard-local passes), its plain version and its wrapper
# ---------------------------------------------------------------------------


def _resample_axis_plain(x3: torch.Tensor, tables,
                         pb: int = PRECISION_BITS) -> torch.Tensor:
    """The pil_resample_axis kernel's plain PyTorch version, on any device:
    uint8 ``x3[outer, n_in, inner]`` -> uint8 ``[outer, n_out, inner]``,
    :func:`_pass_last_int_banded` along the middle axis of the view."""
    dev, n_in = x3.device, x3.shape[1]
    xmin, Wb = _on(tables[0], dev), _on(tables[1], dev)
    acc = torch.full((x3.shape[0], Wb.shape[0], x3.shape[2]), 1 << (pb - 1),
                     dtype=torch.int32, device=dev)
    for k in range(Wb.shape[1]):
        idx = (xmin.long() + k).clamp(0, n_in - 1)
        acc += x3.index_select(1, idx).to(torch.int32) * Wb[:, k, None]
    return (acc >> pb).clamp_(0, 255).to(torch.uint8)


def _plan_axis(tables, outer: int, n_in: int, inner: int, n_sm: int,
               vec4: bool) -> cr.PlanAxis | None:
    """The pil_resample_axis launch plan of a pass over ``x3[outer, n_in,
    inner]`` with the ``(xmin, Wb)`` tables: the float axis kernel's plan
    (``cuda_resize._plan_axis_first``) for one-byte elements on a card of
    ``n_sm`` SMs (``vec4``: the input's address is a multiple of 4); None:
    the unstaged body."""
    return cr._plan_axis_first(cr._first_taps_key(tables[0]), tables[1].shape[1], n_in,
                               outer, inner, 1, n_sm, vec4)


def _resample_axis_cuda(x3: torch.Tensor, tables, pb: int) -> torch.Tensor:
    global launches_axis
    from .. import native

    lib = native.build()
    outer, n_in, inner = x3.shape
    n_out, ntaps = tables[1].shape
    out = torch.empty((outer, n_out, inner), dtype=torch.uint8, device=x3.device)
    if out.numel() == 0:
        return out
    dev = x3.device
    xmin, wb = _on(tables[0], dev), _on(tables[1], dev)
    key = cr._first_taps_key(tables[0])
    plan = _plan_axis(tables, outer, n_in, inner, cr._n_sm(dev), x3.data_ptr() % 4 == 0)
    with torch.cuda.device(dev), span("ia.native.pil_resample_axis"):
        err = lib.ia_pil_resample_axis(
            x3.data_ptr(), out.data_ptr(), outer, n_in, inner, n_out,
            xmin.data_ptr(), wb.data_ptr(), ntaps, pb,
            *cr.axis_launch_args(plan, key, n_in, dev),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"pil_resample_axis launch failed: cudaError {err}")
        launches_axis += 1
    return out


def _resample_axis(x: torch.Tensor, tables, axis: int,
                   pb: int = PRECISION_BITS) -> torch.Tensor:
    """uint8 ``x`` of any rank -> uint8 with ``axis`` resampled by one
    Pillow fixed-point pass over the ``(xmin, Wb)`` int32 host tables (the
    counterpart of the JAX package's ``digit_pass_mid_dynamic`` and of
    ``_pass_last_int_banded``).  ``x`` is viewed as ``[outer, n_in,
    inner]``, so a middle axis, the last axis and NHWC all run without
    moves.  A CUDA tensor goes through the ``pil_resample_axis`` kernel; a
    CPU tensor through the plain version; any other device raises."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.uint8:
        raise ValueError("pil_resample_axis takes a uint8 tensor")
    if not 1 <= pb <= 30:
        raise ValueError(f"precision bits must lie in [1, 30], got {pb}")
    axis %= x.ndim
    _check_tables("axis", tables, x.shape[axis], pb)
    lead, trail = x.shape[:axis], x.shape[axis + 1:]
    x3 = x.reshape(math.prod(lead), x.shape[axis], math.prod(trail)).contiguous()
    if x.device.type == "cuda":
        y = _resample_axis_cuda(x3, tables, pb)
    elif x.device.type == "cpu":
        y = _resample_axis_plain(x3, tables, pb)
    else:
        raise ValueError(
            f"pil_resample_axis runs on CUDA (kernel) or CPU (plain version), "
            f"not on {x.device}")
    return y.reshape(*lead, tables[1].shape[0], *trail)


# ---------------------------------------------------------------------------
# PIL.Image.reduce (plain PyTorch: the JAX package runs it as one XLA reduce)
# ---------------------------------------------------------------------------


def _reduce_grids(span: int, out: int, f: int) -> np.ndarray:
    """Block extent per output index along ONE axis (edge-clipped)."""
    d = np.full(out, f, np.int64)
    if out * f > span:
        d[-1] = span - (out - 1) * f
    return d


def reduce_pil_exact(
    x: torch.Tensor,
    factor: int | tuple[int, int],
    box: tuple[int, int, int, int] | None = None,
    data_format: str | None = None,
) -> torch.Tensor:
    """Bit-identical ``PIL.Image.reduce``: integer-factor block average.

    ``factor``: int or ``(factor_x, factor_y)`` (PIL order: x = width).
    ``box``: optional INTEGER source window ``(x0, y0, x1, y1)``.  Output
    size rounds UP (partial edge blocks average over their clipped pixel
    count).

    Pillow's Reduce.c does not divide: each output byte is
    ``((sum + d//2) * uint32(float32(2**32) / float32(256*d))) >> 24`` with
    ``d`` the block's (clipped) pixel count — a truncated float32
    fixed-point reciprocal whose off-by-one-from-true-rounding cases are
    part of the observable contract.  The tables are the JAX package's,
    computed on the host in numpy float32; the block sums are int64 on the
    tensor's device, then the same fixed-point epilogue (the JAX package's
    uint32 product never wraps: ``s * mult < 2^32``).
    """
    from .resize import _axes_for

    if x.dtype != torch.uint8:
        raise ValueError("reduce_pil_exact is the uint8 (8bpc) pipeline")
    fx, fy = (factor, factor) if isinstance(factor, int) else (int(factor[0]), int(factor[1]))
    if fx < 1 or fy < 1:
        raise ValueError(f"factor must be >= 1, got {(fx, fy)}")
    h_axis, w_axis = _axes_for(x, data_format)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    ih, iw = x.shape[h_axis], x.shape[w_axis]
    if box is None:
        box = (0, 0, iw, ih)
    x0, y0, x1, y1 = (int(v) for v in box)
    if not (0 <= x0 < x1 <= iw and 0 <= y0 < y1 <= ih):
        raise ValueError(f"reduce box {box} must be integral within (0, 0, {iw}, {ih})")
    sw, sh = x1 - x0, y1 - y0
    ow, oh = -(-sw // fx), -(-sh // fy)
    # Host epilogue tables: block pixel counts and Reduce.c multipliers.
    dxs, dys = _reduce_grids(sw, ow, fx), _reduce_grids(sh, oh, fy)
    d = dys[:, None] * dxs[None, :]  # [oh, ow]
    amend = (d // 2).astype(np.uint32)
    mult = (np.float32(2**32) / (256 * d).astype(np.float32)).astype(np.uint32)
    # Device: crop, zero-pad to whole blocks (zeros never change sums),
    # reshape block-sum, then the exact fixed-point epilogue.
    y = torch.movedim(x, (h_axis, w_axis), (-2, -1))
    lead = y.shape[:-2]
    y = y[..., y0:y1, x0:x1]
    y = torch.nn.functional.pad(y, (0, ow * fx - sw, 0, oh * fy - sh))
    s = y.reshape(*lead, oh, fy, ow, fx).to(torch.int64).sum(dim=(-3, -1))
    dev = x.device
    v = ((s + torch.from_numpy(amend.astype(np.int64)).to(dev))
         * torch.from_numpy(mult.astype(np.int64)).to(dev)) >> 24
    return torch.movedim(v.to(torch.uint8), (-2, -1), (h_axis, w_axis))


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def _precision_bits(ih: int, iw: int, oh: int, ow: int, method: str,
                    digits: int) -> int:
    """The coefficient grid of a :func:`resize_pil_exact` call: Pillow's
    pb=22, or pb=14 under ``digits=2`` where both axes have at most 57 taps
    (the +-1 bound's admission, see its docstring)."""
    if digits != 2 or method == "pil_nearest":
        return PRECISION_BITS
    ntaps = max(make_axis_spec(ih, oh, method, antialias=True).ntaps,
                make_axis_spec(iw, ow, method, antialias=True).ntaps)
    if ntaps <= 57:
        return 14
    if debug_enabled():
        print(f"[ia-tpu] digits=2 declined (ntaps={ntaps} > 57): "
              "running the exact pb=22 grid")
    return PRECISION_BITS


@spanned("ia.ops.pil_exact")
def resize_pil_exact(
    x: torch.Tensor,
    size: Sequence[int],
    method: str = "bilinear",
    data_format: str | None = None,
    box: tuple[float, float, float, float] | None = None,
    reducing_gap: float | None = None,
    digits: int | None = None,
) -> torch.Tensor:
    """Bit-identical Pillow antialiased uint8 resize.

    ``x``: uint8 ``[H, W]``, ``[C, H, W]``, ``[N, C, H, W]`` (or NHWC via
    ``data_format``).  ``size``: ``(height, width)``.  Matches
    ``PIL.Image.resize((w, h), resample)`` byte for byte, and the JAX
    package's ``resize_pil_exact`` on every route.

    ``method``: bilinear | bicubic | box | nearest (PIL box) | lanczos3 |
    hamming | pil_nearest (PIL's NEAREST point sample).

    ``box``: optional fractional source window ``(x0, y0, x1, y1)`` in PIL
    order — byte-identical to ``PIL.Image.resize(size, resample, box=box)``.
    It runs the same kernel with the box's tables; tap indices still clamp
    at the full image edges exactly like Pillow.

    ``digits``: the accuracy dial.  ``3`` (default, or ``IA_TPU_PIL_DIGITS``)
    is Pillow's own pb=22 grid — byte-identical output.  ``2`` quantises the
    same double weights at pb=14, guaranteed ``MaxAbsE <= 1`` vs Pillow
    whenever the per-axis tap count is <= 57; wider windows run the exact
    grid.

    ``reducing_gap``: Pillow's reduce-then-resample shortcut
    (``PIL.Image.resize(..., reducing_gap=g)``): an integer-factor
    :func:`reduce_pil_exact` first, then the resample with the box rescaled
    onto the reduced image; byte-identical to Pillow.  ``pil_nearest``
    skips it, as Pillow's NEAREST does.
    """
    from ..config import default_pil_digits
    from .resize import _axes_for

    if x.dtype != torch.uint8:
        raise ValueError("resize_pil_exact is the uint8 (8bpc) pipeline")
    if digits is None:
        digits = default_pil_digits()
    if digits not in (2, 3):
        raise ValueError(f"digits must be 2 or 3, got {digits!r}")
    oh, ow = int(size[0]), int(size[1])
    h_axis, w_axis = _axes_for(x, data_format)
    h_axis, w_axis = h_axis % x.ndim, w_axis % x.ndim
    ih, iw = x.shape[h_axis], x.shape[w_axis]
    pb = _precision_bits(ih, iw, oh, ow, method, digits)
    if reducing_gap is not None:
        if reducing_gap < 1.0:
            raise ValueError("reducing_gap must be 1.0 or greater")
        # PIL.Image.resize's two-step optimisation, replicated expression by
        # expression (truncating int() factor picks, _get_safe_box support
        # margins, box rescale) so the shortcut output stays byte-identical.
        # NEAREST skips it, exactly like Pillow.
        if method != "pil_nearest":
            from .filters import get_filter

            b = tuple(float(v) for v in box) if box is not None else (
                0.0, 0.0, float(iw), float(ih))
            factor_x = int((b[2] - b[0]) / ow / reducing_gap) or 1
            factor_y = int((b[3] - b[1]) / oh / reducing_gap) or 1
            if factor_x > 1 or factor_y > 1:
                fsup = get_filter(method).support - 0.5
                sx = fsup * (b[2] - b[0]) / ow
                sy = fsup * (b[3] - b[1]) / oh
                rb = (
                    max(0, int(b[0] - sx)),
                    max(0, int(b[1] - sy)),
                    min(iw, math.ceil(b[2] + sx)),
                    min(ih, math.ceil(b[3] + sy)),
                )
                x = reduce_pil_exact(x, (factor_x, factor_y), box=rb,
                                     data_format=data_format)
                ih, iw = x.shape[h_axis], x.shape[w_axis]
                box = (
                    (b[0] - rb[0]) / factor_x,
                    (b[1] - rb[1]) / factor_y,
                    (b[2] - rb[0]) / factor_x,
                    (b[3] - rb[1]) / factor_y,
                )
    span_h = span_w = None
    if box is not None:
        bx0, by0, bx1, by1 = (float(v) for v in box)
        if not (0.0 <= bx0 < bx1 <= iw and 0.0 <= by0 < by1 <= ih):
            raise ValueError(
                f"box {box} must lie within (0, 0, {iw}, {ih}) with "
                "x0 < x1 and y0 < y1 (PIL order: x = width axis)"
            )
        if (bx0, by0, bx1, by1) != (0.0, 0.0, float(iw), float(ih)):
            span_w, span_h = (bx0, bx1), (by0, by1)
    if method == "pil_nearest":
        # PIL.Image.NEAREST is a point sample through the affine scaler, not
        # the resample machinery — a pure index gather, trivially bit-exact.
        # ('nearest' here is PIL's BOX antialias filter, as in the reference.)
        y = x.index_select(h_axis, torch.from_numpy(
            _nearest_indices(ih, oh, span_h).astype(np.int64)).to(x.device))
        return y.index_select(w_axis, torch.from_numpy(
            _nearest_indices(iw, ow, span_w).astype(np.int64)).to(x.device))
    # Every layout _axes_for yields keeps H, W trailing or channels-last; the
    # kernel takes planes, so channels-last round-trips through NCHW.
    channels_last = h_axis == x.ndim - 3
    xk = x.movedim(-1, -3) if channels_last else x
    lead = xk.shape[:-2]
    x3 = xk.reshape(math.prod(lead), ih, iw).contiguous()
    if debug_enabled():
        print(f"[ia-tpu] pil_exact pil_resample_2pass ({x3.device.type})")
    with span("ia.tables.pil"):
        tw = _int_tables(iw, ow, method, span_w, pb)
        th = _int_tables(ih, oh, method, span_h, pb)
    y = _resample_2pass(x3, tw, th, pb).reshape(*lead, oh, ow)
    return y.movedim(-3, -1) if channels_last else y
