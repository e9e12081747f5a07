"""Hand-written CUDA kernels of the float resize route (the port of
``interpolate_antialiasing_tpu.ops.pallas_resize``).

Two kernels, each with its wrapper, its plain PyTorch version, its host plan
and its launch count:

  * **resample2d** (``csrc/resample2d.cu``): both separable passes of the
    trailing ``[H, W]`` plane in one launch, W pass into shared memory, then
    H pass.  Replaces ``_kernel_2pass`` (``resize2d_onekernel``) and serves
    the shapes of ``_kernel_2pass_streamed`` (``resize2d_streamed``).
    Wrapper :func:`resize2d`; plain version :func:`_resample2d_plain`; host
    plan :func:`_plan2d`; count ``launches_2d``.
  * **resample_axis** (``csrc/resample_axis.cu``): one pass over any axis of
    any rank.  Replaces ``_kernel_last`` / ``_kernel_mid``
    (``resize_axis_pallas``) and serves the per-axis passes of
    ``_kernel_last_unrolled`` / ``_kernel_mid_unrolled`` (``resize2d_pallas``).
    Wrapper :func:`resize_axis`; plain version :func:`_resample_axis_plain`;
    count ``launches_axis``.

Each pass is given as an :class:`..weights.AxisSpec` (the forward matrix
``W``) or as :class:`..weights.Tables`: ``adjoint_tables(spec)`` runs the
same kernel over ``W^T``, which is how the backward pass of the resize runs
(the JAX package's ``resize2d_onekernel_transpose`` and
``resize_axis_transpose_pallas`` reuse their forward kernels over
transposed bands the same way).

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

import math
from functools import cache, lru_cache

import numpy as np
import torch

from .. import native
from ..config import debug_enabled
from .resize_xla import gather_reduce
from .weights import AxisSpec, Tables, as_tables

__all__ = ["resize2d", "resize_axis"]

# Launches of each kernel: the wrappers add one per kernel launch and
# nowhere else, so a run can show that its main path went through them.
launches_2d = 0
launches_axis = 0

# dtype codes of the C entry points (csrc/ia_dtypes.cuh)
_DTYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
KERNEL_DTYPES = tuple(_DTYPES)

# Largest dynamic shared memory one block may use on Hopper (227 KB).
_SMEM_LIMIT = 232448
# Output-row and output-column tiles of resample2d, largest first.
_TILE_R = (32, 16, 8, 4, 2, 1)
_TILE_C = (64, 32, 16, 8, 4, 2, 1)
_INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Host tables and plans
# ---------------------------------------------------------------------------


Pass = AxisSpec | Tables  # a forward spec, or the tables of any pass


@cache
def _tables(t: Pass) -> tuple[np.ndarray, np.ndarray]:
    """``(xmin[out] int32, w[out, ntaps] float32)``: the pass's float64
    tables (:func:`..weights.as_tables`), cast once.  Read-only (cached)."""
    tb = as_tables(t)
    w = np.ascontiguousarray(tb.w, dtype=np.float32)
    w.setflags(write=False)
    return tb.xmin, w


@lru_cache(maxsize=256)
def _tables_on(t: Pass, device: torch.device):
    """:func:`_tables` as tensors on ``device``, uploaded once per device."""
    xmin, w = _tables(t)
    return (torch.from_numpy(xmin.copy()).to(device),
            torch.from_numpy(w.copy()).to(device))


@cache
def _plan2d(spec_h: Pass) -> tuple[int, int, int] | None:
    """``(tile_r, tile_c, rows_cap)`` for resample2d, or None where no tile
    fits a block's shared memory.

    A block holds the W pass result for its output tile's input row window,
    ``rows_cap x tile_c`` floats.  The window of each ``tile_r``-row tile is
    computed exactly as the kernel computes it; the plan takes the largest
    tile (``tile_r * tile_c`` outputs, then the wider one) that fits, so an
    extreme downscale whose rows read a long window runs narrower column
    tiles rather than leaving the kernel."""
    ymin, w = _tables(spec_h)
    H, OH, ntaps = spec_h.in_size, spec_h.out_size, w.shape[1]
    lo = np.clip(ymin.astype(np.int64), 0, H - 1)
    hi = np.clip(ymin.astype(np.int64) + ntaps - 1, 0, H - 1) + 1
    best = None
    for tile_r in _TILE_R:
        n = -(-OH // tile_r)
        pad = n * tile_r - OH  # edge padding repeats a member of the tile
        lo_t = np.pad(lo, (0, pad), mode="edge").reshape(n, tile_r).min(1)
        hi_t = np.pad(hi, (0, pad), mode="edge").reshape(n, tile_r).max(1)
        rows = int((hi_t - lo_t).max())
        fits = [c for c in _TILE_C if rows * c * 4 <= _SMEM_LIMIT]
        if fits:
            best = max(best or (0, 0, 0, 0), (tile_r * fits[0], fits[0], tile_r, rows))
    if best is None:
        return None
    _, tile_c, tile_r, rows_cap = best
    return tile_r, tile_c, rows_cap


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


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------


def _check(x: torch.Tensor, out_dtype: torch.dtype | None) -> torch.dtype:
    """Validate a kernel call's dtypes and device; return the output dtype
    (float32 for uint8 input, else the input's, by default)."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"the resample kernels take {KERNEL_DTYPES}, got {x.dtype}")
    if out_dtype is None:
        out_dtype = torch.float32 if x.dtype == torch.uint8 else x.dtype
    if out_dtype not in _DTYPES:
        raise ValueError(f"the resample kernels give {KERNEL_DTYPES}, got {out_dtype}")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(
            f"the resample kernels run on CUDA (kernel) or CPU (plain "
            f"version), not on {x.device}")
    return out_dtype


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _resample2d_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    global launches_2d
    lib = native.build()
    tile_r, tile_c, rows_cap = plan
    B, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    out = torch.empty((B, OH, OW), dtype=out_dtype, device=x3.device)
    if B == 0:
        return out
    dev = x3.device
    xmin_w, w_w = _tables_on(spec_w, dev)
    ymin_h, w_h = _tables_on(spec_h, dev)
    quant = int(x3.dtype == torch.uint8 and out_dtype == torch.uint8)
    # every block of a launch is on gridDim.x: split batches whose block
    # count would pass its 2^31 - 1 limit
    per_plane = -(-OH // tile_r) * -(-OW // tile_c)
    with torch.cuda.device(dev):
        for b0, n in native.plane_chunks(B, _INT_MAX // per_plane):
            err = lib.ia_resample2d(
                x3.data_ptr() + b0 * H * W * x3.element_size(),
                out.data_ptr() + b0 * OH * OW * out.element_size(),
                _DTYPES[x3.dtype], _DTYPES[out_dtype], n, H, W, OH, OW,
                xmin_w.data_ptr(), w_w.data_ptr(), w_w.shape[1],
                ymin_h.data_ptr(), w_h.data_ptr(), w_h.shape[1],
                quant, tile_r, tile_c, rows_cap, _stream(dev))
            if err != 0:
                raise RuntimeError(f"resample2d launch failed: cudaError {err}")
            launches_2d += 1
    return out


def _resample_axis_cuda(x3, spec, out_dtype) -> torch.Tensor:
    global launches_axis
    lib = native.build()
    outer, n_in, inner = x3.shape
    out = torch.empty((outer, spec.out_size, inner), dtype=out_dtype,
                      device=x3.device)
    if out.numel() == 0:
        return out
    dev = x3.device
    xmin, w = _tables_on(spec, dev)
    with torch.cuda.device(dev):
        err = lib.ia_resample_axis(
            x3.data_ptr(), out.data_ptr(), _DTYPES[x3.dtype], _DTYPES[out_dtype],
            outer, n_in, inner, spec.out_size, xmin.data_ptr(), w.data_ptr(),
            w.shape[1], _stream(dev))
    if err != 0:
        raise RuntimeError(f"resample_axis launch failed: cudaError {err}")
    launches_axis += 1
    return out


def resize2d(x: torch.Tensor, spec_h: Pass, spec_w: Pass,
             out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Separable 2-D resize of the trailing ``[H, W]`` axes of ``x`` (any
    leading axes) in one resample2d launch — the counterpart of the JAX
    package's ``resize2d_onekernel`` and ``resize2d_streamed``, and, over
    :func:`..weights.adjoint_tables`, of ``resize2d_onekernel_transpose``.

    ``x`` is uint8, float32 or bfloat16; ``out_dtype`` uint8 (``floor(v +
    0.5)`` clamped), float32 or bfloat16, by default float32 for uint8 input
    and the input's dtype otherwise.  Where no output tile's row window fits
    a block's shared memory (:func:`_plan2d`), the call runs two
    resample_axis passes instead, W then H, as the JAX package's
    ``resize2d_pallas`` fallback does; nothing raises for size.
    """
    out_dtype = _check(x, out_dtype)
    if x.ndim < 2 or x.shape[-2] != spec_h.in_size or x.shape[-1] != spec_w.in_size:
        raise ValueError(
            f"resize2d: trailing axes {tuple(x.shape[-2:])} != "
            f"({spec_h.in_size}, {spec_w.in_size})")
    plan = _plan2d(spec_h)
    if plan is None:
        if debug_enabled():
            print("[ia-tpu] resample2d: no tile fits, two resample_axis passes")
        quant = x.dtype == torch.uint8 and out_dtype == torch.uint8
        y = resize_axis(x, spec_w, -1, torch.uint8 if quant else torch.float32)
        return resize_axis(y, spec_h, -2, out_dtype)
    lead = x.shape[:-2]
    x3 = x.reshape(math.prod(lead), spec_h.in_size, spec_w.in_size).contiguous()
    if debug_enabled():
        print(f"[ia-tpu] resample2d {x.dtype}->{out_dtype} ({x.device.type})")
    if x.device.type == "cuda":
        y = _resample2d_cuda(x3, spec_h, spec_w, out_dtype, plan)
    else:
        y = _resample2d_plain(x3, spec_h, spec_w, out_dtype)
    return y.reshape(*lead, spec_h.out_size, spec_w.out_size)


def resize_axis(x: torch.Tensor, spec: Pass, axis: int,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Resize ``axis`` of ``x`` (any rank) in one resample_axis launch — the
    counterpart of the JAX package's ``resize_axis_pallas`` (and, over
    :func:`..weights.adjoint_tables`, of ``resize_axis_transpose_pallas``).
    ``x`` is viewed as ``[outer, n_in, inner]``, so NCHW and NHWC both run
    without moves.  Dtypes as :func:`resize2d`."""
    out_dtype = _check(x, out_dtype)
    axis = axis % x.ndim
    if x.shape[axis] != spec.in_size:
        raise ValueError(f"axis {axis} has {x.shape[axis]} != {spec.in_size}")
    lead, trail = x.shape[:axis], x.shape[axis + 1:]
    x3 = x.reshape(math.prod(lead), spec.in_size, math.prod(trail)).contiguous()
    if debug_enabled():
        print(f"[ia-tpu] resample_axis axis={axis} {spec.in_size}->"
              f"{spec.out_size} {x.dtype}->{out_dtype} ({x.device.type})")
    if x.device.type == "cuda":
        y = _resample_axis_cuda(x3, spec, out_dtype)
    else:
        y = _resample_axis_plain(x3, spec, out_dtype)
    return y.reshape(*lead, spec.out_size, *trail)
