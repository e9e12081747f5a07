"""Plain-PyTorch resize passes (the port of
``interpolate_antialiasing_tpu.ops.resize_xla``).

These are the JAX package's non-kernel routes — ``backend='dense'``,
``'gather'``, ``'banded'`` and ``'xla'``, and float64, which it runs on XLA
on its accelerator too — and they stay plain PyTorch on every device.  Three
formulations of the 1-D banded contraction ``y = W @ x``:

  * ``resize_axis_dense`` — the full ``W[out, in]`` (float64 tables cast to
    the compute dtype once) in one matrix product; the parity oracle.
  * ``resize_axis_gather`` — gather the ``ntaps`` source pixels of each
    output and reduce with the compact weight table (:func:`gather_reduce`,
    which is also the resample kernels' plain version).
  * ``resize_axis_banded`` — the tile-compacted band, one ``[.., k_in] @
    [k_in, tile]`` product per tile of outputs.

Every matrix product runs inside :func:`..config.full_f32`: on the card TF32
stays off, matching the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..config import full_f32
from .weights import AxisSpec, Tables, as_tables, banded_tiles, dense_matrix, tables_matrix

__all__ = [
    "resize_axis_dense",
    "resize_axis_gather",
    "resize_axis_banded",
    "gather_reduce",
    "gather_reduce_weights",
]


def _table_dtype_for(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _compute_dtype_for(x: torch.Tensor) -> torch.dtype:
    return x.dtype if x.is_floating_point() else torch.float32


def _check_axis(x: torch.Tensor, spec: AxisSpec, axis: int) -> None:
    if x.shape[axis] != spec.in_size:
        raise ValueError(f"axis {axis} has size {x.shape[axis]} != {spec.in_size}")


@lru_cache(maxsize=256)
def _dense_on(spec: AxisSpec | Tables, dtype: torch.dtype, device: torch.device):
    """The pass's dense ``[out, in]`` matrix on ``device``: a spec's
    :func:`..weights.dense_matrix`, or the matrix of a pass's tables."""
    M = (tables_matrix(spec).astype(_table_dtype_for(dtype))
         if isinstance(spec, Tables) else dense_matrix(spec, dtype=_table_dtype_for(dtype)))
    return torch.from_numpy(M).to(device=device, dtype=dtype)


def resize_axis_dense(x: torch.Tensor, spec: AxisSpec, axis: int) -> torch.Tensor:
    """Contract ``axis`` of ``x`` with the dense banded matrix ``W[out, in]``."""
    _check_axis(x, spec, axis)
    cdtype = _compute_dtype_for(x)
    W = _dense_on(spec, cdtype, x.device)
    xm = x.to(cdtype).movedim(axis, -1)
    with full_f32():
        y = torch.matmul(xm, W.T)
    return y.movedim(-1, axis)


@lru_cache(maxsize=256)
def _gather_on(t: AxisSpec | Tables, dtype: torch.dtype, device: torch.device):
    # Tables are always built in float64 (Pillow evaluates filters in double)
    # and cast once — float32 table construction can flip xmin boundaries.
    tb = as_tables(t)
    return (torch.from_numpy(tb.xmin.astype(np.int64)).to(device),
            torch.from_numpy(tb.w.copy()).to(device=device, dtype=dtype))


def gather_reduce(x: torch.Tensor, spec: AxisSpec | Tables, axis: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``sum_k w[o, k] * x[.., clamp(xmin[o] + k, 0, in - 1), ..]`` along
    ``axis``, in ``dtype``: taps in order from ``k = 0``, each product and
    each sum rounded to ``dtype`` (no fused multiply-add).  Out-of-range taps
    carry zero weight, so the clamp never adds signal.  ``spec`` is a
    forward pass or the :class:`..weights.Tables` of any pass (an adjoint's).

    This is the order and rounding of the resample kernels, so with
    ``dtype=float32`` it is their plain version bit for bit."""
    xmin, w = _gather_on(spec, dtype, x.device)
    return gather_reduce_weights(x, xmin, w, axis, dtype)


def gather_reduce_weights(x: torch.Tensor, xmin: torch.Tensor, w: torch.Tensor,
                          axis: int, dtype: torch.dtype) -> torch.Tensor:
    """:func:`gather_reduce` over given weights: ``xmin[out]`` int64 (any
    integers; each tap's index is clamped to the axis) and ``w[out, ntaps]``
    in ``dtype``, on ``x``'s device.  The in-kernel synthesis route's plain
    version (:mod:`.cuda_resize`) hands it the weights it builds."""
    axis %= x.ndim
    in_size, out_size = x.shape[axis], w.shape[0]
    shape = list(x.shape)
    shape[axis] = out_size
    acc = torch.zeros(shape, dtype=dtype, device=x.device)
    w_shape = (out_size,) + (1,) * (x.ndim - axis - 1)
    with full_f32():
        for k in range(w.shape[1]):
            idx = (xmin + k).clamp_(0, in_size - 1)
            acc += x.index_select(axis, idx).to(dtype) * w[:, k].reshape(w_shape)
    return acc


def resize_axis_gather(x: torch.Tensor, spec: AxisSpec, axis: int) -> torch.Tensor:
    """Compact gather-reduce along ``axis``: no wasted multiplies.  bfloat16
    sums in float32 and rounds once at the end."""
    _check_axis(x, spec, axis)
    cdtype = _compute_dtype_for(x)
    acc = torch.float64 if cdtype == torch.float64 else torch.float32
    return gather_reduce(x.to(cdtype), spec, axis, acc).to(cdtype)


def resize_axis_banded(
    x: torch.Tensor, spec: AxisSpec, axis: int, tile: int = 128
) -> torch.Tensor:
    """Tiled banded products: for each tile of ``tile`` output pixels, slice
    the static-width input window and contract ``[.., k_in] @ [k_in, tile]``
    (the JAX package's Pallas tiling, as plain tensor code)."""
    _check_axis(x, spec, axis)
    cdtype = _compute_dtype_for(x)
    align = 8
    bt = banded_tiles(spec, tile=tile, dtype=_table_dtype_for(cdtype), align=align)
    xm = x.to(cdtype).movedim(axis, -1)  # [..., in]
    # Window starts may reach round_up(in, align) - k_in, so pad to the
    # aligned input length.
    in_cap = -(-spec.in_size // align) * align
    pad_in = max(in_cap, bt.k_in) - spec.in_size
    if pad_in:
        xm = F.pad(xm, (0, pad_in))
    band = torch.from_numpy(bt.band).to(device=x.device, dtype=cdtype)
    with full_f32():
        outs = [xm.narrow(-1, int(s), bt.k_in) @ band[t]
                for t, s in enumerate(bt.starts)]
    y = torch.cat(outs, dim=-1)[..., : spec.out_size]
    return y.movedim(-1, axis)
