"""Windowed crop-and-resize of uint8 batches with per-image boxes: the host
side, plain versions and wrappers of ``csrc/crop_tables.cu`` and
``csrc/crop_resample.cu`` (the port of
``interpolate_antialiasing_tpu.ops.crop_pallas``).

The crop box's *position* is data (a tensor), but its *size* is bounded by
``max_box_frac``, so the 128 consecutive output rows of one tile only ever
read a static ``K`` input rows (:func:`_window_k`).  Per image and tile the
band of weights over that window is built on the device from the boxes
(:func:`_windowed_band`: the PIL algorithm on the box interval, renormalised
over the window, with the one-hot nearest fallback of a sub-pixel box and
zero rows past the output), as the JAX package builds it inside its traced
call, where XLA fuses the chain into the programs that feed its two
kernels.  On a CUDA tensor one launch of the table kernel
(:func:`_windowed_tables_cuda`, ``launches_crop_tables``) computes each
output row's weights in the same float32 steps and writes its compact
taps (:func:`_compact`) directly; a CPU tensor runs the plain build
(:func:`_windowed_tables_plain`), and the two agree bit for bit.  Then two
passes, **H first, then W** (the reverse of ``resize``):

  pass 1 (H):  ``inter[n, c, o, w] = q(sum_k band_h[n, o, k] * x[n, c, s + k, w])``
  pass 2 (W):  ``y[n, c, o, u]     = q(sum_k band_w[n, u, k] * inter[n, c, o, s + k])``

with the intermediate on the uint8 lattice.  Two precisions, as the JAX
package's ``crop_and_resize_windowed``:

  * ``"pil_int8"`` (default): integer weights ``K = round_half_away(band *
    2^pb)`` with ``(pb, ndig)`` from :func:`_digit_plan` on the padded sizes,
    and ``q(S) = (S + 2^(pb-1)) >> pb``.  The TPU kernels split ``K`` into
    int8 digits and re-centre pixels by -128 for its int8 matrix unit; the
    bias and the digit split cancel exactly, so the card's direct int32
    multiply-add gives the same bytes (row 10 of the kernel table);
  * ``"split"``: float32 weights, float32 sums in tap order and ``q(v) =
    floor(v + 0.5)`` clamped (row 11); the TPU's split-bf16 matrix products
    are a matrix-unit precision trick and are not reproduced.

A third variant, :func:`crop_and_resize_f32`, is no port of a TPU kernel:
the dense route's arithmetic (:mod:`.crop`) over each row's nonzero taps,
which ``crop_and_resize`` takes for flipped uint8 calls on the card.  Its
tables are ``"split"``'s float32 weights over one window of the whole axis
(no row renormalises over a truncated window), a per-image flip folded into
the W tables (:func:`_mirror`), and the intermediate stays float32, so the
output is rounded once (``launches_crop_f32`` counts its passes'
launches).

The kernel reads, per output row, its first input index and ``T`` weights
from that index on (:func:`_compact`: each band column's nonzero range,
which is contiguous, padded with zero weights to ``T``, a static bound on
the count of every row of a box no wider than the image: :func:`_tap_bound`),
so it does ``T``, not ``K``, multiply-adds per output.  A box wider than the
image (a zoom-out) can give a row more taps: the tables keep its true count
and its first ``T`` weights, and the kernel computes all its weights again
from its box (the table kernel's own code), as the plain version takes them
from the band (:func:`_crop_pass_plain`).  Each pass is kernel B
(``csrc/resample_axis.cuh``) with one table per image (entry
``csrc/crop_resample.cu``): a block stages its window of input rows and
its weights in shared memory; the window of a tile of outputs starts at
their least first tap, which the block finds on the device, and is as wide
as the static geometry bounds it (:func:`_crop_windows`); the tile is
kernel B's plan over those windows (:func:`_crop_plan`).  A tile that holds
a row past ``T``, or whose taps need more rows (a box wider than
``max_box_frac``), is staged in chunks of its outputs instead: the block
computes each such row's weights once into shared memory and halves a
chunk until its window fits ``win`` rows and its weights the tile's slots;
only a row whose own taps pass them reads device memory.  The plan, its
shared bytes and the launches are the same either way.  A CUDA tensor
launches the kernel (both passes; ``launches_crop`` counts each pass's
launch); a CPU tensor runs the plain version (:func:`_crop_pass_plain`),
which sums the same taps in the same order, so the two agree bit for bit.
Any other device raises.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..config import debug_enabled
from ..utils.trace import builds, span, spanned
from . import cuda_resize as cr
from .filters import (CUBIC_NAMES, box_filter, filter_is_nonnegative, get_filter,
                      hamming_filter, triangle_filter)

__all__ = ["crop_windowed_supported", "crop_and_resize_windowed", "crop_f32_supported",
           "crop_and_resize_f32"]

# Launches of the crop kernel (one per pass): the wrapper adds one per
# launch and nowhere else.
launches_crop = 0
# Launches of the table kernel (one per call on the card, both axes): its
# wrapper adds one per launch and nowhere else.
launches_crop_tables = 0
# Launches of the float32-intermediate passes (one per pass):
# :func:`_launch` adds one per launch of ``ia_crop_pass`` with a float32
# side and nowhere else.
launches_crop_f32 = 0

_LANE = 128  # output rows per window tile, and the W pass's start alignment
_ALIGN_H = 32  # the H pass's start alignment (the TPU's uint8 sublane tile)
_PRECISIONS = ("pil_int8", "split")
# the element dtype codes of ia_crop_pass (ia_dtypes.cuh::DType)
_DTYPES = {torch.uint8: 0, torch.float32: 1}
_SUM_WINDOW = 32  # the window of XLA's CPU tree reductions (:func:`_tree_sum`)
# the table kernel (csrc/crop_tables.cu): its block, its group sizes (lanes
# per output row), the chunks of a group's lanes a row's taps fill in one
# pass, and the widest row it leaves to one thread (:func:`_table_plan`)
_TABLE_THREADS = 128
_TABLE_LANES = (8, 16, 32)
_TABLE_CHUNKS = 4
_TABLE_SERIAL_SPAN = 16
# the filters admission lets onto this route (the non-negative ones) and
# their codes in csrc/crop_tables.cu (ia_taps.cuh's SynthFilter, and box)
_TABLE_FILTERS = {triangle_filter: 0, hamming_filter: 2, box_filter: 4}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Static window geometry (host)
# ---------------------------------------------------------------------------


def _window_k(in_size: int, out_size: int, support: float, antialias: bool,
              max_box_frac: float, start_align: int, k_mult: int) -> int:
    """Static K for one axis: K input pixels cover any 128 consecutive
    output rows of any box spanning <= ``max_box_frac * in_size``, with
    ``(in_size - K) % start_align == 0`` and ``K % k_mult == 0`` so the
    clipped, alignment-floored window starts stay inside the input."""
    scale_max = max_box_frac * in_size / out_size
    widen = max(scale_max, 1.0) if antialias else 1.0
    # centers of one tile span (LANE-1)*scale; taps extend +-(support*widen
    # + 0.5); +2 guards float rounding of the centers at the boundary.
    ext = (_LANE - 1) * scale_max + 2.0 * (support * widen + 0.5) + 2.0
    k = int(np.ceil(ext)) + start_align  # slack lost to start flooring
    k = _round_up(k, k_mult)
    if k >= in_size:
        return in_size  # window covers the whole input; start == 0
    while (in_size - k) % start_align and k < in_size:
        k += k_mult
    return min(k, in_size)


def _fracs(max_box_frac) -> tuple[float, float]:
    """The (scalar or per-axis ``(frac_h, frac_w)``) box-span bound."""
    if isinstance(max_box_frac, (tuple, list)):
        return float(max_box_frac[0]), float(max_box_frac[1])
    return float(max_box_frac), float(max_box_frac)


def _geom(H, W, oh, ow, support, antialias, max_box_frac):
    """``(align_h, Hp, k_h, W2, k_w)``: the H pass's start alignment, the
    row extent rounded up to 8, its window, the column extent rounded up to
    128 and its window — the JAX package's geometry, so that starts and
    windows agree with it."""
    fh, fw = _fracs(max_box_frac)
    Hp = _round_up(H, 8)
    k_h = _window_k(Hp, oh, support, antialias, fh, _ALIGN_H, k_mult=8)
    W2 = _round_up(W, _LANE)
    k_w = _window_k(W2, ow, support, antialias, fw, _LANE, k_mult=_LANE)
    return _ALIGN_H, Hp, k_h, W2, k_w


def _tap_bound(in_size: int, out_size: int, support: float, antialias: bool,
               k: int) -> int:
    """``T``: at least as many taps as any output row's nonzero range holds,
    for every box whose span is at most the image's (a normalised span of
    at most 1, wherever the box lies: the boxes of ``max_box_frac``, and
    the larger ones that renormalise over a truncated window).

    A row's nonzero taps ``p`` satisfy ``|p - c + 0.5| <= support *
    max(scale, 1)`` with ``scale <= in_size / out_size``: at most
    ``floor(2 support widen) + 1`` integers, one more for float32 rounding
    of the positions; the one-hot fallback of a sub-pixel box has one; and
    no row has more than the window's ``k``.  A box wider than the image can
    exceed it: :func:`_compact` keeps such a row's true count, and the crop
    passes serve it whole."""
    scale = in_size / out_size
    widen = max(scale, 1.0) if antialias else 1.0
    return min(k, int(2.0 * support * widen + 1e-3) + 2)


def _digit_plan(in_size, out_size, support, antialias, frac) -> tuple[int, int]:
    """``(pb, ndig)`` for one axis: pb=14 (two int8 digits on the TPU) when
    the worst-case tap count keeps the weight quantisation inside the +-1
    gate, else Pillow's pb=22 (three digits).  The port multiplies the int32
    weights directly, so only ``pb`` changes its arithmetic."""
    scale_max = frac * in_size / out_size
    widen = max(scale_max, 1.0) if antialias else 1.0
    ntaps = 2.0 * support * widen + 2.0
    return (14, 2) if ntaps <= 57 else (22, 3)


# ---------------------------------------------------------------------------
# Per-image bands (device)
# ---------------------------------------------------------------------------


def _tree_sum(w: torch.Tensor) -> torch.Tensor:
    """``w.sum(dim=2, keepdim=True)`` in the order the JAX package's
    ``_windowed_band`` sums on the CPU, one float32 rounding per add, which
    the table kernel repeats.  XLA's CPU compiler rewrites a sum of more
    than 32 elements into a tree: it pads them to a multiple of 32 with
    half of the padding in front, sums each window of 32 in order, and
    repeats on the window sums while there are more than 32; the last (at
    most 32) are summed in order.  Any other order (``torch.sum``'s, or
    plain tap order) moves a column's sum by an ulp now and then, which
    flips an integer weight that lies on a rounding tie."""
    while w.shape[2] > _SUM_WINDOW:
        pad = -w.shape[2] % _SUM_WINDOW
        w = torch.nn.functional.pad(w, (0, 0, pad // 2, pad - pad // 2))
        w = w.reshape(*w.shape[:2], -1, _SUM_WINDOW, w.shape[-1])
        acc = torch.zeros_like(w[:, :, :, 0])
        for i in range(_SUM_WINDOW):
            acc = acc + w[:, :, :, i]
        w = acc
    total = torch.zeros_like(w[:, :, :1])
    for i in range(w.shape[2]):
        total = total + w[:, :, i:i + 1]
    return total


def _windowed_band(lo, hi, in_size: int, out_size: int, k: int, in_limit: int,
                   start_align: int, mode: str, antialias: bool):
    """Per-image windowed weights: ``(starts [N, nt] int32, band [N, nt, k,
    128] float32)`` for boxes ``[lo, hi)`` in pixel units (``[N]`` float32
    tensors).  ``band[n, t, j, u]`` weighs input ``starts[n, t] + j`` for
    output ``t * 128 + u``.  The math of :func:`.crop._axis_matrix` (the PIL
    algorithm on the box interval) on the window only, float32 op for op as
    the JAX package's ``_windowed_band``, each column's sum in its order on
    the CPU (:func:`_tree_sum`), which the table kernel repeats."""
    filt = get_filter(mode)
    dev = lo.device
    nt = -(-out_size // _LANE)
    lo = lo.float()
    hi = hi.float()
    # a tensor divisor: on the card torch multiplies by the reciprocal of a
    # Python scalar divisor, and the table kernel divides
    scale = (hi - lo) / torch.full_like(lo, float(out_size))
    widen = torch.clamp(scale, min=1.0) if antialias else torch.ones_like(scale)
    support = filt.support * widen  # [N]

    o = torch.arange(nt * _LANE, dtype=torch.float32, device=dev).reshape(nt, _LANE)
    center = lo[:, None, None] + scale[:, None, None] * (o + 0.5)  # [N, nt, L]
    # window start per (image, tile): lowest tap of the tile's first row,
    # floored to the alignment, clipped into the (padded) input
    raw = torch.floor(center[:, :, 0] - support[:, None] - 0.5) - 1.0
    hi_start = float((in_limit - k) // start_align * start_align)
    starts = torch.clamp(torch.floor(raw / start_align) * start_align,
                         0.0, hi_start).to(torch.int32)  # [N, nt]

    pos = (starts.float()[:, :, None, None]
           + torch.arange(k, dtype=torch.float32, device=dev)[None, None, :, None])
    c4 = center[:, :, None, :]  # [N, nt, 1, L]
    arg = (pos - c4 + 0.5) / widen[:, None, None, None]
    w = filt(arg, torch)  # [N, nt, k, L]
    live = o[None, :, None, :] <= float(out_size) - 1.0  # dead pad rows
    valid = (
        (torch.abs(pos - c4 + 0.5) <= support[:, None, None, None])
        & (pos + 0.5 >= lo[:, None, None, None])
        & (pos + 0.5 <= hi[:, None, None, None])
        & (pos <= float(in_size) - 1.0)
        & live
    )
    w = torch.where(valid, w, 0.0)
    total = _tree_sum(w)
    # degenerate sub-pixel boxes: nearest-pixel fallback
    nearest = torch.clamp(torch.round(c4 - 0.5), 0.0, float(in_size - 1))
    onehot = ((pos == nearest) & live).to(w.dtype)
    band = torch.where(total > 0.0, w / torch.where(total == 0.0, 1.0, total), onehot)
    return starts, band


def _digitize_band(band: torch.Tensor, pb: int) -> torch.Tensor:
    """``K = round_half_away(band * 2^pb)`` as int32 (the JAX package's
    ``_digitize_band`` before its split into int8 digits)."""
    scaled = band * float(1 << pb)
    return torch.where(scaled < 0, scaled - 0.5, scaled + 0.5).to(torch.int32)


class _Rows(NamedTuple):
    """What one pass's rows need beside their tables, to compute the
    weights of a row past the tap bound again: the boxes ``[N, 4]``
    (float32, on the tables' device), the axis (0: H from box columns 0 and
    2, 1: W from 1 and 3), its geometry, the filter, and the images whose
    rows the pass mirrors (``flip [N]`` bool, or None; :func:`_mirror`)."""

    boxes: torch.Tensor
    axis: int
    ax: _Axis
    mode: str
    antialias: bool
    flip: torch.Tensor | None = None


class _Table(NamedTuple):
    """One pass's compact per-image tables (:func:`_compact`), the ``(tile_o,
    win)`` windows the kernel may stage for them (:func:`_crop_windows`)
    and the source of their rows (:class:`_Rows`: what a row with more taps
    than ``T`` is computed from; the kernel needs it)."""

    first: torch.Tensor  # [N, out] int32
    cnt: torch.Tensor  # [N, out] int32, each row's true count (may pass T)
    w: torch.Tensor  # [N, out, T] int32 or float32
    wins: tuple
    rows: _Rows


def _mirror(t: torch.Tensor, flip: torch.Tensor | None) -> torch.Tensor:
    """Per-row tables ``[N, out, ...]`` with the rows of the images ``flip``
    marks in reverse order: output ``o`` of such an image takes row ``out -
    1 - o``'s values (a horizontal flip folded into the W tables, as
    :func:`.crop._axis_matrix` folds it into its matrices)."""
    if flip is None:
        return t
    return torch.where(flip.view(-1, *(1,) * (t.ndim - 1)), t.flip(1), t)


def _compact(starts: torch.Tensor, band: torch.Tensor, out_size: int, T: int):
    """Per output row: ``(first [N, out] int32, cnt [N, out] int32, w [N,
    out, T])``.  Row ``u`` reads inputs ``first + j`` for ``j < cnt`` with
    weight ``w[.., j]`` (zero for ``cnt <= j < T``): its band column from
    the first to the last nonzero weight, padded to ``T`` (the first ``T``
    columns of the band column's range).  Taps outside that range carry
    zero weight, so skipping them changes no sum.  ``cnt`` is the row's
    true count: a box wider than the image can give a row more than ``T``
    taps (:func:`_tap_bound`), of which ``w`` holds the first ``T``; the
    band holds them all (:func:`_crop_pass_plain`)."""
    N, nt, k, L = band.shape
    rows = band.permute(0, 1, 3, 2).reshape(N, nt * L, k)[:, :out_size]
    nz = rows != 0
    any_nz = nz.any(dim=2)
    ar = torch.arange(T, device=band.device)
    j0 = torch.where(any_nz, nz.int().argmax(dim=2), 0)
    j1 = torch.where(any_nz, k - nz.flip(2).int().argmax(dim=2), 0)
    cnt = (j1 - j0).to(torch.int32)
    idx = (j0[..., None] + ar).clamp_(max=k - 1)
    w = torch.where(ar < cnt[..., None], rows.gather(2, idx), 0)
    tile_start = starts.repeat_interleave(L, dim=1)[:, :out_size]
    first = (tile_start + j0).to(torch.int32)
    return first.contiguous(), cnt.contiguous(), w.contiguous()


# ---------------------------------------------------------------------------
# Plain version and kernel wrapper
# ---------------------------------------------------------------------------


def _store_u8(acc: torch.Tensor, pb: int | None) -> torch.Tensor:
    """uint8 lattice: ``(S + 2^(pb-1)) >> pb`` for integer sums, ``floor(v +
    0.5)`` for float sums, clamped to [0, 255] (a no-op where admission's
    clip-free bound holds)."""
    if pb is not None:
        v = (acc + (1 << (pb - 1))) >> pb
    else:
        v = torch.floor(acc + 0.5)
    return v.clamp_(0, 255).to(torch.uint8)


def _crop_pass_plain(x4: torch.Tensor, tab, pb: int | None,
                     out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """One pass's plain version: ``x4[N, R, n_in, inner]`` (uint8, or the
    float32 intermediate) -> ``[N, R, n_out, inner]`` uint8, or the float32
    sums unrounded for ``out_dtype`` float32, with per-image row tables
    (:class:`_Table`); each row's ``cnt`` taps summed in order from ``j =
    0``, each product and sum rounded (float) or exact (int32).  A row with
    more taps than the tables hold (a box wider than the image) takes all
    its weights from the band of its box (:func:`_row_weights`), the bits
    the kernel computes again from the box."""
    first, cnt, w = tab.first, tab.cnt, tab.w
    N, R, n_in, inner = x4.shape
    n_out = first.shape[1]
    adt = torch.int32 if pb is not None else torch.float32
    acc = torch.zeros((N, R, n_out, inner), dtype=adt, device=x4.device)
    taps = int(cnt.max()) if cnt.numel() else 0
    T = w.shape[-1]
    if taps > T:
        wide = (cnt > T)[..., None]
        w = torch.where(wide, _row_weights(tab.rows, taps),
                        torch.nn.functional.pad(w, (0, taps - T)))
    for j in range(taps):
        idx = (first + j).clamp(max=n_in - 1).long()
        xv = x4.gather(2, idx[:, None, :, None].expand(N, R, n_out, inner))
        acc = acc + w[:, None, :, j, None] * xv.to(adt)
    return acc if out_dtype == torch.float32 else _store_u8(acc, pb)


def _check_int32(name: str, k: int, pb: int | None) -> None:
    """The int32 accumulator's bound, on the host before a launch: rows of
    non-negative renormalised weights (sums within 2^-20 of 1 in float32)
    sum to at most ``2^pb (1 + 2^-20) + k/2`` after rounding (at most the
    window's ``k`` nonzero taps, the most any row of any box counts), so a
    row's sum stays below 255 times that, plus ``2^(pb-1)``."""
    if pb is None:
        return
    worst = 255 * ((1 << pb) + (1 << pb >> 20) + k // 2 + 1) + (1 << (pb - 1))
    if worst >= 1 << 31:
        raise ValueError(f"crop {name} pass: {k} taps at pb={pb} can "
                         f"overflow the int32 accumulator ({worst} >= 2^31)")


def _crop_windows(n_in: int, n_out: int, T: int, frac: float, support: float,
                  antialias: bool) -> tuple[tuple[int, int], ...]:
    """``(tile_o, win)``: the output tiles a crop pass may take and each
    one's staged window, from the static geometry (the boxes are device
    data).  The nonzero taps of output ``o`` lie within ``support *
    max(scale, 1)`` of its centre, and the centres of ``tile_o``
    consecutive outputs span ``(tile_o - 1) * scale``, ``scale <= frac *
    n_in / n_out`` for a box within the bound; the window holds that span,
    both supports, the ``T`` taps from the last first tap and two rows of
    float32 rounding, clamped to the axis.  The window starts at the
    tile's least first tap, which the kernel's block finds on the device.
    A box wider than the bound (it renormalises over its truncated window)
    may need more rows, and a box wider than the image more than ``T``
    taps a row: the block then stages the tile in chunks of its outputs,
    each chunk's window within ``win`` rows and its weights within the
    tile's ``tile_o * (T - 1)`` slots (``resample_axis.cuh::
    crop_tile_chunked``).  Tiles of every ``cuda_resize._AXIS_TILE_O``
    size, and one of every output."""
    scale = frac * n_in / n_out
    sup = support * (max(scale, 1.0) if antialias else 1.0)
    tiles = [t for t in cr._AXIS_TILE_O if t < n_out] + [n_out]
    return tuple((t, min(n_in, math.ceil((t - 1) * scale + 2.0 * sup) + T + 2))
                 for t in tiles)


@lru_cache(maxsize=256)
@builds
def _crop_plan(wins: tuple, n_in: int, n_out: int, T: int, N: int, R: int, inner: int,
               n_sm: int, vec4: bool, itemsize: int) -> cr.PlanAxis | None:
    """A crop pass's plan over ``x[N, R, n_in, inner]`` of ``itemsize``-byte
    elements (uint8, or the float32 intermediate): kernel B's
    (``cuda_resize._axis_tiles``, its model of a launch) over the windows
    ``wins`` (:func:`_crop_windows`), tiles along ``N * R`` cut at each
    image's ``R`` planes; None (kernel B's unstaged body) for a pass that
    moves at most ``cuda_resize._AXIS_UNSTAGED_BYTES`` or where no tile
    fits, as kernel B's plan decides."""
    outer = N * R
    if outer * inner * (n_in + n_out) * itemsize <= cr._AXIS_UNSTAGED_BYTES:
        return None
    best = max(cr._axis_tiles(wins, n_out, T, n_in, outer, inner, itemsize, n_sm, vec4,
                              per_img=R),
               default=None)
    return None if best is None else best[1]


def _launch(lib, x, out, tab: _Table, N, R, n_in, inner, n_out, pb, dev):
    """One crop pass of ``ia_crop_pass``: uint8 -> uint8 (``launches_crop``),
    or a float32-intermediate pass, where either side is float32
    (``launches_crop_f32``)."""
    global launches_crop, launches_crop_f32
    T = tab.w.shape[-1]
    f32 = torch.float32 in (x.dtype, out.dtype)
    plan = _crop_plan(tab.wins, n_in, n_out, T, N, R, inner, cr._n_sm(dev),
                      x.data_ptr() % 4 == 0, x.element_size())
    rows, ax = tab.rows, tab.rows.ax
    filt = get_filter(rows.mode)
    name = "crop_f32" if f32 else "crop_resample"
    with span("ia.native.crop_f32") if f32 else span("ia.native.crop_resample"):
        err = lib.ia_crop_pass(
            x.data_ptr(), out.data_ptr(), _DTYPES[x.dtype], _DTYPES[out.dtype], N, R, n_in,
            inner, n_out, tab.first.data_ptr(), tab.w.data_ptr(), T, -1 if pb is None else pb,
            tab.cnt.data_ptr(), rows.boxes.data_ptr(), rows.axis, _TABLE_FILTERS[filt.fn],
            filt.support, int(rows.antialias), ax.k, ax.align, _hi_start(ax),
            None if rows.flip is None else rows.flip.data_ptr(),
            *((0, 0, 0, 0, 1, 0) if plan is None else plan[:6]),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {err}")
        if f32:
            launches_crop_f32 += 1
        else:
            launches_crop += 1


def _crop_resample_plain(x: torch.Tensor, tab_h, tab_w, pb_h, pb_w,
                         inter_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """The kernel's plain version, on any device: both passes of
    :func:`_crop_pass_plain`, the intermediate on the uint8 lattice or in
    float32 (``inter_dtype``)."""
    N, C, H, W = x.shape
    OH, OW = tab_h.first.shape[1], tab_w.first.shape[1]
    inter = _crop_pass_plain(x, tab_h, pb_h, inter_dtype)
    y = _crop_pass_plain(inter.reshape(N, C * OH, W, 1), tab_w, pb_w)
    return y.reshape(N, C, OH, OW)


def _crop_resample_cuda(x: torch.Tensor, tab_h, tab_w, pb_h, pb_w,
                        inter_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    from .. import native

    N, C, H, W = x.shape
    OH, OW = tab_h.first.shape[1], tab_w.first.shape[1]
    _check_int32("H", tab_h.rows.ax.k, pb_h)
    _check_int32("W", tab_w.rows.ax.k, pb_w)
    lib = native.build()
    dev = x.device
    x = x.contiguous()
    inter = torch.empty((N, C, OH, W), dtype=inter_dtype, device=dev)
    out = torch.empty((N, C, OH, OW), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        _launch(lib, x, inter, tab_h, N, C, H, W, OH, pb_h, dev)
        _launch(lib, inter, out, tab_w, N, C * OH, W, 1, OW, pb_w, dev)
    return out


def _crop_resample(x: torch.Tensor, tab_h, tab_w, pb_h, pb_w,
                   inter_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Both passes: uint8 ``x[N, C, H, W]`` -> uint8 ``[N, C, OH, OW]`` over
    the compact row tables ``tab_*`` (:class:`_Table`: float32 ``w`` and
    ``pb None``, or int32 ``w`` and ``pb``), through an intermediate on the
    uint8 lattice or, with float32 tables, in float32 (``inter_dtype``):
    the kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return _crop_resample_cuda(x, tab_h, tab_w, pb_h, pb_w, inter_dtype)
    if x.device.type == "cpu":
        return _crop_resample_plain(x, tab_h, tab_w, pb_h, pb_w, inter_dtype)
    raise ValueError(f"crop_resample runs on CUDA (kernel) or CPU (plain "
                     f"version), not on {x.device}")


# ---------------------------------------------------------------------------
# Admission + entry
# ---------------------------------------------------------------------------


def _mode(method: str, antialias: bool) -> str:
    if not antialias and get_filter(method).name in CUBIC_NAMES:
        return "bicubic075"
    return method


def crop_windowed_supported(x, out_hw, method: str, antialias: bool,
                            max_box_frac=1.0) -> bool:
    """Admission for the windowed route: uint8 NCHW, a non-negative filter
    (the uint8 intermediate and the clip-free integer epilogue are exact to
    the +-1 gate only there, and integer outputs need no autodiff), and a
    box-span bound in ``(0, 1]``.

    The JAX package also turns the route down when windowing saves less
    than 30% of the dense route's multiply-adds, and when its bands and
    blocks overflow a VMEM budget; both were measured for or sized by the
    TPU and are dropped.  No window is too large for the kernel: where no
    tile's window fits a block's shared memory, kernel B's unstaged body
    reads the taps through the caches (:func:`_crop_plan`);
    :func:`_check_int32` bounds the accumulator before a launch."""
    if x.ndim != 4 or x.dtype != torch.uint8:
        return False
    fh, fw = _fracs(max_box_frac)
    if not (0.0 < fh <= 1.0 and 0.0 < fw <= 1.0):
        return False
    return filter_is_nonnegative(_mode(method, antialias))


def crop_f32_supported(x, method: str, antialias: bool) -> bool:
    """Admission for the float32-intermediate route
    (:func:`crop_and_resize_f32`): uint8 NCHW, antialiased, with a filter
    the table kernel evaluates (triangle, Hamming, box: the non-negative
    ones).  The box-span bound plays no part: its windows cover the whole
    axis."""
    return (x.ndim == 4 and x.dtype == torch.uint8 and antialias
            and get_filter(_mode(method, antialias)).fn in _TABLE_FILTERS)


@spanned("ia.ops.crop_f32")
def crop_and_resize_f32(x: torch.Tensor, boxes: torch.Tensor, out_hw: tuple[int, int],
                        method: str = "bilinear",
                        flip: torch.Tensor | None = None) -> torch.Tensor:
    """The dense route's arithmetic over each row's nonzero taps: uint8
    ``[N, C, H, W]``, boxes ``[N, 4]`` (normalised ``(y0, x0, y1, x1)``)
    and an optional per-image horizontal flip ``[N]`` bool -> uint8 ``[N,
    C, OH, OW]``.  Float32 weights (the table kernel's, over one window of
    the whole axis, so no row is renormalised over a truncated window; the
    flip folded into the W tables, :func:`_mirror`), float32 products and
    sums in tap order, a float32 intermediate, and one rounding,
    ``floor(v + 0.5)`` clamped, always antialiased: on a CUDA tensor the
    table kernel and two float32-intermediate launches of ``ia_crop_pass``
    (``launches_crop_f32``), on a CPU tensor their plain versions, bit for
    bit the same.  Callers route through :func:`crop_f32_supported`."""
    if debug_enabled():
        print(f"[ia-tpu] crop_resample f32 ({x.device.type})")
    return _crop_resample(x, *_f32_tables(x, boxes, out_hw, method, flip),
                          torch.float32)


@spanned("ia.ops.crop_windowed")
def crop_and_resize_windowed(
    x: torch.Tensor,
    boxes: torch.Tensor,
    out_hw: tuple[int, int],
    method: str = "bilinear",
    antialias: bool = True,
    max_box_frac=1.0,
    precision: str = "pil_int8",
) -> torch.Tensor:
    """Windowed crop+resize: uint8 ``[N, C, H, W]`` and boxes ``[N, 4]``
    (normalised ``(y0, x0, y1, x1)``) -> uint8 ``[N, C, OH, OW]``; the JAX
    package's ``crop_and_resize_windowed``, on every device.

    ``max_box_frac`` bounds the box span per axis (1.0 = the whole image);
    a box larger than the bound renormalises over the truncated window, as
    there.  ``precision`` is ``"pil_int8"`` (fixed-point weights, the
    default) or ``"split"`` (float32 weights); see the module note.
    Callers route through :func:`crop_windowed_supported`.
    """
    if debug_enabled():
        print(f"[ia-tpu] crop_resample {precision} ({x.device.type})")
    return _crop_resample(x, *_windowed_tables(x, boxes, out_hw, method, antialias,
                                               max_box_frac, precision))


class _Axis(NamedTuple):
    """One pass's static table geometry (host): the axis, its window ``k``
    and alignment over the padded extent ``in_limit``, the tap bound ``T``,
    ``pb`` (None: float weights) and the widest tap range of a row of a
    box within the bound (:func:`_tap_span`; 0: ``k``)."""

    in_size: int
    out_size: int
    k: int
    in_limit: int
    align: int
    T: int
    pb: int | None
    span: int = 0


def _tap_span(in_size: int, out_size: int, support: float, antialias: bool, frac: float,
              k: int) -> int:
    """The widest tap range a row of a box within the bound can have: the
    table kernel walks row o's taps from ``floor(c - sup) - 2`` to ``ceil(c
    + sup) + 3`` (``c`` its centre less 0.5, ``sup`` the widened support;
    ``csrc/crop_row.cuh::row_range``), at most ``ceil(2 sup) + 6`` of them,
    and at most ``k``."""
    scale = frac * in_size / out_size
    sup = support * (max(scale, 1.0) if antialias else 1.0)
    return min(k, math.ceil(2.0 * sup) + 6)


@lru_cache(maxsize=256)
@builds
def _table_plan(axes: tuple, N: int, n_sm: int) -> tuple[int, ...]:
    """``G`` per axis, the table kernel's lanes per output row.  One thread
    per row (1 on both axes) where that grid puts a block on every SM and
    no axis's widest row (:func:`_tap_span`) passes
    ``_TABLE_SERIAL_SPAN`` taps: the train batch's tables, whose rows fill
    the card one thread each (inside the crop call, after its large
    passes, the group kernel takes some 4 microseconds more than alone on
    an H100, and one thread per row does not).  Else per axis the least of
    :data:`_TABLE_LANES` whose ``_TABLE_CHUNKS`` chunks hold the axis's
    widest row (a longer row, from a box past the bound, takes several
    passes).  Every plan gives the same tables."""
    spans = [ax.span or ax.k for ax in axes]
    if (sum(_table_blocks(N, axes, (1,) * len(axes))) >= n_sm
            and max(spans) <= _TABLE_SERIAL_SPAN):
        return (1,) * len(axes)
    return tuple(next((g for g in _TABLE_LANES if span <= _TABLE_CHUNKS * g), _TABLE_LANES[-1])
                 for span in spans)


@lru_cache(maxsize=256)
@builds
def _table_blocks(N: int, axes: tuple, plan: tuple) -> tuple[int, ...]:
    """The table kernel's blocks per axis under ``plan`` (:func:`_table_plan`):
    a block's ``_TABLE_THREADS / G`` groups (threads, for G = 1) take a row
    each (row = image * out_size + output row), the W axis's blocks after
    the H axis's."""
    return tuple(-(-N * ax.out_size // (_TABLE_THREADS // G)) for ax, G in zip(axes, plan))


@lru_cache(maxsize=256)
@builds
def _table_geometry(H: int, W: int, oh: int, ow: int, mode: str, antialias: bool,
                    fracs: tuple[float, float], precision: str):
    """The static host side of a call's tables, from the shapes alone:
    ``((_Axis, windows) for H, (_Axis, windows) for W)``, the windows those
    :func:`_crop_windows` gives the crop passes.  ``precision`` ``"f32"``
    (the float32-intermediate route) takes float32 weights over one window
    of the whole padded axis (start 0), so that no box, however wide,
    renormalises over a truncated window."""
    support = get_filter(mode).support
    align_h, Hp, k_h, W2, k_w = _geom(H, W, oh, ow, support, antialias, fracs)
    if precision == "f32":
        k_h, k_w = Hp, W2
    fh, fw = fracs
    pb_h = pb_w = None
    if precision == "pil_int8":
        pb_h, _ = _digit_plan(Hp, oh, support, antialias, fh)
        pb_w, _ = _digit_plan(W2, ow, support, antialias, fw)
    T_h = _tap_bound(H, oh, support, antialias, k_h)
    T_w = _tap_bound(W, ow, support, antialias, k_w)
    # The TPU clips pass 2's starts into its pass-1 intermediate, whose width
    # (a multiple of its VMEM-sized column chunk) may exceed W2.  Clipping
    # into W2 gives the same taps: a start clipped to W2 - k_w (a multiple of
    # 128) belongs to a tile whose taps all lie in [W2 - k_w, W), inside
    # either window.
    return ((_Axis(H, oh, k_h, Hp, align_h, T_h, pb_h,
                   _tap_span(H, oh, support, antialias, fh, k_h)),
             _crop_windows(H, oh, T_h, fh, support, antialias)),
            (_Axis(W, ow, k_w, W2, _LANE, T_w, pb_w,
                   _tap_span(W, ow, support, antialias, fw, k_w)),
             _crop_windows(W, ow, T_w, fw, support, antialias)))


@spanned("ia.tables.crop_windowed")
def _windowed_tables(x, boxes, out_hw, method, antialias, max_box_frac,
                     precision):
    """``(tab_h, tab_w, pb_h, pb_w)`` for :func:`_crop_resample`: the
    per-image tables on ``x``'s device, compacted per output row to the
    static tap bound (:class:`_Table`, with each row's true count and the
    boxes its weights come from): the table kernel on a CUDA tensor
    (:func:`_windowed_tables_cuda`), the plain build on a CPU tensor
    (:func:`_windowed_tables_plain`); both give the same bits."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    return _tables(x, boxes, out_hw, method, antialias, _fracs(max_box_frac), precision)


@spanned("ia.tables.crop_f32")
def _f32_tables(x, boxes, out_hw, method, flip):
    """:func:`_windowed_tables` for the float32-intermediate route,
    antialiased: float32 weights over windows of the whole axis
    (``precision`` ``"f32"``), their
    crop windows at the whole-image bound, the W tables mirrored where
    ``flip`` (``[N]`` bool, or None) is set."""
    if flip is not None:
        if tuple(flip.shape) != (x.shape[0],):
            raise ValueError(f"flip must be [N] bools, got {tuple(flip.shape)}")
        flip = flip.to(device=x.device, dtype=torch.bool).contiguous()
    return _tables(x, boxes, out_hw, method, True, (1.0, 1.0), "f32", flip)


def _tables(x, boxes, out_hw, method, antialias, fracs, precision, flip=None):
    """Both routes' table build, unspanned: the geometry of ``precision``
    at the box-span bound ``fracs``, the W tables mirrored where ``flip``
    is set."""
    N, C, H, W = x.shape
    if tuple(boxes.shape) != (N, 4):
        raise ValueError(f"boxes must be [N, 4] = [{N}, 4], got {tuple(boxes.shape)}")
    mode = _mode(method, antialias)
    (ax_h, wins_h), (ax_w, wins_w) = _table_geometry(
        H, W, int(out_hw[0]), int(out_hw[1]), mode, antialias, fracs, precision)
    # dense [N, 4]: the table kernel and both crop passes index the boxes so
    b = boxes.to(device=x.device, dtype=torch.float32).contiguous()
    if x.device.type == "cuda":
        tab_h, tab_w = _windowed_tables_cuda(b, mode, antialias, (ax_h, ax_w), flip)
    elif x.device.type == "cpu":
        tab_h, tab_w = _windowed_tables_plain(b, mode, antialias, (ax_h, ax_w), flip)
    else:
        raise ValueError(f"crop_tables runs on CUDA (kernel) or CPU (plain "
                         f"version), not on {x.device}")
    return (_Table(*tab_h, wins_h, _Rows(b, 0, ax_h, mode, antialias)),
            _Table(*tab_w, wins_w, _Rows(b, 1, ax_w, mode, antialias, flip)), ax_h.pb, ax_w.pb)


def _hi_start(ax: _Axis) -> int:
    """The largest window start of an axis."""
    return (ax.in_limit - ax.k) // ax.align * ax.align


def _axis_band(rows: _Rows):
    """``(starts, band)`` of one pass: :func:`_windowed_band` of its boxes,
    :func:`_digitize_band` where ``pb`` is set."""
    b, a, ax = rows.boxes, rows.axis, rows.ax
    starts, band = _windowed_band(b[:, a] * ax.in_size, b[:, a + 2] * ax.in_size, ax.in_size,
                                  ax.out_size, ax.k, ax.in_limit, ax.align, rows.mode,
                                  rows.antialias)
    if ax.pb is not None:
        band = _digitize_band(band, ax.pb)
    return starts, band


def _row_weights(rows: _Rows, width: int) -> torch.Tensor:
    """Every row's compact weights ``[N, out, width]`` (:func:`_compact` of
    the band of its box, mirrored as the pass mirrors it): all taps of a
    row past the tap bound, for ``width`` at least its count."""
    starts, band = _axis_band(rows)
    return _mirror(_compact(starts, band, rows.ax.out_size, width)[2], rows.flip)


def _windowed_tables_plain(b: torch.Tensor, mode: str, antialias: bool, axes, flip=None):
    """The table kernel's plain version, on any device: per axis (H from
    box columns 0 and 2, W from 1 and 3) :func:`_windowed_band`,
    :func:`_digitize_band` where ``pb`` is set, then :func:`_compact`, the
    W tables mirrored where ``flip`` is set (:func:`_mirror`); ``[(first,
    cnt, w)] * 2``."""
    return [tuple(_mirror(t, flip if a == 1 else None) for t in
                  _compact(*_axis_band(_Rows(b, a, ax, mode, antialias)), ax.out_size, ax.T))
            for a, ax in enumerate(axes)]


def _windowed_tables_cuda(b: torch.Tensor, mode: str, antialias: bool, axes, flip=None):
    """Both axes' tables in one launch of ``csrc/crop_tables.cu`` (the plain
    version's arithmetic, each row's compact taps written directly by one
    thread or a group of lanes (:func:`_table_plan`); a row past ``T``
    keeps its true count and its first ``T`` weights; the W rows of the
    images ``flip`` marks written mirrored)."""
    global launches_crop_tables
    from .. import native

    filt = get_filter(mode)
    if filt.fn not in _TABLE_FILTERS:
        raise ValueError(f"crop_tables: no device filter for {mode!r}")
    lib = native.build()
    N, dev = b.shape[0], b.device
    tabs, args = [], []
    axes = tuple(axes)
    plan = _table_plan(axes, N, cr._n_sm(dev))
    for ax, G, blocks in zip(axes, plan, _table_blocks(N, axes, plan)):
        first = torch.empty((N, ax.out_size), dtype=torch.int32, device=dev)
        cnt = torch.empty((N, ax.out_size), dtype=torch.int32, device=dev)
        w = torch.empty((N, ax.out_size, ax.T), device=dev,
                        dtype=torch.float32 if ax.pb is None else torch.int32)
        tabs.append((first, cnt, w))
        args += [ax.in_size, ax.out_size, ax.k, ax.align, _hi_start(ax), ax.T,
                 -1 if ax.pb is None else ax.pb, G, blocks, first.data_ptr(),
                 cnt.data_ptr(), w.data_ptr()]
    if N * max(ax.out_size for ax in axes) == 0:
        return tabs
    with torch.cuda.device(dev), span("ia.native.crop_tables"):
        err = lib.ia_crop_tables(b.data_ptr(), N, _TABLE_FILTERS[filt.fn], filt.support,
                                 int(antialias), *args,
                                 None if flip is None else flip.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"crop_tables launch failed: cudaError {err}")
        launches_crop_tables += 1
    return tabs
