"""Hand-written CUDA kernels of the float resize route (the port of
``interpolate_antialiasing_tpu.ops.pallas_resize``).

Two kernels, each with its wrapper, its plain PyTorch version, its host plan
and its launch count:

  * **resample2d** (``csrc/resample2d.cu``): both separable passes of the
    trailing ``[H, W]`` plane in one launch, W pass into shared memory, then
    H pass.  Replaces ``_kernel_2pass`` (``resize2d_onekernel``) and serves
    the shapes of ``_kernel_2pass_streamed`` (``resize2d_streamed``).
    Wrapper :func:`resize2d`; plain version :func:`_resample2d_plain`; host
    plan :func:`_plan_rows` (tiles sized for the batch and the card's SM
    count); count ``launches_2d``.
  * **resample_axis** (``csrc/resample_axis.cuh``, entry
    ``csrc/resample_axis.cu``): one pass over any axis of any rank.
    Replaces ``_kernel_last`` / ``_kernel_mid`` (``resize_axis_pallas``) and
    serves the per-axis passes of ``_kernel_last_unrolled`` /
    ``_kernel_mid_unrolled`` (``resize2d_pallas``).  Wrapper
    :func:`resize_axis`; plain version :func:`_resample_axis_plain`; host
    plan :func:`_plan_axis` (tiles per axis kind, sized for the shape and
    the card's SM count; ``ops/pil_exact.py`` plans the Pillow twin of the
    kernel with it too); count ``launches_axis``.

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
branch of the unrolled kernels.  Counts ``launches_axis_fused`` and
``launches_2d_fused``; plain versions :func:`_resample_axis_fused_plain`
and :func:`_resample2d_fused_plain`, over the weights
:func:`_synth_tables` builds with the kernel's float32 operations in the
kernel's order.  The JAX package's gate applies: box, nearest, area and any
border but ``renorm`` run the tables (each pass gated on its own spec).

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
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..config import debug_enabled
from ..utils.trace import builds, span
from .filters import (
    hamming_filter,
    keys_cubic_filter,
    lanczos3_filter,
    lanczos5_filter,
    triangle_filter,
)
from .resize_xla import gather_reduce, gather_reduce_weights
from .weights import AxisSpec, Tables, as_tables

__all__ = ["resize2d", "resize_axis", "synth_applies"]

# Launches of each kernel: the wrappers add one per kernel launch and
# nowhere else, so a run can show that its main path went through them.
launches_2d = 0
launches_axis = 0
launches_2d_fused = 0
launches_axis_fused = 0

# dtype codes of the C entry points (csrc/ia_dtypes.cuh)
_DTYPES = {torch.uint8: 0, torch.float32: 1, torch.bfloat16: 2}
KERNEL_DTYPES = tuple(_DTYPES)

# Largest shared memory one block may use on Hopper (227 KB), and the part
# of it the plan gives resample2d's dynamic shared memory (the rest: the
# kernel's static shared memory, with room to spare).
_SMEM_LIMIT = 232448
_SMEM_BUDGET = _SMEM_LIMIT - 1024
# Shared memory of one SM (228 KB), and what the card keeps of it per
# resident block (1 KB): how many blocks of a plan's size fit an SM.
_SM_SMEM = 233472
_SM_SMEM_PER_BLOCK = 1024
_BLOCK_THREADS = 256  # resample2d.cuh::kThreads
_SM_THREADS = 2048
_H100_SMS = 132  # the plan's SM count where there is no card (CPU tensors)
# resample2d's output-row tiles, and its output-column tiles: the kernel's
# template values of TC (csrc/resample2d.cuh)
_TILE_R = (64, 32, 16, 8, 4, 2, 1)
TILE_C = (128, 64, 32, 16)
# Resident blocks per SM the plan aims for: the kernel's register bound
# (__launch_bounds__ in csrc/resample2d.cuh) allows four (three in the
# 16-tap bucket), but on the H100 a whole window in one stage at three
# blocks per SM beat a two-stage ring at four (PERF.md, section 6).
_RESIDENT = 3
_INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Host tables and plans
# ---------------------------------------------------------------------------


Pass = AxisSpec | Tables  # a forward spec, or the tables of any pass


@cache
@builds
def _tables(t: Pass) -> tuple[np.ndarray, np.ndarray]:
    """``(xmin[out] int32, w[out, ntaps] float32)``: the pass's float64
    tables (:func:`..weights.as_tables`), cast once.  Read-only (cached)."""
    tb = as_tables(t)
    w = np.ascontiguousarray(tb.w, dtype=np.float32)
    w.setflags(write=False)
    return tb.xmin, w


@lru_cache(maxsize=256)
@builds
def _tables_on(t: Pass, device: torch.device):
    """:func:`_tables` as tensors on ``device``, uploaded once per device."""
    xmin, w = _tables(t)
    return (torch.from_numpy(xmin.copy()).to(device),
            torch.from_numpy(w.copy()).to(device))


class Plan2d(NamedTuple):
    """resample2d's launch plan (:func:`_plan_rows`)."""

    tile_r: int  # output rows per block
    tile_c: int  # output columns per block, one of TILE_C
    rows_cap: int  # widest input row window of a row tile
    cols_cap: int  # widest input column span of a column tile
    chunk: int  # input rows per stage of the ring (one stage: the whole window)
    smem: int  # dynamic shared memory per block, bytes
    blocks: int  # blocks of one launch over all planes, one per output tile
    resident: int  # blocks per SM that shared memory allows (at most 8)


def _align16(v: int) -> int:
    return (v + 15) & ~15


def _smem_bytes(tile_r: int, tile_c: int, rows_cap: int, cols_cap: int,
                chunk: int, ntaps_w: int, ntaps_h: int, itemsize: int,
                inter_size: int = 4) -> int:
    """Dynamic shared memory of one resample2d block, as the kernel lays it
    out (csrc/resample2d.cuh::layout; the C entry point refuses a plan whose
    bytes differ): the ring's stages of ``chunk`` input rows (one where a
    chunk is the whole window, else two), the intermediate ``[rows_cap,
    tile_c]`` (float32; Pillow's kernel: ``inter_size`` 1, bytes), and each
    pass's weights (``[ntaps, tile]``), first taps and synthesis sums."""
    stride = _align16(cols_cap * itemsize) + 32
    stages = 2 if chunk < rows_cap else 1
    return (stages * chunk * stride + _align16(rows_cap * tile_c * inter_size)
            + _align16(ntaps_w * tile_c * 4) + 2 * _align16(tile_c * 4)
            + _align16(ntaps_h * tile_r * 4) + 2 * _align16(tile_r * 4))


def _window(first: np.ndarray, ntaps: int, n_in: int, tile: int) -> int:
    """The widest input window over consecutive tiles of ``tile`` outputs:
    ``max(clamp(first + ntaps - 1) + 1) - min(clamp(first))`` per tile, the
    taps clamped to ``[0, n_in - 1]`` as the kernel clamps them (the ragged
    last tile: its own outputs only)."""
    first = first.astype(np.int64)
    lo = np.clip(first, 0, n_in - 1)
    hi = np.clip(first + ntaps - 1, 0, n_in - 1) + 1
    n = -(-len(first) // tile)
    pad = n * tile - len(first)  # edge padding repeats a member of the tile
    lo_t = np.pad(lo, (0, pad), mode="edge").reshape(n, tile).min(1)
    hi_t = np.pad(hi, (0, pad), mode="edge").reshape(n, tile).max(1)
    return int((hi_t - lo_t).max())


def _plan_rows(first_h: np.ndarray, ntaps_h: int, H: int, first_w: np.ndarray,
               ntaps_w: int, W: int, itemsize: int, planes: int,
               n_sm: int, inter_size: int = 4) -> Plan2d | None:
    """resample2d's plan for ``planes`` planes of ``[H, W]`` with
    ``itemsize``-byte elements on a card of ``n_sm`` SMs, or None where no
    tile fits a block's shared memory (the caller then runs two
    resample_axis passes).  ``inter_size``: bytes of an intermediate
    element (1 for the Pillow two-pass kernel, which plans with it too).

    For each tile (``tile_r`` output rows from ``_TILE_R`` by ``tile_c``
    output columns from :data:`TILE_C`), the widest input row window and
    column span are computed from the passes' first taps (``first_h[OH]``,
    ``first_w[OW]``) exactly as the kernel computes them, and the ring's
    chunk is as large as :func:`_chunk` allows.  Of the tiles that fit, the
    plan takes:

    1. the most blocks up to ``2 * n_sm``: two waves of blocks, at least
       two resident per SM, so a batch-1 image still fills the card, while
       a large batch (config 5's 192 planes give tens of thousands of
       blocks with any tile) keeps wide tiles;
    2. then the most resident blocks per SM that shared memory allows, up
       to ``_RESIDENT`` (the copies' latency is hidden by other blocks);
    3. then the fewest chunks per block (each is a round trip to device
       memory that the block waits for);
    4. then tiles of at least 32 columns (16-column tiles split a warp
       over two rows: on the H100 they ran 1.4x slower at the headline);
    5. then the least work per output: W-pass multiply-adds over the row
       window, H-pass multiply-adds, and staged input words (a row tile's
       halo rows and a column tile's halo columns are the waste; a tile
       wider than the image counts its real outputs only);
    6. then the least shared memory, then the wider column tile.

    Every tap of every output lies in its tile's window and span, which the
    kernel checks (it traps where host and kernel disagree)."""
    best = max(_rows_candidates(first_h, ntaps_h, H, first_w, ntaps_w, W, itemsize, planes,
                                n_sm, inter_size), default=None, key=lambda kp: kp[0])
    return None if best is None else best[1]


def _rows_candidates(first_h: np.ndarray, ntaps_h: int, H: int, first_w: np.ndarray,
                     ntaps_w: int, W: int, itemsize: int, planes: int, n_sm: int,
                     inter_size: int = 4):
    """``(key, plan)`` for every tile :func:`_plan_rows` considers that fits
    a block; the plan is the one with the largest key."""
    OH, OW = len(first_h), len(first_w)
    target = 2 * n_sm
    for tile_c in TILE_C:
        cols_cap = _window(first_w, ntaps_w, W, tile_c)
        stride = _align16(cols_cap * itemsize) + 32
        for tile_r in _TILE_R:
            rows_cap = _window(first_h, ntaps_h, H, tile_r)
            chunk = _chunk(tile_r, tile_c, rows_cap, cols_cap, ntaps_w, ntaps_h,
                           itemsize, inter_size)
            if chunk is None:
                continue
            smem = _smem_bytes(tile_r, tile_c, rows_cap, cols_cap, chunk,
                               ntaps_w, ntaps_h, itemsize, inter_size)
            blocks = planes * -(-OH // tile_r) * -(-OW // tile_c)
            resident = min(_SM_THREADS // _BLOCK_THREADS,
                           _SM_SMEM // (smem + _SM_SMEM_PER_BLOCK))
            eff_r, eff_c = min(tile_r, OH), min(tile_c, OW)
            cost = (rows_cap * eff_c * ntaps_w + eff_r * eff_c * ntaps_h
                    + rows_cap * stride / 4) / (eff_r * eff_c)
            chunks = -(-rows_cap // chunk)
            key = (min(blocks, target), min(resident, _RESIDENT), -chunks,
                   tile_c >= 32, -cost, -smem, tile_c)
            yield key, Plan2d(tile_r, tile_c, rows_cap, cols_cap, chunk, smem, blocks,
                              resident)


def _chunk(tile_r: int, tile_c: int, rows_cap: int, cols_cap: int, ntaps_w: int,
           ntaps_h: int, itemsize: int, inter_size: int = 4) -> int | None:
    """Input rows per chunk of the ring: the whole window (one stage) where
    the block then still fits ``_RESIDENT`` blocks in an SM's shared memory,
    else the most rows of two stages that do, else the same within the
    per-block budget; None where not even one row does."""
    def smem(chunk):
        return _smem_bytes(tile_r, tile_c, rows_cap, cols_cap, chunk, ntaps_w,
                           ntaps_h, itemsize, inter_size)

    for budget in (_SM_SMEM // _RESIDENT - _SM_SMEM_PER_BLOCK, _SMEM_BUDGET):
        if smem(rows_cap) <= budget:
            return rows_cap
        lo, hi = 1, rows_cap - 1  # the largest two-stage chunk within budget
        if smem(lo) > budget:
            continue
        while lo < hi:
            mid = (lo + hi + 1) // 2
            lo, hi = (mid, hi) if smem(mid) <= budget else (lo, mid - 1)
        return lo
    return None


@lru_cache(maxsize=1024)
@builds
def _plan2d(spec_h: Pass, spec_w: Pass, itemsize: int = 4, planes: int = 1,
            n_sm: int = _H100_SMS) -> Plan2d | None:
    """:func:`_plan_rows` over the passes' tables."""
    ymin, wh = _tables(spec_h)
    xmin, ww = _tables(spec_w)
    return _plan_rows(ymin, wh.shape[1], spec_h.in_size, xmin, ww.shape[1],
                      spec_w.in_size, itemsize, planes, n_sm)


@lru_cache(maxsize=1024)
def _plan2d_synth(spec_h: AxisSpec, spec_w: AxisSpec, itemsize: int = 4,
                  planes: int = 1, n_sm: int = _H100_SMS) -> Plan2d | None:
    """:func:`_plan_rows` over the first taps the fused kernel synthesises."""
    return _plan_rows(_synth_first(spec_h), spec_h.ntaps, spec_h.in_size,
                      _synth_first(spec_w), spec_w.ntaps, spec_w.in_size,
                      itemsize, planes, n_sm)


@cache
@lru_cache(maxsize=16)
def _n_sm(dev: torch.device) -> int:
    """The card's SM count (the plan's ``n_sm``); :data:`_H100_SMS` for a
    CPU tensor, whose plan only decides between one plain 2-D pass and two
    axis passes."""
    if dev.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(dev).multi_processor_count


class PlanAxis(NamedTuple):
    """resample_axis' and pil_resample_axis' launch plan (:func:`_plan_axis`)."""

    tile_j: int  # planes (along outer) per block
    tile_o: int  # outputs per block, along the resampled axis
    tile_i: int  # inner columns per block (inner itself: one run per plane)
    win: int  # widest input window of a tile, along the resampled axis
    vec: int  # inner columns per thread: 4 (uint8, aligned) or 1
    smem: int  # dynamic shared memory per block, bytes
    blocks: int  # blocks of the launch, one per tile
    resident: int  # blocks per SM that shared memory allows (at most 8)


# the axis kernels' tiles: outputs, planes and inner spans per block
_AXIS_TILE_O = (256, 128, 64, 32, 16, 8, 4, 2, 1)
_AXIS_TILE_J = (64, 32, 16, 8, 4, 2, 1)
_AXIS_TILE_I = (512, 256, 128, 64, 32)
# The plan's model of a launch on the H100, fitted to every tile timed on
# the card by tools/sweep_axis_plans.py (device time, L2 flushed before
# each launch).  The shapes it was checked on, and how its pick ranked
# (PERF.md section 6, PR 7): the fastest tile at config 5's NHWC H pass
# (bf16 [64, 2160, 5760] -> 1080 rows, tables and synthesised weights),
# row 9's sharded f32 H pass and its adjoint ([3, 4112, 4096] -> 1024 rows
# and back) and row 3's sharded uint8 H pass ([3, 8196, 8192] -> 2048
# rows); 1.03x and 1.07x the fastest at config 5's NHWC W pass ([138240,
# 3840, 3] -> 1920, tables and synthesised weights) and 1.08x at row 3's
# W pass ([24576, 32768, 1] -> 8192).  Between the unstaged cut and those
# passes (the NHWC headline at 2 to 32 frames) its pick was 1.0-1.5x the
# best of its own three best-ranked tiles.  The model: a block's chain of
# copies and barriers costs ~3 us that other resident blocks hide (at most
# four resident: the kernel's __launch_bounds__, three in the 16-tap
# bucket), and its threads issue instructions at about half the SMs' peak
# (128 per cycle at 1.755 GHz): per output three per tap and ten per column
# step (of V outputs), per row of a thread 8 where it keeps one output for
# the whole tile, else 160 (weights reloaded, addresses, the column loop's
# setup), and 10 per 16-byte piece staged.
_AXIS_BLOCK_US = 3.0
_AXIS_ISSUE_PER_SM_US = 128 * 1755 * 0.5
# A pass that moves at most this many bytes (input and output) runs the
# kernel's unstaged body, by weight source: host tables (float and Pillow)
# and synthesised weights.  Set from the crossover of the plan's tile and
# the unstaged body on the H100 (device ms, L2 flushed before each launch;
# tools/sweep_axis_plans.py --cut, PERF.md section 6, PR 7).  Tables: the
# body wins at the NHWC headline's W pass for 1, 2 and 4 frames (6.4, 12.9,
# 25.8 MB: 0.0067 against 0.0121, 0.0111 against 0.0191, 0.0197 against
# 0.0277 ms) and its H pass for 1-4 frames (<= 9.7 MB); at 19.5 MB the H
# pass ties (0.0191) and config 4's NHWC adjoint H pass takes the tile
# (0.0207 against 0.0290); from 39 MB the tile wins (H pass 0.0289 against
# 0.0357), but for the W pass at 51.6 MB (0.0407 against 0.0370).  Pillow:
# the body at 6.4 MB (0.0185 against 0.0271), the tile at 25.8 MB (0.0449
# against 0.0682).  Synthesised weights cost the body a filter evaluation
# per element: the tile ties at 6.4 MB (0.0130 against 0.0129) and wins
# from 4.9 MB on (0.0102 against 0.0126); the body wins at 2.4 MB (0.0075
# against 0.0083).
_AXIS_UNSTAGED_BYTES = 16 << 20
_AXIS_UNSTAGED_BYTES_FUSED = 4 << 20


def _axis_smem_bytes(tile_j: int, tile_o: int, tile_i: int, win: int, ntaps: int,
                     itemsize: int, n_in: int, inner: int) -> int:
    """Dynamic shared memory of one axis-kernel block, as the kernel lays it
    out (csrc/resample_axis.cuh::layout; the C entry point refuses a plan
    whose bytes differ): the staged window, then the weights ``[ntaps,
    tile_o]``, the first taps and the synthesis sums.  Where ``tile_i ==
    inner`` each plane's window is one run of ``win * inner`` elements,
    ``tile_j`` runs; else ``win`` runs of ``tile_i`` elements.  Each run has
    room for a 15-byte head and tail, and the stride between runs is
    congruent, mod 16, to their distance in device memory."""
    if tile_i == inner:
        stride = _align16(win * inner * itemsize + 15) + 16 + (n_in * inner * itemsize) % 16
        data = tile_j * stride + 16
    else:
        stride = _align16(tile_i * itemsize + 15) + 16 + (inner * itemsize) % 16
        data = win * stride + 16
    return _align16(data) + _align16(ntaps * tile_o * 4) + 2 * _align16(tile_o * 4)


def _lanes(tile_i: int, vec: int) -> int:
    """Lanes of a warp per output row (the kernel's G): the inner span's
    columns per ``vec``, rounded up to a power of two, at most 32; 1 for a
    row of at most 3 columns (one thread takes NHWC's channels)."""
    cols, g = -(-tile_i // vec), 1
    while cols > 3 and g < 32 and g < cols:
        g *= 2
    return g


def _plan_axis(first: np.ndarray, ntaps: int, n_in: int, outer: int, inner: int,
               itemsize: int, n_sm: int, vec4: bool = False) -> PlanAxis | None:
    """The axis kernels' tile for a pass over ``x[outer, n_in, inner]`` with
    first taps ``first[n_out]`` and ``itemsize``-byte elements on a card of
    ``n_sm`` SMs, or None where no tile fits a block's shared memory.
    ``vec4``: the input's address is a multiple of 4, so uint8 may take four
    columns per thread.

    The kind of pass sets the tiles tried: one run per plane (``tile_i ==
    inner``) with ``tile_j`` planes sharing the weights, which the last axis
    (inner == 1) and a narrow inner (NHWC's 3 channels) take; and, for a
    wide inner, ``tile_i``-column spans of one plane.  Each ``tile_o`` of
    :data:`_AXIS_TILE_O` has its widest window from ``first``, computed as
    the kernel computes it (:func:`_window`).  Of the tiles that fit, the
    plan takes the one with at least a block per SM (where the shape has
    that many) and the least time by the model above: the blocks' chains
    over the resident blocks, plus the instructions they issue."""
    best = max(_axis_candidates(first, ntaps, n_in, outer, inner, itemsize, n_sm, vec4),
               default=None)
    return None if best is None else best[1]


def _axis_candidates(first: np.ndarray, ntaps: int, n_in: int, outer: int, inner: int,
                     itemsize: int, n_sm: int, vec4: bool = False):
    """``(key, plan)`` for every tile :func:`_plan_axis` considers that fits
    a block; the plan is the one with the largest key."""
    wins = ((t, _window(first, ntaps, n_in, t)) for t in _AXIS_TILE_O)
    return _axis_tiles(wins, len(first), ntaps, n_in, outer, inner, itemsize, n_sm, vec4)


def _axis_tiles(wins, n_out: int, ntaps: int, n_in: int, outer: int, inner: int,
                itemsize: int, n_sm: int, vec4: bool = False, per_img: int | None = None):
    """``(key, plan)`` of every tile for the ``(tile_o, win)`` pairs
    ``wins``, by the model above.  ``per_img``: planes per image of
    per-image tables (the crop passes; None: one table), whose tiles along
    ``outer`` the kernel cuts at image edges (so no tile takes more planes
    than an image has: they would only hold shared memory)."""
    per_img = outer if per_img is None else per_img
    n_img = outer // per_img
    shapes = [(tj, inner) for tj in _AXIS_TILE_J if n_img == 1 or tj <= per_img]
    shapes += [(1, ti) for ti in _AXIS_TILE_I if ti < inner]
    per_sm = 3 if ntaps > 8 else 4  # resident blocks the registers allow
    for tile_o, win in wins:
        eff_o = min(tile_o, n_out)
        for tile_j, tile_i in shapes:
            vec = 4 if (vec4 and itemsize == 1 and inner % 4 == 0 and tile_i % 4 == 0) else 1
            g = _lanes(tile_i, vec)
            step = (_BLOCK_THREADS // 32) * (32 // g)  # rows per pass of the block
            smem = _axis_smem_bytes(tile_j, tile_o, tile_i, win, ntaps, itemsize, n_in, inner)
            if smem > _SMEM_BUDGET:
                continue
            blocks = n_img * -(-per_img // tile_j) * -(-n_out // tile_o) * -(-inner // tile_i)
            if blocks > _INT_MAX:
                continue
            resident = min(_SM_THREADS // _BLOCK_THREADS, _SM_SMEM // (smem + _SM_SMEM_PER_BLOCK))
            eff_j, eff_i = min(tile_j, per_img), min(tile_i, inner)
            rows = eff_j * eff_o
            split = 1
            while split * 2 * rows <= step:
                split *= 2
            passes = -(-eff_i // (g * vec * split))  # column passes per row
            # output slots the block's threads pass through, idle ones included
            slots = -(-rows // (step // split)) * (step // split) * passes * g * vec * split
            staged = (eff_j * win * inner if tile_i == inner else win * eff_i) * itemsize
            # a thread that keeps one output for the whole tile (the slots'
            # pass is a multiple of tile_o) moves only the plane between rows
            per_row = 8 if (step // split) % tile_o == 0 else 160
            instr = ((3 * ntaps + 10 / vec) * slots + per_row * rows * g * split
                     + 10 * staged / 16)
            waves_us = blocks * _AXIS_BLOCK_US / (n_sm * min(resident, per_sm))
            issue_us = blocks * instr / (n_sm * _AXIS_ISSUE_PER_SM_US)
            key = (min(blocks, n_sm), min(resident, 2), -(waves_us + issue_us), -smem, tile_o,
                   tile_j, tile_i)
            yield key, PlanAxis(tile_j, tile_o, tile_i, win, vec, smem, blocks, resident)


@lru_cache(maxsize=1024)
def _plan_axis_first(first_key: bytes, ntaps: int, n_in: int, outer: int, inner: int,
                     itemsize: int, n_sm: int, vec4: bool,
                     fused: bool = False) -> PlanAxis | None:
    """The launch plan of the axis kernels' wrappers, over first taps given
    as int64 bytes (a hashable key for any table's first taps): None, the
    unstaged body, for a pass that moves at most :data:`_AXIS_UNSTAGED_BYTES`
    (``fused``: :data:`_AXIS_UNSTAGED_BYTES_FUSED`) or where no tile fits;
    else :func:`_plan_axis`'s tile."""
    cut = _AXIS_UNSTAGED_BYTES_FUSED if fused else _AXIS_UNSTAGED_BYTES
    if outer * inner * (n_in + len(first_key) // 8) * itemsize <= cut:
        return None
    return _plan_axis(np.frombuffer(first_key, np.int64), ntaps, n_in, outer, inner,
                      itemsize, n_sm, vec4)


def _plan_axis_spec(spec: Pass, fused: bool, outer: int, inner: int, itemsize: int = 4,
                    n_sm: int = _H100_SMS, vec4: bool = False) -> PlanAxis | None:
    """:func:`_plan_axis_first` over a pass's tables (``fused``: over the
    first taps the fused kernel synthesises)."""
    ntaps = spec.ntaps if fused else _tables(spec)[1].shape[1]
    return _plan_axis_first(_first_key(spec, fused), ntaps, spec.in_size, outer, inner,
                            itemsize, n_sm, vec4, fused)


def _win0(first: np.ndarray, n_in: int, tile_o: int) -> np.ndarray:
    """Each output tile's first input row, int32 ``[ceil(n_out / tile_o)]``:
    the least of its outputs' first taps clamped to the axis, as
    :func:`_window` computes it.  The kernel stages ``win`` rows from there,
    so a block needs no first taps before its copies start."""
    lo = np.clip(first.astype(np.int64), 0, n_in - 1)
    n = -(-len(lo) // tile_o)
    lo = np.pad(lo, (0, n * tile_o - len(lo)), mode="edge").reshape(n, tile_o).min(1)
    return lo.astype(np.int32)


@lru_cache(maxsize=256)
def _win0_on(first_key: bytes, n_in: int, tile_o: int, device: torch.device) -> torch.Tensor:
    """:func:`_win0` over int64 first taps given as bytes, on ``device``,
    uploaded once per table, tile and device."""
    return torch.from_numpy(_win0(np.frombuffer(first_key, np.int64), n_in, tile_o)).to(device)


# Values derived from read-only host tables (the cached tables of
# weights.compute_tables, pil_exact._int_tables and the halo plans), by the
# array's identity: a repeated call neither copies nor hashes the table's
# bytes again.  Each entry keeps its array alive, so an identity is never
# reused while it is cached.
_SEEN: dict = {}


def _memo(a: np.ndarray, what, make):
    """``make()``, computed once per read-only array ``a`` and ``what``."""
    if a.flags.writeable:  # may change: derive anew
        return make()
    hit = _SEEN.get((id(a), what))
    if hit is None or hit[0] is not a:
        if len(_SEEN) >= 1024:
            _SEEN.clear()
        with span("ia.build._memo"):
            hit = _SEEN[(id(a), what)] = (a, make())
    return hit[1]


def _first_taps_key(first: np.ndarray) -> bytes:
    """First taps as int64 bytes: the key of :func:`_plan_axis_first` and of
    the window tables (one bytes object per table, so its hash is computed
    once)."""
    return _memo(first, "first", lambda: np.asarray(first, np.int64).tobytes())


@cache
def _first_key(spec: Pass, fused: bool) -> bytes:
    """A pass's first taps (``fused``: the synthesised ones) as int64 bytes."""
    return _first_taps_key(_synth_first(spec) if fused else _tables(spec)[0])


def axis_launch_args(plan: PlanAxis | None, first_key: bytes, n_in: int,
                     device: torch.device) -> tuple[int, ...]:
    """The window table's address and the plan as the axis kernels' C entry
    points take them: win0, tile_j, tile_o, tile_i, win, vec, smem; 0 and
    tile_o = 0 (the unstaged body) for None."""
    if plan is None:
        return (0, 0, 0, 0, 0, 1, 0)
    return (_win0_on(first_key, n_in, plan.tile_o, device).data_ptr(), *plan[:6])


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


def _plan_args(plan: Plan2d) -> tuple[int, ...]:
    """The plan as the C entry points take it: tile_r, tile_c, rows_cap,
    cols_cap, chunk, smem."""
    return plan[:6]


def occupancy_2d(plan: Plan2d, in_dtype: torch.dtype, out_dtype: torch.dtype,
                 ntaps_w: int, ntaps_h: int, fused: bool = False) -> int:
    """Resident blocks per SM of resample2d's kernel (``fused``: the
    synthesising one) under ``plan`` on the current card, as
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it (registers
    and shared memory both count).  Launches nothing; needs the card."""
    lib = native.build()
    fn = lib.ia_resample2d_fused_occupancy if fused else lib.ia_resample2d_occupancy
    blocks = ctypes.c_int(0)
    err = fn(_DTYPES[in_dtype], _DTYPES[out_dtype], ntaps_w, ntaps_h,
             *_plan_args(plan), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"resample2d occupancy query failed: cudaError {err}")
    return blocks.value


def _resample2d_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    global launches_2d
    lib = native.build()
    B, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    out = torch.empty((B, OH, OW), dtype=out_dtype, device=x3.device)
    if B == 0:
        return out
    dev = x3.device
    with span("ia.tables.resize2d"):
        xmin_w, w_w = _tables_on(spec_w, dev)
        ymin_h, w_h = _tables_on(spec_h, dev)
    quant = int(x3.dtype == torch.uint8 and out_dtype == torch.uint8)
    # every block of a launch is on gridDim.x: split batches whose block
    # count would pass its 2^31 - 1 limit
    per_plane = -(-OH // plan.tile_r) * -(-OW // plan.tile_c)
    with torch.cuda.device(dev):
        for b0, n in native.plane_chunks(B, _INT_MAX // per_plane):
            with span("ia.native.resample2d"):
                err = lib.ia_resample2d(
                    x3.data_ptr() + b0 * H * W * x3.element_size(),
                    out.data_ptr() + b0 * OH * OW * out.element_size(),
                    _DTYPES[x3.dtype], _DTYPES[out_dtype], n, H, W, OH, OW,
                    xmin_w.data_ptr(), w_w.data_ptr(), w_w.shape[1],
                    ymin_h.data_ptr(), w_h.data_ptr(), w_h.shape[1],
                    quant, *_plan_args(plan), _stream(dev))
                if err != 0:
                    raise RuntimeError(f"resample2d launch failed: cudaError {err}")
                launches_2d += 1
    return out


def _axis_plan(x3: torch.Tensor, spec: Pass, fused: bool) -> PlanAxis | None:
    outer, _, inner = x3.shape
    return _plan_axis_spec(spec, fused, outer, inner, x3.element_size(),
                           _n_sm(x3.device), x3.data_ptr() % 4 == 0)


def occupancy_axis(plan: PlanAxis, kind: str, in_dtype: torch.dtype,
                   out_dtype: torch.dtype, ntaps: int) -> int:
    """Resident blocks per SM of the axis kernel ``kind`` (``"table"``,
    ``"fused"`` or ``"pil"``, uint8 -> uint8) under ``plan`` on the current
    card, as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` gives it.
    Launches nothing; needs the card."""
    lib = native.build()
    blocks = ctypes.c_int(0)
    if kind == "pil":
        err = lib.ia_pil_resample_axis_occupancy(ntaps, plan.vec, plan.smem,
                                                 ctypes.byref(blocks))
    else:
        err = lib.ia_resample_axis_occupancy(int(kind == "fused"), _DTYPES[in_dtype],
                                             _DTYPES[out_dtype], ntaps, plan.vec,
                                             plan.smem, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"resample_axis occupancy query failed: cudaError {err}")
    return blocks.value


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
    plan = _axis_plan(x3, spec, False)
    with torch.cuda.device(dev), span("ia.native.resample_axis"):
        err = lib.ia_resample_axis(
            x3.data_ptr(), out.data_ptr(), _DTYPES[x3.dtype], _DTYPES[out_dtype],
            outer, n_in, inner, spec.out_size, xmin.data_ptr(), w.data_ptr(),
            w.shape[1], *axis_launch_args(plan, _first_key(spec, False), n_in, dev),
            _stream(dev))
        if err != 0:
            raise RuntimeError(f"resample_axis launch failed: cudaError {err}")
        launches_axis += 1
    return out


def _resample2d_fused_cuda(x3, spec_h, spec_w, out_dtype, plan) -> torch.Tensor:
    global launches_2d_fused
    lib = native.build()
    B, H, W = x3.shape
    OH, OW = spec_h.out_size, spec_w.out_size
    out = torch.empty((B, OH, OW), dtype=out_dtype, device=x3.device)
    if B == 0:
        return out
    dev = x3.device
    sw, sh = _synth_struct(spec_w), _synth_struct(spec_h)
    quant = int(x3.dtype == torch.uint8 and out_dtype == torch.uint8)
    per_plane = -(-OH // plan.tile_r) * -(-OW // plan.tile_c)
    with torch.cuda.device(dev):
        for b0, n in native.plane_chunks(B, _INT_MAX // per_plane):
            with span("ia.native.resample2d_fused"):
                err = lib.ia_resample2d_fused(
                    x3.data_ptr() + b0 * H * W * x3.element_size(),
                    out.data_ptr() + b0 * OH * OW * out.element_size(),
                    _DTYPES[x3.dtype], _DTYPES[out_dtype], n, H, W, OH, OW,
                    ctypes.addressof(sw), ctypes.addressof(sh), quant,
                    *_plan_args(plan), _stream(dev))
                if err != 0:
                    raise RuntimeError(f"resample2d (fused) launch failed: cudaError {err}")
                launches_2d_fused += 1
    return out


def _resample_axis_fused_cuda(x3, spec, out_dtype) -> torch.Tensor:
    global launches_axis_fused
    lib = native.build()
    outer, n_in, inner = x3.shape
    out = torch.empty((outer, spec.out_size, inner), dtype=out_dtype,
                      device=x3.device)
    if out.numel() == 0:
        return out
    dev = x3.device
    plan = _axis_plan(x3, spec, True)
    with torch.cuda.device(dev), span("ia.native.resample_axis_fused"):
        err = lib.ia_resample_axis_fused(
            x3.data_ptr(), out.data_ptr(), _DTYPES[x3.dtype], _DTYPES[out_dtype],
            outer, n_in, inner, spec.out_size,
            ctypes.addressof(_synth_struct(spec)),
            *axis_launch_args(plan, _first_key(spec, True), n_in, dev), _stream(dev))
        if err != 0:
            raise RuntimeError(f"resample_axis (fused) launch failed: cudaError {err}")
        launches_axis_fused += 1
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
                  fused_h: bool = False, fused_w: bool = False) -> Plan2d | None:
    """:func:`resize2d`'s launch decision for ``planes`` planes of
    ``itemsize``-byte elements on a card of ``n_sm`` SMs: kernel A's plan
    (over the synthesised first taps where both passes are fused), or None,
    where no tile fits or only one pass is fused: two resample_axis passes
    (W into :func:`axes_inter_dtype`, then H)."""
    if fused_h != fused_w:
        return None
    return (_plan2d_synth if fused_h else _plan2d)(spec_h, spec_w, itemsize,
                                                   max(1, planes), n_sm)


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
    The launch's tiles follow the batch and the card (:func:`_plan_rows`).

    ``x`` is uint8, float32 or bfloat16; ``out_dtype`` uint8 (``floor(v +
    0.5)`` clamped), float32 or bfloat16, by default float32 for uint8 input
    and the input's dtype otherwise.  Where no output tile's row window fits
    a block's shared memory (:func:`_plan2d`), the call runs two
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
                             _n_sm(x.device), fused_h, fused_w)
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
        print(f"[ia-tpu] resample2d{' (fused)' if fused_h else ''} "
              f"{x.dtype}->{out_dtype} ({x.device.type})")
    if x.device.type == "cuda":
        launch = _resample2d_fused_cuda if fused_h else _resample2d_cuda
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
