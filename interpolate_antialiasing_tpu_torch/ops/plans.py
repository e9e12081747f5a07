"""The host side of the port's hand-written kernels that every route shares:
the card's facts, each kernel's launch plan, and the host tables a plan is
computed from and uploaded with.

  * kernel A (``csrc/resample2d.cuh``): its tile plan :func:`plan_rows`
    (:class:`Plan2d`), over a float pass's tables (:func:`plan2d`, the
    float route) or over Pillow's int32 tables (:func:`plan_pil_2pass`,
    one-byte elements and intermediate); its streaming twin's plan
    (:func:`plan2d_stream`, :class:`PlanStream`) over the in-axis tables
    :func:`stream_tables`;
  * kernel B (``csrc/resample_axis.cuh``): the axis plan
    :func:`plan_axis_first` (:class:`PlanAxis`), over a pass's first taps,
    for the float, fused and Pillow axis kernels (:func:`plan_pil_axis`),
    and its tiles :func:`axis_tiles`, which the crop passes plan with too;
    :func:`axis_launch_args`, the plan and its window table as the C entry
    points take them;
  * the host tables of a float pass (:func:`tables`, :func:`tables_on`),
    and :func:`memo`, which keys a value derived from a read-only table by
    the table's identity;
  * the card: :func:`n_sm` (:data:`H100_SMS` where there is none) and
    :func:`blocks_per_plane`, which, with ``native.GRID_LIMIT``, sets how
    many launches a batch takes.

Nothing here launches a kernel (``native.launch`` does) or imports a
route module; the routes read these as ``plans.<name>`` at call time, so a
test forces a plan by patching this module.
"""

from __future__ import annotations

from functools import cache, lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import native
from ..utils.trace import builds, span
from .weights import AxisSpec, Tables, as_tables

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
H100_SMS = 132  # the plan's SM count where there is no card (CPU tensors)
# resample2d's output-row tiles, and its output-column tiles: the kernel's
# template values of TC (csrc/resample2d.cuh)
_TILE_R = (64, 32, 16, 8, 4, 2, 1)
TILE_C = (128, 64, 32, 16)
# Resident blocks per SM the plan aims for: the kernel's register bound
# (__launch_bounds__ in csrc/resample2d.cuh) allows four (three in the
# 16-tap bucket), but on the H100 a whole window in one stage at three
# blocks per SM beat a two-stage ring at four (PERF.md, section 6).
_RESIDENT = 3
# The streaming kernel (csrc/resample2d_stream.cu): warps per block (kWarps,
# each walks its own strip), its tap buckets (both passes take 4 or 8 taps
# per output; a stage of a warp's ring holds as many input rows), and the
# resident blocks its register bound keeps (kMinBlocks).  Its ring has 2 to
# 4 stages (the kernel waits with cp.async.wait_group, at most 3 groups
# behind).  A launch takes it where strips of at least _STREAM_MIN_ROWS input
# rows (the whole plane where it has fewer) give at least _STREAM_WAVES full
# waves of warps; its plan aims for _STREAM_AHEAD input bytes per SM in
# flight behind the math.
_STREAM_WARPS = 4
_STREAM_TAPS = (4, 8)
_STREAM_RESIDENT = 5
_STREAM_STAGES = (2, 3, 4)
_STREAM_MIN_ROWS = 64
_STREAM_WAVES = 2
_STREAM_AHEAD = 64 << 10


def _stream_tc(ntaps: int) -> int:
    """Output columns of a streaming strip (csrc/resample2d_stream.cu::
    strip_cols): 32 lanes of 4 columns in the 4-tap bucket, of 2 in the
    8-tap one."""
    return 32 * (4 if ntaps == 4 else 2)


def _stream_min_warps(n_sm: int) -> int:
    """Warps a streaming launch needs: :data:`_STREAM_WAVES` full waves."""
    return _STREAM_WAVES * _STREAM_RESIDENT * _STREAM_WARPS * n_sm


Pass = AxisSpec | Tables  # a forward spec, or the tables of any pass


@cache
@builds
def tables(t: Pass) -> tuple[np.ndarray, np.ndarray]:
    """``(xmin[out] int32, w[out, ntaps] float32)``: the pass's float64
    tables (:func:`..weights.as_tables`), cast once.  Read-only (cached)."""
    tb = as_tables(t)
    w = np.ascontiguousarray(tb.w, dtype=np.float32)
    w.setflags(write=False)
    return tb.xmin, w


@lru_cache(maxsize=256)
@builds
def tables_on(t: Pass, device: torch.device):
    """:func:`tables` as tensors on ``device``, uploaded once per device."""
    xmin, w = tables(t)
    return (torch.from_numpy(xmin.copy()).to(device),
            torch.from_numpy(w.copy()).to(device))


class Plan2d(NamedTuple):
    """resample2d's launch plan (:func:`plan_rows`)."""

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


def window(first: np.ndarray, ntaps: int, n_in: int, tile: int) -> int:
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


def plan_rows(first_h: np.ndarray, ntaps_h: int, H: int, first_w: np.ndarray,
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
    """``(key, plan)`` for every tile :func:`plan_rows` considers that fits
    a block; the plan is the one with the largest key."""
    OH, OW = len(first_h), len(first_w)
    target = 2 * n_sm
    for tile_c in TILE_C:
        cols_cap = window(first_w, ntaps_w, W, tile_c)
        stride = _align16(cols_cap * itemsize) + 32
        for tile_r in _TILE_R:
            rows_cap = window(first_h, ntaps_h, H, tile_r)
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


class PlanStream(NamedTuple):
    """The streaming kernel's launch plan (:func:`_plan_stream`)."""

    seg: int  # output rows per warp: a segment of the plane's height
    stages: int  # stages of each warp's ring
    cols_cap: int  # widest input column span of a strip
    ntaps: int  # taps per output of both passes: the bucket (:func:`_stream_ntaps`)
    smem: int  # dynamic shared memory per block, bytes
    blocks: int  # blocks of one launch: a warp per plane x segment x strip
    resident: int  # blocks per SM that shared memory and registers allow


def _effective_taps(w: np.ndarray) -> int:
    """Taps a pass must sum: one past the last weight column with a nonzero
    entry anywhere in the table (trailing columns of zeros add nothing to a
    finite input: ``acc + 0 * x`` is ``acc``)."""
    nz = np.flatnonzero((w != 0).any(axis=0))
    return int(nz[-1]) + 1 if nz.size else 1


def _stream_ntaps(spec_h: Pass, spec_w: Pass) -> int | None:
    """The streaming kernel's taps per output for both passes: the least
    bucket of :data:`_STREAM_TAPS` that holds both passes' effective taps,
    or None where none does."""
    n = max(_effective_taps(tables(spec_h)[1]), _effective_taps(tables(spec_w)[1]))
    return next((b for b in _STREAM_TAPS if n <= b), None)


@lru_cache(maxsize=256)
@builds
def stream_tables(t: Pass, T: int) -> tuple[np.ndarray, np.ndarray] | None:
    """The streaming kernel's form of :func:`tables`: ``(first[out]
    int32, w[out, T] float32)``, ``T`` taps at least the pass's effective
    ones (:func:`_effective_taps`), with every window moved inside ``[0,
    in_size)`` and the taps it gains weighted 0 (an edge window that
    reached past the axis starts at ``in_size - T``; one before it, at 0).
    Each output keeps its nonzero weights on the same inputs in the same
    order, and a zero weight adds nothing to a finite input, so the sums
    are the tables' bit for bit.  None where a tap outside the axis carries
    weight (its clamp repeats the edge) or ``T`` exceeds the axis.
    Read-only."""
    first, w = tables(t)
    n_in = t.in_size
    if T < _effective_taps(w):
        raise ValueError(f"{T} taps drop weights of a pass with {_effective_taps(w)}")
    taps = first[:, None].astype(np.int64) + np.arange(w.shape[1])
    if T > n_in or np.any((w != 0) & ((taps < 0) | (taps >= n_in))):
        return None
    moved = np.clip(first.astype(np.int64), 0, n_in - T)
    j = np.arange(T) + (moved - first)[:, None]  # new tap k is old tap j
    inside = (j >= 0) & (j < w.shape[1])
    w2 = np.where(inside, np.take_along_axis(w, np.clip(j, 0, w.shape[1] - 1), 1), 0)
    w2 = np.ascontiguousarray(w2, dtype=np.float32)
    if np.count_nonzero(w2) != np.count_nonzero(w):
        return None
    moved = moved.astype(np.int32)
    moved.setflags(write=False)
    w2.setflags(write=False)
    return moved, w2


@lru_cache(maxsize=256)
@builds
def stream_tables_on(t: Pass, T: int, device: torch.device):
    """:func:`stream_tables` as tensors on ``device``, uploaded once per
    device."""
    first, w = stream_tables(t, T)
    return (torch.from_numpy(first.copy()).to(device),
            torch.from_numpy(w.copy()).to(device))


def _stream_smem_bytes(stages: int, ntaps: int, cols_cap: int, itemsize: int) -> int:
    """Dynamic shared memory of one streaming block, as the kernel lays it
    out (csrc/resample2d_stream.cu::warp_ring_bytes; the C entry point
    refuses a plan whose bytes differ): a ring per warp of ``stages``
    stages of ``ntaps`` input rows of the widest span (16-byte head and
    tail included)."""
    return _STREAM_WARPS * stages * ntaps * (_align16(cols_cap * itemsize) + 32)


def _plan_stream(first_h: np.ndarray, H: int, first_w: np.ndarray, W: int, ntaps: int,
                 itemsize: int, planes: int, n_sm: int) -> PlanStream | None:
    """The streaming kernel's plan for ``planes`` planes of ``[H, W]``
    over the first taps of the passes' in-axis tables of ``ntaps`` taps
    (:func:`stream_tables`), or None where the launch is short or its
    constraints do not hold: first taps that decrease anywhere, fewer than
    :data:`_STREAM_WAVES` waves of strips, or no ring that fits a block.
    The plan takes the candidate of :func:`_stream_candidates` with the
    largest key."""
    best = max(_stream_candidates(first_h, H, first_w, W, ntaps, itemsize, planes, n_sm),
               default=None, key=lambda kp: kp[0])
    return None if best is None else best[1]


def _stream_candidates(first_h: np.ndarray, H: int, first_w: np.ndarray, W: int,
                       ntaps: int, itemsize: int, planes: int, n_sm: int):
    """``(key, plan)`` for every ring and segment :func:`_plan_stream`
    considers: segments whose input window has at least
    :data:`_STREAM_MIN_ROWS` rows (or the whole plane), at least
    :data:`_STREAM_WAVES` waves of warps.  The key, largest first:

    1. the most resident blocks per SM, up to the register bound;
    2. the most input bytes in flight per SM (the stages ahead of the one
       being walked), up to :data:`_STREAM_AHEAD`;
    3. the least modelled time: waves of blocks times the rows a warp
       copies and resamples (its segment's input window, plus the ring's
       fill), so that the last wave is small and halos few;
    4. then the least shared memory."""
    if np.any(np.diff(first_h) < 0) or np.any(np.diff(first_w) < 0):
        return
    OH, OW = len(first_h), len(first_w)
    tc = _stream_tc(ntaps)
    cols_cap = window(first_w, ntaps, W, tc)
    stride = _align16(cols_cap * itemsize) + 32
    n_tx = -(-OW // tc)
    segs = sorted({-(-OH // n) for n in range(1, min(OH, 64) + 1)}, reverse=True)
    rows_of = {seg: window(first_h, ntaps, H, seg) for seg in segs}
    segs = [seg for seg in segs if seg == OH or rows_of[seg] >= _STREAM_MIN_ROWS]
    for stages in _STREAM_STAGES:
        smem = _stream_smem_bytes(stages, ntaps, cols_cap, itemsize)
        if smem > _SMEM_BUDGET:
            continue
        resident = min(_SM_THREADS // (32 * _STREAM_WARPS), _STREAM_RESIDENT,
                       _SM_SMEM // (smem + _SM_SMEM_PER_BLOCK))
        ahead = resident * _STREAM_WARPS * (stages - 1) * ntaps * stride
        for seg in segs:
            warps = planes * -(-OH // seg) * n_tx
            if warps < _stream_min_warps(n_sm):
                continue
            blocks = -(-warps // _STREAM_WARPS)
            waves = -(-blocks // (resident * n_sm))
            cost = waves * (rows_of[seg] + ntaps * (stages - 1))
            key = (resident, min(ahead, _STREAM_AHEAD), -cost, -smem)
            yield key, PlanStream(seg, stages, cols_cap, ntaps, smem, blocks, resident)


@lru_cache(maxsize=1024)
@builds
def plan2d_stream(spec_h: Pass, spec_w: Pass, itemsize: int, planes: int,
                   n_sm: int) -> PlanStream | None:
    """:func:`_plan_stream` over the passes' in-axis tables, or None where
    either has none or no segmenting reaches :func:`_stream_min_warps`
    (checked first, over the most segments and the narrower strip, so
    that a short launch builds no in-axis tables)."""
    OH, OW = spec_h.out_size, spec_w.out_size
    if planes * min(OH, 64) * -(-OW // _stream_tc(8)) < _stream_min_warps(n_sm):
        return None
    ntaps = _stream_ntaps(spec_h, spec_w)
    th = tw = None
    if ntaps is not None:
        th, tw = stream_tables(spec_h, ntaps), stream_tables(spec_w, ntaps)
    if th is None or tw is None:
        return None
    return _plan_stream(th[0], spec_h.in_size, tw[0], spec_w.in_size, ntaps, itemsize,
                        planes, n_sm)


@lru_cache(maxsize=1024)
@builds
def plan2d(spec_h: Pass, spec_w: Pass, itemsize: int = 4, planes: int = 1,
            n_sm: int = H100_SMS) -> Plan2d | None:
    """:func:`plan_rows` over the passes' tables."""
    ymin, wh = tables(spec_h)
    xmin, ww = tables(spec_w)
    return plan_rows(ymin, wh.shape[1], spec_h.in_size, xmin, ww.shape[1],
                      spec_w.in_size, itemsize, planes, n_sm)


@cache
def n_sm(dev: torch.device) -> int:
    """The card's SM count (the plan's ``n_sm``); :data:`H100_SMS` for a
    CPU tensor, whose plan only decides between one plain 2-D pass and two
    axis passes."""
    if dev.type != "cuda":
        return H100_SMS
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
AXIS_TILE_O = (256, 128, 64, 32, 16, 8, 4, 2, 1)
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
AXIS_UNSTAGED_BYTES = 16 << 20
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
    :data:`AXIS_TILE_O` has its widest window from ``first``, computed as
    the kernel computes it (:func:`window`).  Of the tiles that fit, the
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
    wins = ((t, window(first, ntaps, n_in, t)) for t in AXIS_TILE_O)
    return axis_tiles(wins, len(first), ntaps, n_in, outer, inner, itemsize, n_sm, vec4)


def axis_tiles(wins, n_out: int, ntaps: int, n_in: int, outer: int, inner: int,
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
            if blocks > native.GRID_LIMIT:
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
def plan_axis_first(first_key: bytes, ntaps: int, n_in: int, outer: int, inner: int,
                     itemsize: int, n_sm: int, vec4: bool,
                     fused: bool = False) -> PlanAxis | None:
    """The launch plan of the axis kernels' wrappers, over first taps given
    as int64 bytes (a hashable key for any table's first taps): None, the
    unstaged body, for a pass that moves at most :data:`AXIS_UNSTAGED_BYTES`
    (``fused``: :data:`_AXIS_UNSTAGED_BYTES_FUSED`) or where no tile fits;
    else :func:`_plan_axis`'s tile."""
    cut = _AXIS_UNSTAGED_BYTES_FUSED if fused else AXIS_UNSTAGED_BYTES
    if outer * inner * (n_in + len(first_key) // 8) * itemsize <= cut:
        return None
    return _plan_axis(np.frombuffer(first_key, np.int64), ntaps, n_in, outer, inner,
                      itemsize, n_sm, vec4)



def _win0(first: np.ndarray, n_in: int, tile_o: int) -> np.ndarray:
    """Each output tile's first input row, int32 ``[ceil(n_out / tile_o)]``:
    the least of its outputs' first taps clamped to the axis, as
    :func:`window` computes it.  The kernel stages ``win`` rows from there,
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


def memo(a: np.ndarray, what, make):
    """``make()``, computed once per read-only array ``a`` and ``what``."""
    if a.flags.writeable:  # may change: derive anew
        return make()
    hit = _SEEN.get((id(a), what))
    if hit is None or hit[0] is not a:
        if len(_SEEN) >= 1024:
            _SEEN.clear()
        with span("ia.build.memo"):
            hit = _SEEN[(id(a), what)] = (a, make())
    return hit[1]


def first_taps_key(first: np.ndarray) -> bytes:
    """First taps as int64 bytes: the key of :func:`plan_axis_first` and of
    the window tables (one bytes object per table, so its hash is computed
    once)."""
    return memo(first, "first", lambda: np.asarray(first, np.int64).tobytes())


def axis_launch_args(plan: PlanAxis | None, first_key: bytes, n_in: int,
                     device: torch.device) -> tuple[int, ...]:
    """The window table's address and the plan as the axis kernels' C entry
    points take them: win0, tile_j, tile_o, tile_i, win, vec, smem; 0 and
    tile_o = 0 (the unstaged body) for None."""
    if plan is None:
        return (0, 0, 0, 0, 0, 1, 0)
    return (_win0_on(first_key, n_in, plan.tile_o, device).data_ptr(), *plan[:6])



def blocks_per_plane(plan: Plan2d | PlanStream, OH: int, OW: int) -> int:
    """Blocks of one ``[OH, OW]`` output plane under kernel A's ``plan``
    (the tile plan's output tiles, or the streaming plan's warps of a
    segment and a strip, :data:`_STREAM_WARPS` to a block): how many
    planes one launch may take (``native.launch_planes``)."""
    if isinstance(plan, PlanStream):
        return -(-OH // plan.seg) * -(-OW // _stream_tc(plan.ntaps))
    return -(-OH // plan.tile_r) * -(-OW // plan.tile_c)


# ---------------------------------------------------------------------------
# Pillow's kernels (ops/pil_exact.py): kernel A and kernel B over int32
# tables of one-byte elements
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1024)
@builds
def _plan_2pass_keyed(first_h: bytes, ntaps_h: int, H: int, first_w: bytes, ntaps_w: int,
                      W: int, planes: int, n_sm: int) -> Plan2d | None:
    return plan_rows(np.frombuffer(first_h, np.int64), ntaps_h, H,
                     np.frombuffer(first_w, np.int64), ntaps_w, W, 1, planes, n_sm,
                     inter_size=1)


def plan_pil_2pass(tw, th, planes: int, H: int, W: int,
                   n_sm: int = H100_SMS) -> Plan2d | None:
    """The Pillow two-pass kernel's plan (kernel A's, :func:`plan_rows`,
    for one-byte elements and a one-byte intermediate) over the ``(xmin,
    Wb)`` tables of the W and H passes, for ``planes`` planes of ``[H, W]``
    on a card of ``n_sm`` SMs; None where no tile fits a block's shared
    memory (the wrapper then runs two pil_resample_axis passes).  Cached
    per table, shape and card."""
    return _plan_2pass_keyed(first_taps_key(th[0]), th[1].shape[1], H,
                             first_taps_key(tw[0]), tw[1].shape[1], W, planes, n_sm)


def plan_pil_axis(tables, outer: int, n_in: int, inner: int, n_sm: int,
                  vec4: bool) -> PlanAxis | None:
    """The pil_resample_axis launch plan of a pass over ``x3[outer, n_in,
    inner]`` with the ``(xmin, Wb)`` tables: the float axis kernel's plan
    (:func:`plan_axis_first`) for one-byte elements on a card of ``n_sm``
    SMs (``vec4``: the input's address is a multiple of 4); None: the
    unstaged body."""
    return plan_axis_first(first_taps_key(tables[0]), tables[1].shape[1], n_in, outer, inner,
                           1, n_sm, vec4)
