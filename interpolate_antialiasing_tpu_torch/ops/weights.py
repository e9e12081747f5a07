"""Per-axis resampling weight tables (the PIL ``ImagingResample`` algorithm).

The host (numpy) half of ``interpolate_antialiasing_tpu.ops.weights``, copied
expression for expression so both packages build identical float64 tables:

  1. ``compute_tables`` — compact ``(xmin, size, weights[out, ntaps])`` tables.
  2. ``dense_matrix`` — the banded weight matrix ``W[out, in]`` (the oracle).
  3. ``banded_tiles`` — the tile-compacted band ``[n_tiles, k_in, tile]``
     with per-tile window starts, which the plain ``resize_axis_banded``
     route contracts tile by tile; ``banded_tiles_from_matrix`` builds the
     same from any banded matrix (the JAX package's adjoint bands).
  4. ``Tables`` — the compact ``(xmin, w)`` tables of one pass, for the
     forward matrix ``W`` (:func:`forward_tables`) or its adjoint ``W^T``
     (:func:`adjoint_tables`), which is what the CUDA kernels read.

``pick_tile_h`` (the JAX package's matrix-unit tile picker) is not ported.

Algorithm (identical to the reference / Pillow):

  For output index ``i``:
    center  = scale * (i + 0.5)                       (align_corners=False)
    support = filter.support * max(scale, 1)          (if antialias)
    xmin    = max(int(center - support + 0.5), 0)
    size    = min(int(center + support + 0.5), in_size) - xmin
    w_j     = filter((j + xmin - center + 0.5) * invscale),  j in [0, size)
    w      /= sum(w);  w_j = 0 for j >= size

Border windows are clipped and renormalised — this is the part that makes the
band non-Toeplitz and is required for Pillow bit-parity.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from .filters import CUBIC_NAMES, Filter, get_filter

__all__ = [
    "AxisSpec",
    "make_axis_spec",
    "make_affine_axis_spec",
    "compute_tables",
    "dense_matrix",
    "banded_tiles",
    "banded_tiles_from_matrix",
    "Tables",
    "forward_tables",
    "adjoint_tables",
    "compact_tables",
    "as_tables",
    "tables_matrix",
    "pil_box_f32",
    "area_pixel_compute_scale",
]


def area_pixel_compute_scale(
    in_size: int, out_size: int, align_corners: bool, scale_factor: float | None = None
) -> float:
    """Source-pixels-per-output-pixel, matching ATen's
    ``area_pixel_compute_scale`` semantics."""
    if align_corners:
        if out_size > 1:
            return (in_size - 1) / (out_size - 1)
        return 0.0
    if scale_factor is not None and scale_factor > 0:
        return 1.0 / scale_factor
    return in_size / out_size if out_size > 0 else 0.0


def pil_box_f32(lo: float, hi: float) -> tuple[float, float, float]:
    """Pillow's C float boundary for the resize ``box``, reproduced exactly.

    ``Image.resize(box=...)`` hands the box to C as ``float[4]``, so each
    coordinate is rounded to float32 before any resampling math; the span
    length ``in1 - in0`` is a float32 subtraction before the double divide by
    ``out_size``.  Keeping full float64 here produces off-by-one bytes for
    boxes whose coordinates are not exactly representable in float32.

    Returns ``(lo32, hi32, span_len32)`` as Python floats (each exactly
    float32-representable).  Idempotent, so safe to apply at every entry.
    """
    lo32 = np.float32(lo)
    hi32 = np.float32(hi)
    return float(lo32), float(hi32), float(hi32 - lo32)


@dataclasses.dataclass(frozen=True)
class AxisSpec:
    """Static (hashable) description of one 1-D resampling pass."""

    in_size: int
    out_size: int
    mode: str
    antialias: bool = True
    align_corners: bool = False
    scale: float = 0.0  # source pixels per output pixel
    support: float = 0.0  # half-width of the (possibly widened) window
    invscale: float = 1.0  # argument scaling fed into the filter
    ntaps: int = 0  # static max window length = ceil(support)*2 + 1
    # Border handling: "renorm" (PIL/antialias — clip the window and
    # renormalise), "replicate" (classic torch non-AA — clamp tap indices
    # to the edge, folding out-of-range weights onto the border pixel), or
    # "zero" (jax.image.scale_and_translate — renorm over in-range taps, but
    # an output pixel whose CENTER falls outside [0, in_size] is zeroed
    # entirely, and near-cancelling windows below jax's 1000*eps_f32
    # threshold are zeroed rather than renormalised).
    border: str = "renorm"
    # Optional fractional source window (lo, hi) in input-pixel units —
    # PIL.Image.resize's per-axis ``box``: centers become
    # ``lo + (i + 0.5) * scale`` with ``scale = (hi - lo) / out_size``, while
    # tap indices still clamp at the FULL image edges [0, in_size).
    span: tuple[float, float] | None = None

    @property
    def filter(self) -> Filter:
        return get_filter(self.mode)


def make_axis_spec(
    in_size: int,
    out_size: int,
    mode: str = "bilinear",
    antialias: bool = True,
    align_corners: bool = False,
    scale_factor: float | None = None,
    span: tuple[float, float] | None = None,
) -> AxisSpec:
    if in_size <= 0 or out_size <= 0:
        raise ValueError(
            f"axis sizes must be positive, got in={in_size} out={out_size}"
        )
    if span is not None:
        # Round through float32 FIRST (Pillow's C float[4] box boundary),
        # then validate/canonicalise on the rounded values.
        lo, hi, _ = pil_box_f32(span[0], span[1])
        if not (0.0 <= lo < hi <= float(in_size)):
            raise ValueError(
                f"span must satisfy 0 <= lo < hi <= in_size, got ({lo}, {hi})"
                f" for in_size={in_size}"
            )
        if align_corners or scale_factor is not None or mode == "area":
            raise ValueError(
                "span (resize box) follows PIL.Image.resize semantics: "
                "antialias-style centers only — no align_corners, "
                "scale_factors, or area mode"
            )
        if (lo, hi) == (0.0, float(in_size)):
            span = None  # full axis: identical spec
        else:
            span = (lo, hi)
    if mode == "area":
        # torch `area` (adaptive_avg_pool2d): every pixel the interval
        # [i*in/out, (i+1)*in/out) touches, at full uniform weight.
        if align_corners:
            raise ValueError("area mode does not take align_corners")
        i = np.arange(max(out_size, 1), dtype=np.int64)
        sizes = -(-((i + 1) * in_size) // out_size) - (i * in_size) // out_size
        ntaps = int(sizes.max())
        scale = in_size / out_size if out_size > 0 else 0.0
        return AxisSpec(
            in_size=in_size,
            out_size=out_size,
            mode="area",
            antialias=antialias,
            align_corners=False,
            scale=scale,
            support=ntaps / 2.0,
            invscale=1.0,
            ntaps=ntaps,
            border="renorm",
        )
    # The classic (non-AA) bicubic convention is Keys a=-0.75 with
    # replicate borders (torch/OpenCV); the AA path is PIL's a=-0.5 with
    # renormalised borders.
    if not antialias and get_filter(mode).name in CUBIC_NAMES:
        mode = "bicubic075"
    filt = get_filter(mode)
    border = "renorm" if antialias else "replicate"
    if span is not None:
        # PIL precompute_coeffs(in0, in1): scale over the box span, with the
        # span length computed as a float32 subtraction before the double
        # divide — see pil_box_f32.
        scale = pil_box_f32(span[0], span[1])[2] / out_size
    else:
        scale = area_pixel_compute_scale(
            in_size, out_size, align_corners, scale_factor
        )
    # Antialias widens the window only when downsampling (scale >= 1).
    if antialias and scale >= 1.0:
        support = filt.support * scale
        invscale = 1.0 / scale
    else:
        support = filt.support
        invscale = 1.0
    ntaps = int(math.ceil(support)) * 2 + 1
    return AxisSpec(
        in_size=in_size,
        out_size=out_size,
        mode=filt.name,
        antialias=antialias,
        align_corners=align_corners,
        scale=scale,
        support=support,
        invscale=invscale,
        ntaps=ntaps,
        border=border,
        span=span,
    )


def make_affine_axis_spec(
    in_size: int,
    out_size: int,
    zoom: float,
    translation: float,
    mode: str = "linear",
    antialias: bool = True,
) -> AxisSpec:
    """AxisSpec for one axis of ``jax.image.scale_and_translate``.

    ``zoom`` is jax's ``scale`` (output pixels per input pixel, must be
    positive — callers handle negative zoom by flipping the axis) and
    ``translation`` its output-space offset.  jax samples at
    ``sample_f = (i + 0.5)/zoom - translation/zoom - 0.5``; in this
    library's center convention (``center = sample_f + 0.5``) that is the
    span machinery with ``scale = 1/zoom`` and ``lo = -translation/zoom``
    — the same math as a PIL resize box, minus PIL's float32 coordinate
    boundary (jax keeps full precision, so no pil_box_f32 here) and minus
    the in-bounds requirement.

    Border: windows whose centers all land inside the axis renormalise at
    the edges exactly like the PIL path ("renorm"); when any center exits
    the axis, the "zero" border adds jax's center-out-of-range zeroing, and
    the in-kernel weight synthesis leaves such specs to the tables.
    """
    if in_size <= 0 or out_size <= 0:
        raise ValueError(
            f"axis sizes must be positive, got in={in_size} out={out_size}"
        )
    zoom = float(zoom)
    translation = float(translation)
    if not zoom > 0.0:
        raise ValueError(f"zoom must be positive here (flip first), got {zoom}")
    filt = get_filter(mode)
    scale = 1.0 / zoom
    lo = -translation * scale
    hi = lo + scale * out_size
    if antialias and scale >= 1.0:
        support = filt.support * scale
        invscale = 1.0 / scale
    else:
        support = filt.support
        invscale = 1.0
    ntaps = int(math.ceil(support)) * 2 + 1
    # centers are monotonic in i (zoom > 0): the first/last decide range
    c0 = lo + scale * 0.5
    c1 = lo + scale * (out_size - 0.5)
    in_range = 0.0 <= c0 and c1 <= float(in_size)
    span = None if (lo, hi) == (0.0, float(in_size)) else (lo, hi)
    return AxisSpec(
        in_size=in_size,
        out_size=out_size,
        mode=filt.name,
        antialias=antialias,
        align_corners=False,
        scale=scale,
        support=support,
        invscale=invscale,
        ntaps=ntaps,
        border="renorm" if in_range else "zero",
        span=span,
    )


def _centers(spec: AxisSpec, dtype) -> np.ndarray:
    i = np.arange(spec.out_size, dtype=dtype)
    if spec.align_corners:
        # (center - 0.5) is the continuous source coordinate; with
        # align_corners the source coord of output i is scale * i.
        return dtype(spec.scale) * i + dtype(0.5)
    c = dtype(spec.scale) * (i + dtype(0.5))
    if spec.span is not None:
        # PIL: center = in0 + (i + 0.5) * scale — the addition commutes, so
        # this is bit-identical to Pillow's double evaluation order.
        c = c + dtype(spec.span[0])
    return c


def compute_tables(
    spec: AxisSpec, dtype=np.float64
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (numpy) table builder.

    Returns ``(xmin[out] int32, size[out] int32, weights[out, ntaps] dtype)``.
    Weights are computed in ``dtype`` (default float64, like Pillow which
    evaluates filters in double) and rows sum to 1 with a zero tail.
    """
    dtype = np.dtype(dtype).type
    if spec.mode == "area":
        return _compute_tables_area(spec, dtype)
    ntaps = spec.ntaps
    center = _centers(spec, dtype)  # [out]
    support = dtype(spec.support)
    half = dtype(0.5)

    if spec.border == "replicate":
        return _compute_tables_replicate(spec, center, support, half, dtype)

    # int() in the reference truncates toward zero, but the lower bound is
    # clamped to 0 (where trunc == floor for the surviving values) and the
    # upper bound argument is positive, so floor is exact here.
    xmin = np.maximum(np.floor(center - support + half), 0.0).astype(np.int64)
    xmax = np.minimum(np.floor(center + support + half), float(spec.in_size)).astype(
        np.int64
    )
    size = xmax - xmin  # actual taps per output pixel (<= ntaps)

    j = np.arange(ntaps, dtype=dtype)  # [ntaps]
    arg = (j[None, :] + xmin[:, None].astype(dtype) - center[:, None] + half) * dtype(
        spec.invscale
    )
    w = spec.filter(arg, np)  # [out, ntaps]
    valid = j[None, :] < size[:, None].astype(dtype)
    w = np.where(valid, w, 0.0)
    total = w.sum(axis=1, keepdims=True)
    if spec.border == "zero":
        # jax.image.scale_and_translate semantics: normalise over in-range
        # taps, zero rows whose window mass is below 1000*eps_f32 (jax's
        # near-cancellation guard), and zero rows whose CENTER falls
        # outside [0, in_size] (jax's sample_f in [-0.5, in-0.5] test).
        ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
        w = np.where(ok, w / np.where(ok, total, 1.0), 0.0)
        in_range = (center >= 0.0) & (center <= float(spec.in_size))
        w = np.where(in_range[:, None], w, 0.0)
        # Fully-out-of-range rows are all-zero, but their raw xmin/size can
        # point far outside the axis (clamped floor of a distant center) —
        # clamp them so every reader's window stays in bounds.
        xmin = np.clip(xmin, 0, max(spec.in_size - 1, 0))
        size = np.clip(size, 0, None)
        return xmin.astype(np.int32), size.astype(np.int32), w.astype(dtype)
    # Guard total == 0 exactly like the reference — leave the raw (all-zero)
    # weights in place.
    w = np.where(total != 0.0, w / np.where(total == 0.0, 1.0, total), w)
    return xmin.astype(np.int32), size.astype(np.int32), w.astype(dtype)


def _compute_tables_area(spec, dtype):
    """Exact torch ``area`` windows (ATen adaptive_avg_pool2d index rule:
    ``start = i*in/out`` floored, ``end = (i+1)*in/out`` ceiled, every
    included pixel at full uniform weight)."""
    i = np.arange(spec.out_size, dtype=np.int64)
    xmin = (i * spec.in_size) // spec.out_size
    xmax = -(-((i + 1) * spec.in_size) // spec.out_size)
    size = xmax - xmin
    j = np.arange(spec.ntaps, dtype=np.int64)
    w = np.where(j[None, :] < size[:, None], 1.0 / size[:, None], 0.0)
    return xmin.astype(np.int32), size.astype(np.int32), w.astype(dtype)


def _compute_tables_replicate(spec, center, support, half, dtype):
    """Classic-path tables: unclamped window, out-of-range taps folded onto
    the nearest edge pixel (ATen index-clamp semantics)."""
    out, ntaps, insz = spec.out_size, spec.ntaps, spec.in_size
    xmin0 = np.floor(center - support + half).astype(np.int64)  # may be < 0
    j = np.arange(ntaps, dtype=dtype)
    arg = (j[None, :] + xmin0[:, None].astype(dtype) - center[:, None] + half) * dtype(
        spec.invscale
    )
    w = spec.filter(arg, np)  # [out, ntaps]
    total = w.sum(axis=1, keepdims=True)
    w = np.where(total != 0.0, w / np.where(total == 0.0, 1.0, total), w)

    idx = np.clip(xmin0[:, None] + np.arange(ntaps)[None, :], 0, insz - 1)
    new_xmin = idx[:, 0]
    size = idx[:, -1] - new_xmin + 1
    folded = np.zeros((out, ntaps), dtype=dtype)
    rows = np.repeat(np.arange(out), ntaps)
    cols = (idx - new_xmin[:, None]).reshape(-1)
    np.add.at(folded, (rows, cols), w.reshape(-1))
    return new_xmin.astype(np.int32), size.astype(np.int32), folded


def dense_matrix(spec: AxisSpec, dtype=np.float32, table_dtype=np.float64) -> np.ndarray:
    """Full banded matrix ``W[out, in]`` with ``W[i, xmin[i]+j] = w[i, j]``.

    ``y = W @ x`` along the resampled axis reproduces the reference pass
    exactly; this is the parity oracle.
    """
    xmin, size, w = compute_tables(spec, dtype=table_dtype)
    W = np.zeros((spec.out_size, spec.in_size), dtype=table_dtype)
    rows = np.repeat(np.arange(spec.out_size), spec.ntaps)
    cols = (xmin[:, None] + np.arange(spec.ntaps)[None, :]).reshape(-1)
    vals = w.reshape(-1)
    keep = (cols >= 0) & (cols < spec.in_size)
    W[rows[keep], np.clip(cols, 0, spec.in_size - 1)[keep]] = vals[keep]
    return W.astype(dtype)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BandedTiles:
    """Tile-compacted band, as the JAX package builds it for its kernels.

    For each tile of ``tile`` consecutive output pixels, ``starts[t]`` is the
    first input pixel the tile touches and ``band[t, k, u]`` is the weight of
    input pixel ``starts[t] + k`` for output pixel ``t*tile + u``.  ``k_in``
    (the window) is static across tiles: max window extent rounded up to a
    multiple of ``align``, so every tile is one ``[k_in, tile]`` matrix
    product against a ``[rows, k_in]`` input slab.
    """

    starts: np.ndarray  # [n_tiles] int32
    band: np.ndarray  # [n_tiles, k_in, tile] float
    tile: int
    k_in: int
    n_tiles: int
    out_padded: int


def banded_tiles(
    spec: AxisSpec,
    tile: int = 128,
    dtype=np.float32,
    align: int = 8,
    table_dtype=np.float64,
    in_cap: int | None = None,
) -> BandedTiles:
    """Build the per-tile compact band.

    The per-tile input window is ``[xmin[t0], xmin[t1-1] + ntaps)``.  Both
    the window start and the static window size ``k_in`` are multiples of
    ``align``, and the caller pads the input length to
    ``round_up(in_size, align)`` so every window stays in bounds.  Weights
    are placed relative to the aligned start, so alignment is exact, not
    approximate.

    ``in_cap`` overrides the input length windows must stay inside.  With
    ``align=1, in_cap=in_size`` every window lies within the *unpadded*
    input (starts are clamped; weights are shifted to compensate).
    Out-of-range taps always carry zero weight, so clamping never drops
    signal.
    """
    xmin, size, w = compute_tables(spec, dtype=table_dtype)
    out = spec.out_size
    n_tiles = -(-out // tile)
    out_padded = n_tiles * tile
    if in_cap is None:
        in_cap = _round_up(spec.in_size, align)

    # Aligned per-tile window starts, then the widest span any tile needs.
    raw_starts = []
    spans = []
    for t in range(n_tiles):
        lo = (max(int(xmin[t * tile]), 0) // align) * align
        hi_idx = min((t + 1) * tile, out) - 1
        hi = int(xmin[hi_idx]) + spec.ntaps
        raw_starts.append(lo)
        spans.append(hi - lo)
    k_in = _round_up(max(max(spans), 1), align)
    k_in = min(k_in, in_cap)

    starts = np.zeros((n_tiles,), dtype=np.int32)
    band = np.zeros((n_tiles, k_in, tile), dtype=table_dtype)
    taps = np.arange(spec.ntaps)
    for t in range(n_tiles):
        o0 = t * tile
        o1 = min(o0 + tile, out)
        # Keep the aligned window inside the (padded) input.
        start = max(0, min(raw_starts[t], in_cap - k_in))
        starts[t] = start
        for u in range(o0, o1):
            k = int(xmin[u]) - start + taps  # positions inside the window
            ok = (k >= 0) & (k < k_in)
            band[t, k[ok], u - o0] = w[u, taps[ok]]
    return BandedTiles(
        starts=starts,
        band=band.astype(dtype),
        tile=tile,
        k_in=k_in,
        n_tiles=n_tiles,
        out_padded=out_padded,
    )


def banded_tiles_from_matrix(
    W: np.ndarray, tile: int = 128, dtype=np.float32, align: int = 8,
    in_cap: int | None = None,
) -> BandedTiles:
    """Tile-compact an arbitrary banded matrix ``W[out, in]``, as the JAX
    package does for its adjoint bands (the transposed resize matrix is
    again banded, with monotone window starts).  Window extents come from
    the nonzero structure of each row tile; ``in_cap`` as in
    :func:`banded_tiles`."""
    out, insz = W.shape
    n_tiles = -(-out // tile)
    out_padded = n_tiles * tile
    if in_cap is None:
        in_cap = _round_up(insz, align)

    los, his = [], []
    for t in range(n_tiles):
        rows = W[t * tile : min((t + 1) * tile, out)]
        nz = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        if nz.size:
            lo, hi = int(nz[0]), int(nz[-1]) + 1
        else:
            lo, hi = 0, 1
        lo = (lo // align) * align
        los.append(lo)
        his.append(hi)
    k_in = _round_up(max(hi - lo for lo, hi in zip(los, his)), align)
    k_in = min(k_in, in_cap)

    starts = np.zeros((n_tiles,), dtype=np.int32)
    band = np.zeros((n_tiles, k_in, tile), dtype=np.float64)
    for t in range(n_tiles):
        start = max(0, min(los[t], in_cap - k_in))
        starts[t] = start
        rows = W[t * tile : min((t + 1) * tile, out)]
        seg = rows[:, start : min(start + k_in, insz)]
        band[t, : seg.shape[1], : seg.shape[0]] = seg.T
    return BandedTiles(
        starts=starts,
        band=band.astype(dtype),
        tile=tile,
        k_in=k_in,
        n_tiles=n_tiles,
        out_padded=out_padded,
    )


# ---------------------------------------------------------------------------
# Compact tables of one pass, forward or adjoint
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Tables:
    """The compact tables of one banded pass ``y = M @ x`` with ``M[out,
    in]``: output ``o`` reads inputs ``xmin[o] + k`` for ``k < ntaps`` with
    weight ``w[o, k]`` (float64; taps past ``in_size`` carry zero weight and
    are clamped to the edge by every reader).  One object per spec and
    direction (the builders are cached), so it hashes by identity and keys
    the per-device caches of its readers.  Read-only."""

    in_size: int
    out_size: int
    xmin: np.ndarray  # [out] int32
    w: np.ndarray  # [out, ntaps] float64

    @property
    def ntaps(self) -> int:
        return self.w.shape[1]


def _frozen(*arrays) -> None:
    for a in arrays:
        a.setflags(write=False)


@functools.cache
def forward_tables(spec: AxisSpec) -> Tables:
    """``W``'s tables: :func:`compute_tables` in float64."""
    xmin, _, w = compute_tables(spec, dtype=np.float64)
    xmin = np.ascontiguousarray(xmin, dtype=np.int32)
    w = np.ascontiguousarray(w)
    _frozen(xmin, w)
    return Tables(spec.in_size, spec.out_size, xmin, w)


def compact_tables(M: np.ndarray) -> Tables:
    """Compact tables of a banded matrix ``M[out, in]`` whose nonzero
    columns lie, row by row, in one range: row ``o`` gets ``xmin[o]`` = its
    first nonzero column and the weights up to its last, zeros inside the
    range kept, every row padded with zeros to the widest range.  A row with
    no nonzero gets ``xmin = 0`` and zero weights."""
    out, insz = M.shape
    nz = M != 0.0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, insz - 1 - nz[:, ::-1].argmax(axis=1), 0)
    ntaps = int(max((last - first + 1).max(), 1))
    cols = first[:, None] + np.arange(ntaps)[None, :]
    keep = (cols <= last[:, None]) & any_nz[:, None]
    w = np.where(keep, M[np.arange(out)[:, None], np.minimum(cols, insz - 1)], 0.0)
    xmin = np.ascontiguousarray(first, dtype=np.int32)
    w = np.ascontiguousarray(w, dtype=np.float64)
    _frozen(xmin, w)
    return Tables(insz, out, xmin, w)


@functools.cache
def adjoint_tables(spec: AxisSpec) -> Tables:
    """``W^T``'s tables, from ``dense_matrix(spec, float64).T``: the
    adjoint of the pass maps ``spec.out_size`` values to ``spec.in_size``.
    ``W^T`` is banded with monotone window starts (each input pixel is read
    by one contiguous range of outputs), so its rows compact like ``W``'s;
    an upsampling axis gives each input many outputs (64 -> 196 bicubic:
    about 12 taps)."""
    return compact_tables(dense_matrix(spec, dtype=np.float64).T)


def as_tables(t: AxisSpec | Tables) -> Tables:
    """A pass given as a spec (its forward tables) or as tables."""
    return t if isinstance(t, Tables) else forward_tables(t)


def tables_matrix(t: Tables) -> np.ndarray:
    """The dense float64 matrix ``M[out, in]`` of a pass's tables (the
    inverse of :func:`compact_tables`; taps past ``in_size`` carry zero
    weight and are dropped)."""
    M = np.zeros((t.out_size, t.in_size), dtype=np.float64)
    rows = np.repeat(np.arange(t.out_size), t.ntaps)
    cols = (t.xmin[:, None].astype(np.int64) + np.arange(t.ntaps)[None, :]).reshape(-1)
    keep = cols < t.in_size
    np.add.at(M, (rows[keep], cols[keep]), t.w.reshape(-1)[keep])
    return M
