"""The windowed crop's per-image tables on the CPU: the plain build that the
table kernel (``csrc/crop_tables.cu``) repeats on the card, against the
JAX package's ``_windowed_band`` / ``_digitize_band``.

Tolerances:

* window starts equal, and integer weights ``K`` equal to the JAX digits
  recombined (the same float32 formulas);
* the float band bit for bit for bilinear and box, within 1e-6 for Hamming
  (its sin and cos come from two libraries): each column's sum runs in the
  order XLA's CPU compiler gives ``jnp.sum`` (``_tree_sum``, checked bit
  for bit against it here, with the streamed form the table kernel uses
  over each row's support range).  Another order (``torch.sum``'s, or tap
  order) moves a sum by an ulp now and then, which flips an integer weight
  on a rounding tie.

Cases: the windowed cases of ``tests/test_torch_port_crop.py`` with each of
the route's filters (bilinear, box, Hamming), and boxes drawn from a numpy
seed: sub-pixel boxes (the one-hot fallback), boxes touching the bottom
and right edges, boxes wider than ``max_box_frac``, one output row and
more than 128 output rows or columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu.ops import crop_pallas as jcp
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as tcc
from interpolate_antialiasing_tpu_torch.ops.filters import get_filter
from test_torch_port_crop import WINDOW_CASES

METHODS = ("bilinear", "box", "hamming")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny CPU ops: one torch thread per test, so that several test
    workers on one host do not contend (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_boxes(n: int, seed: int) -> np.ndarray:
    """``[n, 4]`` normalised boxes: a sub-pixel box, one touching the bottom
    and right edges, the whole image, then boxes of random place and span
    (clipped to the image)."""
    rng = np.random.default_rng(seed)
    y0, x0 = rng.uniform(0.0, 0.9, n), rng.uniform(0.0, 0.9, n)
    b = np.stack([y0, x0, np.minimum(1.0, y0 + rng.uniform(0.02, 1.0, n)),
                  np.minimum(1.0, x0 + rng.uniform(0.02, 1.0, n))], axis=-1)
    b[0] = [y0[0], x0[0], y0[0] + 1e-4, x0[0] + 2e-4]
    b[1, 2:] = 1.0
    b[2] = [0.0, 0.0, 1.0, 1.0]
    return b.astype(np.float32)


# (x shape, (oh, ow), max_box_frac): one output row, more than 128 output
# rows or columns, upsampling; boxes wider than a bound below 1
RANDOM_GEOMETRY = {
    "one_row": ((6, 1, 90, 140), (1, 33), 1.0),
    "tall_out": ((6, 1, 200, 120), (150, 20), 0.5),
    "wide_out": ((6, 1, 60, 400), (16, 260), 0.35),
    "upsample": ((6, 1, 24, 40), (70, 90), 1.0),
}

CASES = {f"{name}-{m}": (shape, boxes, ohw, m, frac)
         for name, (shape, boxes, ohw, _, frac) in WINDOW_CASES.items() for m in METHODS}
CASES.update({f"{name}-{m}": (shape, _random_boxes(shape[0], seed=i), ohw, m, frac)
              for i, (name, (shape, ohw, frac)) in enumerate(RANDOM_GEOMETRY.items())
              for m in METHODS})


def _axes(name):
    """Per axis: ``(lo, hi, _Axis)`` of the case's boxes (``pb`` that of the
    integer weights), and the mode."""
    shape, boxes, (oh, ow), method, frac = CASES[name]
    N, C, H, W = shape
    support = get_filter(method).support
    _, Hp, k_h, W2, k_w = tcc._geom(H, W, oh, ow, support, True, frac)
    fh, fw = tcc._fracs(frac)
    pb_h = tcc._digit_plan(Hp, oh, support, True, fh)[0]
    pb_w = tcc._digit_plan(W2, ow, support, True, fw)[0]
    b = torch.from_numpy(np.asarray(boxes, np.float32))
    return [(b[:, 0] * H, b[:, 2] * H,
             tcc._Axis(H, oh, k_h, Hp, 32, tcc._tap_bound(H, oh, support, True, k_h), pb_h)),
            (b[:, 1] * W, b[:, 3] * W,
             tcc._Axis(W, ow, k_w, W2, 128, tcc._tap_bound(W, ow, support, True, k_w),
                       pb_w))], method


def _band(lo, hi, ax, method):
    return tcc._windowed_band(lo, hi, ax.in_size, ax.out_size, ax.k, ax.in_limit, ax.align,
                              method, True)


@pytest.mark.parametrize("name", list(CASES))
def test_band_matches_jax(name):
    axes, method = _axes(name)
    for lo, hi, ax in axes:
        ts, tb = _band(lo, hi, ax, method)
        js, jb = jcp._windowed_band(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                    ax.in_size, ax.out_size, ax.k, ax.in_limit, ax.align,
                                    method, True)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        if method == "hamming":
            assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-6
        else:
            np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        K = tcc._digitize_band(tb, ax.pb).numpy()
        dig, _ = jcp._digitize_band(jb, pb=ax.pb, ndig=3)
        dig = np.asarray(dig).astype(np.int64).reshape(*K.shape[:-1], 3, 128)
        np.testing.assert_array_equal(
            K, dig[..., 0, :] + 256 * dig[..., 1, :] + 65536 * dig[..., 2, :])


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", list(CASES))
def test_compact_tables_expand_to_the_band(name, precision):
    """What the CPU builds for the kernel (``first``, ``cnt``, ``w`` per
    row, at most ``T`` taps, zeros past ``cnt``) expands back to the band
    (or its integer weights) placed at the window starts."""
    shape, boxes, ohw, method, frac = CASES[name]
    x = torch.zeros(shape, dtype=torch.uint8)
    tab_h, tab_w, pb_h, pb_w = tcc._windowed_tables(
        x, torch.from_numpy(np.asarray(boxes, np.float32)), ohw, method, True, frac, precision)
    axes, _ = _axes(name)
    for (lo, hi, ax), tab, pb in zip(axes, (tab_h, tab_w), (pb_h, pb_w)):
        assert pb == (ax.pb if precision == "pil_int8" else None)
        starts, band = _band(lo, hi, ax, method)
        vals = band if pb is None else tcc._digitize_band(band, pb)
        N, T = lo.shape[0], ax.T
        assert tab.w.shape == (N, ax.out_size, T)
        assert tab.w.dtype == (torch.float32 if pb is None else torch.int32)
        assert int(tab.cnt.max()) <= T
        assert bool((tab.w[torch.arange(T) >= tab.cnt[..., None]] == 0).all())
        dense = torch.zeros((N, ax.out_size, ax.in_limit + T), dtype=torch.float64)
        for j in range(T):
            dense.scatter_add_(2, (tab.first + j).long()[..., None],
                               tab.w[..., j, None].double())
        want = torch.zeros_like(dense)
        rows = vals.permute(0, 1, 3, 2).reshape(N, -1, ax.k)[:, :ax.out_size]
        for o in range(ax.out_size):
            s = starts[:, o // 128].long()
            for n in range(N):
                want[n, o, s[n]:s[n] + ax.k] = rows[n, o].double()
        assert torch.equal(dense, want)


# window lengths: one window, exactly one, just over (padded), the crop's
# H and W windows at the train batch, over 32 windows (a second level)
SUM_LENGTHS = (1, 5, 24, 32, 33, 100, 312, 768, 1056, 2048, 3000)


def _sparse_columns(k: int, seed: int) -> np.ndarray:
    """``[2, 1, k, 128]`` float32 columns, each a run of up to 40 nonzero
    values at a random place (as a band column's valid taps)."""
    rng = np.random.default_rng(seed)
    w = np.zeros((2, 1, k, 128), np.float32)
    for n in range(2):
        for u in range(128):
            run = int(rng.integers(1, min(k, 40) + 1))
            s = int(rng.integers(0, k - run + 1))
            w[n, 0, s:s + run, u] = rng.uniform(0.0, 1.0, run)
    return w


@pytest.mark.parametrize("k", SUM_LENGTHS)
def test_tree_sum_is_jnp_sum(k):
    w = _sparse_columns(k, seed=k)
    got = tcc._tree_sum(torch.from_numpy(w)).numpy()
    want = np.asarray(jnp.sum(jnp.asarray(w), axis=2, keepdims=True))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _streamed(col: np.ndarray, j_lo: int, j_hi: int) -> np.float32:
    """``csrc/crop_tables.cu``'s TreeSum over taps ``[j_lo, j_hi)`` of one
    column, the others taken as +0: each level's running window sum joins
    the level above when the next tap leaves its window."""
    k, f32 = len(col), np.float32
    front, s = [], k
    while s > tcc._SUM_WINDOW:
        pad = -s % tcc._SUM_WINDOW
        front.append(pad // 2)
        s = (s + pad) // tcc._SUM_WINDOW
    m = len(front)
    acc, win = [f32(0.0)] * (m + 1), [-1] * m
    for j in range(j_lo, j_hi):
        idx = j
        for lv in range(m):
            idx = (idx + front[lv]) // tcc._SUM_WINDOW
            if idx == win[lv]:
                break
            acc[lv + 1], acc[lv], win[lv] = f32(acc[lv + 1] + acc[lv]), f32(0.0), idx
        acc[0] = f32(acc[0] + col[j])
    for lv in range(m):
        acc[lv + 1] = f32(acc[lv + 1] + acc[lv])
    return acc[m]


@pytest.mark.parametrize("k", SUM_LENGTHS)
def test_streamed_tree_sum_over_the_support_range(k):
    """The kernel's form of :func:`_tree_sum`: only the taps of each row's
    (guarded) support range, added in order, give the same float."""
    w = _sparse_columns(k, seed=k + 1)
    want = tcc._tree_sum(torch.from_numpy(w)).numpy()
    rng = np.random.default_rng(k)
    for n in range(2):
        for u in range(128):
            nz = np.flatnonzero(w[n, 0, :, u])
            j_lo = max(0, int(nz[0]) - int(rng.integers(0, 3)))
            j_hi = min(k, int(nz[-1]) + 1 + int(rng.integers(0, 3)))
            got = _streamed(w[n, 0, :, u], j_lo, j_hi)
            assert got.view(np.int32) == want[n, 0, 0, u].view(np.int32), (n, u)


def test_table_filters_are_the_admitted_ones():
    """Every filter admission lets onto the windowed route has a code in
    the table kernel, and only those."""
    from interpolate_antialiasing_tpu_torch.ops.filters import FILTERS

    admitted = {f.fn for name, f in FILTERS.items()
                if tcc.crop_windowed_supported(torch.empty((1, 1, 8, 8), dtype=torch.uint8),
                                               (4, 4), name, True)}
    assert admitted == set(tcc._TABLE_FILTERS)


def test_boxes_must_be_one_per_image():
    x = torch.zeros((2, 1, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match=r"\[N, 4\]"):
        tcc._windowed_tables(x, torch.zeros((3, 4)), (8, 8), "bilinear", True, 1.0, "split")


# ---------------------------------------------------------------------------
# The table kernel's groups (csrc/crop_tables.cu), modelled in numpy: G
# lanes per output row, a row's taps in segments of _TABLE_CHUNKS * G that
# end on a sum window's border, lane l folding a segment's l-th window, a
# ballot per chunk of G taps for the compaction.
# ---------------------------------------------------------------------------

from chip_smoke import (CROP_4K, TABLE_EDGES, TRAIN_B64, ZOOM_OUT, _run_all_boxes,
                        _zoom_out_boxes)
from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes

GROUPS = tcc._TABLE_LANES
_W = tcc._SUM_WINDOW


def _windows(k: int) -> tuple[int, int]:
    """``csrc/crop_row.cuh::sum_windows``: the zeros in front of the first
    window of 32 taps and the count of windows (one for ``k <= 32``)."""
    if k <= _W:
        return 0, 1
    pad = -k % _W
    return pad // 2, (k + pad) // _W


def _group_total(col: np.ndarray, j_lo: int, j_hi: int, G: int) -> np.float32:
    """The kernel's total of one row: taps ``[j_lo, j_hi)`` of ``col`` in
    segments of at most ``_TABLE_CHUNKS * G`` taps, each ending on a window
    border but the last; lane l of a segment folds the segment's l-th
    window in tap order from +0; the window sums join the levels above in
    order (TreeSum over the windows: :func:`_streamed` of the window sums)."""
    f32, cap = np.float32, tcc._TABLE_CHUNKS * G
    front, count = _windows(len(col))
    sums, touched = np.zeros(count, f32), []
    a = j_lo
    while a < j_hi:
        e = min(j_hi, a + cap)
        if e < j_hi:
            e = (e + front) // _W * _W - front
        assert e > a
        i0, i1 = (a + front) // _W, (e - 1 + front) // _W
        assert i1 - i0 < min(G, cap // _W + 1)  # a lane and a shuffle for each window
        for i in range(i0, i1 + 1):  # lane i - i0
            w0, acc = i * _W - front, f32(0.0)
            for t in range(max(a, w0), min(e, w0 + _W)):
                acc = f32(acc + col[t])
            sums[i] = acc
            touched.append(i)
        a = e
    return _streamed(sums, touched[0], touched[-1] + 1) if touched else f32(0.0)


# the tap ranges of rows of the b64, zoom-out and 4K box sets (widths from
# their bands: 10 and 15 at b64, 19 and 44 zoom-out, 26 and 36 at 4K, 58
# for 4K zoom-out, 330 for a box ten times the image)
RANGE_WIDTHS = (10, 15, 19, 26, 36, 44, 58, 330)
# k of one window, one window exactly, just over it, 32 windows, just over
# (a second level), the 4K W window, and just over 32^3 (three levels)
GROUP_SUM_K = (24, 32, 33, 1024, 1025, 2304, 32 ** 3 + 1)


def _ranges(k: int, seed: int) -> list[tuple[int, int]]:
    """Tap ranges of :data:`RANGE_WIDTHS` (at most ``k``) placed so that
    they cross no, one and two window borders where their width allows,
    and at random places."""
    rng, (front, _) = np.random.default_rng(seed), _windows(k)
    out = []
    for width in sorted({min(w, k) for w in RANGE_WIDTHS}):
        starts = {0, k - width, *rng.integers(0, k - width + 1, 3).tolist()}
        for border in (_W - front, 2 * _W - front):  # a range ending just past a border
            s = border - width + 1
            if 0 <= s <= k - width:
                starts.add(s)
        s = _W - front - 1  # from one tap before a border on
        if 0 <= s <= k - width:
            starts.add(s)
        out += [(s, s + width) for s in sorted(starts)]
    return out


def _crossings(j_lo: int, j_hi: int, k: int) -> int:
    front, _ = _windows(k)
    return (j_hi - 1 + front) // _W - (j_lo + front) // _W


@pytest.mark.parametrize("k", GROUP_SUM_K)
def test_group_sum_is_tree_sum_and_jnp_sum(k):
    """The group's sum order, at every group size, over rows that cross no,
    one and two window borders, bit for bit against ``_tree_sum`` and
    ``jnp.sum`` of the whole column."""
    ranges = _ranges(k, seed=k)
    if k > 64:
        assert {_crossings(a, b, k) for a, b in ranges} >= {0, 1, 2}
    rng = np.random.default_rng(k + 7)
    w = np.zeros((1, 1, k, len(ranges)), np.float32)
    for u, (a, b) in enumerate(ranges):
        w[0, 0, a:b, u] = rng.uniform(0.0, 1.0, b - a)
    want = tcc._tree_sum(torch.from_numpy(w)).numpy()[0, 0, 0]
    jax_sum = np.asarray(jnp.sum(jnp.asarray(w), axis=2))[0, 0]
    np.testing.assert_array_equal(want.view(np.int32), jax_sum.view(np.int32))
    for G in GROUPS:
        got = np.array([_group_total(w[0, 0, :, u], a, b, G) for u, (a, b) in enumerate(ranges)],
                       np.float32)
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=f"G={G}")


def _row_ranges(b: np.ndarray, axis: int, ax, support: float):
    """``csrc/crop_row.cuh::row_range`` in numpy float32, every row of every
    image: ``(start, j_lo, j_hi, center)``, each ``[N, out]``."""
    f32 = np.float32
    size = f32(ax.in_size)
    lo, hi = b[:, axis].astype(f32) * size, b[:, axis + 2].astype(f32) * size
    scale = (hi - lo) / f32(ax.out_size)
    sup = (f32(support) * np.maximum(scale, f32(1.0)))[:, None]
    o = np.arange(ax.out_size)

    def center(i):
        return lo[:, None] + scale[:, None] * (i.astype(f32) + f32(0.5))

    raw = np.floor(center(o // 128 * 128) - sup - f32(0.5)) - f32(1.0)
    al = f32(ax.align)
    start = np.minimum(np.maximum(np.floor(raw / al) * al, f32(0.0)), f32(tcc._hi_start(ax)))
    c = center(o)
    cm, k = c - f32(0.5), f32(ax.k)
    j_lo = np.minimum(np.maximum(np.floor(cm - sup) - f32(2.0) - start, f32(0.0)), k)
    j_hi = np.minimum(np.maximum(np.ceil(cm + sup) + f32(3.0) - start, f32(0.0)), k)
    return start, j_lo.astype(np.int64), j_hi.astype(np.int64), c


# box sets: (x shape, (oh, ow), boxes, max_box_frac); b64's and its
# zoom-out's first 8 images
BOX_SETS = {
    "b64": (TRAIN_B64[0], TRAIN_B64[1], _run_all_boxes(64)[:8], 1.0),
    "b64 zoom-out": (TRAIN_B64[0], TRAIN_B64[1], _zoom_out_boxes(64)[:8], 1.0),
    "4k rrc": (CROP_4K[0], CROP_4K[1],
               sample_boxes(torch.Generator().manual_seed(1), 8, *CROP_4K[0][2:]).numpy(),
               box_fracs(*CROP_4K[0][2:])),
    "zoom-out": ((6, 3, 300, 520), (96, 112), np.asarray(ZOOM_OUT, np.float32), 1.0),
    **{e[0]: (e[1], e[2], np.asarray(e[3], np.float32), e[4]) for e in TABLE_EDGES
       if e[0] in ("row past every segment", "sub-pixel", "zero-count rows",
                   "ragged rows per block")},
}


def _captured_band(monkeypatch, name: str, method: str, precision: str):
    """Per axis of a box set: ``(its _Table, window starts, stored values
    [N, nt, k, 128], the unnormalised weights w and their totals)``, the
    latter two as the plain build's ``_tree_sum`` saw them."""
    shape, ohw, boxes, frac = BOX_SETS[name]
    x = torch.zeros((len(boxes), 1, *shape[2:]), dtype=torch.uint8)
    tabs = tcc._windowed_tables(x, torch.from_numpy(boxes), ohw, method, True, frac, precision)
    seen = []
    real = tcc._tree_sum

    def spy(w):
        total = real(w)
        seen.append((w.numpy(), total.numpy()))
        return total

    monkeypatch.setattr(tcc, "_tree_sum", spy)
    out = []
    for tab in tabs[:2]:
        starts, vals = tcc._axis_band(tab.rows)
        out.append((tab, starts.numpy(), vals.numpy(), *seen[-1]))
    monkeypatch.setattr(tcc, "_tree_sum", real)
    return out


def _column(arr: np.ndarray, n: int, o: int) -> np.ndarray:
    return arr[n, o // 128, :, o % 128]


@pytest.mark.parametrize("name", list(BOX_SETS))
def test_group_sum_over_box_rows(monkeypatch, name):
    """Every row of the box sets: the model's tap range and window start
    against the plain build's, every weight outside the range 0, and the
    group's total at every group size bit for bit the plain build's."""
    method = "bilinear"
    for tab, starts, _, w, total in _captured_band(monkeypatch, name, method, "split"):
        ax = tab.rows.ax
        b = tab.rows.boxes.numpy()
        start, j_lo, j_hi, _ = _row_ranges(b, tab.rows.axis, ax, get_filter(method).support)
        N, out = start.shape
        np.testing.assert_array_equal(start[:, ::128], starts)
        for n in range(N):
            for o in range(out):
                col = _column(w, n, o)
                assert not col[:j_lo[n, o]].any() and not col[j_hi[n, o]:].any()
                want = _column(total, n, o)[0]
                for G in GROUPS:
                    got = _group_total(col, int(j_lo[n, o]), int(j_hi[n, o]), G)
                    assert got.view(np.int32) == want.view(np.int32), (n, o, G)


def _group_compact(nz: np.ndarray, bits: np.ndarray, held: bool, j_lo: int, j_hi: int,
                   G: int, T: int, jn: float, k: int, one: int):
    """A row's ``(j0 or -1, cnt, w[T])`` as the kernel's group writes them:
    ``nz`` and ``bits`` the stored values' nonzero flags and bits over the
    window.  A ballot per chunk of G taps finds j0 (the first set bit) and
    j1 (the last, plus one); a row that fits one segment writes ``w[j -
    j0]`` for ``j - j0 < min(cnt, T)``, a longer one for ``j - j0 < T``
    while it walks (its writes past cnt then zeroed); a row whose total is
    0 takes the one-hot at ``jn``; zeros up to T."""
    unset = np.iinfo(np.int64).min
    w, j0, j1 = np.full(T, unset, np.int64), -1, 0
    L, cap = j_hi - j_lo, tcc._TABLE_CHUNKS * G

    def ballot(a):
        nonlocal j0, j1
        set_ = [lane for lane in range(G) if a + lane < j_hi and nz[a + lane]]
        if set_:
            j0 = a + set_[0] if j0 < 0 else j0
            j1 = a + set_[-1] + 1

    if held and L <= cap:
        chunks = range(j_lo, j_hi, G)
        for a in chunks:
            ballot(a)
        n_w = 0 if j0 < 0 else min(j1 - j0, T)
        for j in range(j_lo, j_lo + len(chunks) * G):
            if 0 <= j - j0 < n_w:
                w[j - j0] = bits[j]
    elif held:
        for a in range(j_lo, j_hi, G):
            ballot(a)
            for j in range(a, min(a + G, j_hi)):
                if j0 >= 0 and j >= j0 and j - j0 < T:
                    w[j - j0] = bits[j]
    elif 0.0 <= jn < k:
        j0, j1 = int(jn), int(jn) + 1
        w[0] = one
    cnt = 0 if j0 < 0 else j1 - j0
    w[min(cnt, T):] = 0
    assert (w != unset).all()
    return j0, cnt, w


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", list(BOX_SETS))
def test_group_compaction_matches_the_plain_tables(monkeypatch, name, precision):
    """The ballot compaction of every row of the box sets (rows past T,
    sub-pixel and zero-count rows among them) at the plan's group size,
    where the plan gives groups, and at 8 lanes (rows longer than a
    segment: the long path) gives the plain build's ``first``, ``cnt`` and
    ``w``."""
    method = "bilinear"
    f32 = np.float32
    bands = _captured_band(monkeypatch, name, method, precision)
    # the plan of the set's whole batch (the b64 sets model 8 of its images)
    plans = tcc._table_plan(tuple(t.rows.ax for t, *_ in bands), BOX_SETS[name][0][0], 132)
    for (tab, starts, vals, _, total), plan in zip(bands, plans):
        ax, pb = tab.rows.ax, tab.rows.ax.pb
        start, j_lo, j_hi, c = _row_ranges(tab.rows.boxes.numpy(), tab.rows.axis, ax,
                                           get_filter(method).support)
        jn = np.minimum(np.maximum(np.rint(c - f32(0.5)), f32(0.0)), f32(ax.in_size - 1)) - start
        N, out = start.shape
        bits = vals if pb is not None else vals.view(np.int32)
        one = (1 << pb) if pb is not None else int(np.float32(1.0).view(np.int32))
        first, cnt, w = (t.numpy() for t in (tab.first, tab.cnt, tab.w.view(torch.int32)))
        for G in sorted({plan, 8} - {1}):
            for n in range(N):
                for o in range(out):
                    j0, cnt_m, w_m = _group_compact(
                        _column(vals, n, o) != 0, _column(bits, n, o),
                        bool(_column(total, n, o)[0] > 0), int(j_lo[n, o]), int(j_hi[n, o]), G,
                        ax.T, float(jn[n, o]), ax.k, one)
                    assert int(start[n, o]) + max(j0, 0) == first[n, o], (n, o, G)
                    assert cnt_m == cnt[n, o], (n, o, G)
                    np.testing.assert_array_equal(w_m, w[n, o], err_msg=f"{(n, o, G)}")


# (N, H, W, (oh, ow), max_box_frac, the plan on 132 SMs): the train batch,
# its first 8 images, 4K, 64 4K frames, the edges' odd row counts, one row,
# a batch of one
PLAN_CASES = [(64, 438, 906, (224, 224), (1.0, 1.0), (1, 1)),
              (8, 438, 906, (224, 224), (1.0, 1.0), (8, 8)),
              (8, 2160, 3840, (224, 224), box_fracs(2160, 3840), (8, 16)),
              (64, 2160, 3840, (224, 224), box_fracs(2160, 3840), (8, 16)),
              (3, 300, 520, (37, 53), (1.0, 1.0), (8, 8)),
              (6, 90, 140, (1, 33), (1.0, 1.0), (32, 8)),
              (1, 300, 520, (96, 112), (0.3, 0.3), (8, 8)),
              (2, 150, 260, (16, 16), (0.25, 0.25), (8, 8))]


@pytest.mark.parametrize("case", PLAN_CASES, ids=[str(c[:4]) for c in PLAN_CASES])
def test_table_plan_and_grid_cover_every_row_once(case):
    """The plan gives one thread per row where that grid puts a block on
    every SM and every axis's widest row is at most
    ``_TABLE_SERIAL_SPAN`` taps, else per axis the least group size whose
    chunks hold the axis's widest row within the bound (or the largest);
    the grid, block b of an axis taking rows b * (threads / G) + group,
    covers every (axis, image, row) exactly once, with every other group of
    a block past the axis's rows; forced sizes too."""
    N, H, W, ohw, fracs, want = case
    axes = tuple(a for a, _ in tcc._table_geometry(H, W, *ohw, "bilinear", True, fracs,
                                                   "pil_int8"))
    assert tcc._table_plan(axes, N, 132) == want
    for n_sm in (132, 114, 8):
        plan = tcc._table_plan(axes, N, n_sm)
        serial = (sum(tcc._table_blocks(N, axes, (1, 1))) >= n_sm
                  and max(a.span for a in axes) <= tcc._TABLE_SERIAL_SPAN)
        assert (plan == (1, 1)) == serial
        if not serial:
            for ax, g in zip(axes, plan):
                assert g in GROUPS
                assert ax.span <= tcc._TABLE_CHUNKS * g or g == GROUPS[-1]
                assert g == GROUPS[0] or ax.span > tcc._TABLE_CHUNKS * g // 2
        for plan in [plan] + [(g, g) for g in (1, *GROUPS)]:
            blocks = tcc._table_blocks(N, axes, plan)
            seen = [np.zeros(N * a.out_size, np.int64) for a in axes]
            for blk in range(sum(blocks)):
                a = int(blk >= blocks[0])
                b = blk - (blocks[0] if a else 0)
                G = plan[a]
                for group in range(tcc._TABLE_THREADS // G):
                    row = b * (tcc._TABLE_THREADS // G) + group
                    if row < N * axes[a].out_size:
                        seen[a][row] += 1
            assert all((s == 1).all() for s in seen)


@pytest.mark.parametrize("name", ["b64", "4k rrc"])
def test_rows_within_the_bound_fit_the_span(monkeypatch, name):
    """Every row of boxes within the bound walks at most the axis's span
    (:func:`_tap_span`), the widest range the plan sizes G for."""
    for tab, *_ in _captured_band(monkeypatch, name, "bilinear", "pil_int8"):
        ax = tab.rows.ax
        _, j_lo, j_hi, _ = _row_ranges(tab.rows.boxes.numpy(), tab.rows.axis, ax, 1.0)
        assert int((j_hi - j_lo).max()) <= ax.span


def test_table_edges_reach_their_edges(monkeypatch):
    """chip_smoke.TABLE_EDGES hold what their names say, in the plain
    tables: rows whose taps span three sum windows, windows over 1024 taps
    on both axes (two sum levels), rows longer than any group's segment,
    sub-pixel rows (a total of 0), rows of count 0, and row counts that no
    group size's rows per block divide."""
    edges = {e[0]: e for e in TABLE_EDGES}
    (_, shape, ohw, boxes, frac) = edges["three sum windows"]
    tab = tcc._windowed_tables(torch.zeros(shape, dtype=torch.uint8), torch.tensor(boxes), ohw,
                               "bilinear", True, frac, "pil_int8")[1]
    starts, _ = tcc._axis_band(tab.rows)
    j = tab.first - starts.repeat_interleave(128, dim=1)[:, :ohw[1]]
    assert max(_crossings(int(a), int(a + c), tab.rows.ax.k)
               for a, c in zip(j.flatten(), tab.cnt.flatten())) >= 2
    (_, shape, ohw, boxes, frac) = edges["two sum levels"]
    axes = [a for a, _ in tcc._table_geometry(*shape[2:], *ohw, "bilinear", True,
                                              tcc._fracs(frac), "pil_int8")]
    assert all(_W ** 2 < a.k for a in axes)
    (_, shape, ohw, boxes, frac) = edges["row past every segment"]
    tabs = tcc._windowed_tables(torch.zeros(shape, dtype=torch.uint8), torch.tensor(boxes), ohw,
                                "bilinear", True, frac, "pil_int8")
    assert all(int(t.cnt.max()) > tcc._TABLE_CHUNKS * GROUPS[-1] for t in tabs[:2])
    for name in ("sub-pixel", "zero-count rows"):
        totals = [t for *_, t in _captured_band(monkeypatch, name, "bilinear", "pil_int8")]
        assert any((t == 0).any() for t in totals)
    (_, shape, ohw, boxes, frac) = edges["zero-count rows"]
    tabs = tcc._windowed_tables(torch.zeros(shape, dtype=torch.uint8), torch.tensor(boxes), ohw,
                                "bilinear", True, frac, "pil_int8")
    assert all(bool((t.cnt == 0).any()) for t in tabs[:2])
    (_, shape, ohw, _, _) = edges["ragged rows per block"]
    assert all(shape[0] * o % (tcc._TABLE_THREADS // g) for o in ohw for g in GROUPS)
