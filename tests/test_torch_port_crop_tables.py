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
