"""Crop boxes wider than the image (zoom-out boxes, as ``tf.image.crop_and_resize``
callers pass them) on the port's windowed route, against the JAX package's
interpret-mode ``crop_and_resize_windowed``.

Such a box can give an output row more taps than the tables' static bound
``T`` (``crop_cuda._tap_bound``).  The tables then keep the row's true count
and its first ``T`` weights; the plain version takes the rest from the band
of its box, and the kernel computes them again from the box (the card tests
and ``chip_smoke.py`` hold the kernel to the plain version byte for byte).

Tolerances, as ``tests/test_torch_port_crop.py`` states them: the integer
variant (``precision="pil_int8"``) byte-equal; the float variant
(``precision="split"``) within one grey level, the TPU kernels' split-bfloat16
products against the port's float32 sums in tap order.

Inputs are made from a numpy seed and handed to both packages.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ZOOM_OUT
from interpolate_antialiasing_tpu.ops import crop_pallas as jcp
from interpolate_antialiasing_tpu_torch.ops import crop as tcrop
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as tcc
from interpolate_antialiasing_tpu_torch.ops.filters import get_filter


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny CPU ops: one torch thread per test (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE, OHW = (2, 2, 96, 200), (24, 40)
INSIDE = ZOOM_OUT[4]  # a box within the image, beside each wide one
# (y0, x0, y1, x1): past every edge, a 40% zoom-out, 30% on one axis only
WIDE = dict(zip(("past every edge", "zoom-out 1.4", "rows 1.3", "columns 1.3"), ZOOM_OUT[:4]))
# (boxes, max_box_frac): each wide box beside one inside the image; boxes
# wider than a bound below 1 on one axis only (one of them also wider than
# the image); a batch that mixes in-bound and wide boxes
CASES = {name: ([box, INSIDE], 1.0) for name, box in WIDE.items()}
CASES["frac 0.5, one axis"] = ([ZOOM_OUT[5], [-0.2, 0.3, 1.1, 0.7]], (0.5, 0.5))
MIXED = [*WIDE.values(), INSIDE, [0.47, 0.55, 0.4701, 0.5502]]
CASES["mixed batch"] = (MIXED, 1.0)


def _x(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, *SHAPE[1:]), dtype=np.uint8)


def _where(got, want):
    d = np.argwhere(got.astype(int) != want.astype(int))
    return f"{len(d)} bytes differ, first at {d[:5].tolist()}"


def _check(got, want, precision):
    assert got.dtype == np.uint8 and got.shape == want.shape
    if precision == "pil_int8":
        assert np.array_equal(got, want), _where(got, want)
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, _where(got, want)


def _both_routes(x, boxes, method, antialias, frac, precision):
    """The JAX package's windowed bytes, and the port's through
    ``crop_cuda.crop_and_resize_windowed`` and, for the default precision,
    the public ``crop_and_resize`` (which routes there)."""
    want = np.asarray(jcp.crop_and_resize_windowed(
        jnp.asarray(x), jnp.asarray(boxes), OHW, method=method, antialias=antialias,
        max_box_frac=frac, precision=precision))
    tx, tb = torch.from_numpy(x), torch.from_numpy(boxes)
    got = [tcc.crop_and_resize_windowed(tx, tb, OHW, method=method, antialias=antialias,
                                        max_box_frac=frac, precision=precision).numpy()]
    if precision == "pil_int8":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # antialias=False's border note
            got.append(tcrop.crop_and_resize(tx, tb, OHW, method=method, antialias=antialias,
                                             max_box_frac=frac).numpy())
    return want, got


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", list(CASES))
def test_wide_boxes_match_jax(name, precision):
    boxes, frac = CASES[name]
    boxes = np.asarray(boxes, np.float32)
    want, got = _both_routes(_x(len(boxes)), boxes, "bilinear", True, frac, precision)
    for g in got:
        _check(g, want, precision)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("antialias", [True, False], ids=["aa", "no-aa"])
@pytest.mark.parametrize("method", ["bilinear", "box", "hamming", "nearest"])
def test_wide_boxes_every_mode_match_jax(method, antialias, precision):
    """Every filter the windowed admission takes (the non-negative ones),
    with and without antialiasing, on the mixed batch."""
    boxes = np.asarray(MIXED, np.float32)
    x = torch.zeros((len(boxes), *SHAPE[1:]), dtype=torch.uint8)
    assert tcc.crop_windowed_supported(x, OHW, method, antialias)
    want, got = _both_routes(_x(len(boxes)), boxes, method, antialias, 1.0, precision)
    for g in got:
        _check(g, want, precision)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_wide_rows_pass_the_tap_bound(precision):
    """The cases above do reach past ``T``: the mixed batch's tables count
    more taps than ``T`` on both axes, in the wide boxes' images only."""
    boxes = torch.tensor(MIXED, dtype=torch.float32)
    x = torch.zeros((len(MIXED), *SHAPE[1:]), dtype=torch.uint8)
    tab_h, tab_w, _, _ = tcc._windowed_tables(x, boxes, OHW, "bilinear", True, 1.0, precision)
    for tab, wide_imgs in ((tab_h, [0, 1, 2]), (tab_w, [0, 1, 3])):
        T = tab.w.shape[-1]
        past = (tab.cnt > T).any(dim=1)
        assert past.nonzero().flatten().tolist() == wide_imgs


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_plain_tables_keep_the_true_count(precision):
    """A wide box's plain tables: ``cnt`` is each row's true count (past
    ``T``), ``w`` its first ``T`` weights, and the band of its box holds the
    rest (``_row_weights``): the row compacted to the window's width."""
    boxes = torch.tensor(MIXED, dtype=torch.float32)
    x = torch.zeros((len(MIXED), *SHAPE[1:]), dtype=torch.uint8)
    for tab in tcc._windowed_tables(x, boxes, OHW, "bilinear", True, 1.0, precision)[:2]:
        ax, T = tab.rows.ax, tab.w.shape[-1]
        assert ax.T == T and int(tab.cnt.max()) > T
        starts, band = tcc._axis_band(tab.rows)
        first, cnt, w = tcc._compact(starts, band, ax.out_size, ax.k)
        assert torch.equal(first, tab.first) and torch.equal(cnt, tab.cnt)
        assert torch.equal(w[..., :T], tab.w)
        assert torch.equal(tcc._row_weights(tab.rows, ax.k), w)
        # every weight of a row lies in its count, and a wide row's last ones
        # are nonzero
        assert not w[torch.arange(ax.k) >= cnt[..., None]].any()
        wide = cnt > T
        last = w.gather(2, (cnt - 1).clamp(min=0).long()[..., None])[..., 0]
        assert bool((last[wide] != 0).all())


def test_int32_bound_holds_at_the_window_k():
    """Rows now count up to the window's ``k`` taps, so the accumulator's
    bound is checked at ``k``: it holds at ``pb = 22`` for the largest
    windows the port makes (the b64 train crop and the 4K
    random_resized_crop at max_box_frac 1) with a wide margin, and the
    integer weights of the widest rows of a zoom-out batch sum, times 255,
    well inside both that bound and 2^31."""
    support = get_filter("bilinear").support
    for (H, W), ohw in (((438, 906), (224, 224)), ((2160, 3840), (224, 224))):
        _, Hp, k_h, W2, k_w = tcc._geom(H, W, *ohw, support, True, 1.0)
        for k in (k_h, k_w):
            tcc._check_int32("H", k, 22)
            worst = 255 * ((1 << 22) + 4 + k // 2 + 1) + (1 << 21)
            assert worst < 0.6 * 2 ** 31
    boxes = torch.tensor([[-1.0, -1.5, 2.0, 2.5], [-3.0, -3.0, 4.0, 4.0]])
    x = torch.zeros((2, 1, 438, 906), dtype=torch.uint8)
    for tab in tcc._windowed_tables(x, boxes, (16, 16), "bilinear", True, 1.0, "pil_int8")[:2]:
        ax = tab.rows.ax
        w = tcc._row_weights(tab.rows, ax.k)
        assert int(tab.cnt.max()) > tab.w.shape[-1]
        row_sum = int(w.abs().sum(dim=2).max())
        assert row_sum <= (1 << ax.pb) + (1 << ax.pb >> 20) + ax.k // 2 + 1
        assert 255 * row_sum + (1 << (ax.pb - 1)) < 2 ** 31
