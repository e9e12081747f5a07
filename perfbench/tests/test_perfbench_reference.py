"""The plain reference against Pillow, against the port's CPU routes, and
its arithmetic on known cases."""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

import small_cells  # noqa: F401  (puts the repository on the path)
from perfbench import run
from perfbench.harness import traffic as gen
from perfbench.reference import crop, pillow
from perfbench.reference.normalize import levels_of, normalize

MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]
NORM = types.SimpleNamespace(mean=MEAN, std=STD)  # what the grey-level check reads of an entry
grey_levels = run.load("checks", "grey_levels")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _image(seed, shape):
    return gen.images(gen.generator(seed, "cpu"), 1, 1, shape, "cpu")[0, 0]


@pytest.mark.parametrize("hw, out", [((438, 906), (256, 529)), ((37, 53), (20, 31)),
                                     ((20, 45), (45, 20)), ((64, 64), (64, 17))])
def test_pillow_reference_is_pillow(hw, out):
    Image = pytest.importorskip("PIL.Image")
    x = _image(7, (3, *hw))
    want = np.asarray(Image.fromarray(x.permute(1, 2, 0).numpy()).resize(
        (out[1], out[0]), Image.BILINEAR)).transpose(2, 0, 1)
    got = pillow.resize(x, *out)
    assert torch.equal(got, torch.from_numpy(want.astype(np.float64)))


@pytest.mark.parametrize("hw, out", [((438, 906), (256, 529)), ((37, 53), (20, 31)),
                                     ((20, 45), (45, 20))])
def test_pillow_reference_is_the_ports_byte_exact_route(hw, out):
    from interpolate_antialiasing_tpu_torch.ops.resize import resize

    x = gen.images(gen.generator(11, "cpu"), 1, 2, (3, *hw), "cpu")[0]
    assert torch.equal(pillow.resize(x, *out), resize(x, out).to(torch.float64))


def test_kept_input_span_by_hand():
    # Resize(256) of 438 rows keeps rows 16..239: scale 438/256, support
    # 1.7109..., first tap trunc(16.5 s - s + 0.5) = 27, last end
    # trunc(239.5 s + s + 0.5) = 411
    assert pillow.kept_input_span(438, 256, 16, 224) == 411 - 27
    assert pillow.kept_input_span(906, 529, 0, 529) == 906


def test_tf32_rounding_to_nearest_even():
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + 1.5 * ulp, 1 + 0.4 * ulp, -(1 + 0.6 * ulp)],
                     dtype=torch.float32)
    want = torch.tensor([1.0, 1.0, 1 + 2 * ulp, 1.0, -(1 + ulp)], dtype=torch.float32)
    assert torch.equal(crop._to_tf32(x), want)


def test_band_rows_sum_to_one_inside_the_box():
    lo, hi = torch.tensor([10.25, 0.0]), torch.tensor([70.5, 60.0])
    w = crop.band(lo, hi, 60, 28)
    assert torch.allclose(w.sum(-1), torch.ones(2, 28, dtype=torch.float64))
    i = torch.arange(60, dtype=torch.float64)
    outside = (i + 0.5 < lo[:, None]) | (i + 0.5 > hi[:, None])
    assert (w.abs().sum(1)[outside] == 0).all()


def test_box_bytes_counts_pixel_centres():
    boxes = torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.1, 0.25, 0.5, 0.75]])
    # 10 x 8 image: the whole box, then rows with centres in [1, 5): 1..4,
    # columns in [2, 6): 2..5
    assert crop.box_bytes(boxes, 10, 8, 3) == 3 * (80 + 4 * 4)


def _crop_inputs(seed, n=3, hw=(60, 124)):
    g = gen.generator(seed, "cpu")
    x = gen.images(g, 1, n, (3, *hw), "cpu")[0]
    boxes = gen.resized_crop_boxes(g, n, *hw, (0.08, 1.0), (0.75, 4 / 3), "cpu")
    return x, boxes


def test_dense_reference_is_the_ports_dense_route_to_rounding():
    from interpolate_antialiasing_tpu_torch.ops.crop import crop_and_resize

    x, boxes = _crop_inputs(3)
    flip = torch.tensor([True, False, True])
    got = crop_and_resize(x, boxes, (28, 28), flip=flip).to(torch.float64)
    want = crop.crop_dense(x, boxes, 28, 28, flip)
    assert (got - want).abs().max() <= 1
    assert (got != want).to(torch.float64).mean() < 0.01


def test_windowed_reference_is_the_ports_route_given_its_weights():
    """With the port's own integer weights the reference's two passes give
    its bytes exactly; the weights themselves differ by at most one unit
    (float32 box geometry against float64)."""
    from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
    from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, crop_and_resize

    x, boxes = _crop_inputs(5, hw=(120, 250))
    H, W = x.shape[-2:]
    fr = box_fracs(H, W)
    got = crop_and_resize(x, boxes, (56, 56), max_box_frac=fr).to(torch.float64)
    tab_h, tab_w, pb_h, pb_w = cc._windowed_tables(x, boxes, (56, 56), "bilinear", True,
                                                   fr, "pil_int8")

    def dense(tab, n_in):
        m = torch.zeros(*tab.w.shape[:2], n_in, dtype=torch.float64)
        for j in range(tab.w.shape[-1]):
            live = j < tab.cnt.long()
            idx = (tab.first.long() + j).clamp(max=n_in - 1)
            m.scatter_add_(2, idx[..., None],
                           torch.where(live, tab.w[..., j].double(), 0.0)[..., None])
        return m

    kh, kw = dense(tab_h, H), dense(tab_w, W)
    inter = crop._lattice(kh[:, None] @ x.to(torch.float64), pb_h)
    assert torch.equal(crop._lattice(inter @ kw.transpose(1, 2)[:, None], pb_w), got)
    wh, ww = crop._bands(boxes, H, W, 56, 56, "bilinear")
    assert (crop._fixed(wh, pb_h) - kh).abs().max() <= 1
    assert (crop._fixed(ww, pb_w) - kw).abs().max() <= 1
    want = crop.crop_windowed(x, boxes, 56, 56, pb_h, pb_w)
    assert (got - want).abs().max() <= 1


@pytest.mark.parametrize("route", ["dense", "windowed"])
def test_a_pixel_centre_on_a_box_edge_counts_in_or_out(route):
    """The box's bottom edge is 303.49999 pixels, 303.5 in float32: the
    port takes the centre 303.5 in, the exact reading leaves it out."""
    from interpolate_antialiasing_tpu_torch.ops.crop import crop_and_resize

    x = gen.images(gen.generator(3, "cpu"), 1, 1, (3, 438, 120), "cpu")[0]
    boxes = torch.tensor([[0.55, 0.2, 0.6929223537445068, 0.5]], dtype=torch.float32)
    assert crop.on_edge(boxes, 438, 120) and not crop.on_edge(boxes - 0.01, 438, 120)
    flip = torch.tensor([True]) if route == "dense" else None
    got = crop_and_resize(x, boxes, (56, 56), flip=flip, use_windowed=flip is None)
    out = normalize(got.to(torch.float64), MEAN, STD, torch.float32)

    def ref(side):
        if flip is not None:
            return crop.crop_dense(x, boxes, 56, 56, flip, side=side)
        return crop.crop_windowed(x, boxes, 56, 56, 14, 14, side=side)

    assert grey_levels.compare(out, ref(0), NORM)["level_gap"] > 1
    assert torch.equal(ref(-1), ref(0)) or torch.equal(ref(1), ref(0))
    assert grey_levels.compare(out, torch.stack([ref(-1), ref(1)]), NORM)["level_gap"] <= 1


def test_normalise_and_back():
    lv = torch.arange(256, dtype=torch.float64).reshape(1, 1, 16, 16).expand(1, 3, 16, 16)
    out = normalize(lv, MEAN, STD, torch.float32)
    assert torch.equal(levels_of(out, MEAN, STD), lv)


def test_compare_reads_rounding_only_where_exact():
    lv = torch.randint(0, 256, (2, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    lv = lv.to(torch.float64)
    r = grey_levels.compare(normalize(lv, MEAN, STD, torch.float32), lv, NORM)
    assert r["mismatch_pct"] == 0.0 and r["level_gap"] == 0.0 and 0 < r["norm_gap"] < 1e-6
    moved = lv.clone()
    moved[1, 0, 0, 0] = (moved[1, 0, 0, 0] + 1) % 256
    r = grey_levels.compare(normalize(moved, MEAN, STD, torch.float32), lv, NORM)
    assert r["mismatch_pct"] == pytest.approx(100 / (3 * 64))
    assert r["level_gap"] == (255.0 if lv[1, 0, 0, 0] == 255 else 1.0)
    nan = normalize(lv, MEAN, STD, torch.float32)
    nan[0, 0, 0, 0] = float("nan")
    assert grey_levels.compare(nan, lv, NORM)["mismatch_pct"] > 0
    assert grey_levels.compare(nan, lv, NORM)["level_gap"] == float("inf")
    assert grey_levels.compare(nan[:1], lv, NORM)["mismatch_pct"] == 100.0
    two = torch.stack([lv, moved])
    r = grey_levels.compare(normalize(moved, MEAN, STD, torch.float32), two, NORM)
    assert r["mismatch_pct"] == 0.0 and r["level_gap"] == 0.0
    assert grey_levels.compare(normalize(lv[0], MEAN, STD, torch.float32), lv,
                               NORM)["mismatch_pct"] == 100.0
