"""The float32-intermediate crop route (``ops/crop_cuda.py::
crop_and_resize_f32``: the table kernel's float32 tables over windows of the
whole axis, the flip folded into the W tables, an H pass into a float32
intermediate, a W pass rounded once) through its plain versions, which a
CPU tensor runs and which the card matches bit for bit
(``tests/test_torch_port_cuda.py``).  The CPU's ``crop_and_resize`` keeps
the dense route for flipped calls, so these tests reach the route through
its private entry.

Against the dense route (``crop_and_resize(use_windowed=False)``, the same
float32 arithmetic summed in another order over dense rows): at most one
grey level apart, and under 0.1% of the elements; a flip is the exact
mirror of the unflipped output; and boxes wider than ``max_box_frac`` or
than the image stay within one level, where the windowed route, which
renormalises over a truncated window, is far off.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as tcc
from interpolate_antialiasing_tpu_torch.ops.crop import sample_boxes

METHODS = ["bilinear", "hamming", "box"]
SHAPES = [((4, 3, 57, 91), (24, 31)), ((6, 2, 120, 200), (64, 48))]
SHAPE_IDS = ["57x91", "120x200"]
# boxes past the bound, and past the image (rows with more taps than T):
# at 64x906 -> 16x224 the windowed route's windows at max_box_frac 0.3 cut
# the full-width box's rows
WIDE = torch.tensor([[0.0, 0.0, 1.0, 1.0], [-0.4, -0.6, 1.5, 1.7], [-1.0, -1.5, 2.0, 2.5]])
WIDE_SHAPE, WIDE_OHW = (3, 2, 64, 906), (16, 224)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _call(shape, seed):
    """``(x, boxes, flip)``: uniform uint8, RandomResizedCrop boxes and
    flips holding both values, from ``seed``."""
    N, _, H, W = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
    boxes = sample_boxes(g, N, H, W)
    flip = torch.rand(N, generator=g) < 0.5
    flip[:2] = torch.tensor([True, False])
    return x, boxes, flip


def _mirrored(y, flip):
    return torch.where(flip[:, None, None, None], y.flip(-1), y)


@pytest.mark.parametrize("shape,ohw", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("method", METHODS)
def test_f32_route_within_one_level_of_the_dense_route(method, shape, ohw):
    x, b, flip = _call(shape, 11)
    y = tcc.crop_and_resize_f32(x, b, ohw, method, flip=flip)
    dense = iat.crop_and_resize(x, b, ohw, method, use_windowed=False, flip=flip)
    assert y.dtype == torch.uint8 and y.shape == dense.shape
    diff = (y.int() - dense.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).double().mean()) < 1e-3


@pytest.mark.parametrize("shape,ohw", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("method", METHODS)
def test_f32_route_flip_is_the_exact_mirror(method, shape, ohw):
    x, b, flip = _call(shape, 12)
    y = tcc.crop_and_resize_f32(x, b, ohw, method, flip=flip)
    assert torch.equal(y, _mirrored(tcc.crop_and_resize_f32(x, b, ohw, method), flip))


@pytest.mark.parametrize("method", METHODS)
def test_f32_route_never_truncates_a_window(method):
    """A full-width box (past ``max_box_frac``) and two boxes wider than
    the image (rows past T, one mirrored) match the dense route within one
    level; the windowed route at ``max_box_frac`` 0.3 renormalises the same
    calls over truncated windows and misses by many levels."""
    x = torch.randint(0, 256, WIDE_SHAPE, generator=torch.Generator().manual_seed(9),
                      dtype=torch.uint8)
    flip = torch.tensor([True, False, True])
    tables = tcc._f32_tables(x, WIDE, WIDE_OHW, method, flip)
    assert int(tables[1].cnt.max()) > tables[1].w.shape[-1]
    y = tcc.crop_and_resize_f32(x, WIDE, WIDE_OHW, method, flip=flip)
    dense = iat.crop_and_resize(x, WIDE, WIDE_OHW, method, use_windowed=False, flip=flip)
    assert int((y.int() - dense.int()).abs().max()) <= 1
    cut = _mirrored(tcc.crop_and_resize_windowed(x, WIDE, WIDE_OHW, method, max_box_frac=0.3,
                                                 precision="split"), flip)
    assert int((cut.int() - dense.int()).abs().max()) > 10


@pytest.mark.parametrize("shape,ohw", SHAPES, ids=SHAPE_IDS)
def test_f32_tables_cover_the_whole_axis_and_fold_the_flip(shape, ohw):
    """Float32 weights over one window of the whole padded axis (start 0),
    the tap bound of the windowed tables; the W tables of a flipped image
    are its unflipped rows in reverse order, bit for bit, and the H tables
    do not move."""
    x, b, flip = _call(shape, 13)
    got = tcc._f32_tables(x, b, ohw, "bilinear", flip)
    plain = tcc._f32_tables(x, b, ohw, "bilinear", None)
    windowed = tcc._windowed_tables(x, b, ohw, "bilinear", True, 1.0, "split")
    assert got[2:] == (None, None)
    for tab, ref in zip(got[:2], windowed[:2]):
        ax = tab.rows.ax
        assert (ax.k, ax.pb, tcc._hi_start(ax)) == (ax.in_limit, None, 0)
        assert tab.w.dtype == torch.float32 and tab.w.shape == ref.w.shape
    for f in ("first", "cnt", "w"):
        assert torch.equal(getattr(got[0], f), getattr(plain[0], f))
        want = tcc._mirror(getattr(plain[1], f), flip)
        assert torch.equal(getattr(got[1], f).view(torch.int32), want.view(torch.int32))


def test_cpu_flipped_calls_stay_on_the_dense_route(monkeypatch):
    """On the CPU a flipped uint8 call keeps the dense route (byte-equal to
    the JAX package's), whatever ``use_windowed`` asks."""

    def refuse(*a, **k):
        raise AssertionError("the float32-intermediate route ran on the CPU")

    monkeypatch.setattr(tcc, "crop_and_resize_f32", refuse)
    x, b, flip = _call(SHAPES[0][0], 14)
    dense = iat.crop_and_resize(x, b, SHAPES[0][1], use_windowed=False, flip=flip)
    for kw in ({}, dict(use_windowed=True)):
        assert torch.equal(iat.crop_and_resize(x, b, SHAPES[0][1], flip=flip, **kw), dense)


def test_f32_route_admission():
    x = torch.zeros((1, 3, 8, 8), dtype=torch.uint8)
    assert tcc.crop_f32_supported(x, "bilinear", True)
    assert tcc.crop_f32_supported(x, "box", True)
    assert tcc.crop_f32_supported(x, "hamming", True)
    assert not tcc.crop_f32_supported(x, "bilinear", False)
    assert not tcc.crop_f32_supported(x, "bicubic", True)
    assert not tcc.crop_f32_supported(x, "lanczos3", True)
    assert not tcc.crop_f32_supported(x.float(), "bilinear", True)
    assert not tcc.crop_f32_supported(x[0], "bilinear", True)
    with pytest.raises(ValueError, match="flip"):
        tcc.crop_and_resize_f32(x, torch.zeros((1, 4)), (4, 4),
                                flip=torch.zeros(2, dtype=torch.bool))


def test_f32_route_emits_its_own_spans():
    """The route's op and table spans, named apart from the windowed and
    dense routes' (``host_tables_us`` reads ``ia.tables.*`` by prefix)."""
    x, b, flip = _call(SHAPES[0][0], 15)
    tcc.crop_and_resize_f32(x, b, SHAPES[0][1], flip=flip)  # geometry built outside
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tcc.crop_and_resize_f32(x, b, SHAPES[0][1], flip=flip)
    names = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if e.name.startswith("ia.")]
    assert names == ["ia.ops.crop_f32", "ia.tables.crop_f32"]
