"""The port's host tables equal the JAX package's, element for element.

Both packages quantise the same float64 Pillow weights; any drift here would
change output bytes, so every comparison is exact (assert_array_equal).
"""

import dataclasses

import numpy as np
import pytest

from interpolate_antialiasing_tpu.ops import filters as jfilters
from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu.ops import weights as jw
from interpolate_antialiasing_tpu.utils import imageio as jimageio
from interpolate_antialiasing_tpu.utils import metrics as jmetrics
from interpolate_antialiasing_tpu_torch.ops import filters as tfilters
from interpolate_antialiasing_tpu_torch.ops import pil_exact as tpe
from interpolate_antialiasing_tpu_torch.ops import weights as tw
from interpolate_antialiasing_tpu_torch.utils import imageio as timageio
from interpolate_antialiasing_tpu_torch.utils import metrics as tmetrics

METHODS = tpe._PIL_AUTO_METHODS
# down, up and mixed axes, including both workloads' axes (906->224,
# 438->224 for the eval pipeline; 906->320, 438->196 for the bench batch)
# and the 4K -> HD frame
SIZES = [(906, 224), (438, 224), (906, 320), (438, 196), (3840, 1920),
         (2160, 1080), (57, 24), (33, 65)]
# fractional resize-box spans: (span, in_size, out_size)
SPANS = [((3.3, 61.7), 70, 20), ((0.25, 40.125), 50, 31)]


def _equal_tables(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_auto_methods_match():
    assert tpe._PIL_AUTO_METHODS == jpe._PIL_AUTO_METHODS
    assert tpe.PRECISION_BITS == jpe.PRECISION_BITS == 22


@pytest.mark.parametrize("in_out", SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_int_tables_and_float_tables_equal(method, in_out):
    n_in, n_out = in_out
    for pb in (22, 14):
        _equal_tables(tpe._int_tables(n_in, n_out, method, None, pb),
                      jpe._int_tables(n_in, n_out, method, None, pb))
    spec_t = tw.make_axis_spec(n_in, n_out, method)
    spec_j = jw.make_axis_spec(n_in, n_out, method)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    _equal_tables(tw.compute_tables(spec_t, np.float64),
                  jw.compute_tables(spec_j, np.float64))
    assert tpe._needs_clip(n_in, n_out, method) == jpe._needs_clip(
        n_in, n_out, method)


@pytest.mark.parametrize("span", SPANS)
@pytest.mark.parametrize("method", METHODS)
def test_box_span_tables_equal(method, span):
    sp, n_in, n_out = span
    for pb in (22, 14):
        _equal_tables(tpe._int_tables(n_in, n_out, method, sp, pb),
                      jpe._int_tables(n_in, n_out, method, sp, pb))
    spec_t = tw.make_axis_spec(n_in, n_out, method, span=sp)
    spec_j = jw.make_axis_spec(n_in, n_out, method, span=sp)
    assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
    _equal_tables(tw.compute_tables(spec_t), jw.compute_tables(spec_j))


@pytest.mark.parametrize("in_out", SIZES + [(70, 20), (10, 10), (7, 300)])
def test_nearest_indices_equal(in_out):
    n_in, n_out = in_out
    np.testing.assert_array_equal(tpe._nearest_indices(n_in, n_out),
                                  jpe._nearest_indices(n_in, n_out))


@pytest.mark.parametrize("span", SPANS)
def test_nearest_indices_box_equal(span):
    sp, n_in, n_out = span
    np.testing.assert_array_equal(tpe._nearest_indices(n_in, n_out, sp),
                                  jpe._nearest_indices(n_in, n_out, sp))


@pytest.mark.parametrize("method", METHODS)
def test_int_matrix_equal(method):
    for pb in (22, 14):
        np.testing.assert_array_equal(tpe._int_matrix(83, 31, method, None, pb),
                                      jpe._int_matrix(83, 31, method, None, pb))


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="area"),
        dict(mode="bicubic", antialias=False),  # replicate border, a=-0.75
        dict(mode="bilinear", align_corners=True),
        dict(mode="bilinear", scale_factor=0.37),
        dict(mode="lanczos5"),
    ],
    ids=["area", "replicate", "align_corners", "scale_factor", "lanczos5"],
)
def test_other_spec_tables_equal(kw):
    for n_in, n_out in [(57, 24), (33, 65)]:
        spec_t = tw.make_axis_spec(n_in, n_out, **kw)
        spec_j = jw.make_axis_spec(n_in, n_out, **kw)
        assert dataclasses.asdict(spec_t) == dataclasses.asdict(spec_j)
        _equal_tables(tw.compute_tables(spec_t), jw.compute_tables(spec_j))
        np.testing.assert_array_equal(
            tw.dense_matrix(spec_t, np.float64), jw.dense_matrix(spec_j, np.float64))


def test_filters_and_helpers_equal():
    assert tfilters.CUBIC_NAMES == jfilters.CUBIC_NAMES
    assert sorted(tfilters.FILTERS) == sorted(jfilters.FILTERS)
    xs = np.linspace(-6.0, 6.0, 4001)
    for name in tfilters.FILTERS:
        np.testing.assert_array_equal(tfilters.get_filter(name)(xs, np),
                                      jfilters.get_filter(name)(xs, np))
        assert tfilters.filter_is_nonnegative(name) == \
            jfilters.filter_is_nonnegative(name)
    assert tw.pil_box_f32(0.1, 33.3) == jw.pil_box_f32(0.1, 33.3)
    for args in [(10, 3, False), (10, 3, True), (3, 10, False), (10, 1, True)]:
        assert tw.area_pixel_compute_scale(*args) == \
            jw.area_pixel_compute_scale(*args)


def test_bad_axis_specs_raise_like_jax():
    for args, kw in [((0, 5), {}), ((5, 0), {}),
                     ((10, 5), dict(span=(4.0, 2.0))),
                     ((10, 5), dict(span=(1.0, 4.0), align_corners=True)),
                     ((10, 5), dict(mode="area", align_corners=True))]:
        with pytest.raises(ValueError) as et:
            tw.make_axis_spec(*args, **kw)
        with pytest.raises(ValueError) as ej:
            jw.make_axis_spec(*args, **kw)
        assert str(et.value) == str(ej.value)


def test_utils_copies_equal():
    np.testing.assert_array_equal(timageio.synthetic_image(),
                                  jimageio.synthetic_image())
    a = np.arange(12.0).reshape(3, 4)
    b = a + np.linspace(0, 1, 12).reshape(3, 4)
    assert tmetrics.accuracy_report(a, b, "x") == jmetrics.accuracy_report(a, b, "x")
