"""The entry points that come with the in-kernel weight slice, against the
JAX package: ``scale_and_translate`` (and the affine specs with the "zero"
border behind it), ``reduce_pil_exact`` and ``reducing_gap``, and the
mixed-size batch models (``resize_mixed_batch``, ``ShapeBucketResizer``,
``aa_pyramid``).

Tolerances: ``scale_and_translate`` within 5e-5 (absolute, on inputs in
[0, 1)), the bound of the JAX package's own tests against jax.image
(tests/test_scale_translate.py); bfloat16 within 0.02 as there.  The Pillow
routes byte for byte, against the JAX package and against Pillow.  Inputs
are made from a numpy seed and handed to both packages.
"""

import jax
import jax.image as jimage
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.models import ShapeBucketResizer as JaxBucket
from interpolate_antialiasing_tpu.models import aa_pyramid as jax_pyramid
from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu.ops import resize as jresize
from interpolate_antialiasing_tpu.ops.weights import compute_tables as jtables
from interpolate_antialiasing_tpu.ops.weights import dense_matrix as jdense
from interpolate_antialiasing_tpu.ops.weights import make_affine_axis_spec as jaffine
from interpolate_antialiasing_tpu_torch.models import (
    ShapeBucketResizer,
    aa_pyramid,
    resize_mixed_batch,
)
from interpolate_antialiasing_tpu_torch.ops import weights as tw

Image = pytest.importorskip("PIL.Image")

PIL_RESAMPLE = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
                "lanczos3": Image.LANCZOS}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny CPU ops per test (gradcheck perturbs every input); with
    several test workers on one host, torch's thread pools contend.  One
    thread per test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def jax_accel_route(monkeypatch):
    monkeypatch.setattr(jresize, "_on_tpu", lambda: True)
    monkeypatch.setattr(jpe, "_use_tpu_kernels", lambda: True)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _img_u8(shape, seed=7):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _jax_image(x, shape, dims, sc, tr, method, antialias=True):
    return np.asarray(jimage.scale_and_translate(
        jnp.asarray(x), shape, dims, jnp.asarray(sc, jnp.float32),
        jnp.asarray(tr, jnp.float32), method, antialias=antialias))


def _both(x, shape, dims, sc, tr, method, antialias=True):
    got = iat.scale_and_translate(torch.from_numpy(x), shape, dims, sc, tr, method,
                                  antialias=antialias)
    want = np.asarray(ia.scale_and_translate(jnp.asarray(x), shape, dims, sc, tr, method,
                                             antialias=antialias))
    return got, want


# ---------------------------------------------------------------------------
# The affine specs and the "zero" border
# ---------------------------------------------------------------------------

AFFINE_SPECS = [
    # (in, out, zoom, translation, mode, antialias)
    (47, 23, 0.5, 0.0, "linear", True),
    (47, 23, 0.45, 3.0, "cubic", True),
    (61, 90, 1.5, 6.0, "lanczos3", True),
    (61, 31, 0.52, -2.5, "lanczos5", True),
    (47, 23, 0.7, -30.0, "cubic", True),  # partly out of range: "zero"
    (47, 23, 0.5, 40.0, "linear", True),  # fully out of range
    (47, 23, 0.5, 1.0, "linear", False),
    (96, 48, 0.5, 0.0, "linear", True),  # full frame: the plain resize spec
]


@pytest.mark.parametrize("args", AFFINE_SPECS)
def test_affine_specs_and_zero_border_tables_equal_jax(args):
    js, ts = jaffine(*args), tw.make_affine_axis_spec(*args)
    assert (ts.border, ts.span, ts.ntaps, ts.scale, ts.support) == (
        js.border, js.span, js.ntaps, js.scale, js.support)
    for a, b in zip(tw.compute_tables(ts), jtables(js)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tw.dense_matrix(ts, dtype=np.float64),
                                  jdense(js, dtype=np.float64))
    t = tw.as_tables(ts)
    np.testing.assert_array_equal(tw.tables_matrix(t), jdense(js, dtype=np.float64))


def test_affine_spec_validation_matches_jax():
    for args in [(0, 5, 1.0, 0.0), (5, 5, 0.0, 0.0), (5, 5, -1.0, 0.0)]:
        with pytest.raises(ValueError) as et:
            tw.make_affine_axis_spec(*args)
        with pytest.raises(ValueError) as ej:
            jaffine(*args)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# scale_and_translate: tests/test_scale_translate.py's cases
# ---------------------------------------------------------------------------

CASES = [
    # (out_hw, scale, translation, method, antialias)
    ((23, 31), (0.5, 0.52), (0.0, 0.0), "linear", True),
    ((23, 31), (0.45, 0.5), (3.0, -2.5), "cubic", True),
    ((80, 90), (1.7, 1.5), (-4.0, 6.0), "lanczos3", True),
    ((23, 31), (0.33, 3.0), (0.25, -0.75), "lanczos5", True),
    ((23, 31), (0.5, 0.52), (1.0, -1.0), "linear", False),
    ((23, 31), (0.7, 0.7), (-30.0, 55.0), "cubic", True),  # partly out of range
]


@pytest.mark.parametrize("out_hw,sc,tr,method,aa", CASES)
def test_scale_and_translate_matches_jax(out_hw, sc, tr, method, aa):
    img = _rand((2, 3, 47, 61), seed=1)
    shape = (2, 3) + out_hw
    got, want = _both(img, shape, (2, 3), sc, tr, method, aa)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 5e-5
    assert np.abs(got.numpy() - _jax_image(img, shape, (2, 3), sc, tr, method, aa)).max() < 5e-5


def test_fully_out_of_range_is_zero():
    img = _rand((2, 3, 47, 61), seed=1)
    got, want = _both(img, (2, 3, 23, 31), (2, 3), (0.5, 0.5), (40.0, -40.0), "linear")
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.abs().max()) == 0.0


@pytest.mark.parametrize("sc,tr,method,aa", [
    ((-0.5, 0.5), (23.0, 0.0), "cubic", True),
    ((-0.5, -0.52), (23.5, 30.0), "lanczos3", True),
    ((-1.7, 0.5), (70.0, 0.0), "linear", False),
])
def test_negative_scale_flip(sc, tr, method, aa):
    """Negative zoom = flipped resampling, with jax's SIGNED kernel_scale
    quirk (no antialias widening for negative scale)."""
    img = _rand((2, 3, 47, 61), seed=1)
    got, want = _both(img, (2, 3, 23, 31), (2, 3), sc, tr, method, aa)
    assert np.abs(got.numpy() - want).max() < 5e-5


def test_zero_scale_is_zero():
    img = _rand((2, 3, 47, 61), seed=1)
    got, want = _both(img, (2, 3, 23, 31), (2, 3), (0.0, 0.5), (0.0, 0.0), "linear")
    assert float(got.abs().max()) == 0.0 and float(np.abs(want).max()) == 0.0


def test_tensor_params_are_the_traced_route():
    """Tensor scale/translation (JAX's traced parameters under jit) run the
    dense contraction; against the JAX package's traced route."""
    img = _rand((2, 3, 47, 61), seed=1)
    f = jax.jit(lambda v, s, t: ia.scale_and_translate(v, (2, 3, 23, 31), (2, 3), s, t,
                                                       "cubic"))
    for s, t in [((0.45, 0.5), (3.0, -2.5)), ((0.495, 0.55), (4.0, -1.5))]:
        want = np.asarray(f(jnp.asarray(img), jnp.asarray(s, jnp.float32),
                            jnp.asarray(t, jnp.float32)))
        got = iat.scale_and_translate(torch.from_numpy(img), (2, 3, 23, 31), (2, 3),
                                      torch.tensor(s), torch.tensor(t), "cubic")
        assert np.abs(got.numpy() - want).max() < 5e-5
        static = iat.scale_and_translate(torch.from_numpy(img), (2, 3, 23, 31), (2, 3),
                                         s, t, "cubic")
        assert float((static - got).abs().max()) < 5e-5


def test_one_spatial_dim():
    img = _rand((2, 3, 47, 61), seed=1)
    got, want = _both(img, (2, 3, 23, 61), (2,), [0.5], [1.5], "linear")
    assert np.abs(got.numpy() - want).max() < 5e-5


def test_three_spatial_dims():
    vol = _rand((1, 13, 17, 19), seed=2)
    sc, tr = [0.55, 0.5, 0.6], [0.5, -0.25, 1.0]
    got, want = _both(vol, (1, 7, 9, 11), (1, 2, 3), sc, tr, "linear")
    assert np.abs(got.numpy() - want).max() < 5e-5


def test_bfloat16_static_route():
    img = _rand((2, 3, 47, 61), seed=1)
    got = iat.scale_and_translate(torch.from_numpy(img).bfloat16(), (2, 3, 23, 31), (2, 3),
                                  (0.5, 0.52), (1.0, -1.0), "linear")
    assert got.dtype == torch.bfloat16
    ref = _jax_image(img, (2, 3, 23, 31), (2, 3), (0.5, 0.52), (1.0, -1.0), "linear")
    assert np.abs(got.float().numpy() - ref).max() < 0.02


def test_uint8_input_computes_in_float32():
    img = _img_u8((1, 2, 30, 40))
    got, want = _both(img, (1, 2, 15, 20), (2, 3), (0.5, 0.5), (0.0, 0.0), "linear")
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() < 5e-5 * 255


@pytest.mark.parametrize("bad", [
    dict(method="box"),
    dict(shape=(2, 3, 23)),
    dict(spatial_dims=(2, 2)),
    dict(scale=(0.5,)),
    dict(shape=(2, 4, 23, 31)),
])
def test_validation_errors_match_jax(bad):
    img = _rand((2, 3, 47, 61), seed=1)
    kw = dict(shape=(2, 3, 23, 31), spatial_dims=(2, 3), scale=(0.5, 0.5),
              translation=(0.0, 0.0), method="linear")
    kw.update(bad)
    args = (kw["shape"], kw["spatial_dims"], kw["scale"], kw["translation"], kw["method"])
    with pytest.raises(ValueError) as et:
        iat.scale_and_translate(torch.from_numpy(img), *args)
    with pytest.raises(ValueError) as ej:
        ia.scale_and_translate(jnp.asarray(img), *args)
    assert str(et.value) == str(ej.value)


def test_fuzz_random_affine_params():
    """tests/test_scale_translate.py's randomised sweep: scales in [-2, 3]
    minus a band around 0, translations in [-15, 15], all four methods."""
    rng = np.random.default_rng(1234)
    img = rng.random((1, 3, 29, 41)).astype(np.float32)
    methods = ["linear", "cubic", "lanczos3", "lanczos5"]
    for i in range(12):
        sc = tuple(float(s) for s in rng.uniform(-2.0, 3.0, 2))
        if abs(sc[0]) < 0.05 or abs(sc[1]) < 0.05:
            continue
        tr = tuple(float(t) for t in rng.uniform(-15.0, 15.0, 2))
        m = methods[i % 4]
        shape = (1, 3, int(rng.integers(5, 40)), int(rng.integers(5, 40)))
        got, want = _both(img, shape, (2, 3), sc, tr, m)
        assert np.abs(got.numpy() - want).max() < 5e-5, (sc, tr, m, shape)


# ---------------------------------------------------------------------------
# scale_and_translate gradients
# ---------------------------------------------------------------------------


def test_gradcheck_static_route():
    """f64 gradcheck and gradgradcheck through the static route (the plane
    op's exact adjoint), forward mode too."""
    x = torch.from_numpy(np.random.default_rng(3).random((1, 1, 24, 31))).requires_grad_()
    f = lambda v: iat.scale_and_translate(  # noqa: E731
        v, (1, 1, 10, 12), (2, 3), (0.42, 0.39), (1.5, -0.75), "linear")
    assert torch.autograd.gradcheck(f, (x,), check_forward_ad=True)
    assert torch.autograd.gradgradcheck(f, (x,))


def test_gradients_in_scale_and_translation_match_jax():
    """The tensor-parameter route is differentiable in the image, the scale
    and the translation: against jax.grad of the JAX package's traced
    route, in float64."""
    x = np.random.default_rng(4).random((1, 1, 24, 31))
    s0, t0 = np.array([0.42, 0.39]), np.array([1.5, -0.75])
    shape, dims = (1, 1, 10, 12), (2, 3)
    w = np.random.default_rng(5).random(shape)

    def jf(v, s, t):
        return (jax.jit(lambda a, b, c: ia.scale_and_translate(
            a, shape, dims, b, c, "cubic"))(v, s, t) * w).sum()

    want = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s0), jnp.asarray(t0))
    xt, st, tt = (torch.from_numpy(a).requires_grad_() for a in (x, s0, t0))
    y = iat.scale_and_translate(xt, shape, dims, st, tt, "cubic")
    got = torch.autograd.grad((y * torch.from_numpy(w)).sum(), (xt, st, tt))
    for g, jg in zip(got, want):
        jg = np.asarray(jg)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# reduce_pil_exact and reducing_gap: tests/test_box.py's cases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def u8img():
    return np.random.default_rng(7).integers(0, 256, (64, 97), np.uint8)


def test_reduce_pil_exact_fuzz():
    """Random shapes, factors and integer boxes (partial edge blocks
    included): byte-equal to the JAX package and to PIL.Image.reduce."""
    rng_ = np.random.default_rng(7)
    for t in range(10):
        ih, iw = int(rng_.integers(9, 70)), int(rng_.integers(9, 70))
        fx, fy = int(rng_.integers(1, 7)), int(rng_.integers(1, 7))
        img = rng_.integers(0, 256, (ih, iw, 3), dtype=np.uint8)
        if t % 2:
            x0 = int(rng_.integers(0, iw // 3)); y0 = int(rng_.integers(0, ih // 3))
            x1 = int(rng_.integers(x0 + 1, iw + 1)); y1 = int(rng_.integers(y0 + 1, ih + 1))
            box = (x0, y0, x1, y1)
        else:
            box = None
        ref = np.asarray(Image.fromarray(img).reduce((fx, fy), box=box))
        want = np.asarray(ia.reduce_pil_exact(jnp.asarray(img), (fx, fy), box=box,
                                              data_format="HWC"))
        got = iat.reduce_pil_exact(torch.from_numpy(img), (fx, fy), box=box,
                                   data_format="HWC")
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), ref)


def test_reduce_pil_exact_layouts_and_errors():
    img = _img_u8((2, 3, 31, 45))
    got = iat.reduce_pil_exact(torch.from_numpy(img), 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ia.reduce_pil_exact(jnp.asarray(img), 3)))
    for args, kw in [((img.astype(np.float32), 2), {}), ((img, 0), {}),
                     ((img, 2), dict(box=(0, 0, 46, 31)))]:
        with pytest.raises(ValueError) as et:
            iat.reduce_pil_exact(torch.from_numpy(args[0]), args[1], **kw)
        with pytest.raises(ValueError) as ej:
            ia.reduce_pil_exact(jnp.asarray(args[0]), args[1], **kw)
        assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("reducing_gap", [2.0, 3.0])
def test_reducing_gap_byte_identical(jax_accel_route, u8img, reducing_gap):
    ref = np.asarray(Image.fromarray(u8img).resize(
        (40, 30), Image.BILINEAR, reducing_gap=reducing_gap))
    got = iat.resize(torch.from_numpy(u8img), (30, 40), method="bilinear",
                     data_format="HWC", reducing_gap=reducing_gap)
    want = np.asarray(ia.resize(jnp.asarray(u8img), (30, 40), method="bilinear",
                                data_format="HWC", reducing_gap=reducing_gap))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reducing_gap_with_box_byte_identical(jax_accel_route, u8img):
    box = (1 / 3, 2 / 7, 90 + 1 / 3, 62 + 3 / 7)
    ref = np.asarray(Image.fromarray(u8img).resize(
        (24, 18), Image.BICUBIC, box=box, reducing_gap=2.0))
    got = iat.resize(torch.from_numpy(u8img), (18, 24), method="bicubic",
                     data_format="HWC", box=box, reducing_gap=2.0)
    want = np.asarray(ia.resize(jnp.asarray(u8img), (18, 24), method="bicubic",
                                data_format="HWC", box=box, reducing_gap=2.0))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "lanczos3"])
@pytest.mark.parametrize("gap", [1.0, 1.5, 2.5])
def test_reducing_gap_resize_pil_exact_chw(jax_accel_route, method, gap):
    """resize_pil_exact with reducing_gap on a CHW batch, each filter,
    against the JAX package and per plane against Pillow."""
    img = _img_u8((3, 90, 130), seed=11)
    got = iat.resize_pil_exact(torch.from_numpy(img), (20, 27), method=method,
                               reducing_gap=gap)
    want = np.asarray(ia.resize_pil_exact(jnp.asarray(img), (20, 27), method=method,
                                          reducing_gap=gap))
    np.testing.assert_array_equal(got.numpy(), want)
    for c in range(3):
        ref = Image.fromarray(img[c]).resize((27, 20), PIL_RESAMPLE[method],
                                             reducing_gap=gap)
        np.testing.assert_array_equal(got.numpy()[c], np.asarray(ref))


def test_reducing_gap_rejections_match_jax():
    x = np.zeros((3, 20, 20), np.uint8)
    for kw in [dict(reducing_gap=0.5), dict(reducing_gap=2.0, align_corners=True),
               dict(reducing_gap=2.0, backend="xla")]:
        with pytest.raises(ValueError) as et:
            iat.resize(torch.from_numpy(x), (10, 10), **kw)
        with pytest.raises(ValueError) as ej:
            ia.resize(jnp.asarray(x), (10, 10), **kw)
        assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# The mixed-size batch models: tests/test_models.py's cases
# ---------------------------------------------------------------------------


def _mixed_images():
    rng = np.random.default_rng(1234)
    return [(rng.random((3, 40 + 7 * i, 60 + 5 * (i % 3))) * 255).astype(np.uint8)
            for i in range(6)]


def test_resize_mixed_batch_matches_jax(jax_accel_route):
    images = _mixed_images()
    r = ShapeBucketResizer((32, 32), device="cpu")
    y = r(images)
    assert tuple(y.shape) == (6, 3, 32, 32) and y.dtype == torch.uint8
    want = np.asarray(JaxBucket((32, 32))(images))
    np.testing.assert_array_equal(y.numpy(), want)
    # bucketed result == resizing each image individually, in input order
    for i, im in enumerate(images):
        np.testing.assert_array_equal(y[i].numpy(),
                                      iat.resize(torch.from_numpy(im), (32, 32)).numpy())
    assert r.shapes_compiled == len({im.shape for im in images})
    np.testing.assert_array_equal(
        resize_mixed_batch(images, (32, 32), device="cpu").numpy(), want)


def test_resize_mixed_batch_hwc_and_float(jax_accel_route):
    images = [im.transpose(1, 2, 0).copy() for im in _mixed_images()[:3]]
    got = resize_mixed_batch(images, (20, 24), method="bicubic", data_format="HWC",
                             device="cpu")
    want = np.asarray(ia.models.resize_mixed_batch(images, (20, 24), method="bicubic",
                                                   data_format="HWC"))
    np.testing.assert_array_equal(got.numpy(), want)
    floats = [im.astype(np.float32) / 255.0 for im in _mixed_images()[:3]]
    got = resize_mixed_batch(floats, (20, 24), device="cpu")
    want = np.asarray(ia.models.resize_mixed_batch(floats, (20, 24)))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    with pytest.raises(ValueError, match="at least one image"):
        resize_mixed_batch([], (8, 8), device="cpu")


def test_shape_bucket_warmup(jax_accel_route):
    """warmup() runs each new shape once: new shapes count once, repeats and
    seen shapes are free, and warmed output matches the per-image resize
    and the JAX package."""
    r, jr = ShapeBucketResizer((24, 24), device="cpu"), JaxBucket((24, 24))
    shapes = [(3, 40, 60), (3, 47, 65), (3, 40, 60)]
    assert r.warmup(shapes) == jr.warmup(shapes) == 2
    assert r.shapes_compiled == 2
    assert r.warmup([(3, 40, 60)]) == 0
    im = (np.random.default_rng(1234).random((3, 47, 65)) * 255).astype(np.uint8)
    y = r([im])
    np.testing.assert_array_equal(y[0].numpy(),
                                  iat.resize(torch.from_numpy(im), (24, 24)).numpy())
    np.testing.assert_array_equal(y.numpy(), np.asarray(jr([im])))


def test_mixed_batch_runs_on_the_card_by_default(monkeypatch):
    """device=None means the CUDA card, as for the Trainer: with none, it
    raises and names device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShapeBucketResizer((8, 8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resize_mixed_batch([np.zeros((3, 8, 8), np.uint8)], (4, 4))


def test_aa_pyramid_matches_jax():
    x = _rand((1, 3, 64, 96), seed=6)
    levels = aa_pyramid(torch.from_numpy(x), 4)
    want = jax_pyramid(jnp.asarray(x), 4)
    assert [tuple(l.shape[-2:]) for l in levels] == [(64, 96), (32, 48), (16, 24), (8, 12)]
    for got, w in zip(levels, want):
        w = np.asarray(w)
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_aa_pyramid_nhwc_and_bicubic():
    x = _rand((2, 50, 70, 3), seed=8)
    levels = aa_pyramid(torch.from_numpy(x), 3, mode="bicubic", factor=3, h_axis=1,
                        w_axis=2)
    want = jax_pyramid(jnp.asarray(x), 3, mode="bicubic", factor=3, h_axis=1, w_axis=2)
    for got, w in zip(levels, want):
        w = np.asarray(w)
        assert got.shape == w.shape
        assert np.abs(got.numpy() - w).max() <= 1e-5 * np.abs(w).max()
