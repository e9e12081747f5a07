"""The port's float route against the JAX package: the two-pass resample2d
kernel's plain version (what a CPU tensor runs), and the public entries that
reach it (``resize``, ``resize_plane``, ``image_resize``,
``VideoDownscaler``, the float32-domain ``ImageNetEvalPipeline``).

Two references, with the tolerances they admit:

* the JAX package's XLA route (``resize_axis_dense``, ``backend="dense"``):
  float32 max abs error <= 1e-5 * max|ref|, uint8 <= 1, bfloat16 <=
  2^-7 * max|ref| (one bfloat16 rounding of the output);
* its accelerator kernels, in Pallas interpret mode
  (``resize2d_onekernel`` / ``resize2d_streamed`` on the shapes of
  tests/test_resize2d_fused.py's ONEK_CASES / STREAM_CASES, and the public
  routes with ``_on_tpu`` patched to True): at the tolerances of the JAX
  package's own tests of those kernels (test_resize2d_fused.py:122-130,
  :188-196), which cover its split-bf16 matrix-unit arithmetic.

Inputs are made from a numpy seed and handed to both packages.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.models import ImageNetEvalPipeline as JaxPipeline
from interpolate_antialiasing_tpu.models import VideoDownscaler as JaxVideo
from interpolate_antialiasing_tpu.ops import pallas_resize as jpr
from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu.ops import resize as jresize
from interpolate_antialiasing_tpu.ops.resize_xla import resize_axis_dense
from interpolate_antialiasing_tpu.ops.weights import make_axis_spec as jspec
from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.config import default_precision
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops import resize as tresize
from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec as tspec

TDT = {"uint8": torch.uint8, "float32": torch.float32, "bfloat16": torch.bfloat16}

# tests/test_resize2d_fused.py's shapes: (shape, (oh, ow), mode, in, out)
ONEK_CASES = [
    ((2, 3, 438, 906), (196, 320), "bilinear", "uint8", "uint8"),
    ((2, 3, 438, 906), (196, 320), "bicubic", "uint8", "float32"),
    ((1, 3, 100, 150), (250, 75), "bilinear", "float32", "float32"),
    ((2, 130, 140), (64, 72), "lanczos3", "float32", "float32"),
    ((5, 97, 131), (40, 1200), "bilinear", "float32", "float32"),
    ((2, 3, 96, 128), (96, 128), "box", "uint8", "uint8"),
    ((1, 64, 64), (130, 260), "bicubic", "uint8", "uint8"),
]
STREAM_CASES = [
    ((2, 216, 384), (108, 192), "bilinear", "float32", "float32"),
    ((1, 216, 384), (108, 192), "bilinear", "bfloat16", "bfloat16"),
    ((1, 440, 1024), (196, 320), "bilinear", "uint8", "uint8"),
    ((3, 256, 512), (700, 300), "bicubic", "float32", "float32"),
    ((1, 64, 256), (320, 96), "lanczos3", "float32", "float32"),
    ((1, 219, 391), (108, 192), "bilinear", "float32", "float32"),
    ((1, 438, 906), (196, 320), "bilinear", "uint8", "uint8"),
    ((2, 301, 400), (150, 333), "bicubic", "float32", "float32"),
    ((1, 64, 256), (130, 512), "bicubic", "uint8", "uint8"),
    ((1, 215, 250), (430, 125), "bilinear", "bfloat16", "bfloat16"),
]
PAIRS = [(i, o) for i in TDT for o in TDT]


@pytest.fixture()
def jax_accel_route(monkeypatch):
    monkeypatch.setattr(jresize, "_on_tpu", lambda: True)
    monkeypatch.setattr(jpe, "_use_tpu_kernels", lambda: True)


def _pair(shape, dt, scale=255.0, seed=0):
    """The same seeded input as a JAX array and a CPU tensor of dtype dt."""
    xf = np.random.default_rng(seed).random(shape).astype(np.float32) * scale
    if dt == "uint8":
        xf = xf.astype(np.uint8)
    return jnp.asarray(xf).astype(dt), torch.from_numpy(xf).to(TDT[dt])


def _np(y):
    """A JAX array or a tensor as a float64 numpy array."""
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(y.astype(jnp.float32)).astype(np.float64)


def _jax_dense2d(xj, spec_h, spec_w, odt):
    """The JAX package's XLA route for a trailing [H, W] plane: dense W pass,
    then H pass; uint8 -> uint8 rounds the intermediate to the uint8 lattice
    as Pillow does (the oracle of test_resize2d_fused.py::_dense2d_u8)."""
    t = resize_axis_dense(xj.astype(jnp.float32), spec_w, xj.ndim - 1)
    if xj.dtype == jnp.uint8 and odt == "uint8":
        t = jnp.clip(jnp.floor(t + 0.5), 0, 255)
    return resize_axis_dense(t, spec_h, xj.ndim - 2)


def _assert_vs_xla(got, ref, odt):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    if odt == "uint8":
        ref = np.clip(np.floor(ref + 0.5), 0, 255)
        assert np.abs(got - ref).max() <= 1
    elif odt == "bfloat16":
        assert np.abs(got - ref).max() <= 2**-7 * np.abs(ref).max()
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# resample2d's plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,ohw,mode,idt,odt", ONEK_CASES + STREAM_CASES)
def test_resample2d_plain_matches_xla_route(shape, ohw, mode, idt, odt):
    xj, xt = _pair(shape, idt)
    sh, sw = tspec(shape[-2], ohw[0], mode), tspec(shape[-1], ohw[1], mode)
    got = cr.resize2d(xt, sh, sw, out_dtype=TDT[odt])
    assert got.dtype == TDT[odt] and tuple(got.shape) == (*shape[:-2], *ohw)
    ref = _jax_dense2d(xj, jspec(shape[-2], ohw[0], mode),
                       jspec(shape[-1], ohw[1], mode), odt)
    _assert_vs_xla(got, ref, odt)


@pytest.mark.parametrize("idt,odt", PAIRS)
@pytest.mark.parametrize("mode,kw", [("bicubic", {}), ("lanczos3", {}),
                                     ("hamming", {}), ("area", {}),
                                     ("bicubic", dict(antialias=False)),
                                     ("bilinear", dict(align_corners=True))])
def test_resample2d_plain_dtype_pairs_and_modes(idt, odt, mode, kw):
    shape, ohw = (2, 37, 53), (24, 71)  # H down, W up
    xj, xt = _pair(shape, idt, seed=5)
    sh, sw = (tspec(n, o, mode, **kw) for n, o in zip(shape[1:], ohw))
    jh, jw = (jspec(n, o, mode, **kw) for n, o in zip(shape[1:], ohw))
    got = cr.resize2d(xt, sh, sw, out_dtype=TDT[odt])
    _assert_vs_xla(got, _jax_dense2d(xj, jh, jw, odt), odt)


@pytest.mark.parametrize("shape,ohw,mode,idt,odt", ONEK_CASES)
def test_resample2d_plain_matches_jax_onekernel(shape, ohw, mode, idt, odt):
    xj, xt = _pair(shape, idt, scale=255.0 if idt == "uint8" else 1.0)
    jh, jw = jspec(shape[-2], ohw[0], mode), jspec(shape[-1], ohw[1], mode)
    assert jpr.resize2d_onekernel_supported(xj, jh, jw)
    want = _np(jpr.resize2d_onekernel(xj, jh, jw, out_dtype=odt))
    got = _np(cr.resize2d(xt, tspec(shape[-2], ohw[0], mode),
                          tspec(shape[-1], ohw[1], mode), TDT[odt]))
    err = np.abs(got - want).max()
    if odt == "uint8":
        assert err <= 1.0, err
    else:
        scale = np.abs(want).max() + 1e-6
        assert err <= (255.0 if idt == "uint8" else 1.0) * 2e-4 + 1e-3 * scale, err


@pytest.mark.parametrize("shape,ohw,mode,idt,odt", STREAM_CASES)
def test_resample2d_plain_matches_jax_streamed(shape, ohw, mode, idt, odt):
    xj, xt = _pair(shape, idt)
    jh, jw = jspec(shape[-2], ohw[0], mode), jspec(shape[-1], ohw[1], mode)
    inter = jnp.bfloat16 if idt == "bfloat16" else jnp.float32
    assert jpr.resize2d_streamed_supported(xj, jh, jw, odt, inter_dtype=inter)
    want = _np(jpr.resize2d_streamed(xj, jh, jw, out_dtype=odt, inter_dtype=inter))
    got = _np(cr.resize2d(xt, tspec(shape[-2], ohw[0], mode),
                          tspec(shape[-1], ohw[1], mode), TDT[odt]))
    err = np.abs(got - want).max()
    if odt == "uint8":
        assert err <= 1.0, err
    elif idt == "bfloat16":
        assert err <= 255 * 2**-7, err
    else:
        assert err <= 0.01, err


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,size,kw,dt",
    [((1, 3, 438, 906), (196, 320), dict(method="bilinear"), "float32"),
     ((1, 3, 438, 906), (196, 320), dict(method="bicubic"), "float32"),
     ((1, 438, 906, 3), (196, 320), dict(method="bilinear", data_format="NHWC"),
      "float32"),
     ((1, 438, 906, 3), (196, 320), dict(method="bicubic", data_format="NHWC"),
      "float32"),
     ((2, 3, 216, 384), (108, 192), dict(method="bilinear"), "bfloat16"),
     ((2, 3, 60, 90), (30, 41),
      dict(method="lanczos3", box=(3.5, 2.0, 80.0, 55.25)), "float32")],
    ids=["f32_bilinear", "f32_bicubic", "f32_nhwc_bilinear", "f32_nhwc_bicubic",
         "bf16", "f32_box"],
)
def test_resize_float_matches_jax_routes(jax_accel_route, shape, size, kw, dt):
    """The headline configs (BASELINE 1-2: f32 438x906 -> 196x320, both
    layouts) and bf16 through the port's auto route, against the JAX
    package's XLA route and its accelerator route."""
    xj, xt = _pair(shape, dt)
    got = iat.resize(xt, size, **kw)
    assert got.dtype == TDT[dt]
    _assert_vs_xla(got, ia.resize(xj, size, backend="dense", **kw), dt)
    accel = _np(ia.resize(xj, size, **kw))
    tol = 2e-2 if dt == "bfloat16" else 1e-3  # test_resize2d_fused.py:63
    assert np.abs(_np(got) - accel).max() <= tol * np.abs(accel).max()


@pytest.mark.parametrize(
    "shape,kw",
    [((2, 3, 40, 60), dict(method="area")),
     ((2, 3, 40, 60), dict(method="lanczos5")),
     ((2, 3, 40, 60), dict(antialias=False, method="bicubic")),
     ((2, 3, 40, 60), dict(align_corners=True)),
     ((2, 3, 40, 60), dict(scale_factors=(0.5, 0.5))),
     ((2, 3, 40, 60), dict(output_dtype="float32")),
     ((2, 3, 40, 60), dict(output_dtype="bfloat16", method="hamming")),
     ((2, 40, 60, 3), dict(data_format="NHWC", method="area")),
     ((40, 60, 3), dict(data_format="HWC", output_dtype="float32")),
     ((2, 3, 40, 60), dict(backend="pallas", method="bicubic")),
     ((3, 40, 60), dict(box=(1.5, 2.0, 50.0, 33.0), output_dtype="float32"))],
    ids=["area", "lanczos5", "no_antialias", "align_corners", "scale_factors",
         "float_out", "bf16_out", "nhwc_area", "hwc_float_out", "pallas",
         "box_float_out"],
)
def test_resize_uint8_kernel_routes_match_jax(jax_accel_route, shape, kw):
    """uint8 calls that are not promoted to the Pillow route run the
    two-pass kernel with in-kernel decode/encode, as on the JAX package's
    accelerator (resize.py:642-716)."""
    xj, xt = _pair(shape, "uint8", seed=9)
    odt = kw.get("output_dtype", "uint8")
    tkw = dict(kw, output_dtype=TDT[odt]) if "output_dtype" in kw else kw
    got = iat.resize(xt, (20, 30), **tkw)
    assert got.dtype == TDT[odt]
    want = _np(ia.resize(xj, (20, 30), **kw))
    err = np.abs(_np(got) - want).max()
    if odt == "uint8":
        assert err <= 1, err
    elif odt == "bfloat16":
        assert err <= 2**-7 * np.abs(want).max(), err
    else:  # test_resize2d_fused.py:130
        assert err <= 255 * 2e-4 + 1e-3 * np.abs(want).max(), err


def test_resize_plane_and_image_resize_match_jax():
    xj, xt = _pair((2, 3, 50, 70), "float32", scale=1.0, seed=2)
    for kw in [dict(mode="bicubic"), dict(mode="bilinear", antialias=False),
               dict(mode="lanczos3", scale_factors=(0.45, 0.6))]:
        size = (23, 42) if "scale_factors" not in kw else (22, 42)
        got = iat.resize_plane(xt, size, 2, 3, **kw)
        _assert_vs_xla(got, ia.resize_plane(xj, size, 2, 3, backend="dense", **kw),
                       "float32")
    # a non-trailing plane runs the per-axis kernel
    got = iat.resize_plane(xt, (23, 2), 2, 1, mode="bicubic")
    _assert_vs_xla(got, ia.resize_plane(xj, (23, 2), 2, 1, mode="bicubic",
                                        backend="dense"), "float32")
    for shape in [(2, 3, 25, 35), (2, 3, 50, 35), (1, 3, 25, 70)]:
        for method in ["linear", "cubic", "lanczos3"]:
            _assert_vs_xla(iat.image_resize(xt, shape, method),
                           ia.image_resize(xj, shape, method), "float32")


def test_video_downscaler_matches_jax():
    """BASELINE config 5's module at a small frame: bf16 in and out."""
    xj, xt = _pair((2, 3, 216, 384), "bfloat16", scale=1.0, seed=4)
    got = iat.VideoDownscaler(out_hw=(108, 192))(xt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 3, 108, 192)
    _assert_vs_xla(got, JaxVideo(out_hw=(108, 192), backend="dense")(xj),
                   "bfloat16")
    assert len(list(iat.VideoDownscaler().parameters())) == 0


@pytest.mark.parametrize("short_side", [None, 64])
def test_eval_pipeline_float32_domain_matches_jax(short_side):
    x = np.random.default_rng(3).integers(0, 256, (2, 3, 100, 150), dtype=np.uint8)
    kw = dict(size=(56, 56), resize_domain="float32", short_side=short_side)
    got = iat.ImageNetEvalPipeline(**kw)(torch.from_numpy(x))
    want = np.asarray(JaxPipeline(**kw)(jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == torch.float32
    # resize to 1e-5 relative of 255, then /255, -mean, /std (std >= 0.224)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# Gradients, host plan, routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "entry",
    ["resize", "resize_dense", "resize_plane", "resize_nd", "interpolate",
     "image_resize", "video_downscaler"],
)
def test_requires_grad_is_refused(entry):
    """An input that requires grad is no longer refused: every public float
    entry is differentiable, and its gradient equals ``jax.vjp`` of the JAX
    package's entry on the same input and cotangent (float64 to 1e-12,
    float32 to 1e-5 * max; ``VideoDownscaler`` computes in bfloat16, so
    within one bfloat16 rounding, 2^-7 * max).  Under ``no_grad`` the
    output carries no grad_fn and is the same."""
    port, ref = {
        "resize": (lambda m, x: m.resize(x, (10, 12)), None),
        "resize_dense": (lambda m, x: m.resize(x, (10, 12), backend="dense"), None),
        "resize_plane": (lambda m, x: m.resize_plane(x, (10, 12), 2, 3), None),
        "resize_nd": (lambda m, x: m.resize_nd(x, (10,), (2,)), None),
        "interpolate": (lambda m, x: m.interpolate(x, size=(10, 12)), None),
        "image_resize": (lambda m, x: m.image_resize(x, (1, 2, 10, 12)), None),
        "video_downscaler": (lambda m, x: iat.VideoDownscaler((10, 12))(x),
                             lambda x: JaxVideo((10, 12))(x)),
    }[entry]
    ref = ref or (lambda x: port(ia, x))
    dtypes = ["float32"] if entry == "video_downscaler" else ["float64", "float32"]
    for dt in dtypes:
        rng = np.random.default_rng(12)
        xn = rng.random((1, 2, 20, 24)).astype(dt)
        x = torch.from_numpy(xn).requires_grad_()
        y = port(iat, x)
        ct = rng.random(tuple(y.shape)).astype(np.float32)
        gx, = torch.autograd.grad(y, x, torch.from_numpy(ct).to(y.dtype))
        assert gx.dtype == x.dtype and gx.shape == x.shape
        yj, vjp = jax.vjp(ref, jnp.asarray(xn))
        want = np.asarray(vjp(jnp.asarray(ct).astype(yj.dtype))[0], np.float64)
        err = np.abs(gx.numpy().astype(np.float64) - want).max()
        peak = np.abs(want).max()
        tol = {"float64": 1e-12, "float32": 1e-5 * peak}[dt]
        if entry == "video_downscaler":
            tol = 2.0**-7 * peak
        assert err <= tol, (dt, err)
        with torch.no_grad():
            y0 = port(iat, x)
        assert y0.grad_fn is None and torch.equal(y0, y.detach())


def _assert_plan_covers(plan, spec_h, spec_w, itemsize):
    """The plan's invariants: every tap of every output row lies in its row
    tile's window, every tap of every output column in its column tile's
    span; the chunk ring covers the window; the block's bytes are the
    kernel's layout and fit the per-block budget."""
    for spec, tile, cap in ((spec_h, plan.tile_r, plan.rows_cap),
                            (spec_w, plan.tile_c, plan.cols_cap)):
        first, w = plans.tables(spec)
        taps = np.clip(first[:, None].astype(np.int64) + np.arange(w.shape[1]),
                       0, spec.in_size - 1)
        for t in range(-(-spec.out_size // tile)):
            r = taps[t * tile:(t + 1) * tile]
            assert r.max() - r.min() + 1 <= cap
    assert plan.tile_c in plans.TILE_C and plan.tile_r in plans._TILE_R
    assert 1 <= plan.chunk <= plan.rows_cap
    assert -(-plan.rows_cap // plan.chunk) * plan.chunk >= plan.rows_cap
    ntw, nth = plans.tables(spec_w)[1].shape[1], plans.tables(spec_h)[1].shape[1]
    assert plan.smem == plans._smem_bytes(plan.tile_r, plan.tile_c, plan.rows_cap,
                                          plan.cols_cap, plan.chunk, ntw, nth, itemsize)
    # the ring's stages (one where a chunk is the whole window, else two)
    # hold chunk rows of the widest span, 16-byte head and tail included,
    # inside the block's bytes
    stride = -(-plan.cols_cap * itemsize // 16) * 16 + 32
    stages = 1 if plan.chunk == plan.rows_cap else 2
    assert stride >= plan.cols_cap * itemsize + 30
    assert stages * plan.chunk * stride + 4 * plan.rows_cap * plan.tile_c <= plan.smem
    assert plan.smem <= plans._SMEM_BUDGET < plans._SMEM_LIMIT


def test_plan_narrows_columns_for_an_extreme_downscale():
    # 2160 -> 8 lanczos3 reads ~1,600 input rows per output row
    spec, spec_w = tspec(2160, 8, "lanczos3"), tspec(96, 48, "lanczos3")
    plan = plans.plan2d(spec, spec_w)
    assert plan.tile_c < 64
    _assert_plan_covers(plan, spec, spec_w, 4)
    # and along W: the span of 2160 columns is staged through the ring
    plan = plans.plan2d(spec_w, spec)
    assert plan.cols_cap == 2160
    _assert_plan_covers(plan, spec_w, spec, 4)
    for sh, sw in [(tspec(2160, 1080, "bilinear"), tspec(3840, 1920, "bilinear")),
                   (tspec(438, 196, "bicubic"), tspec(906, 320, "bicubic")),
                   (tspec(33, 65, "bicubic"), tspec(17, 5, "area")),
                   (tspec(40, 7, "area"), tspec(23, 1, "bilinear"))]:
        for itemsize in (1, 2, 4):
            _assert_plan_covers(plans.plan2d(sh, sw, itemsize), sh, sw, itemsize)


def _smallest_block(spec_h, spec_w, itemsize):
    """The least shared memory any tile of the plan could take: one output
    row, the narrowest column tile, a ring of one row."""
    (fh, wh), (fw, ww) = plans.tables(spec_h), plans.tables(spec_w)
    return min(plans._smem_bytes(1, c, plans.window(fh, wh.shape[1], spec_h.in_size, 1),
                                 plans.window(fw, ww.shape[1], spec_w.in_size, c), 1,
                                 ww.shape[1], wh.shape[1], itemsize) for c in plans.TILE_C)


def test_plan_gives_up_only_when_no_tile_fits(monkeypatch):
    # a window of ~4,000 rows of 16 float32 columns does not fit in 227 KB;
    # ~3,000 does (the old one-column tiles took windows up to ~58,000 rows;
    # the kernel's narrowest tile is now 16 columns)
    sw = tspec(4, 4, "box")
    for n_in, fits in [(3000, True), (4000, False), (50000, False), (70000, False)]:
        sh = tspec(n_in, 1, "box")
        assert (plans.plan2d(sh, sw) is not None) == fits
        assert fits == (_smallest_block(sh, sw, 4) <= plans._SMEM_BUDGET)
    # where the plan gives up, resize2d runs two resample_axis passes
    calls = []
    real = cr.resize_axis
    monkeypatch.setattr(plans, "plan2d", lambda *a: None)
    monkeypatch.setattr(cr, "resize_axis",
                        lambda *a, **k: calls.append(a[2:]) or real(*a, **k))
    for idt, odt, inter in [("uint8", "uint8", torch.uint8),
                            ("uint8", "float32", torch.float32),
                            ("bfloat16", "bfloat16", torch.float32)]:
        calls.clear()
        xj, xt = _pair((2, 30, 41), idt, seed=1)
        sh, sw = tspec(30, 17, "bicubic"), tspec(41, 60, "bicubic")
        got = cr.resize2d(xt, sh, sw, TDT[odt])
        assert calls == [(-1, inter), (-2, TDT[odt])]
        _assert_vs_xla(got, _jax_dense2d(xj, jspec(30, 17, "bicubic"),
                                         jspec(41, 60, "bicubic"), odt), odt)


def test_plan_tile_c_is_a_kernel_template_value():
    """The plan's column tiles are exactly the kernel's instantiations of
    TC (csrc/resample2d.cuh, one source each per weight source), and every
    plan takes one of them."""
    csrc = Path(cr.__file__).parent.parent / "csrc"
    src = (csrc / "resample2d.cuh").read_text()
    for prefix in ("resample2d_tc", "resample2d_fused_tc"):  # tables, synthesis
        assert sorted(int(p.stem[len(prefix):])
                      for p in csrc.glob(f"{prefix}*.cu")) == sorted(plans.TILE_C)
    assert sorted(int(v) for v in re.findall(r"case (\d+): return launch_tc", src)) == \
        sorted(plans.TILE_C)
    for sh, sw in [(tspec(438, 196), tspec(906, 320)), (tspec(97, 40, "lanczos3"),
                                                          tspec(131, 260, "lanczos3")),
                   (tspec(1, 30), tspec(200, 1, "box"))]:
        for itemsize in (1, 2, 4):
            for planes in (1, 64):
                assert plans.plan2d(sh, sw, itemsize, planes).tile_c in plans.TILE_C


@pytest.mark.parametrize("n_sm", [132, 114, 66])
def test_plan_fills_the_card(n_sm):
    # the batch-1 headline (3 planes): at least two waves of blocks
    sh, sw = tspec(438, 196, "bilinear"), tspec(906, 320, "bilinear")
    plan = plans.plan2d(sh, sw, 4, 3, n_sm)
    assert plan.blocks >= 2 * n_sm and plan.resident >= 2
    _assert_plan_covers(plan, sh, sw, 4)
    # config 5's 192 planes give tens of thousands of blocks with any tile:
    # the plan keeps a wide one
    big = plans.plan2d(tspec(2160, 1080), tspec(3840, 1920), 2, 192, n_sm)
    assert big.tile_c >= 64 and big.blocks >= 10000 and big.resident >= 2
    # fewer outputs than SMs: the most blocks any tile gives, one per row
    tiny = plans.plan2d(tspec(17, 8), tspec(23, 11), 4, 1, n_sm)
    assert (tiny.tile_r, tiny.blocks) == (1, 8)


def test_plan_follows_the_batch():
    """More planes need fewer blocks per plane: the tiles grow with the
    batch, and the cache keeps one plan per argument tuple."""
    sh, sw = tspec(438, 196, "bicubic"), tspec(906, 320, "bicubic")
    small, large = plans.plan2d(sh, sw, 4, 1), plans.plan2d(sh, sw, 4, 192)
    assert small.tile_r * small.tile_c <= large.tile_r * large.tile_c
    assert small.blocks >= 2 * plans.H100_SMS
    assert plans.plan2d(sh, sw, 4, 192) is large


def test_cpu_tensors_run_the_plain_versions(monkeypatch, capsys):
    before = (native.launches["resample2d"], native.launches["resample_axis"])
    x = torch.rand((2, 3, 30, 40))
    iat.resize(x, (15, 20))
    iat.resize(x.permute(0, 2, 3, 1), (15, 20), data_format="NHWC")
    assert (native.launches["resample2d"], native.launches["resample_axis"]) == before == (0, 0)
    monkeypatch.setenv("IA_TPU_DEBUG", "1")
    iat.resize(x, (15, 20))
    assert "resample2d torch.float32->torch.float32 (cpu)" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not on meta"):
        cr.resize2d(torch.zeros((1, 8, 8), device="meta"), tspec(8, 4), tspec(8, 4))
    with pytest.raises(ValueError, match="take"):
        cr.resize_axis(torch.zeros((1, 8), dtype=torch.float64), tspec(8, 4), -1)


def test_precision_dial_validated_like_jax(monkeypatch):
    """The dial does nothing in the port; its value is validated once, when
    the config module is imported, with the JAX package's message."""
    import importlib.util

    from interpolate_antialiasing_tpu.config import default_precision as jprec
    from interpolate_antialiasing_tpu_torch import config as tconfig

    for v in ("split", "bf16", "f32"):
        monkeypatch.setenv("IA_TPU_PRECISION", v)
        assert default_precision() == jprec() == v
    monkeypatch.setenv("IA_TPU_PRECISION", "tf32")
    # the kernels' wrappers no longer read it
    assert iat.resize(torch.rand((1, 8, 8)), (4, 4)).shape == (1, 4, 4)
    spec = importlib.util.spec_from_file_location("_config_probe", tconfig.__file__)
    with pytest.raises(ValueError) as et:
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    with pytest.raises(ValueError) as ej:
        jprec()
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# Traps: rounding, TF32, wide integers, uint16
# ---------------------------------------------------------------------------


def test_uint8_rounds_half_up_not_to_even():
    """floor(v + 0.5): an exact .5 goes up, where torch.round would go to
    the even neighbour."""
    halves = torch.tensor([0.5, 1.5, 2.5, 3.5, 254.5, 255.5, -0.5])
    assert tresize._finalize_dtype(halves, torch.uint8).tolist() == \
        [1, 2, 3, 4, 255, 255, 0]
    assert torch.round(halves[:4]).tolist() == [0.0, 2.0, 2.0, 4.0]
    # a box 2 -> 1 average of 2 and 3 is exactly 2.5 on every route
    x = torch.tensor([[[2, 3]]], dtype=torch.uint8)
    sh, sw = tspec(1, 1, "box"), tspec(2, 1, "box")
    assert cr.resize2d(x, sh, sw, torch.uint8).item() == 3
    assert cr.resize_axis(x, sw, -1, torch.uint8).item() == 3
    for backend in ("auto", "pallas", "dense"):
        assert iat.resize(x, (1, 1), method="box", backend=backend).item() == 3


def test_tf32_stays_off_in_plain_versions_and_xla_routes(monkeypatch):
    """The kernels' plain versions and the plain routes run their products
    with TF32 off (config.full_f32), and restore the caller's setting."""
    seen = []

    def spying(real):
        def spy(*a, **k):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32))
            return real(*a, **k)
        return spy

    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        monkeypatch.setattr(torch.Tensor, "index_select",
                            spying(torch.Tensor.index_select))
        monkeypatch.setattr(torch, "matmul", spying(torch.matmul))
        monkeypatch.setattr(torch, "einsum", spying(torch.einsum))
        x = torch.rand((1, 2, 20, 30))
        for backend in ("auto", "pallas", "dense", "gather"):
            n = len(seen)
            iat.resize(x, (10, 15), backend=backend)
            assert len(seen) > n, backend
        assert all(s == (False, False) for s in seen)
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True)  # restored
    finally:
        monkeypatch.undo()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_wide_integers_compute_in_f64_like_jax_x64(dtype):
    """The tests run the JAX package with x64 on (tests/conftest.py), where
    integers wider than 16 bits compute in float64; the port always does."""
    x = np.random.default_rng(8).integers(-10**6, 10**9, (1, 2, 37, 53)).astype(dtype)
    assert tresize._compute_dtype(getattr(torch, dtype)) == torch.float64
    for method in ("bilinear", "bicubic", "lanczos3"):
        got = iat.resize(torch.from_numpy(x), (23, 29), method=method)
        want = np.asarray(ia.resize(jnp.asarray(x), (23, 29), method=method))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    big = np.full((1, 1, 16, 16), np.iinfo(np.int32).max, np.int32)
    np.testing.assert_array_equal(
        iat.resize(torch.from_numpy(big), (8, 8)).numpy(), np.iinfo(np.int32).max)


def test_uint16_round_trips_like_jax():
    x = np.random.default_rng(6).integers(0, 65536, (1, 3, 97, 123), dtype=np.uint16)
    for method in ("bilinear", "bicubic", "lanczos3"):
        got = iat.resize(torch.from_numpy(x), (41, 53), method=method)
        assert got.dtype == torch.uint16
        want = np.asarray(ia.resize(jnp.asarray(x), (41, 53), method=method))
        d = np.abs(got.numpy().astype(np.int64) - want.astype(np.int64)).max()
        assert d <= 1, d
    c = np.full((1, 3, 50, 60), 65535, np.uint16)
    np.testing.assert_array_equal(
        iat.resize(torch.from_numpy(c), (23, 37), method="bicubic").numpy(), 65535)
    got = iat.resize(torch.from_numpy(x), (41, 53), method="nearest_legacy")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ia.resize(jnp.asarray(x), (41, 53),
                                          method="nearest_legacy")))
