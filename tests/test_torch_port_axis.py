"""The port's per-axis routes against the JAX package: the resample_axis
kernel's plain version (what a CPU tensor runs), the plain dense / gather /
banded formulations, ``resize_nd`` and ``interpolate`` — and
``interpolate`` against ``torch.nn.functional.interpolate`` itself, at the
cases of tests/test_torch_parity.py.

Tolerances as in tests/test_torch_port_float.py: against the JAX package's
XLA route float32 <= 1e-5 * max|ref|, uint8 <= 1, bfloat16 <= 2^-7 *
max|ref|; against its interpret-mode ``resize_axis_pallas``, the tolerance
of its own test (tests/test_pallas_kernels.py); against torch, the
tolerances of test_torch_parity.py.  Also the host helpers: the banded
tiles, element for element, and the launch-splitting plan.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.ops import pallas_resize as jpr
from interpolate_antialiasing_tpu.ops import resize_xla as jxla
from interpolate_antialiasing_tpu.ops import weights as jw
from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import resize_xla as txla
from interpolate_antialiasing_tpu_torch.ops import weights as tw

TDT = {"uint8": torch.uint8, "float32": torch.float32, "bfloat16": torch.bfloat16,
       "float64": torch.float64}


def _pair(shape, dt, scale=255.0, seed=0):
    xf = np.random.default_rng(seed).random(shape) * scale
    xf = xf.astype(np.uint8) if dt == "uint8" else xf.astype(
        np.float64 if dt == "float64" else np.float32)
    return jnp.asarray(xf).astype(dt), torch.from_numpy(xf).to(TDT[dt])


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(y.astype(jnp.float32 if y.dtype == jnp.bfloat16 else y.dtype)
                      ).astype(np.float64)


def _assert_close(got, ref, odt):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    if odt == "uint8":
        assert err <= 1, err
    elif odt == "bfloat16":
        assert err <= 2**-7 * np.abs(ref).max(), err
    else:
        assert err <= 1e-5 * np.abs(ref).max(), err


# (shape, axis, in, out, mode): last and middle axes, down and up, every dtype
AXIS_CASES = [
    ((2, 3, 40, 906), -1, 320, "bilinear"),
    ((2, 3, 438, 50), -2, 196, "bicubic"),
    ((4, 57, 6), 1, 130, "lanczos3"),
    ((3, 97), -1, 40, "hamming"),
    ((2, 64, 5, 7), 1, 23, "box"),
    ((2, 31, 9), -2, 17, "area"),
]


@pytest.mark.parametrize("odt", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("idt", ["uint8", "float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis,n_out,mode", AXIS_CASES)
def test_resample_axis_plain_matches_xla_route(shape, axis, n_out, mode, idt, odt):
    xj, xt = _pair(shape, idt, seed=2)
    spec_t = tw.make_axis_spec(shape[axis], n_out, mode)
    got = cr.resize_axis(xt, spec_t, axis, out_dtype=TDT[odt])
    assert got.dtype == TDT[odt]
    ref = jxla.resize_axis_dense(xj.astype(jnp.float32),
                                 jw.make_axis_spec(shape[axis], n_out, mode), axis)
    if odt == "uint8":
        ref = jnp.clip(jnp.floor(ref + 0.5), 0, 255)
    _assert_close(got, ref, odt)


@pytest.mark.parametrize(
    "shape,axis,n_out,mode,idt,odt",
    [((2, 3, 40, 906), -1, 320, "bilinear", "float32", "float32"),
     ((2, 3, 438, 50), -2, 196, "bicubic", "float32", "float32"),
     ((2, 3, 40, 906), -1, 320, "bilinear", "uint8", "float32"),
     ((2, 3, 438, 50), -2, 196, "bilinear", "float32", "uint8"),
     ((1, 216, 384), -1, 192, "bilinear", "bfloat16", "bfloat16"),
     ((1, 216, 384), -2, 108, "lanczos3", "bfloat16", "bfloat16"),
     ((2, 50, 300), -1, 600, "bicubic", "uint8", "uint8")],
)
def test_resample_axis_plain_matches_jax_kernel(shape, axis, n_out, mode, idt, odt):
    """Against the JAX package's resize_axis_pallas (the _kernel_last /
    _kernel_mid route, interpret mode)."""
    xj, xt = _pair(shape, idt, seed=3)
    spec_j = jw.make_axis_spec(shape[axis], n_out, mode)
    assert jpr.pallas_supported(xj, spec_j, axis)
    want = jpr.resize_axis_pallas(xj, spec_j, axis, out_dtype=odt)
    got = cr.resize_axis(xt, tw.make_axis_spec(shape[axis], n_out, mode), axis,
                         out_dtype=TDT[odt])
    err = np.abs(_np(got) - _np(want)).max()
    if odt == "uint8":
        assert err <= 1, err
    elif odt == "bfloat16":
        assert err <= 2**-7 * np.abs(_np(want)).max(), err
    else:  # split-bf16 products in the JAX kernel (test_pallas_kernels.py:39)
        assert err < 3e-5 * max(1.0, np.abs(_np(want)).max()), err


@pytest.mark.parametrize("dt", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("route", ["dense", "gather", "banded"])
@pytest.mark.parametrize(
    "shape,axis,n_out,kw",
    [((2, 3, 40, 906), -1, 320, dict(mode="bicubic")),
     ((2, 37, 11), 1, 80, dict(mode="lanczos3")),
     ((3, 25, 4), -2, 12, dict(mode="bicubic", antialias=False)),
     ((3, 50), -1, 21, dict(mode="area"))],
    ids=["last_down", "mid_up", "replicate", "area"],
)
def test_plain_routes_match_jax(shape, axis, n_out, kw, route, dt):
    xj, xt = _pair(shape, dt, scale=1.0, seed=4)
    fn_t = getattr(txla, f"resize_axis_{route}")
    fn_j = getattr(jxla, f"resize_axis_{route}")
    got = fn_t(xt, tw.make_axis_spec(shape[axis], n_out, **kw), axis)
    want = fn_j(xj, jw.make_axis_spec(shape[axis], n_out, **kw), axis)
    assert got.dtype == TDT[dt]
    if dt == "float64":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-12)
    else:
        _assert_close(got, want, dt)


@pytest.mark.parametrize("method", ["dense", "gather", "banded"])
def test_resize_plane_plain_backends_match_jax(method):
    """``resize_plane(backend=...)`` on the plain formulations against the
    JAX package's resize_plane_xla (W pass, then H pass)."""
    xj, xt = _pair((2, 3, 60, 80), "float32", scale=1.0, seed=5)
    got = iat.resize_plane(xt, (25, 33), 2, 3, mode="bicubic", backend=method)
    want = jxla.resize_plane_xla(xj, (25, 33), 2, 3, mode="bicubic",
                                 method=method)
    _assert_close(got, want, "float32")


def _per_tap_f32(x, spec, axis):
    """numpy float32 ``acc = acc + x[tap] * w`` in tap order: the sum the
    resample kernels compute, written out independently of the port."""
    xmin, _, w = tw.compute_tables(spec, dtype=np.float64)
    w = w.astype(np.float32)
    xm = np.moveaxis(x.astype(np.float32), axis, -1)
    acc = np.zeros(xm.shape[:-1] + (spec.out_size,), np.float32)
    for k in range(w.shape[1]):
        idx = np.clip(xmin.astype(np.int64) + k, 0, spec.in_size - 1)
        acc = acc + xm[..., idx] * w[:, k]
    return np.moveaxis(acc, -1, axis)


@pytest.mark.parametrize("mode,kw", [("bicubic", {}), ("lanczos3", {}),
                                     ("area", {}), ("box", {}),
                                     ("bicubic", dict(antialias=False))])
def test_plain_versions_sum_taps_in_order_bit_for_bit(mode, kw):
    """The kernels' plain versions round each product and each sum to
    float32 in tap order, with no fused multiply-add: the same sum as a
    numpy loop, bit for bit.  The kernels on the card keep this order, so
    they are held to their plain versions exactly
    (tests/test_torch_port_cuda.py, chip_smoke.py)."""
    x = (np.random.default_rng(11).random((2, 37, 53)) * 255).astype(np.float32)
    sh, sw = tw.make_axis_spec(37, 24, mode, **kw), tw.make_axis_spec(53, 71, mode, **kw)
    t = _per_tap_f32(x, sw, 2)
    np.testing.assert_array_equal(
        cr.resize_axis(torch.from_numpy(x), sw, -1).numpy(), t)
    np.testing.assert_array_equal(
        cr.resize2d(torch.from_numpy(x), sh, sw).numpy(), _per_tap_f32(t, sh, 1))
    # uint8 -> uint8: the W pass result on the uint8 lattice, floor(v + 0.5)
    xu = x.astype(np.uint8)
    q = np.clip(np.floor(_per_tap_f32(xu, sw, 2) + np.float32(0.5)), 0, 255)
    want = np.clip(np.floor(_per_tap_f32(q, sh, 1) + np.float32(0.5)), 0, 255)
    np.testing.assert_array_equal(
        cr.resize2d(torch.from_numpy(xu), sh, sw, torch.uint8).numpy(),
        want.astype(np.uint8))


def test_f64_runs_the_plain_routes_like_jax_on_its_accelerator():
    """float64 has no kernel: auto picks dense for small tables and banded
    for large ones (the JAX package's _pick_method_f64)."""
    from interpolate_antialiasing_tpu.ops import resize as jresize
    from interpolate_antialiasing_tpu_torch.ops import resize as tresize

    for n_in, n_out in [(40, 30), (906, 320)]:
        spec_t = tw.make_axis_spec(n_in, n_out)
        assert tresize._pick_method_f64(spec_t) == jresize._pick_method_f64(
            jw.make_axis_spec(n_in, n_out))
    xj, xt = _pair((1, 2, 438, 906), "float64", scale=1.0, seed=6)
    got = iat.resize(xt, (196, 320), method="bicubic")
    assert got.dtype == torch.float64
    want = ia.resize(xj, (196, 320), method="bicubic", backend="dense")
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize(
    "shape,sizes,axes,kw,dt",
    [((1, 2, 9, 14, 18), (5, 21, 11), (-3, -2, -1), dict(), "float32"),
     ((2, 3, 57), (23,), (-1,), dict(method="bicubic"), "float32"),
     ((2, 30, 40, 3), (15, 20), (1, 2), dict(method="lanczos3"), "float32"),
     ((2, 30, 40), (12,), (1,), dict(align_corners=True, antialias=False),
      "bfloat16"),
     ((2, 30, 40), (12, 50), (1, 2), dict(), "uint8"),
     ((1, 2, 9, 14, 18), (5, 21, 11), (2, 3, 4), dict(), "float64")],
)
def test_resize_nd_matches_jax(shape, sizes, axes, kw, dt):
    xj, xt = _pair(shape, dt, seed=7)
    got = iat.resize_nd(xt, sizes, axes, **kw)
    assert got.dtype == TDT[dt]
    want = ia.resize_nd(xj, sizes, axes, backend="dense", **kw)
    if dt == "float64":
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-9)
    else:
        _assert_close(got, want, dt)


@pytest.mark.parametrize(
    "shape,kw",
    [((1, 2, 9, 14, 18), dict(size=(5, 21, 11), mode="trilinear")),
     ((1, 2, 9, 14, 18), dict(scale_factor=0.5, mode="trilinear")),
     ((2, 3, 57), dict(size=23, mode="linear", align_corners=True,
                       antialias=False)),
     ((2, 3, 57), dict(size=23, mode="area")),
     ((1, 2, 9, 14, 18), dict(size=(5, 21, 11), mode="nearest")),
     ((1, 2, 9, 14, 18), dict(size=(5, 21, 11), mode="nearest-exact")),
     ((2, 3, 24, 36), dict(size=(6, 9), mode="area")),
     ((2, 3, 24, 36), dict(scale_factor=(0.5, 1.5), mode="bicubic")),
     ((2, 3, 24, 36), dict(size=(12, 18), mode="nearest-exact")),
     ((2, 3, 24, 36), dict(scale_factor=0.4, mode="nearest")),
     ((2, 24, 36, 3), dict(size=(12, 18), data_format="channels_last"))],
)
def test_interpolate_matches_jax(shape, kw):
    xj, xt = _pair(shape, "float32", seed=8)
    got = iat.interpolate(xt, **kw)
    _assert_close(got, ia.interpolate(xj, backend="dense", **kw), "float32")


def _torch_resize(x, size, mode, antialias, align_corners):
    ac = align_corners if mode not in ("nearest", "nearest-exact", "area") else None
    return F.interpolate(torch.from_numpy(x), size=size, mode=mode,
                         align_corners=ac, antialias=antialias).numpy()


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("ohw", [(196, 320), (96, 120), (196, 1200), (67, 41)])
def test_interpolate_aa_matches_torch(rng, mode, ohw):
    x = rng.random((2, 3, 438, 906)).astype(np.float32) * 255.0
    ref = _torch_resize(x, ohw, mode, True, False)
    got = iat.interpolate(torch.from_numpy(x), size=ohw, mode=mode).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=1e-5)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("ohw", [(96, 120), (67, 41), (500, 1000)])
def test_interpolate_non_aa_matches_torch(rng, mode, align_corners, ohw):
    x = rng.random((1, 2, 200, 300)).astype(np.float32)
    ref = _torch_resize(x, ohw, mode, False, align_corners)
    got = iat.interpolate(torch.from_numpy(x), size=ohw, mode=mode,
                          align_corners=align_corners, antialias=False).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-5, rtol=1e-5)


def test_interpolate_modes_match_torch(rng):
    """Upsample, area (fractional fuzz), nearest-exact and legacy nearest
    (byte-exact), linear/trilinear and the 3-D/5-D nearest and area ranks —
    the remaining cases of test_torch_parity.py."""
    x = rng.random((1, 3, 50, 60)).astype(np.float32)
    np.testing.assert_allclose(
        iat.interpolate(torch.from_numpy(x), size=(100, 90)).numpy(),
        _torch_resize(x, (100, 90), "bilinear", True, False), atol=2e-5, rtol=1e-5)
    for _ in range(10):
        H, W = int(rng.integers(3, 130)), int(rng.integers(3, 130))
        oh, ow = int(rng.integers(1, H + 1)), int(rng.integers(1, W + 1))
        x = (rng.random((1, 3, H, W)) * 255).astype(np.float32)
        np.testing.assert_allclose(
            iat.interpolate(torch.from_numpy(x), size=(oh, ow), mode="area").numpy(),
            _torch_resize(x, (oh, ow), "area", False, False), atol=2e-4, rtol=1e-6)
        for mode in ("nearest", "nearest-exact"):
            np.testing.assert_array_equal(
                iat.interpolate(torch.from_numpy(x), size=(ow, oh), mode=mode).numpy(),
                _torch_resize(x, (ow, oh), mode, False, False))
    x = (rng.random((1, 2, 37, 53)) * 255).astype(np.float32)
    for sf in (0.4, 1.7, 2.0, 0.5):
        np.testing.assert_array_equal(
            iat.interpolate(torch.from_numpy(x), scale_factor=sf, mode="nearest").numpy(),
            F.interpolate(torch.from_numpy(x), scale_factor=sf, mode="nearest").numpy())
    for align_corners in (False, True):
        x1 = rng.random((2, 3, 57)).astype(np.float32) * 255.0
        np.testing.assert_allclose(
            iat.interpolate(torch.from_numpy(x1), size=23, mode="linear",
                            align_corners=align_corners, antialias=False).numpy(),
            _torch_resize(x1, 23, "linear", False, align_corners), atol=1e-3, rtol=1e-5)
        x3 = rng.random((1, 2, 9, 14, 18)).astype(np.float32) * 255.0
        np.testing.assert_allclose(
            iat.interpolate(torch.from_numpy(x3), size=(5, 21, 11), mode="trilinear",
                            align_corners=align_corners, antialias=False).numpy(),
            _torch_resize(x3, (5, 21, 11), "trilinear", False, align_corners),
            atol=1e-3, rtol=1e-5)
    for mode in ("nearest", "nearest-exact", "area"):
        for xs, size in [(x1, 23), (x3, (5, 21, 11))]:
            got = iat.interpolate(torch.from_numpy(xs), size=size, mode=mode).numpy()
            ref = _torch_resize(xs, size, mode, False, False)
            np.testing.assert_allclose(got, ref, atol=2e-4 if mode == "area" else 0,
                                       rtol=1e-6 if mode == "area" else 0)


@pytest.mark.parametrize("tile,align", [(128, 8), (128, 128), (32, 1)])
@pytest.mark.parametrize(
    "n_in,n_out,kw",
    [(906, 320, {}), (438, 196, dict(mode="bicubic")), (64, 300, dict(mode="lanczos3")),
     (57, 24, dict(mode="bicubic", antialias=False)), (40, 7, dict(mode="area"))],
)
def test_banded_tiles_equal_jax(n_in, n_out, kw, tile, align):
    spec_t, spec_j = tw.make_axis_spec(n_in, n_out, **kw), jw.make_axis_spec(n_in, n_out, **kw)
    a = tw.banded_tiles(spec_t, tile=tile, align=align, dtype=np.float64)
    b = jw.banded_tiles(spec_j, tile=tile, align=align, dtype=np.float64)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    a = tw.banded_tiles(spec_t, tile=tile, align=1, in_cap=n_in)
    b = jw.banded_tiles(spec_j, tile=tile, align=1, in_cap=n_in)
    np.testing.assert_array_equal(a.band, b.band)
    np.testing.assert_array_equal(a.starts, b.starts)


def test_plane_chunks_cover_the_batch_within_the_limit():
    assert native.plane_chunks(0, 5) == []
    assert native.plane_chunks(5, 5) == [(0, 5)]
    assert native.plane_chunks(70000, 65535) == [(0, 65535), (65535, 4465)]
    for n, m in [(1, 1), (7, 3), (131071, 65535), (10**6, 2**31 - 1)]:
        chunks = native.plane_chunks(n, m)
        assert all(1 <= c <= m for _, c in chunks)
        assert [s for s, _ in chunks] == list(range(0, n, m))
        assert sum(c for _, c in chunks) == n
    with pytest.raises(ValueError):
        native.plane_chunks(4, 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    spec = tw.make_axis_spec(8, 4)
    with pytest.raises(ValueError, match="take"):
        cr.resize_axis(torch.zeros((2, 8), dtype=torch.int32), spec, -1)
    with pytest.raises(ValueError, match="give"):
        cr.resize_axis(torch.zeros((2, 8)), spec, -1, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="axis 1 has 8 != 9"):
        cr.resize_axis(torch.zeros((2, 8)), tw.make_axis_spec(9, 4), 1)
    with pytest.raises(ValueError, match="trailing axes"):
        cr.resize2d(torch.zeros((2, 8, 8)), spec, tw.make_axis_spec(9, 4))
    # an empty batch and a non-contiguous input are fine
    assert cr.resize_axis(torch.zeros((0, 8)), spec, -1).shape == (0, 4)
    x = torch.rand((3, 8, 16))[..., ::2]
    np.testing.assert_array_equal(cr.resize2d(x, spec, spec).numpy(),
                                  cr.resize2d(x.contiguous(), spec, spec).numpy())
