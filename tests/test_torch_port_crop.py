"""The port's crop_and_resize against the JAX package: the windowed route's
host side and its kernel's plain version (what a CPU tensor runs) against
the JAX package's interpret-mode ``crop_and_resize_windowed``, the dense
route against the JAX package's CPU route (values and box gradients), the
admission, the routing and ``random_resized_crop``'s sampler.

Tolerances:

* window starts equal, bands within 1e-6 (the same float32 formulas);
* the integer variant (``precision="pil_int8"``) byte-equal;
* the float variant (``precision="split"``) within one grey level: the
  port sums float32 products in tap order, the TPU kernels split each
  weight into two bfloat16 digits for the matrix unit, so a sum that lands
  on a rounding tie (bilinear at an exact ratio gives many ``k + 0.5``)
  may round the other way;
* the dense route to ``1e-5 * max`` in float32 and equal bytes for uint8;
  its box gradients to 1e-4 of ``jax.grad``'s.

Inputs are made from a numpy seed and handed to both packages.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.ops import crop_pallas as jcp
from interpolate_antialiasing_tpu_torch.ops import crop as tcrop
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as tcc
from interpolate_antialiasing_tpu_torch.ops.filters import get_filter


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny CPU ops: one torch thread per test, so that several test
    workers on one host do not contend (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _dense_route_boxes(n, seed):
    """tests/test_crop.py::test_crop_windowed_matches_dense_route's boxes."""
    u = np.random.default_rng(seed).uniform(0, 1, (n, 4)).astype(np.float32)
    return np.stack([u[:, 0] * 0.4, u[:, 1] * 0.4,
                     u[:, 0] * 0.4 + 0.3 + u[:, 2] * 0.3,
                     u[:, 1] * 0.4 + 0.3 + u[:, 3] * 0.3], axis=-1)


def _rrc_boxes():
    gen = torch.Generator().manual_seed(3)
    return tcrop.sample_boxes(gen, 4, 120, 200, (0.2, 0.9), (0.8, 1.25)).numpy()


_FULL_BORDER_DEGENERATE = np.array([
    [0.0, 0.0, 1.0, 1.0],  # full image
    [0.1, 0.2, 0.8, 0.9],
    [0.0, 0.5, 0.3, 1.0],  # touches two borders
    [0.47, 0.55, 0.4701, 0.5502],  # degenerate sub-pixel box
], np.float32)
_SMALL = np.array([[0.2, 0.3, 0.55, 0.65], [0.0, 0.0, 0.4, 0.4]], np.float32)

# tests/test_crop.py:249-358's windowed cases, a box past its span bound
# (the truncated window renormalises), rows that are not a multiple of 8
# (the padded row extent) and a width whose 128-column count is prime, where
# the TPU's pass-1 intermediate is wider than W2 and the right-edge W
# windows start past W2 - k_w there: (x shape, boxes, (oh, ow), method,
# max_box_frac)
WINDOW_CASES = {
    "oracle-bilinear": ((4, 3, 96, 160), _FULL_BORDER_DEGENERATE, (48, 64), "bilinear", 1.0),
    "oracle-box": ((4, 3, 96, 160), _FULL_BORDER_DEGENERATE, (48, 64), "box", 1.0),
    "oracle-hamming": ((4, 3, 96, 160), _FULL_BORDER_DEGENERATE, (48, 64), "hamming", 1.0),
    "dense_route": ((3, 2, 80, 144), _dense_route_boxes(3, 5), (32, 48), "bilinear", 1.0),
    "frac-1.0": ((2, 1, 128, 256), _SMALL, (32, 32), "bilinear", 1.0),
    "frac-0.45": ((2, 1, 128, 256), _SMALL, (32, 32), "bilinear", 0.45),
    "beyond_bound": ((2, 3, 300, 520), np.array([[0.0, 0.0, 1.0, 1.0],
                                                 [0.1, 0.05, 0.95, 0.9]], np.float32),
                     (200, 150), "bilinear", (0.3, 0.3)),
    "rrc": ((4, 3, 120, 200), _rrc_boxes(), (32, 32), "bilinear",
            tcrop.box_fracs(120, 200, (0.2, 0.9), (0.8, 1.25))),
    "rows_not_8": ((2, 3, 101, 150), _FULL_BORDER_DEGENERATE[:2], (40, 60), "triangle", 1.0),
    "wide_prime": ((2, 1, 64, 1600), np.array([[0.0, 0.9, 1.0, 1.0], [0.1, 0.5, 0.9, 1.0]],
                                              np.float32), (32, 200), "bilinear", 0.1),
}


def _case(name):
    shape, boxes, ohw, method, frac = WINDOW_CASES[name]
    return _u8(shape, seed=len(name)), np.asarray(boxes, np.float32), ohw, method, frac


@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_window_geometry_starts_and_bands_match_jax(name):
    x, boxes, (oh, ow), method, frac = _case(name)
    N, C, H, W = x.shape
    support = get_filter(method).support
    geom = tcc._geom(H, W, oh, ow, support, True, frac)
    assert geom == jcp._geom(H, W, oh, ow, support, True, frac)
    _, Hp, k_h, W2, k_w = geom
    fh, fw = tcc._fracs(frac)
    assert tcc._digit_plan(Hp, oh, support, True, fh) == jcp._digit_plan(
        Hp, oh, support, True, fh)
    assert tcc._digit_plan(W2, ow, support, True, fw) == jcp._digit_plan(
        W2, ow, support, True, fw)
    b = torch.from_numpy(boxes)
    for lo, hi, n_in, n_out, k, limit, align in [
        (b[:, 0] * H, b[:, 2] * H, H, oh, k_h, Hp, 32),
        (b[:, 1] * W, b[:, 3] * W, W, ow, k_w, W2, 128),
    ]:
        ts, tb = tcc._windowed_band(lo, hi, n_in, n_out, k, limit, align, method, True)
        js, jb = jcp._windowed_band(jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy()),
                                    n_in, n_out, k, limit, align, method, True)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-6
        # the integer weights are the JAX package's digits recombined
        pb = tcc._digit_plan(limit if align == 32 else W2, n_out, support, True,
                             fh if align == 32 else fw)[0]
        K = tcc._digitize_band(tb, pb).numpy()
        dig, _ = jcp._digitize_band(jb, pb=pb, ndig=3)
        dig = np.asarray(dig).astype(np.int64).reshape(*K.shape[:-1], 3, 128)
        np.testing.assert_array_equal(
            K, dig[..., 0, :] + 256 * dig[..., 1, :] + 65536 * dig[..., 2, :])


def _where(got, want):
    d = np.argwhere(got.astype(int) != want.astype(int))
    return f"{len(d)} bytes differ, first at {d[:5].tolist()}"


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", list(WINDOW_CASES))
def test_windowed_plain_matches_jax_interpret(name, precision):
    x, boxes, ohw, method, frac = _case(name)
    want = np.asarray(jcp.crop_and_resize_windowed(
        jnp.asarray(x), jnp.asarray(boxes), ohw, method=method, max_box_frac=frac,
        precision=precision))
    got = tcc.crop_and_resize_windowed(
        torch.from_numpy(x), torch.from_numpy(boxes), ohw, method=method,
        max_box_frac=frac, precision=precision).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    if precision == "pil_int8":
        assert np.array_equal(got, want), _where(got, want)
    else:
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, _where(got, want)


def test_windowed_tables_are_compact_rows():
    """The kernel reads each output row's nonzero range, padded to the
    static tap bound T: the compact tables expand back to the windowed
    band."""
    x, boxes, ohw, method, frac = _case("rrc")
    b = torch.from_numpy(boxes)
    H = x.shape[2]
    _, Hp, k_h, _, _ = tcc._geom(H, x.shape[3], *ohw, 1.0, True, frac)
    starts, band = tcc._windowed_band(b[:, 0] * H, b[:, 2] * H, H, ohw[0], k_h, Hp,
                                      32, method, True)
    T = tcc._tap_bound(H, ohw[0], get_filter(method).support, True, k_h)
    first, cnt, w = tcc._compact(starts, band, ohw[0], T)
    assert w.shape[-1] == T and int(cnt.max()) <= T < k_h  # far fewer taps than the window
    dense = torch.zeros((x.shape[0], ohw[0], H + k_h))
    for j in range(w.shape[-1]):
        idx = (first + j).long()
        dense.scatter_add_(2, idx[..., None], (w[..., j] * (j < cnt)).float()[..., None])
    rows = band.permute(0, 1, 3, 2).reshape(x.shape[0], -1, k_h)[:, :ohw[0]]
    want = torch.zeros_like(dense)
    for n in range(x.shape[0]):
        for o in range(ohw[0]):
            s = int(starts[n, o // 128])
            want[n, o, s:s + k_h] = rows[n, o]
    assert torch.equal(dense, want)


def test_int32_bound_is_checked_before_a_launch():
    tcc._check_int32("H", 57, 14)
    tcc._check_int32("W", 10**4, 22)
    with pytest.raises(ValueError, match="overflow"):
        tcc._check_int32("W", 10**5, 30)


# ---------------------------------------------------------------------------
# Admission and routing
# ---------------------------------------------------------------------------


def test_windowed_admission():
    u8_4k = torch.empty((8, 3, 2160, 3840), dtype=torch.uint8, device="meta")
    assert tcc.crop_windowed_supported(u8_4k, (224, 224), "bilinear", True)
    # negative-lobe filters keep the unquantised dense path
    assert not tcc.crop_windowed_supported(u8_4k, (224, 224), "bicubic", True)
    assert not tcc.crop_windowed_supported(u8_4k, (224, 224), "lanczos3", True)
    # float inputs keep the dense differentiable path
    f32 = torch.empty((8, 3, 2160, 3840), dtype=torch.float32, device="meta")
    assert not tcc.crop_windowed_supported(f32, (224, 224), "bilinear", True)
    assert not tcc.crop_windowed_supported(u8_4k[0], (224, 224), "bilinear", True)
    for frac in (0.0, 1.5, (0.5, 0.0), (1.0, 1.01)):
        assert not tcc.crop_windowed_supported(u8_4k, (224, 224), "bilinear", True, frac)


def test_tpu_measured_admission_conditions_are_gone():
    """The JAX package also declines when windowing saves under 30% of the
    dense route's multiply-adds (measured on a TPU) and when its blocks
    overflow a VMEM budget; the port admits both."""
    for shape, ohw, frac in [
        ((2, 3, 96, 160), (48, 64), 1.0),  # windowing saves too few MACs
        ((1, 1, 2048, 60000), (224, 224), 0.1),  # a pass-2 row block > VMEM
    ]:
        jx = jax.ShapeDtypeStruct(shape, jnp.uint8)
        assert not jcp.crop_windowed_supported(jx, ohw, "bilinear", True, frac)
        tx = torch.empty(shape, dtype=torch.uint8, device="meta")
        assert tcc.crop_windowed_supported(tx, ohw, "bilinear", True, frac)
    # the second is refused for VMEM alone: its MAC ratio is far below 0.70
    _, Hp, k_h, W2, k_w = jcp._geom(2048, 60000, 224, 224, 1.0, True, 0.1)
    mac_win = k_h * 2 * 128 * 60000 + k_w * 2 * 128 * 224
    assert mac_win < 0.2 * (224 * 2048 * 60000 + 224 * 60000 * 224)


def test_routing(monkeypatch):
    """None routes admitted calls without flip to the windowed route (on
    every device, as the JAX package does on its accelerator); flip, float
    input or a negative-lobe filter take the dense route; True/False force
    the choice, with True falling back where the kernel does not admit."""
    seen = []
    real = tcc.crop_and_resize_windowed
    monkeypatch.setattr(tcc, "crop_and_resize_windowed",
                        lambda *a, **k: seen.append(1) or real(*a, **k))
    x = torch.from_numpy(_u8((2, 3, 40, 56), 0))
    b = torch.tensor([[0.1, 0.05, 0.9, 0.8]] * 2)
    flip = torch.tensor([True, False])
    for kw, windowed in [
        ({}, True), (dict(flip=flip), False), (dict(use_windowed=False), False),
        (dict(use_windowed=True), True), (dict(use_windowed=True, flip=flip), False),
        (dict(method="bicubic"), False), (dict(max_box_frac=(0.9, 0.95)), True),
    ]:
        seen.clear()
        y = iat.crop_and_resize(x, b, (16, 24), **kw)
        assert y.dtype == torch.uint8 and y.shape == (2, 3, 16, 24)
        assert seen == ([1] if windowed else []), kw
    seen.clear()
    iat.crop_and_resize(x.float(), b, (16, 24))
    assert seen == []


def test_windowed_route_within_one_of_dense_route():
    """tests/test_crop.py::test_crop_windowed_matches_dense_route: the
    windowed route rounds its intermediate to the uint8 lattice."""
    x, boxes, ohw, _, _ = _case("dense_route")
    xt, bt = torch.from_numpy(x), torch.from_numpy(boxes)
    yd = iat.crop_and_resize(xt, bt, ohw, use_windowed=False).numpy().astype(int)
    yw = iat.crop_and_resize(xt, bt, ohw).numpy().astype(int)
    assert np.abs(yd - yw).max() <= 1


# ---------------------------------------------------------------------------
# The dense route against the JAX package's CPU route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,antialias", [("bilinear", True), ("bicubic", True),
                                              ("lanczos3", True), ("box", True),
                                              ("bicubic", False), ("nearest", False)])
def test_dense_route_matches_jax(method, antialias):
    rng = np.random.default_rng(21)
    xf = (rng.random((3, 2, 57, 73)) * 255).astype(np.float32)
    boxes = np.concatenate([_FULL_BORDER_DEGENERATE[1:], _dense_route_boxes(1, 8)])[:3]
    flip = np.array([True, False, True])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for kw in [{}, dict(flip=flip)]:
            tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
            jkw = {k: jnp.asarray(v) for k, v in kw.items()}
            got = iat.crop_and_resize(torch.from_numpy(xf), torch.from_numpy(boxes),
                                      (24, 31), method, antialias, **tkw).numpy()
            want = np.asarray(ia.crop_and_resize(jnp.asarray(xf), jnp.asarray(boxes),
                                                 (24, 31), method, antialias, **jkw))
            assert got.dtype == np.float32
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
            x8 = xf.astype(np.uint8)
            got = iat.crop_and_resize(torch.from_numpy(x8), torch.from_numpy(boxes),
                                      (24, 31), method, antialias, use_windowed=False,
                                      **tkw).numpy()
            want = np.asarray(ia.crop_and_resize(jnp.asarray(x8), jnp.asarray(boxes),
                                                 (24, 31), method, antialias,
                                                 use_windowed=False, **jkw))
            assert got.dtype == np.uint8
            assert np.array_equal(got, want), _where(got, want)


def test_axis_matrix_matches_jax():
    from interpolate_antialiasing_tpu.ops.crop import _axis_matrix as jam

    lo = np.array([0.0, 3.25, 40.5, 47.0], np.float32)
    hi = np.array([64.0, 50.75, 40.52, 64.0], np.float32)
    flip = np.array([False, True, False, True])
    for mode in ("bilinear", "bicubic", "lanczos3", "box", "hamming"):
        got = tcrop._axis_matrix(torch.from_numpy(lo), torch.from_numpy(hi), 64, 20,
                                 mode, True, flip=torch.from_numpy(flip)).numpy()
        for n in range(4):
            want = np.asarray(jam(jnp.float32(lo[n]), jnp.float32(hi[n]), 64, 20, mode,
                                  True, flip=jnp.asarray(flip[n])))
            assert np.abs(got[n] - want).max() <= 1e-6, (mode, n)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_box_gradients_match_jax(mode):
    """tests/test_crop.py::test_crop_box_gradients_match_fd: the dense route
    is differentiable with respect to the boxes and the image."""
    rng = np.random.default_rng(1234)
    xn = rng.random((1, 2, 17, 23))
    tn = rng.random((1, 2, 6, 7))
    bn = np.array([[0.1371, 0.2113, 0.7832, 0.9071]])

    def jloss(x, b):
        return jnp.sum((ia.crop_and_resize(x, b, (6, 7), method=mode) - tn) ** 2)

    jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xn), jnp.asarray(bn))
    x = torch.from_numpy(xn).requires_grad_()
    b = torch.from_numpy(bn).requires_grad_()
    loss = ((iat.crop_and_resize(x, b, (6, 7), method=mode) - torch.from_numpy(tn)) ** 2).sum()
    gx, gb = torch.autograd.grad(loss, (x, b))
    assert np.all(gb.numpy() != 0.0)
    np.testing.assert_allclose(gb.numpy(), np.asarray(jgb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-4)
    # and central differences, as the JAX package's test checks
    eps = 1e-3
    for k in range(4):
        e = torch.zeros((1, 4), dtype=torch.float64)
        e[0, k] = eps
        f = [float(((iat.crop_and_resize(x.detach(), b.detach() + s * e, (6, 7),
                                         method=mode) - torch.from_numpy(tn)) ** 2).sum())
             for s in (1, -1)]
        np.testing.assert_allclose(float(gb[0, k]), (f[0] - f[1]) / (2 * eps),
                                   rtol=2e-3, atol=1e-4)


def test_box_gradient_descent_recovers_box():
    x = torch.from_numpy(np.random.default_rng(1234).random((1, 1, 24, 24)))
    b_true = torch.tensor([[0.25, 0.30, 0.75, 0.85]], dtype=torch.float64)
    tgt = iat.crop_and_resize(x, b_true, (8, 8))
    b = torch.tensor([[0.20, 0.35, 0.80, 0.80]], dtype=torch.float64)
    l0 = float(((iat.crop_and_resize(x, b, (8, 8)) - tgt) ** 2).sum())
    for _ in range(200):
        b.requires_grad_()
        loss = ((iat.crop_and_resize(x, b, (8, 8)) - tgt) ** 2).sum()
        g, = torch.autograd.grad(loss, b)
        b = (b - 0.002 * g).detach()
    assert float(loss.detach()) < 1e-6 * l0
    np.testing.assert_allclose(b.numpy(), b_true.numpy(), atol=1e-3)


# ---------------------------------------------------------------------------
# Semantics (tests/test_crop.py, ported)
# ---------------------------------------------------------------------------


def test_full_box_matches_resize():
    x = torch.from_numpy((np.random.default_rng(1).random((2, 3, 60, 90)) * 255)
                         .astype(np.float32))
    y = iat.crop_and_resize(x, torch.tensor([[0.0, 0.0, 1.0, 1.0]] * 2), (30, 40))
    ref = iat.resize(x, (30, 40), backend="xla")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=2e-3)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_integer_box_matches_crop_then_resize(mode):
    H, W = 64, 96
    x = torch.from_numpy((np.random.default_rng(2).random((1, 3, H, W)) * 255)
                         .astype(np.float32))
    y0, x0, y1, x1 = 8, 16, 56, 80
    boxes = torch.tensor([[y0 / H, x0 / W, y1 / H, x1 / W]])
    y = iat.crop_and_resize(x, boxes, (24, 32), method=mode)
    ref = iat.resize(x[:, :, y0:y1, x0:x1], (24, 32), method=mode, backend="xla")
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=5e-3)


def test_subpixel_box_samples_nearest():
    x = torch.full((1, 1, 100, 100), 200.0)
    boxes = torch.tensor([[0.501, 0.501, 0.504, 0.504]])
    np.testing.assert_allclose(iat.crop_and_resize(x, boxes, (4, 4)).numpy(), 200.0,
                               atol=1e-4)
    x8 = x.to(torch.uint8)
    for precision in ("pil_int8", "split"):
        y = tcc.crop_and_resize_windowed(x8, boxes, (4, 4), precision=precision)
        assert bool((y == 200).all())


def test_nonaa_bicubic_convention():
    """antialias=False bicubic uses Keys a=-0.75, like resize() does."""
    x = torch.from_numpy(np.random.default_rng(3).random((1, 1, 32, 32))
                         .astype(np.float32) * 255)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        y = iat.crop_and_resize(x, torch.tensor([[0.0, 0.0, 1.0, 1.0]]), (64, 64),
                                method="bicubic", antialias=False)
    ref = iat.resize(x, (64, 64), method="bicubic", antialias=False, backend="xla")
    assert float((y - ref)[..., 4:-4, 4:-4].abs().max()) < 1e-3


def test_classic_path_warns_once_on_border_divergence():
    tcrop._warn_classic_border_divergence.cache_clear()
    x = torch.zeros((1, 1, 16, 16))
    full = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        iat.crop_and_resize(x, full, (8, 8), antialias=False)
        iat.crop_and_resize(x, full, (8, 8), antialias=False)  # cached: silent
        iat.crop_and_resize(x, full, (8, 8), antialias=True)
    assert len([w for w in rec if "replicate" in str(w.message)]) == 1


def test_bad_args():
    x = torch.zeros((1, 3, 10, 10))
    with pytest.raises(ValueError):
        iat.crop_and_resize(x[0], torch.zeros((1, 4)), (4, 4))
    with pytest.raises(ValueError):
        iat.crop_and_resize(x, torch.zeros((1, 3)), (4, 4))
    with pytest.raises(ValueError, match="flip"):
        iat.crop_and_resize(x, torch.zeros((1, 4)), (4, 4), flip=torch.zeros(2, dtype=bool))
    with pytest.raises(ValueError, match="precision"):
        tcc.crop_and_resize_windowed(x.to(torch.uint8), torch.zeros((1, 4)), (4, 4),
                                     precision="bf16")


def test_flip_folds_into_weights():
    """flip equals mirroring the output afterwards, exactly."""
    x = torch.from_numpy(_u8((4, 3, 40, 56), 4))
    boxes = torch.tensor([[0.1, 0.05, 0.9, 0.8]] * 4)
    flip = torch.tensor([True, False, True, False])
    a = iat.crop_and_resize(x, boxes, (16, 24), flip=flip)
    base = iat.crop_and_resize(x, boxes, (16, 24), use_windowed=False)
    want = torch.where(flip[:, None, None, None], base.flip(-1), base)
    assert torch.equal(a, want)


# ---------------------------------------------------------------------------
# random_resized_crop
# ---------------------------------------------------------------------------


def test_sampler_properties():
    """torch cannot draw jax.random's numbers: hold the sampler to the JAX
    package's formulas instead.  Area fraction in ``scale`` and aspect
    ratio in ``ratio`` wherever the box was not clamped; every box inside
    the image and inside the span bound; the bound is crop.py:383-384's."""
    H, W, scale, ratio = 120, 200, (0.08, 0.6), (3 / 4, 4 / 3)
    gen = torch.Generator().manual_seed(0)
    b = tcrop.sample_boxes(gen, 4000, H, W, scale, ratio).double().numpy()
    assert b.dtype == np.float64 and b.shape == (4000, 4)
    assert (b >= 0).all() and (b <= 1 + 1e-6).all()
    assert (b[:, 2] > b[:, 0]).all() and (b[:, 3] > b[:, 1]).all()
    ch, cw = (b[:, 2] - b[:, 0]) * H, (b[:, 3] - b[:, 1]) * W
    free = (ch < H - 1e-3) & (cw < W - 1e-3)
    assert free.mean() > 0.5
    area = ch * cw / (H * W)
    assert (area[free] >= scale[0] - 1e-5).all() and (area[free] <= scale[1] + 1e-5).all()
    r = cw / ch
    assert (r[free] >= ratio[0] - 1e-4).all() and (r[free] <= ratio[1] + 1e-4).all()
    # the log-uniform ratio spreads to both ends
    assert r[free].min() < 0.8 and r[free].max() > 1.25
    fh, fw = tcrop.box_fracs(H, W, scale, ratio)
    assert fh == min(1.0, float(np.sqrt(scale[1] * (W / H) / ratio[0])))
    assert fw == min(1.0, float(np.sqrt(scale[1] * (H / W) * ratio[1])))
    assert (ch <= fh * H + 1e-3).all() and (cw <= fw * W + 1e-3).all()
    fh, fw = tcrop.box_fracs(438, 906, (0.08, 0.5), ratio)
    assert fh == min(1.0, float(np.sqrt(0.5 * (906 / 438) / ratio[0])))
    assert fw == float(np.sqrt(0.5 * (438 / 906) * ratio[1])) < 1.0
    # a generator's seed fixes the draw
    again = tcrop.sample_boxes(torch.Generator().manual_seed(0), 4000, H, W, scale, ratio)
    assert np.array_equal(again.double().numpy(), b)


def test_random_resized_crop_is_crop_and_resize_of_its_boxes():
    x = torch.from_numpy(_u8((4, 3, 120, 200), 6))
    kw = dict(scale=(0.2, 0.9), ratio=(0.8, 1.25))
    y = iat.random_resized_crop(torch.Generator().manual_seed(3), x, (32, 32), **kw)
    boxes = tcrop.sample_boxes(torch.Generator().manual_seed(3), 4, 120, 200, **kw)
    want = iat.crop_and_resize(x, boxes, (32, 32),
                               max_box_frac=tcrop.box_fracs(120, 200, **kw))
    assert y.dtype == torch.uint8 and torch.equal(y, want)
    y2 = iat.random_resized_crop(torch.Generator().manual_seed(4), x, (32, 32), **kw)
    assert not torch.equal(y, y2)
    # the same boxes down the JAX package's dense route: within one grey level
    jd = np.asarray(ia.crop_and_resize(jnp.asarray(x.numpy()), jnp.asarray(boxes.numpy()),
                                       (32, 32), use_windowed=False), int)
    assert np.abs(y.numpy().astype(int) - jd).max() <= 1
    # float input: the dense route, values inside the input's range
    xf = x.float()
    yf = iat.random_resized_crop(torch.Generator().manual_seed(3), xf, (32, 32), **kw)
    assert yf.dtype == torch.float32
    assert float(yf.min()) >= float(xf.min()) - 1e-3
    assert float(yf.max()) <= float(xf.max()) + 1e-3
    with pytest.raises(ValueError):
        iat.random_resized_crop(None, x[0], (8, 8))
