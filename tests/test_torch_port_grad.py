"""Autograd through the port's resize against the JAX package: the adjoint
tables, the adjoint kernels' plain versions (what a CPU tensor runs) against
the JAX package's interpret-mode adjoint kernels, gradients of every public
entry against ``jax.vjp``, and tests/test_grads.py ported in full
(``gradcheck`` / ``gradgradcheck``, the transpose identity, the backward
shims, ``torch.func.vmap`` / ``jvp`` / ``grad`` compositions).

Tolerances: the adjoint kernels' plain versions against the JAX
interpret-mode kernels at the forward kernels' tolerance
(``<= 2e-4 + 1e-3 * max|want|``, test_torch_port_float.py), which covers
the TPU kernels' split-bf16 arithmetic; against the float64 dense adjoint,
float32 summation only (``<= 1e-5 * max``); gradients against ``jax.vjp``
at float64 to 1e-12 and at float32 to ``1e-5 * max``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import gradcheck, gradgradcheck

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.ops import pallas_resize as jpr
from interpolate_antialiasing_tpu.ops import weights as jw
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops import resize as tresize
from interpolate_antialiasing_tpu_torch.ops import weights as tw
from interpolate_antialiasing_tpu_torch.ops.autograd import apply_axis, apply_plane

MODES = ["bilinear", "bicubic", "box"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests run many tiny CPU ops (gradcheck perturbs every input);
    with several test workers on one host, torch's thread pools contend and
    a tiny matmul takes 100x longer.  One thread per test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SPECS = [
    (906, 320, "bicubic", {}),
    (64, 196, "bicubic", {}),
    (50, 300, "lanczos3", {}),
    (438, 196, "bilinear", {}),
    (131, 50, "box", {}),
    (97, 200, "hamming", {}),
    (40, 7, "area", {}),
    (33, 65, "bicubic", dict(antialias=False)),
    (33, 16, "bilinear", dict(align_corners=True)),
    (60, 30, "nearest", dict(antialias=False)),
    (90, 41, "lanczos3", dict(span=(3.5, 80.0))),
]


def _ids(cases):
    return [f"{i}-{o}-{m}-{'-'.join(kw) or 'aa'}" for i, o, m, kw in cases]


# ---------------------------------------------------------------------------
# Adjoint tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out,mode,kw", SPECS, ids=_ids(SPECS))
def test_adjoint_tables_expand_to_the_transposed_matrix(n_in, n_out, mode, kw):
    spec = tw.make_axis_spec(n_in, n_out, mode, **kw)
    t = tw.adjoint_tables(spec)
    assert (t.in_size, t.out_size) == (n_out, n_in)
    Wt = tw.dense_matrix(spec, dtype=np.float64).T
    got = np.zeros_like(Wt)
    for k in range(t.ntaps):
        cols = t.xmin.astype(np.int64) + k
        ok = cols < n_out
        np.add.at(got, (np.nonzero(ok)[0], cols[ok]), t.w[ok, k])
        assert not np.any(t.w[~ok, k])  # taps past the end weigh nothing
    np.testing.assert_array_equal(got, Wt)
    assert tw.adjoint_tables(spec) is t  # one object per spec
    # the forward tables are compute_tables' own
    f = tw.forward_tables(spec)
    xmin, _, w = tw.compute_tables(spec)
    np.testing.assert_array_equal(f.xmin, xmin)
    np.testing.assert_array_equal(f.w, w)


def test_upsampling_adjoint_has_more_taps():
    spec = tw.make_axis_spec(64, 196, "bicubic")
    assert spec.ntaps == 5 and tw.adjoint_tables(spec).ntaps == 13
    # and the resample2d plan sees the transposed H table
    t = tw.adjoint_tables(spec)
    plan = plans.plan2d(t, t)
    assert plan is not None and plan != plans.plan2d(spec, spec)


@pytest.mark.parametrize("n_in,n_out,mode,kw", SPECS, ids=_ids(SPECS))
@pytest.mark.parametrize("tile,align,in_cap", [(128, 8, None), (128, 1, "out"),
                                               (64, 32, None)])
def test_banded_tiles_from_matrix_equals_jax(n_in, n_out, mode, kw, tile, align, in_cap):
    jkw = dict(kw)
    jspec = jw.make_axis_spec(n_in, n_out, mode, **jkw)
    Wt = tw.dense_matrix(tw.make_axis_spec(n_in, n_out, mode, **kw), np.float64).T
    cap = n_out if in_cap == "out" else None
    got = tw.banded_tiles_from_matrix(Wt, tile=tile, align=align, in_cap=cap)
    want = jw.banded_tiles_from_matrix(jw.dense_matrix(jspec, np.float64).T,
                                       tile=tile, align=align, in_cap=cap)
    for f in ("tile", "k_in", "n_tiles", "out_padded"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.band, want.band)


def test_compact_tables_of_an_empty_row():
    M = np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.25], [1.0, 0.0, 0.0]])
    t = tw.compact_tables(M)
    assert t.ntaps == 2
    np.testing.assert_array_equal(t.xmin, [0, 1, 0])
    np.testing.assert_array_equal(t.w, [[0.0, 0.0], [0.5, 0.25], [1.0, 0.0]])


# ---------------------------------------------------------------------------
# The adjoint kernels' plain versions against the JAX package
# ---------------------------------------------------------------------------


def _g(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _assert_forward_tol(got, want):
    err = np.abs(got - want).max()
    assert err <= 2e-4 + 1e-3 * np.abs(want).max(), err


@pytest.mark.parametrize("H,W,OH,OW,mode", [(438, 906, 196, 320, "bilinear"),
                                           (97, 131, 200, 50, "bicubic")])
def test_plane_adjoint_plain_matches_jax_onekernel_transpose(H, W, OH, OW, mode):
    """tests/test_resize2d_fused.py::test_onekernel_adjoint_matches_dense's
    cases: resample2d over transposed tables (W pass, then H pass)."""
    g = _g((2, OH, OW), seed=1)
    jh, jw_ = jw.make_axis_spec(H, OH, mode), jw.make_axis_spec(W, OW, mode)
    assert jpr.resize2d_onekernel_transpose_supported(jnp.asarray(g), jh, jw_)
    want = np.asarray(jpr.resize2d_onekernel_transpose(jnp.asarray(g), jh, jw_))
    sh, sw = tw.make_axis_spec(H, OH, mode), tw.make_axis_spec(W, OW, mode)
    got = cr.resize2d(torch.from_numpy(g), tw.adjoint_tables(sh),
                      tw.adjoint_tables(sw), torch.float32).numpy()
    assert got.shape == (2, H, W)
    _assert_forward_tol(got, want)
    ref = np.einsum("io,bou,uj->bij", tw.dense_matrix(sh, np.float64).T,
                    g.astype(np.float64), tw.dense_matrix(sw, np.float64))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("n_in,n_out,axis,shape", [
    (906, 320, 3, (2, 3, 10, 320)),
    (64, 196, 2, (2, 3, 196, 33)),
    (50, 300, 3, (1, 2, 4, 300)),
])
def test_axis_adjoint_plain_matches_jax_transpose_pallas(n_in, n_out, axis, shape):
    """tests/test_resize2d_fused.py::test_transpose_pass_matches_dense's
    cases: resample_axis over a transposed table."""
    g = _g(shape, seed=2)
    want = np.asarray(jpr.resize_axis_transpose_pallas(
        jnp.asarray(g), jw.make_axis_spec(n_in, n_out, "bicubic"), axis))
    spec = tw.make_axis_spec(n_in, n_out, "bicubic")
    got = cr.resize_axis(torch.from_numpy(g), tw.adjoint_tables(spec), axis,
                         torch.float32).numpy()
    _assert_forward_tol(got, want)
    ref = np.moveaxis(np.moveaxis(g.astype(np.float64), axis, -1)
                      @ tw.dense_matrix(spec, np.float64), -1, axis)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_adjoint_routes(monkeypatch):
    """auto/pallas float32 and bfloat16: one resample2d over transposed
    tables for a trailing plane, resample_axis per pass otherwise; float64
    and the plain backends: the dense adjoint."""
    calls = []
    for name in ("resize2d", "resize_axis"):
        real = getattr(tresize, name)

        def spy(x, *a, _n=name, _r=real, **k):
            calls.append((_n, x.dtype, type(a[0]).__name__))
            return _r(x, *a, **k)
        monkeypatch.setattr(tresize, name, spy)
    for dt, backend, h, w, want in [
        (torch.float32, "auto", 2, 3, [("resize2d", torch.float32, "AxisSpec"),
                                       ("resize2d", torch.float32, "Tables")]),
        (torch.bfloat16, "pallas", 2, 3, [("resize2d", torch.bfloat16, "AxisSpec"),
                                          ("resize2d", torch.bfloat16, "Tables")]),
        (torch.float32, "auto", 1, 2, [("resize_axis", torch.float32, "AxisSpec")] * 2
         + [("resize_axis", torch.float32, "Tables")] * 2),
        (torch.float64, "auto", 2, 3, []),
        (torch.float32, "dense", 2, 3, []),
        (torch.float32, "gather", 2, 3, []),
    ]:
        calls.clear()
        x = torch.rand((1, 3, 20, 24) if h == 2 else (1, 20, 24, 3), dtype=dt,
                       requires_grad=True)
        y = iat.resize_plane(x, (10, 12), h, w, backend=backend)
        g, = torch.autograd.grad(y.float().sum(), x)
        assert g.dtype == dt and g.shape == x.shape
        assert calls == want, (dt, backend, calls)


def test_uint8_is_never_differentiated():
    x = torch.zeros((1, 8, 8), dtype=torch.uint8)
    with pytest.raises(TypeError, match="floating"):
        apply_plane(x, tw.make_axis_spec(8, 4), tw.make_axis_spec(8, 4), 1, 2, "auto")
    with pytest.raises(TypeError, match="floating"):
        apply_axis(x, tw.make_axis_spec(8, 4), 2, "auto")
    with pytest.raises(ValueError, match="spec expects"):
        apply_axis(x.float(), tw.make_axis_spec(9, 4), 2, "auto")
    # the uint8 routes of resize stay what they were, with no grad_fn
    assert iat.resize(x, (4, 4)).grad_fn is None


def test_backward_kernels_run_only_when_an_input_needs_grad(monkeypatch):
    """A model whose images do not require grad runs no adjoint: the
    Trainer's step launches the forward kernel only."""
    from interpolate_antialiasing_tpu_torch.ops import autograd as ag

    calls = []
    real = ag._plane_adjoint
    monkeypatch.setattr(ag, "_plane_adjoint",
                        lambda *a: calls.append(1) or real(*a))
    w = torch.rand((3, 4), requires_grad=True)
    x = torch.rand((2, 3, 20, 24))
    loss = (iat.resize_plane(x, (10, 12), 2, 3).mean(dim=(2, 3)) @ w).sum()
    loss.backward()
    assert calls == [] and w.grad is not None
    x.requires_grad_()
    iat.resize_plane(x, (10, 12), 2, 3).sum().backward()
    assert calls == [1]


# ---------------------------------------------------------------------------
# tests/test_grads.py, ported
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ohw", [(11, 13), (29, 31), (13, 29)])
def test_check_grads_f64(mode, ohw):
    x = torch.from_numpy(np.random.default_rng(0).random((1, 2, 19, 23)))
    x.requires_grad_()
    f = lambda t: iat.resize_plane(t, ohw, 2, 3, mode=mode)
    assert gradcheck(f, (x,), atol=1e-6, rtol=1e-6)
    assert gradgradcheck(f, (x,), atol=1e-6, rtol=1e-6)
    # forward mode too (the op on the tangent)
    assert gradcheck(f, (x,), atol=1e-6, rtol=1e-6, check_forward_ad=True,
                     check_backward_ad=False)


def test_vjp_is_transpose():
    """<W x, y> == <x, W^T y> to float64 precision."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1, 1, 17, 19))).requires_grad_()
    y = torch.from_numpy(rng.random((1, 1, 9, 11)))
    out = iat.resize_plane(x, (9, 11), 2, 3, mode="bicubic")
    gx, = torch.autograd.grad(out, x, grad_outputs=y)
    lhs = float((out * y).sum())
    rhs = float((x * gx).sum())
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))


@pytest.mark.parametrize("mode,shim", [("bilinear", "linear"), ("nearest", "nearest"),
                                       ("bicubic", "cubic")])
def test_backward_shims_match_autodiff(mode, shim):
    rng = np.random.default_rng(2)
    xn = rng.random((2, 3, 19, 23))
    gn = rng.random((2, 3, 9, 11))
    x = torch.from_numpy(xn).requires_grad_()
    g = torch.from_numpy(gn)
    f = getattr(iat, f"{shim}_forward")
    y = f(x, (9, 11))
    np.testing.assert_allclose(
        y.detach().numpy(), iat.resize_plane(x, (9, 11), 2, 3, mode=mode).detach().numpy())
    gx, = torch.autograd.grad(y, x, grad_outputs=g)
    gx2 = getattr(iat, f"{shim}_backward")(g, (9, 11), x.shape)
    np.testing.assert_allclose(gx.numpy(), gx2.numpy(), atol=1e-12)
    # and the JAX package's shim
    want = getattr(ia, f"{shim}_backward")(jnp.asarray(gn), (9, 11), xn.shape)
    np.testing.assert_allclose(gx2.numpy(), np.asarray(want), atol=1e-12)
    # float32 runs the kernel route (resample_axis over transposed tables)
    g32 = getattr(iat, f"{shim}_backward")(g.float(), (9, 11), x.shape)
    np.testing.assert_allclose(g32.numpy(), np.asarray(want),
                               atol=1e-5 * float(np.abs(want).max()))


def test_grad_through_uint8_free_path():
    """resize() on float input is differentiable end to end."""
    x = torch.from_numpy(np.random.default_rng(3).random((1, 3, 16, 16)))
    x.requires_grad_()
    g, = torch.autograd.grad((iat.resize(x, (8, 8)) ** 2).sum(), x)
    assert g.shape == x.shape and float(g.abs().max()) > 0


def test_grad_of_sum_is_the_column_sums():
    """grad of sum == column sums of W_h (x) W_w: each input pixel's total
    contribution."""
    x = torch.from_numpy(np.random.default_rng(4).random((1, 2, 20, 24)))
    g = torch.func.grad(lambda t: iat.resize_plane(t, (10, 12), 2, 3).sum())(x)
    Wh = tw.dense_matrix(tw.make_axis_spec(20, 10, "bilinear"), dtype=np.float64)
    Ww = tw.dense_matrix(tw.make_axis_spec(24, 12, "bilinear"), dtype=np.float64)
    expected = np.outer(Wh.sum(axis=0), Ww.sum(axis=0))
    np.testing.assert_allclose(g[0, 0].numpy(), expected, atol=1e-10)


def test_vmap_and_second_order():
    """torch.func.vmap, reverse-over-reverse and forward mode compose: the
    ops carry backward, jvp and vmap rules."""
    x = torch.from_numpy(np.random.default_rng(1234).random((4, 3, 32, 48))
                         .astype(np.float32))
    f = lambda img: iat.resize_plane(img, (16, 24), 1, 2)
    yv = torch.func.vmap(f)(x)
    yd = iat.resize_plane(x, (16, 24), 2, 3)
    np.testing.assert_allclose(yv.numpy(), yd.numpy(), atol=1e-5)

    g = lambda t: (iat.resize_plane(t, (16, 24), 2, 3) ** 2).sum()
    hvp = torch.func.grad(lambda t: (torch.func.grad(g)(t) * t).sum())(x)
    assert hvp.shape == x.shape and bool(torch.isfinite(hvp).all())

    # linear op: jvp(tangent) == f(tangent); also vmap-of-jvp and jvp-of-vmap
    y, tang = torch.func.jvp(f, (x[0],), (x[0],))
    np.testing.assert_allclose(y.numpy(), tang.numpy(), atol=1e-6)
    yb, tb = torch.func.jvp(torch.func.vmap(f), (x,), (x,))
    np.testing.assert_allclose(yb.numpy(), tb.numpy(), atol=1e-6)
    yb2, tb2 = torch.func.vmap(lambda a: torch.func.jvp(f, (a,), (a,)))(x)
    np.testing.assert_allclose(yb2.numpy(), tb2.numpy(), atol=1e-6)
    # vmap of the backward (the adjoint's vmap rule)
    gv = torch.func.vmap(torch.func.grad(lambda a: (f(a) ** 2).sum()))(x)
    gd = torch.func.grad(lambda a: (yd_fn(a) ** 2).sum())(x)
    np.testing.assert_allclose(gv.numpy(), gd.numpy(), atol=1e-5)


def yd_fn(a):
    return iat.resize_plane(a, (16, 24), 2, 3)


def test_resize_nd_grad_all_backends():
    """resize_nd is differentiable on every backend route."""
    x = torch.from_numpy(np.random.default_rng(1234).random((2, 24, 28, 32))
                         .astype(np.float32))
    ref = None
    for backend in ["xla", "pallas", "dense", "gather", "banded", "auto"]:
        g = torch.func.grad(
            lambda t: (iat.resize_nd(t, (12, 14, 16), (-3, -2, -1),
                                     backend=backend) ** 2).sum())(x)
        assert g.shape == x.shape and bool(torch.isfinite(g).all()), backend
        if ref is None:
            ref = g.numpy()
        else:
            np.testing.assert_allclose(g.numpy(), ref, atol=5e-3, err_msg=backend)


def test_resize_nd_jvp_all_backends():
    x = torch.from_numpy(np.random.default_rng(1234).random((2, 10, 12))
                         .astype(np.float32))
    for backend in ["xla", "pallas", "dense", "gather", "banded", "auto"]:
        f = lambda t: iat.resize_nd(t, (5, 6), (-2, -1), backend=backend)
        y, tang = torch.func.jvp(f, (x,), (x,))
        np.testing.assert_allclose(y.numpy(), tang.numpy(), atol=1e-5,
                                   err_msg=backend)
        yv = torch.func.vmap(f)(x[None])[0]
        np.testing.assert_allclose(yv.numpy(), y.numpy(), atol=1e-6, err_msg=backend)


def test_jvp_grad_compositions():
    """jvp, grad of jvp, jvp of grad and linearize agree with the
    linear-operator identities."""
    x = torch.from_numpy(np.random.default_rng(1234).random((1, 2, 18, 20))
                         .astype(np.float32))
    f = lambda t: iat.resize_plane(t, (9, 10), 2, 3, mode="bicubic")

    y, t1 = torch.func.jvp(f, (x,), (2.0 * x,))
    np.testing.assert_allclose(t1.numpy(), 2 * y.numpy(), atol=1e-5)

    # d/dx <f(x), f(x)>: the Hessian-vector product 2 W^T W x, three ways
    g = torch.func.grad(lambda t: (f(t) ** 2).sum())
    _, hv = torch.func.jvp(g, (x,), (x,))
    y2, lin = torch.func.linearize(g, x)
    np.testing.assert_allclose(hv.numpy(), lin(x).numpy(), atol=1e-5)
    np.testing.assert_allclose(hv.numpy(), y2.numpy(), atol=1e-4)
    # grad of jvp: the tangent of a linear op is f(t), so its grad is W^T 1
    gj = torch.func.grad(lambda t: torch.func.jvp(f, (t,), (t,))[1].sum())(x)
    np.testing.assert_allclose(
        gj.numpy(), torch.func.grad(lambda t: f(t).sum())(x).numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# Gradients of the public entries against jax.vjp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(
    "entry,shape,kw",
    [("resize_plane", (2, 3, 40, 60), dict(out_hw=(17, 90), h_axis=2, w_axis=3,
                                           mode="bicubic")),
     ("resize_plane", (2, 40, 60, 3), dict(out_hw=(17, 23), h_axis=1, w_axis=2,
                                           mode="lanczos3")),
     ("resize", (2, 3, 40, 60), dict(size=(17, 23), method="hamming")),
     ("resize", (2, 40, 60, 3), dict(size=(70, 23), data_format="NHWC")),
     ("resize_nd", (2, 12, 40, 60), dict(sizes=(5, 17, 90), axes=(1, 2, 3))),
     ("interpolate", (2, 3, 40, 60), dict(size=(17, 23), mode="bicubic")),
     ("interpolate", (2, 3, 12, 40, 60), dict(size=(5, 17, 23), mode="trilinear")),
     ("image_resize", (2, 3, 40, 60), dict(shape=(2, 3, 17, 23), method="cubic"))],
    ids=["resize_plane", "resize_plane_nhwc", "resize", "resize_nhwc",
         "resize_nd", "interpolate", "interpolate_trilinear", "image_resize"],
)
def test_entry_gradients_match_jax_vjp(entry, shape, kw, dtype):
    rng = np.random.default_rng(11)
    xn = rng.random(shape).astype(dtype)
    x = torch.from_numpy(xn).requires_grad_()
    y = getattr(iat, entry)(x, **kw)
    ct = rng.random(tuple(y.shape)).astype(dtype)
    gx, = torch.autograd.grad(y, x, grad_outputs=torch.from_numpy(ct))
    _, vjp = jax.vjp(lambda t: getattr(ia, entry)(t, **kw), jnp.asarray(xn))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    assert gx.dtype == x.dtype
    err = np.abs(gx.numpy().astype(np.float64) - want).max()
    tol = 1e-12 if dtype == "float64" else 1e-5 * np.abs(want).max()
    assert err <= tol, err
