"""The port's sharded path (``interpolate_antialiasing_tpu_torch.parallel``)
against the JAX package's (``interpolate_antialiasing_tpu.parallel``).

Three levels:

  * the host plans and tables, element for element (``plan_halo``,
    ``plan_halo_banded``, ``_int_halo_tables``), their errors and
    immutability; each shard's compact tables expand exactly to
    ``plan.Wl[d]`` and ``Wl[d]^T``;
  * the shard bodies without a process group: each shard's extended block
    built from the padded image as the ring delivers it
    (``halo._extended_blocks``), run through the shard-local bodies and
    stitched, against the JAX package's sharded functions on the conftest's
    8-device virtual mesh (float to 1e-4, the JAX tests' own tolerance;
    the byte-exact route byte for byte, and against Pillow); the integer
    pass's plain version byte-equal to JAX's interpret-mode
    ``digit_pass_mid_dynamic`` over its digit tables, and the float one
    against the interpret-mode ``banded_pass_mid_dynamic``;
  * the public entry points in spawned gloo process groups of 2 and 4 ranks
    (one spawn per group size, shared by the module; each case asserted in
    its own test): results against the JAX package on a virtual mesh of as
    many devices, gradients against ``jax.grad``, forward mode against
    ``jax.jvp``, the adjoint identity across ranks, the collectives a call
    makes (only the ring's two sends and two receives), the ``Trainer`` on
    a data mesh and on dp x sp against the single-device ``Trainer`` after
    two steps, and ``dryrun_multichip(4)``.
"""

import os
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu.ops.pallas_resize import banded_pass_mid_dynamic
from interpolate_antialiasing_tpu.parallel import halo as jhalo
from interpolate_antialiasing_tpu_torch import parallel as tpar
from interpolate_antialiasing_tpu_torch.ops import pil_exact as tpe
from interpolate_antialiasing_tpu_torch.ops.resize import _apply_axis_diff
from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec, tables_matrix
from interpolate_antialiasing_tpu_torch.parallel import halo as thalo
from interpolate_antialiasing_tpu_torch.parallel.dryrun import run_group


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one torch thread per test, so that several test
    workers on one host do not contend (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n, name="sp"):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _f32(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# 1. Host plans and tables
# ---------------------------------------------------------------------------

# (in, out, mode, n): tests/test_parallel*.py's sizes, divisible
PLAN_CASES = [(64, 32, "bilinear", 8), (32, 64, "bilinear", 8), (128, 48, "bicubic", 8),
              (64, 32, "bicubic", 2), (48, 24, "lanczos3", 4), (96, 96, "box", 4)]
# ... and ceil-padded, as plan_halo_banded takes them
BANDED_CASES = [(67, 29, "bilinear", 8), (50, 111, "bicubic", 8), (129, 40, "bicubic", 8),
                (48, 24, "bicubic", 8), (56, 24, "bilinear", 8), (515, 257, "bilinear", 2),
                (4096, 1024, "bilinear", 8), (97, 41, "lanczos3", 4)]
# (in_h, oh, mode, n) of the byte-exact route
INT_CASES = [(96, 40, "bilinear", 8), (97, 41, "bicubic", 8), (97, 41, "lanczos3", 8),
             (240, 96, "bilinear", 8), (520, 250, "box", 8), (320, 160, "hamming", 8),
             (4096, 1024, "bilinear", 8), (500, 200, "bilinear", 2)]


@pytest.mark.parametrize("in_size,out_size,mode,n", PLAN_CASES)
def test_plan_halo_equals_jax(in_size, out_size, mode, n):
    halo, Wl = tpar.plan_halo(in_size, out_size, mode, True, n)
    jh, jWl = jhalo.plan_halo(in_size, out_size, mode, True, n)
    assert halo == jh and Wl.dtype == jWl.dtype
    np.testing.assert_array_equal(Wl, jWl)


@pytest.mark.parametrize("in_size,out_size,mode,n", BANDED_CASES)
def test_plan_halo_banded_equals_jax(in_size, out_size, mode, n):
    p = tpar.plan_halo_banded(in_size, out_size, mode, True, n)
    q = jhalo.plan_halo_banded(in_size, out_size, mode, True, n)
    for f in ("halo", "hl", "ol", "ext", "ext_pad", "k_in", "n_tiles"):
        assert getattr(p, f) == getattr(q, f), f
    for f in ("starts", "bands", "Wl"):
        a, b = getattr(p, f), getattr(q, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("in_h,oh,mode,n", INT_CASES)
def test_int_halo_tables_equal_jax(in_h, oh, mode, n):
    plan, starts, Wsh = thalo._int_halo_tables(in_h, oh, mode, n)
    jplan, jstarts, jWsh = jhalo._int_halo_tables(in_h, oh, mode, n)
    assert (plan.halo, plan.hl, plan.ol, plan.ext) == (jplan.halo, jplan.hl, jplan.ol, jplan.ext)
    for a, b in ((starts, jstarts), (Wsh, jWsh)):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("call,err,match", [
    (lambda: tpar.plan_halo(64, 8, "lanczos3", True, 8), ValueError, "halo .* exceeds"),
    (lambda: tpar.plan_halo_banded(64, 8, "lanczos3", True, 8), ValueError, "halo .* exceeds"),
    (lambda: tpar.plan_halo(67, 32, "bilinear", True, 8), ValueError, "must divide"),
    (lambda: tpar.make_mesh((1024,), ("data",)), ValueError, "needs .* devices"),
    (lambda: tpar.resize_sharded_pil_exact(torch.zeros(16, 16), (8, 8), None), TypeError,
     "uint8-only"),
], ids=["plan_halo_oversized", "banded_oversized", "plan_halo_non_divisible",
        "make_mesh_underprovisioned", "pil_exact_rejects_float"])
def test_errors_match_jax(call, err, match):
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("which", ["plan_halo.Wl", "banded.starts", "banded.bands",
                                   "banded.Wl", "int.starts", "int.Wsh"])
def test_cached_plans_are_read_only(which):
    arrays = {
        "plan_halo.Wl": tpar.plan_halo(64, 32, "bilinear", True, 8)[1],
        "banded.starts": tpar.plan_halo_banded(67, 29, "bilinear", True, 8).starts,
        "banded.bands": tpar.plan_halo_banded(67, 29, "bilinear", True, 8).bands,
        "banded.Wl": tpar.plan_halo_banded(67, 29, "bilinear", True, 8).Wl,
        "int.starts": thalo._int_halo_tables(97, 41, "bicubic", 8)[1],
        "int.Wsh": thalo._int_halo_tables(97, 41, "bicubic", 8)[2],
    }
    with pytest.raises(ValueError):
        arrays[which].reshape(-1)[0] = 99


def test_plans_are_cached_and_hash_by_identity():
    p = tpar.plan_halo_banded(67, 29, "bilinear", True, 8)
    assert p is tpar.plan_halo_banded(67, 29, "bilinear", True, 8)
    assert thalo._shard_tables(p, 3) is thalo._shard_tables(p, 3)
    import dataclasses

    with pytest.raises(dataclasses.FrozenInstanceError):
        p.halo = 0


@pytest.mark.parametrize("in_size,out_size,mode,n", BANDED_CASES[:6])
def test_shard_tables_expand_to_the_plans_matrices(in_size, out_size, mode, n):
    """Each shard's compact tables are exactly ``Wl[d]`` and its adjoint's
    exactly ``Wl[d]^T``; the first shard never weights its wrapped-around
    top rows, nor the last its bottom ones."""
    plan = tpar.plan_halo_banded(in_size, out_size, mode, True, n)
    for d in range(n):
        fwd, adj = thalo._shard_tables(plan, d)
        assert (fwd.in_size, fwd.out_size) == (plan.ext_pad, plan.ol)
        assert (adj.in_size, adj.out_size) == (plan.ol, plan.ext_pad)
        np.testing.assert_array_equal(tables_matrix(fwd), plan.Wl[d])
        np.testing.assert_array_equal(tables_matrix(adj), plan.Wl[d].T)
    if plan.halo:
        assert not tables_matrix(thalo._shard_tables(plan, 0)[0])[:, :plan.halo].any()
        bottom = in_size - (n - 1) * plan.hl + plan.halo  # last shard's real rows end
        assert not tables_matrix(thalo._shard_tables(plan, n - 1)[0])[:, bottom:].any()


# ---------------------------------------------------------------------------
# 2. Shard bodies, stitched, without a process group
# ---------------------------------------------------------------------------


def _stitch(ys, h_axis, out_size, ol):
    return torch.cat([thalo._own_rows(y, h_axis, out_size, ol, d) for d, y in enumerate(ys)],
                     h_axis)


def _stitched_h(x, out_h, mode, n, h_axis, backend="auto"):
    plan = tpar.plan_halo_banded(x.shape[h_axis], out_h, mode, True, n)
    xp = thalo._pad_axis(x, h_axis, n * plan.hl - x.shape[h_axis])
    exts = thalo._extended_blocks(xp, plan, n, h_axis)
    return _stitch([thalo._shard_h_float(e, plan, d, h_axis, backend)
                    for d, e in enumerate(exts)], h_axis, out_h, plan.ol)


def _stitched_2d(x, size, mode, n, h_axis, w_axis, backend="auto"):
    cd = x.dtype if x.is_floating_point() else torch.float32
    plan = tpar.plan_halo_banded(x.shape[h_axis], size[0], mode, True, n)
    xp = thalo._pad_axis(x.to(cd), h_axis, n * plan.hl - x.shape[h_axis])
    yw = _apply_axis_diff(xp, make_axis_spec(x.shape[w_axis], size[1], mode), w_axis, "auto")
    y = _stitch([thalo._shard_h_float(e, plan, d, h_axis, backend) for d, e in
                 enumerate(thalo._extended_blocks(yw, plan, n, h_axis))], h_axis, size[0],
                plan.ol)
    if x.dtype == torch.uint8:
        y = torch.floor(y + 0.5).clamp_(0.0, 255.0).to(torch.uint8)
    return y


def _stitched_pil(x, size, mode, n, h_axis, w_axis, use_kernels=True):
    tables = thalo._int_halo_tables(x.shape[h_axis], size[0], mode, n)
    plan = tables[0]
    xp = thalo._pad_axis(x, h_axis, n * plan.hl - x.shape[h_axis])
    yw = thalo._pil_w_pass(xp, tpe._int_tables(x.shape[w_axis], size[1], mode), w_axis,
                           use_kernels)
    return _stitch([thalo._shard_h_int(e, tables, d, h_axis, use_kernels) for d, e in
                    enumerate(thalo._extended_blocks(yw, plan, n, h_axis))], h_axis, size[0],
                   plan.ol)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("in_h,out_h", [(64, 32), (32, 64), (128, 48), (67, 29), (50, 111),
                                        (129, 40)])
def test_stitched_h_pass_matches_jax_halo_resize_h(mode, in_h, out_h):
    x = _f32((2, 3, in_h, 40), 11)
    want = np.asarray(jhalo.halo_resize_h(jnp.asarray(x), out_h, _mesh(8), mode=mode))
    got = _stitched_h(torch.from_numpy(x), out_h, mode, 8, 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("in_hw,ohw", [((67, 53), (29, 31)), ((64, 96), (32, 48))])
def test_stitched_resize_matches_jax_resize_sharded(in_hw, ohw):
    x = _f32((1, 3, *in_hw), 12)
    want = np.asarray(jhalo.resize_sharded(jnp.asarray(x), ohw, _mesh(8)))
    got = _stitched_2d(torch.from_numpy(x), ohw, "bilinear", 8, 2, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_stitched_resize_float64_dense_route_matches_jax():
    """The dense route (``use_pallas=False``) in float64, the precision of
    the JAX package's check_grads case."""
    x = np.random.default_rng(13).random((2, 48, 40))
    want = np.asarray(jhalo.resize_sharded(jnp.asarray(x), (24, 20), _mesh(8), mode="bicubic",
                                           use_pallas=False))
    got = _stitched_2d(torch.from_numpy(x), (24, 20), "bicubic", 8, 1, 2, backend="dense")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)


def test_stitched_resize_uint8_within_one_of_jax():
    x = _u8((3, 66, 50), 14)
    want = np.asarray(jhalo.resize_sharded(jnp.asarray(x), (30, 26), _mesh(8),
                                           data_format="CHW"))
    got = _stitched_2d(torch.from_numpy(x), (30, 26), "bilinear", 8, 1, 2)
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def _pillow(img, size, mode):
    from PIL import Image

    resample = {"bilinear": Image.Resampling.BILINEAR, "bicubic": Image.Resampling.BICUBIC,
                "lanczos3": Image.Resampling.LANCZOS, "box": Image.Resampling.BOX,
                "hamming": Image.Resampling.HAMMING}[mode]
    return np.asarray(Image.fromarray(img).resize((size[1], size[0]), resample))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3"])
@pytest.mark.parametrize("H,W,oh,ow", [(96, 130, 40, 70), (97, 111, 41, 59)])
def test_stitched_pil_exact_equals_jax_and_pillow(mode, H, W, oh, ow):
    img = _u8((3, H, W), 99)
    ref = np.stack([_pillow(img[c], (oh, ow), mode) for c in range(3)])
    jax_y = np.asarray(jhalo.resize_sharded_pil_exact(jnp.asarray(img), (oh, ow), _mesh(8),
                                                      mode=mode))
    np.testing.assert_array_equal(jax_y, ref)
    for use_kernels in (True, False):
        got = _stitched_pil(torch.from_numpy(img), (oh, ow), mode, 8, 1, 2, use_kernels)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{mode} kernels={use_kernels}")


@pytest.mark.parametrize("case", ["2d", "nhwc", "tall", "box", "hamming"])
def test_stitched_pil_exact_layouts_equal_pillow(case):
    """Bare 2-D, NHWC (through the kernel's ``[outer, n, inner]`` view),
    the tall banded image of the JAX tests, and box / hamming."""
    if case == "2d":
        img, size, mode, axes = _u8((240, 120), 5), (96, 50), "bilinear", (0, 1)
        ref = _pillow(img, size, mode)
    elif case == "nhwc":
        img, size, mode, axes = _u8((160, 100, 3), 17), (72, 48), "bilinear", (0, 1)
        ref = _pillow(img, size, mode)
    elif case == "tall":
        img, size, mode, axes = _u8((4096, 256), 5), (1024, 128), "bilinear", (0, 1)
        ref = _pillow(img, size, mode)
    else:
        mode = case
        img, size, axes = _u8((2, 320, 180), 31), (160, 90), (1, 2)
        ref = np.stack([_pillow(img[c], size, mode) for c in range(2)])
    got = _stitched_pil(torch.from_numpy(img), size, mode, 8, *axes)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3", "box", "hamming"])
def test_int_pass_plain_equals_jax_digit_pass(mode):
    """Per shard: the pil_resample_axis kernel's plain version over
    ``_int_halo_tables`` == JAX's interpret-mode ``digit_pass_mid_dynamic``
    over ``_digit_halo_tables``, byte for byte (pad rows included)."""
    in_h, oh, n = 97, 41, 4
    plan, starts, Wsh = thalo._int_halo_tables(in_h, oh, mode, n)
    _, dstarts, dbands, dct = jhalo._digit_halo_tables(in_h, oh, mode, n)
    clip = jpe._needs_clip(in_h, oh, mode)
    for d in range(n):
        x3 = _u8((2, plan.ext, 40), 100 + d)
        want = np.asarray(jpe.digit_pass_mid_dynamic(jnp.asarray(x3), dstarts[d], dbands[d],
                                                     dct[d], plan.ol, clip=clip))
        got = tpe._resample_axis_plain(torch.from_numpy(x3), (starts[d], Wsh[d]))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{mode} shard {d}")


@pytest.mark.parametrize("mode,in_h,out_h", [("bilinear", 67, 29), ("bicubic", 129, 40),
                                             ("lanczos3", 97, 41)])
def test_float_pass_plain_matches_jax_banded_dynamic(mode, in_h, out_h):
    """Per shard: kernel B's plain version over the shard's tables against
    JAX's interpret-mode ``banded_pass_mid_dynamic`` over its bands (float32
    products summed in another order: to 1e-5)."""
    n = 4
    plan = tpar.plan_halo_banded(in_h, out_h, mode, True, n)
    for d in range(n):
        x3 = _f32((2, plan.ext_pad, 40), 200 + d)
        want = np.asarray(banded_pass_mid_dynamic(jnp.asarray(x3), plan.starts[d],
                                                  plan.bands[d], plan.ol))
        got = thalo._shard_h_float(torch.from_numpy(x3), plan, d, 1)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_stitched_gradient_matches_jax_grad():
    """The gradient through the shard bodies (the helper's concatenations
    transpose to the ring's fold; the H pass's backward is kernel B over
    ``Wl[d]^T``) against ``jax.grad`` of the JAX package's
    ``resize_sharded``."""
    x = _f32((2, 64, 96), 15)
    want = jax.grad(lambda v: jnp.sum(jnp.sin(jhalo.resize_sharded(
        v, (40, 48), _mesh(8), mode="bicubic"))))(jnp.asarray(x))
    v = torch.from_numpy(x).requires_grad_()
    y = _stitched_2d(v, (40, 48), "bicubic", 8, 1, 2)
    g, = torch.autograd.grad(torch.sin(y).sum(), v)
    assert float(np.abs(g.numpy() - np.asarray(want)).max()) <= 1e-5


# ---------------------------------------------------------------------------
# 3. The public entry points in spawned gloo process groups
# ---------------------------------------------------------------------------


def _counting_mode():
    """A dispatch mode that counts the process-group operations (c10d and
    functional-collective ops) run under it, by name."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "c10d" in func.namespace:
                self.ops[str(func)] = self.ops.get(str(func), 0) + 1
            return func(*args, **(kwargs or {}))

    return Count()


def _chunk_rows(n, d, size):
    b = -(-size // n)
    s = min(d * b, size)
    return s, min(b, size - s)


def _case_halo_resize_h(n, d, mesh):
    x = torch.from_numpy(_f32((2, 3, 67, 40), 21))
    y = tpar.halo_resize_h(x, 29, mesh, mode="bicubic")
    return {"y": y.to_local(), "shape": tuple(y.shape), "placements": str(y.placements)}


def _case_resize_sharded_f32(n, d, mesh):
    from torch.distributed.tensor import DTensor, Shard

    x = torch.from_numpy(_f32((1, 3, 67, 53), 22))
    y = tpar.resize_sharded(x, (29, 31), mesh)
    s, rows = _chunk_rows(n, d, 67)
    xd = DTensor.from_local(x.narrow(2, s, rows), mesh, [Shard(2)], run_check=False,
                            shape=x.shape, stride=x.stride())
    yd = tpar.resize_sharded(xd, (29, 31), mesh)
    return {"y": y.to_local(), "shape": tuple(y.shape),
            "dtensor_in_equal": bool(torch.equal(yd.to_local(), y.to_local()))}


def _case_resize_sharded_u8(n, d, mesh):
    x = torch.from_numpy(_u8((3, 66, 50), 23))
    return {"y": tpar.resize_sharded(x, (30, 26), mesh, data_format="CHW").to_local()}


def _case_pil_exact(n, d, mesh):
    x = torch.from_numpy(_u8((3, 97, 111), 24))
    kern = tpar.resize_sharded_pil_exact(x, (41, 59), mesh, mode="bicubic")
    gather = tpar.resize_sharded_pil_exact(x, (41, 59), mesh, mode="bicubic",
                                           use_tpu_kernels=False)
    return {"y": kern.to_local(), "gather_equal": bool(torch.equal(kern.to_local(),
                                                                   gather.to_local()))}


def _case_pil_exact_nhwc(n, d, mesh):
    x = torch.from_numpy(_u8((160, 100, 3), 25))
    return {"y": tpar.resize_sharded_pil_exact(x, (72, 48), mesh,
                                               data_format="NHWC").to_local()}


def _case_grad(n, d, mesh):
    out = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        v = torch.from_numpy(_f32((2, 48, 40), 26)).to(dt).requires_grad_()
        y = tpar.resize_sharded(v, (24, 20), mesh, mode="bicubic", data_format="CHW",
                                use_pallas=None if dt == torch.float32 else False)
        out[name], = torch.autograd.grad(torch.sin(y.to_local()).sum(), v)
    return out


def _case_jvp(n, d, mesh):
    import torch.autograd.forward_ad as fwAD

    x = torch.from_numpy(_f32((2, 48, 40), 27)).double()
    t = torch.from_numpy(_f32((2, 48, 40), 28)).double()
    s, rows = _chunk_rows(n, d, 48)
    with fwAD.dual_level():
        dual = fwAD.make_dual(x.narrow(1, s, rows), t.narrow(1, s, rows))
        y = thalo._resize_sharded_block(dual, x.shape, (24, 20), mesh, "sp", "bicubic", True,
                                        1, 2, False)
        p = fwAD.unpack_dual(y)
        return {"y": p.primal.clone(), "t": p.tangent.clone()}


def _case_adjoint(n, d, mesh):
    out = {}
    x = torch.from_numpy(_f32((3, 56, 64), 29)).requires_grad_()
    ycot = torch.from_numpy(_f32((3, 24, 64), 30))
    s, rows = _chunk_rows(n, d, 24)
    for up in (True, False):
        fx = tpar.halo_resize_h(x, 24, mesh, mode="bilinear", use_pallas=up).to_local()
        yl = ycot.narrow(1, s, rows)
        xt, = torch.autograd.grad(fx, x, grad_outputs=yl)
        out[f"lhs_{up}"] = float((fx.double() * yl.double()).sum())
        out[f"rhs_{up}"] = float((x.detach().double() * xt.double()).sum())
    return out


def _case_collectives(n, d, mesh):
    xf = torch.from_numpy(_f32((1, 3, 67, 53), 22))
    xu = torch.from_numpy(_u8((3, 97, 111), 24))
    dp_mesh = tpar.make_mesh((n,), ("data",), device_type="cpu")
    calls = {
        "resize_sharded": lambda: tpar.resize_sharded(xf, (29, 31), mesh),
        "halo_resize_h": lambda: tpar.halo_resize_h(xf, 29, mesh),
        "resize_sharded_pil_exact": lambda: tpar.resize_sharded_pil_exact(xu, (41, 59), mesh),
        "data_parallel_resize": lambda: tpar.data_parallel_resize(
            torch.from_numpy(_f32((2 * n, 3, 40, 56), 31)), (20, 28), dp_mesh),
    }
    out = {}
    for name, fn in calls.items():
        with _counting_mode() as c:
            fn()
        out[name] = c.ops
    v = xf.clone().requires_grad_()
    y = tpar.resize_sharded(v, (29, 31), mesh).to_local()
    with _counting_mode() as c:
        torch.autograd.grad(y.sum(), v)
    out["resize_sharded backward"] = c.ops
    return out


def _case_data_parallel(n, d, mesh):
    from torch.distributed.tensor import DTensor, Shard

    dp_mesh = tpar.make_mesh((n,), ("data",), device_type="cpu")
    x = torch.from_numpy(_f32((2 * n + 1, 3, 40, 56), 32))
    y = tpar.data_parallel_resize(x, (20, 28), dp_mesh)
    xs = tpar.shard_batch(x, dp_mesh)
    ys = tpar.data_parallel_resize(xs, (20, 28), dp_mesh)
    s, rows = _chunk_rows(n, d, x.shape[0])
    return {"y": y.to_local(), "shape": tuple(y.shape),
            "is_dtensor": isinstance(y, DTensor) and y.placements == (Shard(0),),
            "shard_batch_block": bool(torch.equal(xs.to_local(), x.narrow(0, s, rows))),
            "local_is_resize": bool(torch.equal(y.to_local(), iat.resize(x.narrow(0, s, rows),
                                                                         (20, 28)))),
            "sharded_in_equal": bool(torch.equal(ys.to_local(), y.to_local()))}


def _train_batch():
    return _f32((8, 3, 40, 56), 1234), np.random.default_rng(1234).integers(0, 10, 8)


def _trainer_run(mesh):
    imgs, labels = _train_batch()
    tr = iat.Trainer(mesh=mesh, resize_to=(16, 16))
    losses = [float(tr.step(torch.from_numpy(imgs), torch.from_numpy(labels)))
              for _ in range(2)]
    return {"losses": losses, **{k: p.detach().clone() for k, p in tr.params.items()}}


def _case_trainer_data(n, d, mesh):
    return _trainer_run(tpar.make_mesh((n,), ("data",), device_type="cpu"))


def _case_trainer_dp_sp(n, d, mesh):
    shape = (2, n // 2) if n >= 4 else (1, n)
    return _trainer_run(tpar.make_mesh(shape, ("data", "sp"), device_type="cpu"))


def _case_mesh_checks(n, d, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    from interpolate_antialiasing_tpu_torch.models import train as ttrain

    checks = {
        "make_mesh_too_big": lambda: tpar.make_mesh((n + 1,), ("data",), device_type="cpu"),
        "trainer_not_a_mesh": lambda: iat.Trainer(mesh=object()),
        "step_not_a_mesh": lambda: ttrain.make_train_step(mesh=object()),
        "step_without_data_axis": lambda: ttrain.make_train_step(mesh=mesh),
        "resize_on_missing_axis": lambda: tpar.resize_sharded(torch.zeros(1, 3, 16, 16), (8, 8),
                                                              mesh, axis="rows"),
        "wrong_placement": lambda: tpar.resize_sharded(
            DTensor.from_local(torch.zeros(1, 3, 16, 16), mesh, [Replicate()]), (8, 8), mesh),
    }
    out = {}
    for name, fn in checks.items():
        try:
            fn()
            out[name] = "no error"
        except Exception as e:  # noqa: BLE001 — the test reads the type and text
            out[name] = f"{type(e).__name__}: {e}"
    m = tpar.make_mesh((n,), ("sp",), device_type="cpu")
    out["mesh"] = (tuple(m.shape), m.mesh_dim_names, m.device_type)
    return out


GROUP_CASES = {
    "halo_resize_h": _case_halo_resize_h,
    "resize_sharded_f32": _case_resize_sharded_f32,
    "resize_sharded_u8": _case_resize_sharded_u8,
    "pil_exact": _case_pil_exact,
    "pil_exact_nhwc": _case_pil_exact_nhwc,
    "grad": _case_grad,
    "jvp": _case_jvp,
    "adjoint": _case_adjoint,
    "collectives": _case_collectives,
    "data_parallel": _case_data_parallel,
    "trainer_data": _case_trainer_data,
    "trainer_dp_sp": _case_trainer_dp_sp,
    "mesh_checks": _case_mesh_checks,
}


def _group_cases(rank, n, out_dir):
    """One rank of a spawned group: every case in order, each result (or
    its traceback) saved for the parent's tests."""
    mesh = tpar.make_mesh((n,), ("sp",), device_type="cpu")
    d = mesh.get_local_rank("sp")
    results = {}
    for name, fn in GROUP_CASES.items():
        try:
            results[name] = fn(n, d, mesh)
        except Exception:  # noqa: BLE001 — reported by the case's own test
            results[name] = traceback.format_exc()
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    runs = {}

    def get(n):
        if n not in runs:
            out = tmp_path_factory.mktemp(f"gloo{n}")
            run_group(_group_cases, n, str(out), str(out), timeout=300)
            runs[n] = [torch.load(out / f"rank{r}.pt") for r in range(n)]
        return runs[n]

    return get


def _ranks(group_runs, n, case):
    per_rank = [r[case] for r in group_runs(n)]
    for r, res in enumerate(per_rank):
        if isinstance(res, str):
            pytest.fail(f"rank {r} of {n}, case {case}:\n{res}")
    return per_rank


NS = [2, 4]


@pytest.mark.parametrize("n", NS)
def test_group_halo_resize_h_matches_jax(group_runs, n):
    res = _ranks(group_runs, n, "halo_resize_h")
    want = np.asarray(jhalo.halo_resize_h(jnp.asarray(_f32((2, 3, 67, 40), 21)), 29, _mesh(n),
                                          mode="bicubic"))
    got = torch.cat([r["y"] for r in res], 2).numpy()
    assert res[0]["shape"] == want.shape and "Shard(dim=2)" in res[0]["placements"]
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("n", NS)
def test_group_resize_sharded_matches_jax(group_runs, n):
    res = _ranks(group_runs, n, "resize_sharded_f32")
    want = np.asarray(jhalo.resize_sharded(jnp.asarray(_f32((1, 3, 67, 53), 22)), (29, 31),
                                           _mesh(n)))
    assert res[0]["shape"] == (1, 3, 29, 31) and all(r["dtensor_in_equal"] for r in res)
    np.testing.assert_allclose(torch.cat([r["y"] for r in res], 2).numpy(), want, atol=1e-4)


@pytest.mark.parametrize("n", NS)
def test_group_resize_sharded_uint8_within_one_of_jax(group_runs, n):
    res = _ranks(group_runs, n, "resize_sharded_u8")
    want = np.asarray(jhalo.resize_sharded(jnp.asarray(_u8((3, 66, 50), 23)), (30, 26),
                                           _mesh(n), data_format="CHW"))
    got = torch.cat([r["y"] for r in res], 1).numpy()
    assert got.dtype == np.uint8 and np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("n", NS)
def test_group_pil_exact_equals_jax_and_pillow(group_runs, n):
    res = _ranks(group_runs, n, "pil_exact")
    img = _u8((3, 97, 111), 24)
    got = torch.cat([r["y"] for r in res], 1).numpy()
    ref = np.stack([_pillow(img[c], (41, 59), "bicubic") for c in range(3)])
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.asarray(jhalo.resize_sharded_pil_exact(
        jnp.asarray(img), (41, 59), _mesh(n), mode="bicubic")))
    assert all(r["gather_equal"] for r in res)


@pytest.mark.parametrize("n", NS)
def test_group_pil_exact_nhwc_equals_pillow(group_runs, n):
    res = _ranks(group_runs, n, "pil_exact_nhwc")
    got = torch.cat([r["y"] for r in res], 0).numpy()
    np.testing.assert_array_equal(got, _pillow(_u8((160, 100, 3), 25), (72, 48), "bilinear"))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("n", NS)
def test_group_gradient_matches_jax_grad(group_runs, n, dtype):
    """Each rank's gradient lands in its own block; their sum is
    ``jax.grad`` of the JAX package's ``resize_sharded`` (f32 on kernel B's
    route to 1e-5, f64 on the dense route to 1e-12)."""
    res = _ranks(group_runs, n, "grad")
    x = _f32((2, 48, 40), 26).astype(np.float64 if dtype == "f64" else np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.sin(jhalo.resize_sharded(
        v, (24, 20), _mesh(n), mode="bicubic", data_format="CHW",
        use_pallas=False))))(jnp.asarray(x))
    got = sum(r[dtype] for r in res).numpy()
    assert float(np.abs(got - np.asarray(want)).max()) <= (1e-5 if dtype == "f32" else 1e-12)


@pytest.mark.parametrize("n", NS)
def test_group_forward_mode_matches_jax_jvp(group_runs, n):
    res = _ranks(group_runs, n, "jvp")
    x = _f32((2, 48, 40), 27).astype(np.float64)
    t = _f32((2, 48, 40), 28).astype(np.float64)
    y, ty = jax.jvp(lambda v: jhalo.resize_sharded(v, (24, 20), _mesh(n), mode="bicubic",
                                                   use_pallas=False), (jnp.asarray(x),),
                    (jnp.asarray(t),))
    np.testing.assert_allclose(torch.cat([r["y"] for r in res], 1).numpy(), np.asarray(y),
                               atol=1e-12)
    np.testing.assert_allclose(torch.cat([r["t"] for r in res], 1).numpy(), np.asarray(ty),
                               atol=1e-12)


@pytest.mark.parametrize("route", ["kernel", "dense"])
@pytest.mark.parametrize("n", NS)
def test_group_adjoint_identity(group_runs, n, route):
    """<W x, y> == <x, W^T y> through halo_resize_h's whole chain across
    ranks (pad, ring exchange and its fold, local contraction, cut)."""
    res = _ranks(group_runs, n, "adjoint")
    up = route == "kernel"
    lhs = sum(r[f"lhs_{up}"] for r in res)
    rhs = sum(r[f"rhs_{up}"] for r in res)
    assert abs(lhs - rhs) <= 1e-5 * max(1.0, abs(lhs)), (lhs, rhs)


@pytest.mark.parametrize("n", NS)
def test_group_only_the_ring_communicates(group_runs, n):
    """A sharded call makes the ring's two sends and two receives and
    nothing else (no all-gather, no DTensor redistribution); its backward
    the fold's two and two; ``data_parallel_resize`` none."""
    res = _ranks(group_runs, n, "collectives")
    ring = {"c10d.send.default": 2, "c10d.recv_.default": 2}
    for r in res:
        assert r["resize_sharded"] == ring, r
        assert r["halo_resize_h"] == ring, r
        assert r["resize_sharded_pil_exact"] == ring, r
        assert r["resize_sharded backward"] == ring, r
        assert r["data_parallel_resize"] == {}, r


@pytest.mark.parametrize("n", NS)
def test_group_data_parallel_resize(group_runs, n):
    res = _ranks(group_runs, n, "data_parallel")
    x = _f32((2 * n + 1, 3, 40, 56), 32)
    for r in res:
        assert r["is_dtensor"] and r["shard_batch_block"] and r["local_is_resize"]
        assert r["sharded_in_equal"] and r["shape"] == (2 * n + 1, 3, 20, 28)
    got = torch.cat([r["y"] for r in res], 0).numpy()
    np.testing.assert_allclose(got, np.asarray(ia.resize(jnp.asarray(x), (20, 28))), atol=1e-4)


def _single_device_trainer():
    imgs, labels = _train_batch()
    tr = iat.Trainer(resize_to=(16, 16), device="cpu")
    losses = [float(tr.step(torch.from_numpy(imgs), torch.from_numpy(labels)))
              for _ in range(2)]
    return losses, tr.params


@pytest.mark.parametrize("case", ["trainer_data", "trainer_dp_sp"])
@pytest.mark.parametrize("n", NS)
def test_group_trainer_matches_single_device(group_runs, n, case):
    """Two steps on a data mesh, and on dp x sp (the resize sharded over H
    and gathered): the loss and every parameter on every rank equal the
    single-device Trainer's to 1e-5 relative."""
    res = _ranks(group_runs, n, case)
    losses, params = _single_device_trainer()
    for r in res:
        for a, b in zip(r["losses"], losses):
            assert abs(a - b) <= 1e-5 * abs(b), (r["losses"], losses)
        for k, p in params.items():
            want = p.detach().numpy()
            err = np.abs(r[k].numpy() - want).max()
            assert err <= 1e-5 * np.abs(want).max(), (k, err)


@pytest.mark.parametrize("check,want", [
    ("make_mesh_too_big", "ValueError: mesh shape"),
    ("trainer_not_a_mesh", "TypeError: mesh must be a torch.distributed DeviceMesh"),
    ("step_not_a_mesh", "TypeError: mesh must be a torch.distributed DeviceMesh"),
    ("step_without_data_axis", "ValueError: mesh has no data axis"),
    ("resize_on_missing_axis", "ValueError: mesh has no axis 'rows'"),
    ("wrong_placement", "ValueError: x must be sharded Shard(2)"),
])
def test_mesh_arguments_are_checked(group_runs, check, want):
    res = _ranks(group_runs, 2, "mesh_checks")
    for r in res:
        assert r[check].startswith(want), r[check]
        assert r["mesh"] == ((2,), ("sp",), "cpu")


def test_dryrun_multichip_four_ranks():
    """The port of ``__graft_entry__.dryrun_multichip``: a dp x sp train
    step, the sharded resize and its gradient with sizes the mesh does not
    divide, and the byte-exact route on its kernels equal to its gather
    route, over four spawned gloo ranks."""
    tpar.dryrun_multichip(4)
