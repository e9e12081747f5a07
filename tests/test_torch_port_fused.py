"""The port's in-kernel weight synthesis (``fused=True``) against the JAX
package's fused route.

On a CPU tensor ``cuda_resize.resize_axis`` / ``resize2d`` with
``fused=True`` run the fused kernels' plain versions, whose weights
(``_synth_tables``) are built with the kernels' float32 operations in their
order.  Two references, from the JAX package's ``_synth_band``:

* ``_synth_band`` evaluated op by op (eagerly) at ``banded_tiles(...)
  .starts``, tile by tile: the weights match within 2 float32 ulps of each
  output's largest weight for triangle and cubic (the sums' order), and
  within 3 for the sin/cos filters (Hamming, Lanczos), whose sin and cos
  come from XLA's CPU implementation on one side and torch's on the other
  (measured: at most 3).  The contraction of the input with those bands, in
  float64, holds the port's float outputs within 2e-6 * max|ref|.
* The fused kernels themselves, ``resize_axis_pallas`` / ``resize2d_pallas``
  with ``fused=True`` in Pallas interpret mode at ``precision="f32"`` (its
  default ``split`` drops a bf16 lo x lo product, a property of the TPU's
  matrix unit).  XLA compiles ``_synth_band`` inside the kernel to a band
  that differs from its eager value by up to 3.5e-6 per weight (measured
  at 906 -> 320 bilinear), which moves outputs by about 1e-5 relative; so
  float outputs are held within 3e-5 * max|ref|, the bound of the JAX
  package's own test of these kernels (tests/test_pallas_kernels.py:39).

uint8 outputs: within 1 of either (a float32 sum on either side of a
rounding boundary); bfloat16 outputs: within one bfloat16 step, 2^-8 *
max|ref|, for the same reason.  Inputs are made from a numpy seed and
handed to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu.ops import pallas_resize as jpr
from interpolate_antialiasing_tpu.ops.weights import banded_tiles as jbanded
from interpolate_antialiasing_tpu.ops.weights import make_axis_spec as jspec
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops.weights import adjoint_tables
from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec as tspec

TDT = {jnp.uint8: torch.uint8, jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
CONTINUOUS = ["bilinear", "bicubic", "hamming", "lanczos3", "lanczos5"]
SINC = ("hamming", "lanczos3", "lanczos5")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many tiny CPU ops per test; with several test workers on one host,
    torch's thread pools contend.  One thread per test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _input(shape, jdt, seed=0):
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    return (x * 255).astype(np.uint8) if jdt == jnp.uint8 else x


def _to_jax(x, jdt):
    return jnp.asarray(x).astype(jdt)


def _to_torch(x, jdt):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TDT[jdt])


def _assert_close(got: torch.Tensor, want, odt, f32_tol):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), dtype=np.float64)
    got = got.float().numpy().astype(np.float64)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    if odt == jnp.uint8:
        assert err <= 1.0, err
    elif odt == jnp.bfloat16:
        assert err <= 2.0**-8 * scale, (err, scale)
    else:
        assert err <= f32_tol * scale, (err, scale)


JAX_KERNEL_TOL = 3e-5  # tests/test_pallas_kernels.py:39
EAGER_TOL = 2e-6


def _eager_band_matrix(js) -> np.ndarray:
    """``W[out, in]`` (float64) of the bands ``_synth_band`` builds, eagerly,
    at ``_pass_last``'s tiles."""
    bt = jbanded(js, tile=128, dtype=np.float32, align=128)
    W = np.zeros((js.out_size, js.in_size))
    for t, start in enumerate(bt.starts):
        band = np.asarray(jpr._synth_band(js, jnp.int32(int(start)), t, 128, bt.k_in))
        n = min(128, js.out_size - t * 128)
        cols = min(bt.k_in, js.in_size - int(start))
        W[t * 128:t * 128 + n, int(start):int(start) + cols] = band[:cols, :n].T
    return W


def _eager_pass(x: np.ndarray, js, axis: int) -> np.ndarray:
    y = np.moveaxis(x.astype(np.float64), axis, -1) @ _eager_band_matrix(js).T
    return np.moveaxis(y, -1, axis)


# tests/test_pallas_kernels.py's CASES: (shape, out, axis, mode)
AXIS_CASES = [
    ((2, 3, 50, 906), 320, 3, "bilinear"),
    ((2, 3, 438, 64), 196, 2, "bicubic"),
    ((1, 3, 438, 906), 196, 2, "bilinear"),
    ((4, 37, 53, 3), 80, 1, "bicubic"),
    ((2, 3, 40, 60), 90, 3, "bilinear"),
    ((1, 3, 438, 906), 196, 2, "box"),
    ((2, 130, 140), 64, 1, "bilinear"),  # 3-D input
]


@pytest.mark.parametrize("shape,out,axis,mode", AXIS_CASES)
def test_resize_axis_fused_matches_jax(shape, out, axis, mode):
    x = _input(shape, jnp.float32, seed=1)
    js = jspec(shape[axis], out, mode)
    want = jpr.resize_axis_pallas(jnp.asarray(x), js, axis, fused=True, precision="f32")
    got = cr.resize_axis(torch.from_numpy(x), tspec(shape[axis], out, mode), axis,
                         fused=True)
    _assert_close(got, want, jnp.float32, JAX_KERNEL_TOL)
    if cr.synth_applies(tspec(shape[axis], out, mode)):
        _assert_close(got, _eager_pass(x, js, axis), jnp.float32, EAGER_TOL)


# tests/test_resize2d_fused.py's CASES, and test_fused_synth_pipeline's
# 438x906 uint8 image: (shape, (oh, ow), mode, in, out)
PLANE_CASES = [
    ((2, 3, 438, 906), (196, 320), "bilinear", jnp.uint8, jnp.uint8),
    ((2, 3, 438, 906), (196, 320), "bicubic", jnp.uint8, jnp.float32),
    ((1, 3, 100, 150), (250, 75), "bilinear", jnp.float32, jnp.float32),
    ((2, 130, 140), (64, 72), "bilinear", jnp.float32, jnp.float32),
    ((1, 1, 512, 768), (256, 384), "bilinear", jnp.bfloat16, jnp.bfloat16),
    ((2, 3, 96, 128), (96, 128), "box", jnp.uint8, jnp.uint8),
    ((1, 3, 438, 906), (196, 320), "bilinear", jnp.uint8, jnp.uint8),
]


@pytest.mark.parametrize("shape,ohw,mode,idt,odt", PLANE_CASES)
def test_resize2d_fused_matches_jax(shape, ohw, mode, idt, odt):
    x = _input(shape, idt, seed=2)
    jh, jw = jspec(shape[-2], ohw[0], mode), jspec(shape[-1], ohw[1], mode)
    want = jpr.resize2d_pallas(_to_jax(x, idt), jh, jw, out_dtype=odt,
                               precision="f32", fused=True)
    xt = _to_torch(x, idt)
    sh, sw = tspec(shape[-2], ohw[0], mode), tspec(shape[-1], ohw[1], mode)
    got = cr.resize2d(xt, sh, sw, TDT[odt], fused=True)
    assert got.dtype == TDT[odt] and tuple(got.shape) == (*shape[:-2], *ohw)
    _assert_close(got, want, odt, JAX_KERNEL_TOL)
    if cr.synth_applies(sh):
        y = _eager_pass(xt.double().numpy(), jw, -1)
        if idt == odt == jnp.uint8:
            y = np.clip(np.floor(y + 0.5), 0, 255)
        y = _eager_pass(y, jh, -2)
        if odt == jnp.uint8:
            y = np.clip(np.floor(y + 0.5), 0, 255)
        _assert_close(got, y, odt, EAGER_TOL)


def _spec_kw(variant):
    return {"plain": {}, "align_corners": dict(align_corners=True),
            "span": dict(span=(3.5, 90.0))}[variant]


@pytest.mark.parametrize("variant", ["plain", "align_corners", "span"])
@pytest.mark.parametrize("mode", CONTINUOUS)
def test_every_continuous_filter_matches_jax(mode, variant):
    """Each filter the kernels synthesise, down- and upsampling, on the last
    and a middle axis, with align_corners and a span."""
    x = _input((2, 50, 97), jnp.float32, seed=3)
    for n_in, n_out, axis in ((97, 40, 2), (50, 120, 1)):
        kw = _spec_kw(variant)
        if "span" in kw:
            kw = dict(span=(3.5, min(90.0, float(n_in))))
        js = jspec(n_in, n_out, mode, **kw)
        want = jpr.resize_axis_pallas(jnp.asarray(x), js, axis, fused=True, precision="f32")
        got = cr.resize_axis(torch.from_numpy(x), tspec(n_in, n_out, mode, **kw), axis,
                             fused=True)
        _assert_close(got, want, jnp.float32, JAX_KERNEL_TOL)
        _assert_close(got, _eager_pass(x, js, axis), jnp.float32, EAGER_TOL)


@pytest.mark.parametrize("variant", ["plain", "align_corners", "span"])
@pytest.mark.parametrize("mode", CONTINUOUS)
@pytest.mark.parametrize("n_in,n_out", [(906, 320), (50, 300)])
def test_synthesised_weights_match_synth_band(mode, variant, n_in, n_out):
    """The weights of every output against ``_synth_band`` at the tiles'
    starts (``_pass_last``'s tiling): every nonzero synthesised tap lies in
    its tile's band, and the two agree within the stated ulps."""
    kw = _spec_kw(variant)
    if "span" in kw:
        kw = dict(span=(3.5, min(90.0, float(n_in))))
    js, ts = jspec(n_in, n_out, mode, **kw), tspec(n_in, n_out, mode, **kw)
    first, w = cr._synth_tables(ts, torch.device("cpu"))
    first, w = first.numpy(), w.numpy()
    np.testing.assert_array_equal(first, cr._synth_first(ts))
    bt = jbanded(js, tile=128, dtype=np.float32, align=128)
    ulps = 3 if mode in SINC else 2
    for t, start in enumerate(bt.starts):
        band = np.asarray(jpr._synth_band(js, jnp.int32(int(start)), t, 128, bt.k_in))
        for u in range(min(128, n_out - t * 128)):
            o = t * 128 + u
            mine = np.zeros(bt.k_in, np.float32)
            k = np.nonzero(w[o])[0]
            p = first[o] + k - int(start)
            assert ((p >= 0) & (p < bt.k_in)).all(), (o, p)
            mine[p] = w[o, k]
            ref = band[:, u]
            err = np.abs(mine.astype(np.float64) - ref).max()
            assert err <= ulps * np.spacing(np.abs(ref).max()), (o, err)


@pytest.mark.parametrize("kw", [dict(mode="box"), dict(mode="area"),
                                dict(mode="bicubic", antialias=False),
                                dict(mode="bilinear", antialias=False)],
                         ids=["box", "area", "bicubic_no_aa", "bilinear_no_aa"])
def test_gated_specs_run_the_tables(kw):
    """box, area and the replicate border of antialias=False are the JAX
    package's gate: fused=True runs the table route, bit for bit."""
    x = torch.from_numpy(_input((2, 3, 57, 83), jnp.float32, seed=4))
    mode = kw.pop("mode")
    sh, sw = tspec(57, 24, mode, **kw), tspec(83, 130, mode, **kw)
    assert not cr.synth_applies(sh) and not cr.synth_applies(sw)
    assert torch.equal(cr.resize2d(x, sh, sw, fused=True), cr.resize2d(x, sh, sw))
    assert torch.equal(cr.resize_axis(x, sw, -1, fused=True), cr.resize_axis(x, sw, -1))


def test_tables_with_fused_raise():
    x = torch.zeros((2, 31, 40))
    t = adjoint_tables(tspec(64, 31, "bicubic"))
    with pytest.raises(ValueError, match="no closed form"):
        cr.resize_axis(x, t, 1, fused=True)
    with pytest.raises(ValueError, match="no closed form"):
        cr.resize2d(torch.zeros((2, 31, 31)), t, t, fused=True)


def test_fused_runs_the_fused_plain_versions(monkeypatch):
    """On a CPU tensor, fused=True runs the fused plain versions (and only
    them) where the gate admits the specs; fused=False the table ones."""
    calls = []
    for name in ("_resample2d_fused_plain", "_resample_axis_fused_plain",
                 "_resample2d_plain", "_resample_axis_plain"):
        orig = getattr(cr, name)
        monkeypatch.setattr(cr, name, lambda *a, _n=name, _f=orig: calls.append(_n) or _f(*a))
    x = torch.from_numpy(_input((2, 40, 60), jnp.float32, seed=5))
    sh, sw = tspec(40, 20, "bicubic"), tspec(60, 90, "bicubic")
    cr.resize2d(x, sh, sw, fused=True)
    cr.resize_axis(x, sw, -1, fused=True)
    assert calls == ["_resample2d_fused_plain", "_resample_axis_fused_plain"]
    calls.clear()
    cr.resize2d(x, sh, sw)
    assert calls == ["_resample2d_plain"]


def test_one_fused_pass_runs_each_pass_on_its_own(monkeypatch):
    """Specs the gate splits (one continuous, one box) run two axis passes,
    each with its own weights: the same values as one resample2d launch."""
    x = torch.from_numpy(_input((2, 40, 60), jnp.float32, seed=6))
    sh, sw = tspec(40, 20, "box"), tspec(60, 90, "lanczos3")
    got = cr.resize2d(x, sh, sw, fused=True)
    want = cr.resize_axis(cr.resize_axis(x, sw, -1, fused=True), sh, -2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("idt,odt", [(torch.uint8, torch.uint8), (torch.float32, torch.float32)])
def test_no_tile_runs_two_fused_axis_passes(monkeypatch, idt, odt):
    """Where no output tile's row window fits a block (the plan is None),
    resize2d(fused=True) runs two fused axis passes, the u8 -> u8
    intermediate on the uint8 lattice as in the one-launch kernel."""
    x = _to_torch(_input((2, 40, 60), jnp.uint8 if idt == torch.uint8 else jnp.float32, 7),
                  jnp.uint8 if idt == torch.uint8 else jnp.float32)
    sh, sw = tspec(40, 20, "bilinear"), tspec(60, 90, "bicubic")
    want = cr.resize2d(x, sh, sw, odt, fused=True)
    monkeypatch.setattr(cr, "_plan2d_synth", lambda *a: None)
    calls = []
    orig = cr._resample_axis_fused_plain
    monkeypatch.setattr(cr, "_resample_axis_fused_plain",
                        lambda *a: calls.append(a[1]) or orig(*a))
    got = cr.resize2d(x, sh, sw, odt, fused=True)
    assert calls == [sw, sh]
    assert torch.equal(got, want)


def test_synth_first_plans_the_kernels_window():
    """The host's float32 first taps (numpy) equal the plain version's
    (torch) on every spec kind, and the fused plan covers the windows: every
    tap of a row tile in its window, of a column tile in its span, the block
    within the per-block budget."""
    specs = (tspec(2160, 1080, "bilinear"), tspec(438, 196, "bicubic"),
             tspec(97, 131, "lanczos3", align_corners=True),
             tspec(97, 40, "hamming", span=(3.5, 90.0)), tspec(64, 196, "lanczos5"))
    for spec in specs:
        first = cr._synth_first(spec)
        np.testing.assert_array_equal(first, cr._synth_tables(spec, torch.device("cpu"))[0])
    for spec, spec_w in zip(specs, specs[1:] + specs[:1]):
        plan = cr._plan2d_synth(spec, spec_w)
        for sp, tile, cap in ((spec, plan.tile_r, plan.rows_cap),
                              (spec_w, plan.tile_c, plan.cols_cap)):
            first = cr._synth_first(sp)
            lo = np.clip(first, 0, sp.in_size - 1)
            hi = np.clip(first + sp.ntaps - 1, 0, sp.in_size - 1) + 1
            for o0 in range(0, sp.out_size, tile):
                assert hi[o0:o0 + tile].max() - lo[o0:o0 + tile].min() <= cap
        assert plan.tile_c in plans.TILE_C and 1 <= plan.chunk <= plan.rows_cap
        assert plan.smem == plans._smem_bytes(plan.tile_r, plan.tile_c, plan.rows_cap,
                                              plan.cols_cap, plan.chunk, spec_w.ntaps,
                                              spec.ntaps, 4)
        assert plan.smem <= plans._SMEM_BUDGET
