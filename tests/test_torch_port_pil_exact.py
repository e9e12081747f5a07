"""The port's resize_pil_exact (plain version on CPU tensors) is byte-equal
to the JAX package's Pillow kernel route and to Pillow itself.

On the JAX side the TPU kernel ``_kernel_2pass_pil`` runs in Pallas
interpret mode: ``_use_tpu_kernels`` is patched to True, as
tests/test_models.py does, and each case asserts that the whole-image kernel
admits its shape, so the bytes compared are that kernel's.  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.ops import pil_exact as tpe
from interpolate_antialiasing_tpu_torch.ops import plans

PIL = pytest.importorskip("PIL.Image")

MODES = ["bilinear", "bicubic", "lanczos3", "box", "hamming"]
# the shapes of tests/test_pil_exact.py::test_digit_split_pallas_bit_identical
SHAPES = [(64, 96, 32, 40), (57, 83, 24, 31), (40, 120, 96, 48), (33, 31, 65, 67)]


@pytest.fixture()
def jax_kernel_route(monkeypatch):
    monkeypatch.setattr(jpe, "_use_tpu_kernels", lambda: True)


def _img(shape, seed=7):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("digits", [3, 2])
@pytest.mark.parametrize("hwos", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_byte_equal_to_jax_kernel(jax_kernel_route, mode, hwos, digits):
    H, W, oh, ow = hwos
    img = _img((2, H, W))
    assert jpe.pil_exact_pallas_supported((2, H, W), oh, ow, mode)
    want = np.asarray(jpe.resize_pil_exact(jnp.asarray(img), (oh, ow),
                                           method=mode, digits=digits))
    got = tpe.resize_pil_exact(torch.from_numpy(img), (oh, ow), method=mode,
                               digits=digits)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_byte_equal_to_jax_kernel_nhwc(jax_kernel_route):
    img = _img((2, 40, 60, 3))
    assert jpe.pil_exact_pallas_supported((2, 3, 40, 60), 20, 30, "bicubic")
    want = np.asarray(jpe.resize_pil_exact(jnp.asarray(img), (20, 30),
                                           method="bicubic", data_format="NHWC"))
    got = tpe.resize_pil_exact(torch.from_numpy(img), (20, 30),
                               method="bicubic", data_format="NHWC")
    assert got.shape == (2, 20, 30, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_direct_kernel_call_matches_wrapper():
    """The JAX package's _resize_pil_exact_pallas, called directly in
    interpret mode, against the port's kernel wrapper on the same tables."""
    img = _img((3, 57, 83))
    want = np.asarray(jpe._resize_pil_exact_pallas(jnp.asarray(img), 24, 31,
                                                   "lanczos3"))
    got = tpe._resample_2pass(torch.from_numpy(img),
                              tpe._int_tables(83, 31, "lanczos3"),
                              tpe._int_tables(57, 24, "lanczos3"))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "mode,box",
    [("bilinear", (3.3, 4.25, 61.7, 45.5)), ("lanczos3", (0.5, 0.0, 70.0, 33.75)),
     ("hamming", (10.0, 2.5, 20.0, 48.0))],
)
def test_box_route_matches_jax(mode, box):
    img = _img((3, 50, 70))
    want = np.asarray(jpe.resize_pil_exact(jnp.asarray(img), (20, 31),
                                           method=mode, box=box))
    got = tpe.resize_pil_exact(torch.from_numpy(img), (20, 31), method=mode,
                               box=box)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("box", [None, (2.5, 1.0, 60.25, 40.0)])
@pytest.mark.parametrize("size", [(20, 31), (90, 130)])
def test_pil_nearest_matches_jax(size, box):
    img = _img((2, 3, 50, 70))
    want = np.asarray(jpe.resize_pil_exact(jnp.asarray(img), size,
                                           method="pil_nearest", box=box))
    got = tpe.resize_pil_exact(torch.from_numpy(img), size,
                               method="pil_nearest", box=box)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "mode,pil_mode,hwos",
    [("bilinear", "BILINEAR", (438, 906, 196, 320)),
     ("lanczos3", "LANCZOS", (96, 120, 196, 1200))],
)
def test_matches_pillow(mode, pil_mode, hwos):
    H, W, oh, ow = hwos
    img = _img((H, W, 3))
    want = np.asarray(PIL.fromarray(img).resize((ow, oh), getattr(PIL, pil_mode)))
    got = tpe.resize_pil_exact(torch.from_numpy(img), (oh, ow), method=mode,
                               data_format="HWC")
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensor_leaves_launch_counter():
    before = native.launches["pil_resample_2pass"]
    tpe.resize_pil_exact(torch.from_numpy(_img((2, 3, 40, 60))), (20, 30))
    tpe._resample_2pass(torch.from_numpy(_img((2, 40, 60))),
                        tpe._int_tables(60, 30, "bilinear"),
                        tpe._int_tables(40, 20, "bilinear"))
    assert native.launches["pil_resample_2pass"] == before == 0


def test_overflow_check():
    """255 * max row sum|Wb| + 2^(pb-1) must stay below 2^31."""
    x3 = torch.zeros((1, 8, 8), dtype=torch.uint8)
    ok = tpe._int_tables(8, 4, "bilinear")
    big = (np.zeros(4, np.int32), np.full((4, 3), 1 << 23, np.int32))
    with pytest.raises(ValueError, match="overflow"):
        tpe._resample_2pass(x3, big, ok)
    with pytest.raises(ValueError, match="overflow"):
        tpe._resample_2pass(x3, ok, big)
    # the shipped filters' worst row (lanczos3 906->320) is far inside
    _, Wb = tpe._int_tables(906, 320, "lanczos3")
    assert 255 * int(np.abs(Wb.astype(np.int64)).sum(1).max()) + (1 << 21) < 2**31


def test_wrapper_rejects_what_the_kernel_does_not_take():
    tw = tpe._int_tables(8, 4, "bilinear")
    with pytest.raises(ValueError, match="uint8"):
        tpe._resample_2pass(torch.zeros((1, 8, 8)), tw, tw)
    with pytest.raises(ValueError, match="uint8"):
        tpe._resample_2pass(torch.zeros((8, 8), dtype=torch.uint8), tw, tw)
    with pytest.raises(ValueError, match="contiguous"):
        tpe._resample_2pass(torch.zeros((1, 8, 16), dtype=torch.uint8)[..., ::2],
                            tw, tw)
    with pytest.raises(ValueError, match="tables"):
        tpe._resample_2pass(torch.zeros((1, 8, 8), dtype=torch.uint8),
                            (tw[0][:2], tw[1]), tw)
    with pytest.raises(ValueError, match="not on meta"):
        tpe._resample_2pass(torch.zeros((1, 8, 8), dtype=torch.uint8,
                                        device="meta"), tw, tw)


def test_row_plan_fits_shared_memory():
    """The kernel's tile (kernel A's plan over Pillow's tables, one-byte
    elements and intermediate), planned on the host: the layout fits a
    block, and every tap of every output lies in its tile's row window and
    column span.  Where no tile fits (a 20000-row lanczos3 window), the plan
    is None and the wrapper's two pil_resample_axis passes give the same
    bytes."""
    for n_in, n_out, mode in [(438, 196, "bilinear"), (2160, 1080, "bilinear"),
                              (3840, 24, "lanczos3"), (33, 65, "bicubic")]:
        tab = tpe._int_tables(n_in, n_out, mode)
        plan = plans.plan_pil_2pass(tab, tab, 3, n_in, n_in)
        assert plan is not None and plan.smem <= plans._SMEM_BUDGET
        assert plan.smem == plans._smem_bytes(plan.tile_r, plan.tile_c, plan.rows_cap,
                                              plan.cols_cap, plan.chunk, tab[1].shape[1],
                                              tab[1].shape[1], 1, 1)
        lo = np.clip(tab[0].astype(np.int64)[:, None] + np.arange(tab[1].shape[1]),
                     0, n_in - 1)
        for tile, cap in ((plan.tile_r, plan.rows_cap), (plan.tile_c, plan.cols_cap)):
            assert 1 <= cap <= n_in
            for t in range(-(-n_out // tile)):
                rows_t = lo[t * tile:(t + 1) * tile]
                assert rows_t.max() - rows_t.min() + 1 <= cap
    tab = tpe._int_tables(20000, 10, "lanczos3")
    small = tpe._int_tables(64, 32, "bilinear")
    assert plans.plan_pil_2pass(small, tab, 1, 20000, 64) is None
    x3 = torch.from_numpy(_img((1, 20000, 64)))
    np.testing.assert_array_equal(tpe._resample_2pass_axes(x3, small, tab, 22).numpy(),
                                  tpe._resample_2pass_plain(x3, small, tab).numpy())


def test_digits2_declined_for_wide_windows():
    img = torch.from_numpy(_img((1, 8, 906)))
    # 906 -> 8 lanczos3 needs ntaps > 57: the dial keeps the exact grid
    np.testing.assert_array_equal(
        tpe.resize_pil_exact(img, (4, 8), method="lanczos3", digits=2).numpy(),
        tpe.resize_pil_exact(img, (4, 8), method="lanczos3", digits=3).numpy())


def test_digits_env_dial(monkeypatch):
    img = torch.from_numpy(_img((2, 57, 83)))
    monkeypatch.setenv("IA_TPU_PIL_DIGITS", "2")
    via_env = tpe.resize_pil_exact(img, (24, 31), method="bicubic")
    np.testing.assert_array_equal(
        via_env.numpy(),
        tpe.resize_pil_exact(img, (24, 31), method="bicubic", digits=2).numpy())
    monkeypatch.setenv("IA_TPU_PIL_DIGITS", "5")
    with pytest.raises(ValueError, match="IA_TPU_PIL_DIGITS"):
        tpe.resize_pil_exact(img, (24, 31))


def test_rejects_like_jax():
    xt = torch.zeros((3, 20, 20), dtype=torch.uint8)
    xj = jnp.zeros((3, 20, 20), jnp.uint8)
    for kw in [dict(digits=4), dict(box=(0.0, 0.0, 30.0, 10.0)),
               dict(box=(5.0, 0.0, 5.0, 10.0)), dict(reducing_gap=0.5)]:
        with pytest.raises(ValueError) as et:
            tpe.resize_pil_exact(xt, (10, 10), **kw)
        with pytest.raises(ValueError) as ej:
            jpe.resize_pil_exact(xj, (10, 10), **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="uint8"):
        tpe.resize_pil_exact(torch.zeros((3, 20, 20)), (10, 10))
    # reducing_gap, once refused here, now gives the JAX package's bytes
    # (a 2 x 2 reduce, then the resample)
    img = _img((3, 20, 20))
    np.testing.assert_array_equal(
        tpe.resize_pil_exact(torch.from_numpy(img), (10, 10), reducing_gap=1.0).numpy(),
        np.asarray(jpe.resize_pil_exact(jnp.asarray(img), (10, 10), reducing_gap=1.0)))
