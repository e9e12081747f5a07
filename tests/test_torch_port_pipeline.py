"""The port's main path as a whole: ``resize`` routing and the uint8
ImageNet-eval pipeline against the JAX package with its accelerator route
forced (``_on_tpu`` and ``_use_tpu_kernels`` patched to True, as
tests/test_models.py does), plus the port's import and build contracts."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu as ia
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu.models import ImageNetEvalPipeline as JaxPipeline
from interpolate_antialiasing_tpu.ops import pil_exact as jpe
from interpolate_antialiasing_tpu.ops import resize as jresize
from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.config import ResizeOptions
from interpolate_antialiasing_tpu_torch.models import imagenet_eval_preprocess
from interpolate_antialiasing_tpu_torch.ops import pil_exact as tpe

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture()
def jax_accel_route(monkeypatch):
    monkeypatch.setattr(jresize, "_on_tpu", lambda: True)
    monkeypatch.setattr(jpe, "_use_tpu_kernels", lambda: True)


def _img(shape, seed=3):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize(
    "shape,kw",
    [((2, 3, 100, 150), dict(size=(64, 96))),
     ((2, 3, 300, 350), dict(size=(225, 225), short_side=256))],
    ids=["direct", "short_side_center_crop"],
)
def test_eval_pipeline_matches_jax(jax_accel_route, shape, kw):
    x = _img(shape)
    # the uint8 stage, byte for byte
    H, W = shape[-2:]
    if "short_side" in kw:
        s = kw["short_side"]
        hw = (s, int(s * W / H)) if H <= W else (int(s * H / W), s)
    else:
        hw = kw["size"]
    np.testing.assert_array_equal(
        iat.resize(torch.from_numpy(x), hw).numpy(),
        np.asarray(ia.resize(jnp.asarray(x), hw)))
    # the normalised output: float32 /255, -mean, /std in two frameworks
    want = np.asarray(JaxPipeline(**kw)(jnp.asarray(x)))
    got = iat.ImageNetEvalPipeline(**kw)(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_eval_preprocess_helper_and_crop_errors(jax_accel_route):
    x = _img((1, 3, 60, 80))
    np.testing.assert_allclose(
        imagenet_eval_preprocess(torch.from_numpy(x), (32, 40)).numpy(),
        np.asarray(JaxPipeline(size=(32, 40))(jnp.asarray(x))), rtol=0, atol=1e-6)
    with pytest.raises(ValueError) as et:
        iat.ImageNetEvalPipeline(size=(64, 300), short_side=32)(torch.from_numpy(x))
    with pytest.raises(ValueError) as ej:
        JaxPipeline(size=(64, 300), short_side=32)(jnp.asarray(x))
    assert str(et.value) == str(ej.value)


def test_pipeline_buffers_and_float_domain(jax_accel_route):
    pipe = iat.ImageNetEvalPipeline()
    assert set(dict(pipe.named_buffers())) == {"mean", "std"}
    assert pipe.mean.shape == (1, 3, 1, 1) and pipe.mean.dtype == torch.float32
    # the float32 domain, and a float input to the uint8-domain pipeline,
    # resize in float as the JAX pipeline does
    x = _img((1, 3, 20, 20))
    for kw, xin in [(dict(size=(8, 8), resize_domain="float32"), x),
                    (dict(size=(8, 8)), x.astype(np.float32))]:
        got = iat.ImageNetEvalPipeline(**kw)(torch.from_numpy(xin))
        want = np.asarray(JaxPipeline(**kw)(jnp.asarray(xin)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("method", ["nearest", "bicubic", "hamming"])
def test_auto_promotes_u8_to_pil_exact(jax_accel_route, method):
    x = _img((2, 3, 40, 60))
    got = iat.resize(torch.from_numpy(x), (20, 30), method=method)
    pil_method = "box" if method == "nearest" else method
    np.testing.assert_array_equal(
        got.numpy(),
        iat.resize_pil_exact(torch.from_numpy(x), (20, 30),
                             method=pil_method).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ia.resize(jnp.asarray(x), (20, 30), method=method)))


@pytest.mark.parametrize(
    "shape,kw",
    [((2, 40, 60, 3), dict(data_format="NHWC")),
     ((40, 60, 3), dict(data_format="HWC")),
     ((40, 60), {}),
     ((3, 40, 60), dict(box=(1.5, 2.0, 50.0, 33.0), method="bicubic")),
     ((3, 40, 60), dict(backend="pil_exact", method="lanczos3")),
     ((3, 40, 60), dict(options=ResizeOptions(method="box")))],
    ids=["nhwc", "hwc", "hw", "box", "backend_pil_exact", "options"],
)
def test_resize_routes_match_jax(jax_accel_route, shape, kw):
    x = _img(shape)
    jkw = dict(kw)
    if "options" in kw:
        jkw["options"] = ia.ResizeOptions(method=kw["options"].method)
    got = iat.resize(torch.from_numpy(x), (20, 30), **kw)
    want = np.asarray(ia.resize(jnp.asarray(x), (20, 30), **jkw))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "dtype,kw",
    [(torch.float32, {}),
     (torch.uint8, dict(method="nearest_legacy")),
     (torch.uint8, dict(method="area")),
     (torch.uint8, dict(method="lanczos5")),
     (torch.uint8, dict(align_corners=True)),
     (torch.uint8, dict(antialias=False)),
     (torch.uint8, dict(scale_factors=(0.5, 0.5))),
     (torch.uint8, dict(output_dtype=torch.float32)),
     (torch.uint8, dict(backend="xla")),
     (torch.uint8, dict(reducing_gap=1.0))],
    ids=["float32", "nearest_legacy", "area", "lanczos5", "align_corners",
         "no_antialias", "scale_factors", "float_out", "backend_xla",
         "reducing_gap"],
)
def test_unported_routes_raise(jax_accel_route, dtype, kw):
    """The routes that raised NotImplementedError in earlier slices of the
    port now match the JAX package's accelerator route (uint8 within 1,
    float32 within the tolerance of its kernel tests); reducing_gap (a 2 x 2
    reduce here, then the Pillow resample) byte for byte."""
    x = _img((1, 3, 20, 30))
    xin = x.astype(np.float32) if dtype == torch.float32 else x
    got = iat.resize(torch.from_numpy(xin), (10, 15), **kw)
    if "reducing_gap" in kw:
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(ia.resize(jnp.asarray(xin), (10, 15), **kw)))
        return
    jkw = dict(kw, output_dtype=jnp.float32) if "output_dtype" in kw else kw
    want = np.asarray(ia.resize(jnp.asarray(xin), (10, 15), **jkw))
    assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype
    err = np.abs(got.numpy().astype(np.float64) - want.astype(np.float64)).max()
    assert err <= (1 if want.dtype == np.uint8 else 255 * 2e-4 + 1e-3 * 255), err


@pytest.mark.parametrize(
    "shape,size,kw",
    [((1, 3, 20, 30), (0, 5), {}),
     ((1, 3, 20, 30), (5, -1), {}),
     ((1, 3, 0, 30), (5, 5), {}),
     ((1, 3, 20, 30), (5, 5), dict(data_format="NCWH")),
     ((1, 3, 20, 30), (5, 5), dict(box=(0.0, 0.0, 31.0, 20.0))),
     ((1, 3, 20, 30), (5, 5), dict(box=(4.0, 0.0, 4.0, 20.0))),
     ((1, 3, 20, 30), (5, 5), dict(box=(0.0, 0.0, 10.0, 10.0), method="area")),
     ((1, 3, 20, 30), (5, 5), dict(box=(0.0, 0.0, 10.0, 10.0),
                                   align_corners=True)),
     ((1, 3, 20, 30), (5, 5), dict(method="nearest_legacy", align_corners=True)),
     ((1, 3, 20, 30), (5, 5), dict(reducing_gap=2.0, antialias=False)),
     ((1, 3, 20, 30), (5, 5), dict(backend="pil_exact", align_corners=True)),
     ((1, 3, 20, 30), (5, 5), dict(backend="foo")),
     ((1, 3, 20, 30), (5, 5), dict(method="bicubic", options=True))],
    ids=["zero_h", "negative_w", "empty_input", "bad_format", "box_outside",
         "box_empty", "box_area", "box_align_corners", "legacy_align_corners",
         "reducing_gap_route", "pil_exact_align_corners", "unknown_backend",
         "options_and_kwargs"],
)
def test_bad_arguments_raise_like_jax(jax_accel_route, shape, size, kw):
    x = _img(shape)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("options"):
        tkw["options"], jkw["options"] = ResizeOptions(), ia.ResizeOptions()
    with pytest.raises(ValueError) as et:
        iat.resize(torch.from_numpy(x), size, **tkw)
    with pytest.raises(ValueError) as ej:
        ia.resize(jnp.asarray(x), size, **jkw)
    assert str(et.value) == str(ej.value)


def test_pil_exact_backend_rejects_float_like_jax():
    with pytest.raises(ValueError) as et:
        iat.resize(torch.zeros((1, 3, 20, 20)), (10, 10), backend="pil_exact")
    with pytest.raises(ValueError) as ej:
        ia.resize(jnp.zeros((1, 3, 20, 20), jnp.float32), (10, 10),
                  backend="pil_exact")
    assert str(et.value) == str(ej.value)


def test_env_backend_dial(monkeypatch):
    x = torch.from_numpy(_img((1, 3, 20, 30)))
    monkeypatch.setenv("IA_TPU_BACKEND", "xla")
    want = np.asarray(ia.resize(jnp.asarray(x.numpy()), (10, 15), backend="xla"))
    assert np.abs(iat.resize(x, (10, 15)).numpy().astype(int) - want).max() <= 1
    monkeypatch.setenv("IA_TPU_BACKEND", "pil_exact")
    np.testing.assert_array_equal(iat.resize(x, (10, 15)).numpy(),
                                  iat.resize_pil_exact(x, (10, 15)).numpy())


def test_debug_dial_prints_route(monkeypatch, capsys):
    monkeypatch.setenv("IA_TPU_DEBUG", "1")
    iat.resize(torch.from_numpy(_img((1, 3, 20, 30))), (10, 15))
    out = capsys.readouterr().out
    assert "pil_exact" in out and "pil_resample_2pass (cpu)" in out


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import interpolate_antialiasing_tpu_torch as iat\n"
        "import interpolate_antialiasing_tpu_torch.models\n"
        "import interpolate_antialiasing_tpu_torch.native\n"
        "import interpolate_antialiasing_tpu_torch.ops.cuda_resize\n"
        "import interpolate_antialiasing_tpu_torch.ops.resize_xla\n"
        "import interpolate_antialiasing_tpu_torch.ops.autograd\n"
        "import interpolate_antialiasing_tpu_torch.ops.api\n"
        "import interpolate_antialiasing_tpu_torch.ops.crop\n"
        "import interpolate_antialiasing_tpu_torch.ops.crop_cuda\n"
        "import interpolate_antialiasing_tpu_torch.models.train\n"
        "import interpolate_antialiasing_tpu_torch.models.aa_resize\n"
        "import interpolate_antialiasing_tpu_torch.utils.timing\n"
        "import interpolate_antialiasing_tpu_torch.utils.imageio\n"
        "import interpolate_antialiasing_tpu_torch.utils.metrics\n"
        "import interpolate_antialiasing_tpu_torch.parallel\n"
        "import interpolate_antialiasing_tpu_torch.parallel.halo\n"
        "import interpolate_antialiasing_tpu_torch.parallel.sharding\n"
        "import interpolate_antialiasing_tpu_torch.parallel.dryrun\n"
        "import interpolate_antialiasing_tpu_torch.ops.scale_translate\n"
        "import interpolate_antialiasing_tpu_torch.models.batch\n"
        "import interpolate_antialiasing_tpu_torch.models.pyramid\n"
        "import interpolate_antialiasing_tpu_torch.cli\n"
        "import interpolate_antialiasing_tpu_torch.utils.inspect as insp\n"
        "import interpolate_antialiasing_tpu_torch.utils.oracle as orc\n"
        "import torch\n"
        "x = torch.zeros((1, 3, 16, 16), dtype=torch.uint8)\n"
        "iat.ImageNetEvalPipeline(size=(8, 8))(x)\n"
        "iat.ImageNetEvalPipeline(size=(8, 8), resize_domain='float32')(x)\n"
        "iat.VideoDownscaler((8, 8))(x.float())\n"
        "iat.interpolate(x.float(), size=(8, 8), mode='bicubic', backend='dense')\n"
        "iat.resize_nd(x.float(), (5,), (-1,))\n"
        "g = torch.Generator().manual_seed(0)\n"
        "iat.random_resized_crop(g, x, (8, 8))\n"
        "iat.ImageNetTrainPipeline(size=(8, 8))(g, x)\n"
        "xf = x.float().requires_grad_()\n"
        "iat.resize_plane(xf, (8, 8), 2, 3).sum().backward()\n"
        "iat.Trainer(resize_to=(8, 8), device='cpu').step(x.float(), torch.zeros(1, dtype=torch.long))\n"
        "from interpolate_antialiasing_tpu_torch.parallel import halo\n"
        "plan = halo.plan_halo_banded(16, 8, 'bilinear', True, 2)\n"
        "ext = halo._extended_blocks(x.float(), plan, 2, 2)\n"
        "halo._shard_h_float(ext[0], plan, 0, 2)\n"
        "halo._shard_h_int(halo._extended_blocks(x, plan, 2, 2)[1], "
        "halo._int_halo_tables(16, 8, 'bilinear', 2), 1, 2)\n"
        "iat.scale_and_translate(x.float(), (1, 3, 8, 8), (2, 3), (0.5, 0.5), (0.0, 0.0))\n"
        "iat.scale_and_translate(x.float(), (1, 3, 8, 8), (2, 3), torch.tensor([0.5, 0.5]),"
        " torch.tensor([0.0, 0.0]))\n"
        "iat.reduce_pil_exact(x, 2)\n"
        "iat.resize(x, (4, 4), reducing_gap=1.0)\n"
        "iat.models.resize_mixed_batch([x[0].numpy()], (8, 8), device='cpu')\n"
        "iat.models.aa_pyramid(x.float(), 2)\n"
        "from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr\n"
        "from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec as m\n"
        "cr.resize2d(x, m(16, 8, 'lanczos3'), m(16, 8, 'hamming'), fused=True)\n"
        "interpolate_antialiasing_tpu_torch.native.compute_tables_native(16, 8, 'bicubic')\n"
        "insp.kernel_report((1, 3, 16, 16), (8, 8), device='cpu')\n"
        "insp.sharded_report(64, 32, 'bilinear', 2, 32)\n"
        "insp.lower_text(lambda: iat.resize(x, (8, 8)))\n"
        "orc.pil_available()\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    interpolate_antialiasing_tpu_torch.cli.main(['--device', 'cpu', '--inspect'])\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'interpolate_antialiasing_tpu.')) or m == "
        "'interpolate_antialiasing_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_nvcc", lambda: None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    native.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            native.build()
    finally:
        native.build.cache_clear()
    assert not (tmp_path / "_build").exists() or not any(
        (tmp_path / "_build").rglob("*.so"))


def test_build_is_keyed_by_sources():
    path = native._lib_path()
    assert path.parent.parent == native._BUILD_DIR
    assert path.name == native._LIB_NAME
    assert [p.name for p in native._sources()] == [
        "crop_resample.cu", "crop_resample_f32.cu", "crop_tables.cu", "launch_floor.cu",
        "pil_resample.cu",
        "pil_resample_axis.cu",
        "pil_resample_tc128.cu", "pil_resample_tc16.cu", "pil_resample_tc32.cu",
        "pil_resample_tc64.cu", "resample2d.cu",
        "resample2d_fused.cu", "resample2d_fused_tc128.cu", "resample2d_fused_tc16.cu",
        "resample2d_fused_tc32.cu", "resample2d_fused_tc64.cu", "resample2d_stream.cu",
        "resample2d_tc128.cu",
        "resample2d_tc16.cu", "resample2d_tc32.cu", "resample2d_tc64.cu", "resample_axis.cu",
        "resample_axis_synth_nt0.cu", "resample_axis_synth_nt16.cu", "resample_axis_synth_nt8.cu",
        "resample_axis_table_nt0.cu", "resample_axis_table_nt16.cu", "resample_axis_table_nt8.cu"]
    assert native._lib_path() == path  # stable for unchanged sources


def test_time_cuda_needs_a_card():
    from interpolate_antialiasing_tpu_torch.utils.timing import time_cuda

    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="CUDA"):
        time_cuda(lambda: None)


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits nonzero and prints no result where there is no
    card."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
