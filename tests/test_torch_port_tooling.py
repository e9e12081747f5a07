"""The port's tooling against the JAX package on the CPU: ``utils/oracle``
(byte-equal to the JAX oracle), ``utils/inspect`` (the route and launches
``kernel_report`` gives against the route ``resize`` prints under
IA_TPU_DEBUG=1; bytes and useful MACs against the JAX report; the bounds of
PERF.md's rows 1 and 5; ``sharded_report`` against the JAX report;
``lower_text``), the native table builder (against ``ops.weights`` and the
JAX package's build of the same source; two processes building it at once),
``utils/timing`` without a card, and the CLI on ``--device cpu``.

The card's side of the same tools (``compiled_text``,
``device_time_per_call``, ``kernel_report`` against the launch counters) is
in tests/test_torch_port_cuda.py and chip_smoke.py's ``cli`` phase."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu import native as jnative
from interpolate_antialiasing_tpu.cli import main as jax_cli
from interpolate_antialiasing_tpu.utils import inspect as jinspect
from interpolate_antialiasing_tpu.utils import oracle as joracle
from interpolate_antialiasing_tpu_torch import cli, config, native
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
from interpolate_antialiasing_tpu_torch.ops.weights import compute_tables, make_axis_spec
from interpolate_antialiasing_tpu_torch.utils import inspect as tinspect
from interpolate_antialiasing_tpu_torch.utils import oracle as toracle
from interpolate_antialiasing_tpu_torch.utils import timing

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Many small CPU ops; with several test workers on one host, torch's
    thread pools contend.  One thread per test, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(shape, seed=5):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


# ---------------------------------------------------------------------------
# utils/oracle
# ---------------------------------------------------------------------------

ORACLE_MODES = ["bilinear", "linear", "triangle", "bicubic", "cubic", "box",
                "nearest", "lanczos3", "hamming", "pil_nearest"]


@pytest.mark.parametrize("shape,out_hw", [((37, 53), (17, 29)), ((1, 41, 29), (20, 63)),
                                          ((3, 57, 83), (31, 24))],
                         ids=["hw", "chw1", "chw3_odd"])
@pytest.mark.parametrize("mode", ORACLE_MODES)
def test_oracle_byte_equal_to_jax_oracle(mode, shape, out_hw):
    pytest.importorskip("PIL")
    x = _img(shape)
    got = toracle.pil_resize(x, out_hw, mode)
    want = joracle.pil_resize(x, out_hw, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_oracle_raises_without_pillow(monkeypatch):
    monkeypatch.setattr(toracle, "_HAVE_PIL", False)
    assert not toracle.pil_available()
    with pytest.raises(RuntimeError, match="Pillow not available"):
        toracle.pil_resize(_img((8, 8)), (4, 4), "bilinear")


# ---------------------------------------------------------------------------
# kernel_report: the route resize takes, from the same decisions
# ---------------------------------------------------------------------------

def _debug_route(text: str) -> str:
    """The passes the IA_TPU_DEBUG=1 lines of one resize name, in order,
    " + "-joined as kernel_report's ``route``."""
    tokens = []
    for line in text.splitlines():
        if "pil_resample_2pass: no tile fits" in line:
            tokens[-1:] = ["pil_resample_axis", "pil_resample_axis"]
        elif m := re.match(r"\[ia-tpu\] pil_exact (pil_resample_2pass) ", line):
            tokens.append(m.group(1))
        elif m := re.match(r"\[ia-tpu\] (resample2d|resample_axis)( \(fused\))? (?!:)", line):
            tokens.append(m.group(1) + (m.group(2) or ""))
        elif m := re.match(r"\[ia-tpu\] axis=\d+ \d+->\d+ (\w+) ", line):
            tokens.append(m.group(1))
    return " + ".join(tokens)


# (id, shape, out_hw, dtype, keyword arguments, the route on a CPU tensor)
ROUTE_CASES = [
    ("u8_nchw_pil", (2, 3, 40, 56), (17, 23), torch.uint8, {}, "pil_resample_2pass"),
    ("u8_nhwc_pil", (2, 40, 56, 3), (17, 23), torch.uint8, dict(data_format="NHWC"),
     "pil_resample_2pass"),
    ("u8_explicit_pil_exact", (1, 3, 40, 56), (17, 23), torch.uint8,
     dict(backend="pil_exact", method="bicubic"), "pil_resample_2pass"),
    ("u8_to_f32", (1, 3, 40, 56), (17, 23), torch.uint8,
     dict(output_dtype=torch.float32), "resample2d"),
    ("u8_pallas", (1, 3, 40, 56), (17, 23), torch.uint8, dict(backend="pallas"),
     "resample2d"),
    ("u8_align_corners", (1, 3, 40, 56), (17, 23), torch.uint8,
     dict(align_corners=True), "resample2d"),
    ("f32_bilinear", (1, 3, 40, 56), (17, 23), torch.float32, {}, "resample2d"),
    ("f32_bicubic", (2, 3, 40, 56), (50, 23), torch.float32, dict(method="bicubic"),
     "resample2d"),
    ("f32_lanczos3", (1, 2, 64, 48), (30, 100), torch.float32, dict(method="lanczos3"),
     "resample2d"),
    ("bf16", (1, 3, 40, 56), (17, 23), torch.bfloat16, {}, "resample2d"),
    ("f16_computes_f32", (1, 3, 40, 56), (17, 23), torch.float16, {}, "resample2d"),
    ("f32_nhwc", (1, 40, 56, 3), (17, 23), torch.float32, dict(data_format="NHWC"),
     "resample_axis + resample_axis"),
    ("f32_align_corners", (1, 3, 40, 56), (17, 23), torch.float32,
     dict(align_corners=True, method="bicubic"), "resample2d"),
    ("f32_scale_factors", (1, 3, 40, 56), (20, 28), torch.float32,
     dict(scale_factors=(0.5, 0.5)), "resample2d"),
    ("f32_no_tile_fits", (2, 58200, 4), (1, 4), torch.float32, dict(method="box"),
     "resample_axis + resample_axis"),
    ("f64_small_dense", (1, 2, 30, 40), (11, 13), torch.float64, {}, "dense + dense"),
    ("f64_large_banded", (1, 1, 40, 400), (20, 200), torch.float64, {}, "banded + dense"),
    ("i32_computes_f64", (1, 1, 30, 40), (11, 13), torch.int32, {}, "dense + dense"),
    ("f32_dense", (1, 3, 40, 56), (17, 23), torch.float32, dict(backend="dense"),
     "dense + dense"),
    ("f32_gather", (1, 3, 40, 56), (17, 23), torch.float32, dict(backend="gather"),
     "gather + gather"),
    ("f32_banded", (1, 3, 40, 56), (17, 23), torch.float32, dict(backend="banded"),
     "banded + banded"),
    ("f32_xla", (1, 3, 40, 56), (17, 23), torch.float32, dict(backend="xla"),
     "dense + dense"),
]


def _input(shape, dtype, seed=3):
    x = torch.from_numpy(_img(shape, seed))
    return x if dtype == torch.uint8 else x.to(dtype)


@pytest.mark.parametrize("name,shape,out_hw,dtype,kw,want", ROUTE_CASES,
                         ids=[c[0] for c in ROUTE_CASES])
def test_kernel_report_route_is_the_route_resize_takes(monkeypatch, capsys, name, shape,
                                                       out_hw, dtype, kw, want):
    kw = dict(kw)
    method = kw.pop("method", "bilinear")
    rep = tinspect.kernel_report(shape, out_hw, mode=method, dtype=dtype, **kw,
                                 device="cpu")
    monkeypatch.setenv("IA_TPU_DEBUG", "1")
    capsys.readouterr()
    y = iat.resize(_input(shape, dtype), out_hw, method=method, **kw)
    printed = _debug_route(capsys.readouterr().out)
    assert rep.route == printed == want
    kernels = [t for t in want.split(" + ") if t.startswith(("pil_", "resample"))]
    assert rep.launches == {k: kernels.count(k) for k in kernels}
    assert rep.n_sm_assumed and rep.n_sm == 132
    assert rep.out_dtype == str(y.dtype).removeprefix("torch.")
    passes = want.split(" + ")
    assert [a["pass"] for a in rep.axes] == (passes * 2 if len(passes) == 1 else passes)


# (shape, out_hw, mode, jax dtype, torch dtype, keyword arguments)
JAX_REPORT_CASES = [
    ((1, 3, 43, 90), (19, 32), "bilinear", jnp.float32, torch.float32, {}),
    ((2, 3, 40, 56), (17, 23), "bicubic", jnp.float32, torch.float32, {}),
    ((1, 3, 64, 48), (30, 100), "lanczos3", jnp.float32, torch.float32, {}),
    ((1, 3, 43, 90), (19, 32), "bicubic", jnp.float32, torch.float32,
     dict(align_corners=True)),
    ((1, 3, 43, 90), (19, 32), "bicubic", jnp.float32, torch.float32, dict(antialias=False)),
    ((1, 43, 90, 3), (19, 32), "hamming", jnp.float32, torch.float32,
     dict(data_format="NHWC")),
    ((1, 3, 43, 90), (19, 32), "bilinear", jnp.float32, torch.float32, dict(backend="dense")),
    ((1, 3, 43, 90), (19, 32), "bilinear", jnp.float64, torch.float64, {}),
    ((1, 3, 43, 90), (19, 32), "bilinear", jnp.bfloat16, torch.bfloat16, {}),
    ((2, 3, 43, 90), (19, 32), "box", jnp.uint8, torch.uint8, {}),
]


@pytest.mark.parametrize("shape,out_hw,mode,jdt,tdt,kw", JAX_REPORT_CASES)
def test_kernel_report_counts_equal_the_jax_report(shape, out_hw, mode, jdt, tdt, kw):
    want = jinspect.kernel_report(shape, out_hw, mode, dtype=jdt, **kw)
    got = tinspect.kernel_report(shape, out_hw, mode, dtype=tdt, **kw)
    np.testing.assert_allclose(got.hbm_mbytes, want.hbm_mbytes, rtol=1e-12)
    if tdt != torch.uint8:  # the float routes' tables are the JAX bands'
        np.testing.assert_allclose(got.total_useful_mmacs, want.total_useful_mmacs,
                                   rtol=1e-12)
    assert [a["in_size"] for a in got.axes] == [a["in_size"] for a in want.axes]
    assert [a["out_size"] for a in got.axes] == [a["out_size"] for a in want.axes]


def test_kernel_report_counts_the_output_at_its_own_dtype():
    """The JAX report counts the output at the input's itemsize; the port at
    the output's (uint8 in, float32 out: three more bytes per output)."""
    shape, out_hw = (2, 3, 43, 90), (19, 32)
    want = jinspect.kernel_report(shape, out_hw, dtype=jnp.uint8, output_dtype=jnp.float32)
    got = tinspect.kernel_report(shape, out_hw, dtype=torch.uint8,
                                 output_dtype=torch.float32)
    assert got.route == "resample2d"
    np.testing.assert_allclose(got.hbm_mbytes - want.hbm_mbytes, 6 * 19 * 32 * 3 / 1e6,
                               rtol=1e-12)


@pytest.mark.parametrize("name,shape,out_hw,dtype,want", [
    ("bench batch, PERF.md row 1", (64, 3, 438, 906), (196, 320), torch.uint8, 0.0263),
    ("4K -> HD, PERF.md row 2", (3, 2160, 3840), (1080, 1920), torch.uint8, 0.0093),
    ("configs 1-2, PERF.md row 4", (1, 3, 438, 906), (196, 320), torch.float32, 0.0017),
    ("config 5, PERF.md row 5", (64, 3, 2160, 3840), (1080, 1920), torch.bfloat16, 1.1885),
])
def test_kernel_report_bound_is_perf_md(name, shape, out_hw, dtype, want):
    rep = tinspect.kernel_report(shape, out_hw, dtype=dtype, device="cpu")
    assert rep.bound_by == "bytes"
    # PERF.md gives the bounds to four decimals
    assert abs(rep.bound_ms - want) <= max(0.005 * want, 0.00005), (name, rep.bound_ms)
    # row 5 is a long launch: kernel A's streaming twin
    kernel = ("pil_resample_2pass" if dtype == torch.uint8
              else "resample2d_stream" if "row 5" in name else "resample2d")
    assert rep.launches == {kernel: 1}


def test_kernel_report_text_and_json():
    rep = tinspect.kernel_report((1, 3, 438, 906), (196, 320), mode="bicubic",
                                 dtype=torch.float32, device="cpu")
    text = str(rep)
    assert "route=resample2d" in text and "ntaps=" in text and "assumed" in text
    back = json.loads(rep.to_json())
    assert back["route"] == "resample2d" and back["plan"]["tile_c"] == rep.plan["tile_c"]
    assert len(back["axes"]) == 2 and back["bound_by"] == rep.bound_by


@pytest.mark.parametrize("in_h,out_h,mode,n,width", [
    (2160, 1080, "bilinear", 8, 1920),
    (32768, 8192, "bilinear", 4, None),
    (2160, 1080, "bicubic", 4, None),
    (2160, 1080, "lanczos3", 2, None),
])
def test_sharded_report_equals_the_jax_report(in_h, out_h, mode, n, width):
    want = jinspect.sharded_report(in_h, out_h, mode, n, width)
    got = tinspect.sharded_report(in_h, out_h, mode, n, width)
    assert set(want) - set(got) == {"digit_table_geometry"}
    assert set(got) - set(want) == {"int_table_geometry"}
    for k in set(want) & set(got):
        assert got[k] == want[k], k
    assert got["int_table_geometry"]["ntaps"] >= 1


def test_lower_text_lists_the_crop_table_build():
    x = torch.from_numpy(_img((2, 3, 40, 56)))
    boxes = torch.tensor([[0.1, 0.1, 0.8, 0.9], [0.0, 0.2, 0.7, 1.0]])
    text = tinspect.lower_text(lambda: iat.crop_and_resize(x, boxes, (16, 16)))
    n_ops, n_launch = map(int, re.match(r"# (\d+) aten ops, (\d+) kernel launches",
                                        text).groups())
    assert n_launch == 0  # a CPU tensor runs the plain passes
    assert n_ops == len(text.splitlines()) - 1
    tables = tinspect.lower_text(lambda: cc._windowed_tables(
        x, boxes, (16, 16), "bilinear", True, 1.0, "pil_int8"))
    n_tables = int(re.match(r"# (\d+) aten ops", tables).group(1))
    assert 0 < n_tables < n_ops
    for op in ("aten.floor.default", "aten.clamp.default", "aten.where.self"):
        assert op in tables
    # the table build's operators open the call's list, in the same order
    ops = [ln.split()[0] for ln in text.splitlines()[1:]]
    assert ops[:n_tables] == [ln.split()[0] for ln in tables.splitlines()[1:]]


# ---------------------------------------------------------------------------
# The native table builder and its build directory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_native_private(tmp_path_factory):
    """The JAX package's native builder, built once into a directory of this
    module's own (the default cache path is shared by every test process)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("IA_TPU_CACHE", str(tmp_path_factory.mktemp("jax_native")))
    mp.setattr(jnative, "_tried", False)
    mp.setattr(jnative, "_lib", None)
    available = jnative.native_available()
    yield available
    mp.undo()


@pytest.fixture()
def private_build_dir(tmp_path, monkeypatch):
    """This test's own build directory for the port's libraries, restored
    after."""
    monkeypatch.setattr(native, "_BUILD_DIR", native._BUILD_DIR)
    config.enable_compilation_cache(str(tmp_path / "cache"))
    yield tmp_path / "cache"
    native.build.cache_clear()
    native._tables_lib.cache_clear()


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "box", "lanczos3", "hamming"])
@pytest.mark.parametrize("insz,outsz", [(906, 320), (438, 196), (10, 4), (4, 10), (1, 1),
                                        (906, 1200)])
@pytest.mark.parametrize("ac", [False, True])
def test_native_tables_match_weights_and_jax(jax_native_private, mode, insz, outsz, ac):
    got = native.compute_tables_native(insz, outsz, mode, True, ac)
    assert got is not None, "the host C++ compiler did not build csrc/aa_tables.cpp"
    xm, sz, w = compute_tables(make_axis_spec(insz, outsz, mode, antialias=True,
                                              align_corners=ac), dtype=np.float64)
    np.testing.assert_array_equal(got[0], xm)
    np.testing.assert_array_equal(got[1], sz)
    # numpy normalises with pairwise summation, the C++ loop sequentially
    np.testing.assert_allclose(got[2], w, rtol=0, atol=1e-14)
    assert jax_native_private, "the JAX package's native builder did not build"
    jx = jnative.compute_tables_native(insz, outsz, mode, True, ac)
    for a, b in zip(got, jx):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
def test_native_tables_non_aa(jax_native_private, mode):
    got = native.compute_tables_native(50, 80, mode, False, False)
    xm, sz, w = compute_tables(make_axis_spec(50, 80, mode, antialias=False),
                               dtype=np.float64)
    np.testing.assert_array_equal(got[0], xm)
    np.testing.assert_allclose(got[2], w, rtol=0, atol=1e-14)
    assert jax_native_private
    for a, b in zip(got, jnative.compute_tables_native(50, 80, mode, False, False)):
        np.testing.assert_array_equal(a, b)


def test_native_disabled_by_env(monkeypatch):
    monkeypatch.setenv("IA_TPU_NO_NATIVE", "1")
    assert not native.native_available()
    assert native.compute_tables_native(10, 4, "bilinear") is None


_BUILD_CHILD = (
    "import sys\n"
    "from interpolate_antialiasing_tpu_torch import config, native\n"
    "config.enable_compilation_cache(sys.argv[1])\n"
    "t = native.compute_tables_native(906, 320, 'bicubic')\n"
    "assert t is not None and t[2].shape == (320, 13), t\n"
    "print('ok', native._tables_lib_path())\n"
)


def test_two_processes_build_the_table_library_at_once(tmp_path):
    """Two test workers that build the library at once both load a whole
    one: each compiles to a temporary name and renames it into place."""
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "IA_TPU_NO_NATIVE")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD, str(cache)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.startswith("ok ")
    libs = sorted(cache.rglob("*"))
    assert [p.name for p in libs if p.is_file()] == ["libaa_tables.so"], libs


def test_enable_compilation_cache_moves_the_build(private_build_dir, monkeypatch):
    assert native._lib_path().parent.parent == private_build_dir
    assert native._tables_lib_path().parent.parent == private_build_dir
    assert native.native_available()
    assert any(private_build_dir.rglob("libaa_tables.so"))
    # without an argument the environment variable names the directory
    other = private_build_dir.parent / "from_env"
    monkeypatch.setenv("IA_TPU_COMPILE_CACHE", str(other))
    assert config.enable_compilation_cache() == str(other)
    assert native._lib_path().parent.parent == other


def test_compilation_cache_default_changes_nothing(monkeypatch):
    before = native._BUILD_DIR
    monkeypatch.delenv("IA_TPU_COMPILE_CACHE", raising=False)
    assert config.enable_compilation_cache() is None
    assert native._BUILD_DIR == before
    # the variable alone moves nothing: only the call does
    monkeypatch.setenv("IA_TPU_COMPILE_CACHE", "/nonexistent/ia_tpu")
    assert native._lib_path().parent.parent == before


# ---------------------------------------------------------------------------
# utils/timing without a card
# ---------------------------------------------------------------------------

@pytest.fixture()
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_card_timers_raise_without_cuda(no_card):
    f = lambda: None  # noqa: E731
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.time_cuda(f)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.device_time_per_call(f)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.device_seconds_from_trace(f)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.host_us(f)


class _Record:
    """A kernel record as torch.profiler gives it: a name and a time range."""

    def __init__(self, name: str, us: float):
        self.name = name
        self.time_range = type("Range", (), {"elapsed_us": lambda _self: us})()


@pytest.fixture()
def fake_profiles(monkeypatch):
    """A card that is not there and a profiler that hands back, profile by
    profile, the next of ``state["counts"]`` records of 2 us each, named
    "k"; ``state["taken"]`` lists the profiles taken."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    state = {"counts": [], "taken": []}

    def profile(run_once, match):
        run_once()
        n = state["counts"][len(state["taken"])]
        state["taken"].append(n)
        return [_Record("k", 2.0) for _ in range(n)]

    monkeypatch.setattr(timing, "_profile", profile)
    return state


def test_device_time_per_call_profiles_again_where_records_fall_short(fake_profiles):
    """A call makes 2 kernel records; the profile of 5 calls loses one, so
    both profiles are taken again, and the time is the full count's."""
    fake_profiles["counts"] = [2, 9, 2, 10]
    ms = timing.device_time_per_call(lambda: None, iters=5)
    assert fake_profiles["taken"] == [2, 9, 2, 10]
    assert ms == pytest.approx(10 * 2.0 / 1e3 / 5)
    fake_profiles["counts"], fake_profiles["taken"] = [2, 9, 2, 10], []
    assert timing.device_time_per_call(lambda: None, iters=5, match="k") == pytest.approx(
        2.0 / 1e3)


def test_device_time_per_call_raises_after_three_short_profiles(fake_profiles):
    """Three short profiles (the last: the one-call profile itself lost a
    record, so 5 calls' full count disagrees with it): no time from a short
    count, an error instead."""
    fake_profiles["counts"] = [2, 9, 2, 8, 1, 10]
    with pytest.raises(RuntimeError, match="fell short"):
        timing.device_time_per_call(lambda: None, iters=5)
    assert len(fake_profiles["taken"]) == 6
    fake_profiles["counts"], fake_profiles["taken"] = [0] * 6, []
    with pytest.raises(RuntimeError, match="no device time"):
        timing.device_time_per_call(lambda: None, iters=5, match="k")


def test_device_time_per_call_holds_one_call_to_its_launches(fake_profiles, monkeypatch):
    """A call that launches two hand-written kernels (its wrappers' counters
    move by 2) but whose one-call profile holds one record has lost one:
    profiled again, although 5 calls' records are 5 times that one."""
    def call():
        native.launches["crop_resample"] += 2

    monkeypatch.setattr(native, "launches", dict.fromkeys(native.KERNELS, 0))
    fake_profiles["counts"] = [1, 5, 2, 10]
    assert timing.device_time_per_call(call, iters=5) == pytest.approx(10 * 2.0 / 1e3 / 5)
    assert fake_profiles["taken"] == [1, 5, 2, 10]


def test_launch_counts_name_the_ten_kernels_from_the_start():
    """``launch_counts()`` keys every hand-written kernel of the routes from
    the process's start, and is a copy: changing it changes no count."""
    counts = tinspect.launch_counts()
    assert list(counts) == ["pil_resample_2pass", "resample2d", "resample2d_stream",
                            "resample_axis", "crop_tables", "crop_resample", "crop_f32",
                            "pil_resample_axis", "resample2d_fused", "resample_axis_fused"]
    counts["resample2d"] += 1
    assert tinspect.launch_counts()["resample2d"] == counts["resample2d"] - 1


def test_device_seconds_from_trace_requires_what_it_expects(fake_profiles):
    fake_profiles["counts"] = [3, 4]
    assert timing.device_seconds_from_trace(lambda: None, "k", expect=4) == pytest.approx(8e-6)
    fake_profiles["counts"], fake_profiles["taken"] = [3, 3, 5], []
    with pytest.raises(RuntimeError, match="not the 4 expected"):
        timing.device_seconds_from_trace(lambda: None, "k", expect=4)
    fake_profiles["counts"], fake_profiles["taken"] = [3], []
    assert timing.device_seconds_from_trace(lambda: None) == pytest.approx(6e-6)


def test_time_calls_on_the_cpu_names_the_cpu():
    x = torch.zeros((1, 3, 20, 30))
    r = timing.time_calls(lambda t: iat.resize(t, (10, 15)), x, iters=2, repeats=2)
    assert isinstance(r, timing.BenchResult)
    assert r["device"] == "cpu" and r.seconds > 0 and r["iters"] == 2
    assert r.mpix_per_s(150) > 0


# ---------------------------------------------------------------------------
# The CLI on --device cpu
# ---------------------------------------------------------------------------

def test_cli_inspect(capsys):
    rep = cli.main(["--device", "cpu", "--inspect", "--mode", "bicubic",
                    "--size", "120", "96"])
    out = capsys.readouterr().out
    assert "route=pil_resample_2pass" in out and "ntaps=" in out and "assumed" in out
    assert rep.route == "pil_resample_2pass" and rep.in_shape == (1, 3, 438, 906)


def test_cli_accuracy_save_pil_exact_prints_what_the_jax_cli_prints(capsys, tmp_path):
    argv = ["--mode", "bilinear", "--size", "40", "24", "--backend", "pil_exact",
            "--save", str(tmp_path / "port.png")]
    (row,) = cli.main(["--device", "cpu"] + argv)
    port = capsys.readouterr().out.strip()
    assert row["mae"] == 0.0 and row["max_abs_err"] == 0.0 and row["oracle"] == "pillow"
    assert (tmp_path / "port.png").exists()
    jax_cli(argv[:-1] + [str(tmp_path / "jax.png")])
    assert port == capsys.readouterr().out.strip()
    assert port == "mode=bilinear size=40x24 oracle=pillow MAE=0.0000 MaxAbsE=0.0"


@pytest.mark.parametrize("mode", ["lanczos5", "area", "nearest_legacy", "bicubic075",
                                  "pil_nearest"])
def test_cli_accuracy_other_oracles(capsys, mode):
    (row,) = cli.main(["--device", "cpu", "--mode", mode, "--size", "40", "24"])
    out = capsys.readouterr().out
    assert row["oracle"] == ("pillow" if mode == "pil_nearest" else "dense-f64")
    assert f"oracle={row['oracle']}" in out
    assert row["max_abs_err"] <= 1.0
    if mode in ("nearest_legacy", "pil_nearest"):  # index gathers on both sides
        assert row["max_abs_err"] == 0.0


def test_cli_backward(capsys):
    res = cli.main(["--device", "cpu", "--backward", "--size", "24", "16"])
    out = capsys.readouterr().out
    assert "backward smoke: out (1, 3, 16, 24) grad (1, 3, 128, 160)" in out
    assert "finite-difference check passed" in out
    assert res["forward_launches"] == {} and res["adjoint_launches"] == {}
    assert abs(res["adjoint_lhs"] - res["adjoint_rhs"]) <= 1e-4 * abs(res["adjoint_lhs"])


def test_cli_bench_row_keys(capsys):
    (row,) = cli.main(["--device", "cpu", "--bench", "--size", "40", "24"])
    assert json.loads(capsys.readouterr().out) == row
    jax_keys = {"size", "pil_ms", "dense_ms", "dense_Mpix_s", "gather_ms", "gather_Mpix_s",
                "pallas_ms", "pallas_Mpix_s", "pil_exact_ms", "pil_exact_Mpix_s",
                "pil2digit_ms", "pil2digit_Mpix_s"}
    assert set(row) == jax_keys | {"device"}
    assert row["device"] == "cpu" and row["size"] == "40x24"
    assert all(row[k] > 0 for k in jax_keys - {"size"})


def test_cli_profile_writes_a_trace(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv("IA_TPU_TRACE_DIR", str(tmp_path))
    path = cli.main(["--device", "cpu", "--profile", "--size", "40", "24"])
    assert Path(path).parent == tmp_path and Path(path).exists()
    assert json.loads(Path(path).read_text())["traceEvents"]
    assert f"trace written to {path}" in capsys.readouterr().out


def test_cli_dump_hlo_raises_without_a_card(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA card"):
        cli.main(["--dump-hlo", str(tmp_path / "out.txt"), "--size", "40", "24"])
    assert not (tmp_path / "out.txt").exists()


def test_cli_runs_need_device_cpu_without_a_card(no_card):
    for argv in (["--bench", "--size", "40", "24"], ["--backward"], ["--profile"], []):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)
