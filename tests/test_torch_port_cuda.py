"""The port's CUDA kernels on the card, against their plain versions on the
same card.  Every test here is marked ``cuda`` and skips where there is no
card; on a machine with one (and the CUDA toolkit):

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which these tests do not
use.)  Every kernel is held to its plain version bit for bit: the float
kernels round each product and each sum in the plain version's tap order
(csrc/ia_dtypes.cuh::mac), so any difference, a wrong rounding of a store
included, is a fault; the Pillow kernel is byte-exact as well.
"""

import math
import re

import numpy as np
import pytest
import torch

from chip_smoke import (CROP_4K, MIXED_TILE, ROW_PAST_EVERY_CHUNK, TABLE_EDGES, TRAIN_B64,
                        ZOOM_OUT, _zoom_out_boxes)
import interpolate_antialiasing_tpu_torch as iat
from interpolate_antialiasing_tpu_torch.ops import crop_cuda as cc
from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch import native
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops.crop import box_fracs, sample_boxes
from interpolate_antialiasing_tpu_torch.ops.resize_xla import resize_axis_dense
from interpolate_antialiasing_tpu_torch.ops.weights import adjoint_tables, make_axis_spec
from port_cases import NORMALIZE_CASES, normalize_input

pytestmark = pytest.mark.cuda

DTYPES = (torch.uint8, torch.float32, torch.bfloat16)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts(*names):
    """The launch counts of the kernels ``names``, in that order."""
    return tuple(native.launches[n] for n in names)


def _input(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.rand(shape, device=dev, generator=g) * 255).to(dtype)


def _assert_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    differing = int((got != want).sum())
    err = float((got.double() - want.double()).abs().max())
    assert differing == 0, (differing, err)


@pytest.mark.parametrize("odt", DTYPES)
@pytest.mark.parametrize("idt", DTYPES)
@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3", "area"])
def test_resample2d_kernel_matches_plain(dev, mode, idt, odt):
    x = _input((3, 97, 131), idt, dev)
    sh, sw = make_axis_spec(97, 40, mode), make_axis_spec(131, 260, mode)
    before = native.launches["resample2d"]
    got = cr.resize2d(x, sh, sw, odt)
    torch.cuda.synchronize()
    assert native.launches["resample2d"] == before + 1
    _assert_equal(got, cr._resample2d_plain(x, sh, sw, odt))


@pytest.mark.parametrize("odt", DTYPES)
@pytest.mark.parametrize("idt", DTYPES)
@pytest.mark.parametrize("axis", [-1, -2, 1])
def test_resample_axis_kernel_matches_plain(dev, axis, idt, odt):
    x = _input((2, 57, 83, 3), idt, dev, seed=1)
    spec = make_axis_spec(x.shape[axis], 31, "bicubic")
    before = native.launches["resample_axis"]
    got = cr.resize_axis(x, spec, axis, odt)
    torch.cuda.synchronize()
    assert native.launches["resample_axis"] == before + 1
    ax = axis % x.ndim
    x3 = x.reshape(math.prod(x.shape[:ax]), x.shape[ax], math.prod(x.shape[ax + 1:]))
    want = cr._resample_axis_plain(x3, spec, odt).reshape(got.shape)
    _assert_equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3", "box"])
def test_adjoint_resample2d_matches_plain(dev, mode, dt):
    """resample2d over transposed tables (the plane adjoint): H downsampled,
    W upsampled, so the W adjoint has many taps per output."""
    th = adjoint_tables(make_axis_spec(97, 40, mode))
    tw = adjoint_tables(make_axis_spec(131, 260, mode))
    g = _input((3, 40, 260), dt, dev, seed=3)
    before = native.launches["resample2d"]
    got = cr.resize2d(g, th, tw, dt)
    torch.cuda.synchronize()
    assert native.launches["resample2d"] == before + 1 and got.shape == (3, 97, 131)
    _assert_equal(got, cr._resample2d_plain(g, th, tw, dt))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("axis", [-1, 1])
def test_adjoint_resample_axis_matches_plain(dev, axis, dt):
    g = _input((2, 31, 83, 3) if axis == 1 else (2, 57, 31), dt, dev, seed=4)
    t = adjoint_tables(make_axis_spec(64, 31, "bicubic"))
    before = native.launches["resample_axis"]
    got = cr.resize_axis(g, t, axis, dt)
    torch.cuda.synchronize()
    assert native.launches["resample_axis"] == before + 1 and got.shape[axis] == 64
    ax = axis % g.ndim
    g3 = g.reshape(math.prod(g.shape[:ax]), g.shape[ax], math.prod(g.shape[ax + 1:]))
    _assert_equal(got, cr._resample_axis_plain(g3, t, dt).reshape(got.shape))


def test_resize_plane_gradient_runs_the_adjoint_kernel(dev):
    x = _input((2, 3, 97, 131), torch.float32, dev, seed=5).requires_grad_()
    before = native.launches["resample2d"]
    y = iat.resize_plane(x, (40, 260), 2, 3, mode="bicubic")
    g, = torch.autograd.grad(y, x, grad_outputs=y)
    torch.cuda.synchronize()
    assert native.launches["resample2d"] == before + 2
    xc = x.detach().cpu().requires_grad_()
    yc = iat.resize_plane(xc, (40, 260), 2, 3, mode="bicubic")
    gc, = torch.autograd.grad(yc, xc, grad_outputs=yc)
    _assert_equal(g.cpu(), gc)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("frac", [1.0, 0.45])
def test_crop_kernel_matches_plain(dev, precision, frac):
    x = _input((4, 3, 300, 520), torch.uint8, dev, seed=6)
    gen = torch.Generator().manual_seed(0)
    boxes = sample_boxes(gen, 4, 300, 520, (0.05, 0.2)).to(dev)
    tables = cc._windowed_tables(x, boxes, (96, 112), "bilinear", True, frac, precision)
    before = native.launches["crop_resample"]
    got = cc._crop_resample(x, *tables)
    torch.cuda.synchronize()
    assert native.launches["crop_resample"] == before + 2
    _assert_equal(got, cc._crop_resample_plain(x, *tables))


def test_pil_kernel_takes_more_than_65535_planes(dev):
    x = _input((70000, 8, 8), torch.uint8, dev, seed=2)
    got = pe.resize_pil_exact(x, (4, 5))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), pe.resize_pil_exact(x.cpu(), (4, 5)))


def test_dense_route_keeps_tf32_off(dev):
    """With TF32 allowed globally, the dense route still multiplies in full
    float32 (TF32 would leave ~1e-3 relative error on a 4096-long sum)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.rand((64, 4096), device=dev) + 1.0
        spec = make_axis_spec(4096, 16, "box")
        got = resize_axis_dense(x, spec, -1)
        want = resize_axis_dense(x.cpu().double(), spec, -1)
        assert float((got.cpu().double() - want).abs().max()) <= 1e-5
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@pytest.mark.parametrize("layout", ["mid", "last", "nhwc"])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3", "box", "hamming"])
def test_pil_resample_axis_kernel_matches_plain(dev, mode, layout):
    """The sharded byte-exact route's kernel over every shard's tables of a
    ceil-padded 4-shard plan, byte for byte."""
    from interpolate_antialiasing_tpu_torch.parallel import halo

    plan, starts, wsh = halo._int_halo_tables(97, 41, mode, 4)
    shape, axis = {"mid": ((3, plan.ext, 70), 1), "last": ((3, 70, plan.ext), 2),
                   "nhwc": ((2, plan.ext, 70, 3), 1)}[layout]
    x = _input(shape, torch.uint8, dev, seed=7)
    for d in range(4):
        before = native.launches["pil_resample_axis"]
        got = pe._resample_axis(x, (starts[d], wsh[d]), axis)
        torch.cuda.synchronize()
        assert native.launches["pil_resample_axis"] == before + 1
        assert torch.equal(got.cpu(), pe._resample_axis(x.cpu(), (starts[d], wsh[d]), axis))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3"])
def test_resample_axis_over_shard_tables_matches_plain(dev, mode, dt):
    """Kernel B over each shard's compact tables of ``Wl[d]`` and of
    ``Wl[d]^T`` (the sharded float H pass and its adjoint)."""
    from interpolate_antialiasing_tpu_torch.parallel import halo

    plan = halo.plan_halo_banded(129, 40, mode, True, 4)
    for d in range(4):
        for t, n_in in zip(halo._shard_tables(plan, d), (plan.ext_pad, plan.ol)):
            x = _input((2, n_in, 37), dt, dev, seed=8 + d)
            before = native.launches["resample_axis"]
            got = cr.resize_axis(x, t, 1, dt)
            torch.cuda.synchronize()
            assert native.launches["resample_axis"] == before + 1
            _assert_equal(got, cr._resample_axis_plain(x, t, dt))


# ---------------------------------------------------------------------------
# In-kernel weight synthesis (fused=True): both kernels' fused twins against
# their plain versions on the same card, bit for bit
# ---------------------------------------------------------------------------

CONTINUOUS = ["bilinear", "bicubic", "hamming", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("odt", DTYPES)
@pytest.mark.parametrize("idt", DTYPES)
@pytest.mark.parametrize("mode", CONTINUOUS)
def test_resample2d_fused_kernel_matches_plain(dev, mode, idt, odt):
    x = _input((3, 97, 131), idt, dev, seed=9)
    sh, sw = make_axis_spec(97, 40, mode), make_axis_spec(131, 260, mode)
    before = _counts("resample2d_fused", "resample2d")
    got = cr.resize2d(x, sh, sw, odt, fused=True)
    torch.cuda.synchronize()
    assert _counts("resample2d_fused", "resample2d") == (before[0] + 1, before[1])
    _assert_equal(got, cr._resample2d_fused_plain(x, sh, sw, odt))


@pytest.mark.parametrize("odt", DTYPES)
@pytest.mark.parametrize("idt", DTYPES)
@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("mode", CONTINUOUS)
def test_resample_axis_fused_kernel_matches_plain(dev, mode, axis, idt, odt):
    x = _input((2, 57, 83, 3), idt, dev, seed=10)
    spec = make_axis_spec(x.shape[axis], 130 if axis == 1 else 31, mode)
    before = _counts("resample_axis_fused", "resample_axis")
    got = cr.resize_axis(x, spec, axis, odt, fused=True)
    torch.cuda.synchronize()
    assert _counts("resample_axis_fused", "resample_axis") == (before[0] + 1, before[1])
    ax = axis % x.ndim
    x3 = x.reshape(math.prod(x.shape[:ax]), x.shape[ax], math.prod(x.shape[ax + 1:]))
    _assert_equal(got, cr._resample_axis_fused_plain(x3, spec, odt).reshape(got.shape))


@pytest.mark.parametrize("kw", [dict(align_corners=True), dict(span=(3.5, 90.0))],
                         ids=["align_corners", "span"])
@pytest.mark.parametrize("mode", CONTINUOUS)
def test_fused_kernels_align_corners_and_span(dev, mode, kw):
    x = _input((2, 97, 131), torch.float32, dev, seed=11)
    sh, sw = make_axis_spec(97, 40, mode, **kw), make_axis_spec(131, 60, mode, **kw)
    _assert_equal(cr.resize2d(x, sh, sw, fused=True),
                  cr._resample2d_fused_plain(x, sh, sw, torch.float32))
    _assert_equal(cr.resize_axis(x, sh, 1, fused=True),
                  cr._resample_axis_fused_plain(x, sh, torch.float32))


# ---------------------------------------------------------------------------
# Kernel A's edges (the redesign for Hopper): spans staged through the ring,
# taps past the unrolled buckets, tiny grids, one-wide outputs and rows that
# start off 16 bytes, with host tables and with synthesised weights
# ---------------------------------------------------------------------------

KERNEL_A_EDGES = [
    ("extreme_downscale_w", (1, 96, 2160), (48, 8), "lanczos3"),
    ("ntaps_61", (1, 64, 600), (10, 100), "lanczos5"),
    ("few_blocks", (1, 17, 23), (8, 11), "bicubic"),
    ("one_column", (2, 50, 70), (30, 1), "bilinear"),
    ("one_row", (2, 50, 70), (1, 30), "bilinear"),
]


@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
@pytest.mark.parametrize("name,shape,ohw,mode", KERNEL_A_EDGES,
                         ids=[c[0] for c in KERNEL_A_EDGES])
def test_resample2d_edges_match_plain(dev, name, shape, ohw, mode, fused):
    x = _input(shape, torch.float32, dev, seed=12)
    sh, sw = make_axis_spec(shape[-2], ohw[0], mode), make_axis_spec(shape[-1], ohw[1], mode)
    before = _counts("resample2d", "resample2d_fused")
    got = cr.resize2d(x, sh, sw, fused=fused)
    torch.cuda.synchronize()
    assert _counts("resample2d", "resample2d_fused") == \
        (before[0] + (not fused), before[1] + fused)
    plain = cr._resample2d_fused_plain if fused else cr._resample2d_plain
    _assert_equal(got, plain(x, sh, sw, torch.float32))


@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
@pytest.mark.parametrize("dt", DTYPES)
def test_resample2d_unaligned_rows_match_plain(dev, dt, fused):
    """Rows 83 elements wide and a plane offset (``x[1:]``): no row starts
    on 16 bytes, and the staged copies mask the head and tail."""
    x = _input((4, 37, 83), dt, dev, seed=13)[1:]
    assert x.data_ptr() % 16 != 0
    sh, sw = make_axis_spec(37, 17, "bicubic"), make_axis_spec(83, 29, "bicubic")
    got = cr.resize2d(x, sh, sw, dt, fused=fused)
    plain = cr._resample2d_fused_plain if fused else cr._resample2d_plain
    _assert_equal(got, plain(x, sh, sw, dt))


def test_resample2d_plan_occupancy(dev):
    """The headline plan launches at least two waves of blocks on this card,
    and the card holds at least two of them per SM."""
    sh, sw = make_axis_spec(438, 196), make_axis_spec(906, 320)
    n_sm = plans.n_sm(dev)
    for fused in (False, True):
        plan = (cr._plan2d_synth if fused else plans.plan2d)(sh, sw, 4, 3, n_sm)
        assert plan.blocks >= 2 * n_sm
        assert cr.occupancy_2d(plan, torch.float32, torch.float32, sw.ntaps, sh.ntaps,
                               fused) >= 2


# ---------------------------------------------------------------------------
# Kernel A's streaming twin (csrc/resample2d_stream.cu): every plan its
# planner weighs, forced past the gate, bit for bit against the plain version
# ---------------------------------------------------------------------------

# (name, x shape, output [OH, OW], mode, x off 16 bytes): ragged last strips
# and segments, rows of 1498 or 1499 elements (no row starts on 16 bytes),
# both tap buckets (exactly 2x bilinear: 4 taps; 2.5x bilinear and 2x
# bicubic: 8)
STREAM_EDGES = [
    ("x2_ragged", (4, 1002, 1498), (501, 749), "bilinear", False),
    ("x2_offset", (3, 1002, 1498), (501, 749), "bilinear", True),
    ("x2.5_odd", (4, 1003, 1499), (401, 653), "bilinear", False),
    ("x2_ragged_bicubic", (4, 1002, 1498), (501, 749), "bicubic", False),
    ("x2_offset_bicubic", (3, 1002, 1498), (501, 749), "bicubic", True),
]


def _stream_plans(x3, sh, sw):
    """Every plan plans._stream_candidates weighs for ``x3``'s pass,
    at planes enough to pass its gate."""
    nt = plans._stream_ntaps(sh, sw)
    th, tw = plans.stream_tables(sh, nt), plans.stream_tables(sw, nt)
    return list(dict.fromkeys(p for _, p in plans._stream_candidates(
        th[0], sh.in_size, tw[0], sw.in_size, nt, x3.element_size(), 4096,
        plans.n_sm(x3.device))))


@pytest.mark.parametrize("idt,odt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.uint8, torch.float32),
                                     (torch.uint8, torch.uint8)],
                         ids=["bf16", "f32", "u8_f32", "u8_u8"])
@pytest.mark.parametrize("name,shape,ohw,mode,offset", STREAM_EDGES,
                         ids=[c[0] for c in STREAM_EDGES])
def test_resample2d_stream_every_strip_matches_plain(dev, monkeypatch, name, shape, ohw, mode,
                                                     offset, idt, odt):
    x = _offset_input(shape, idt, dev, 40) if offset else _input(shape, idt, dev, 40)
    sh, sw = make_axis_spec(shape[1], ohw[0], mode), make_axis_spec(shape[2], ohw[1], mode)
    want = cr._resample2d_plain(x, sh, sw, odt)
    cands = _stream_plans(x, sh, sw)
    assert len(cands) > 4
    for plan in cands:
        monkeypatch.setattr(cr, "resize2d_plan", lambda *a, p=plan, **k: p)
        before = _counts("resample2d", "resample2d_stream")
        got = cr.resize2d(x, sh, sw, odt)
        torch.cuda.synchronize()
        assert _counts("resample2d", "resample2d_stream") == (before[0], before[1] + 1)
        _assert_equal(got, want)


def test_resample2d_stream_config5_batch4_matches_plain(dev):
    """Four frames of BASELINE config 5 through ``resize2d`` on its own plan:
    one launch of the streaming kernel, the plain version's bits."""
    x = _input((4, 3, 2160, 3840), torch.bfloat16, dev, 41)
    sh, sw = make_axis_spec(2160, 1080), make_axis_spec(3840, 1920)
    assert isinstance(cr.resize2d_plan(sh, sw, 2, 12, plans.n_sm(dev)), plans.PlanStream)
    before = _counts("resample2d", "resample2d_stream")
    got = cr.resize2d(x, sh, sw)
    torch.cuda.synchronize()
    assert _counts("resample2d", "resample2d_stream") == (before[0], before[1] + 1)
    want = cr._resample2d_plain(x.reshape(12, 2160, 3840), sh, sw, torch.bfloat16)
    _assert_equal(got, want.reshape(got.shape))


def test_resample2d_stream_launches_once_per_video_call_and_never_on_the_pillow_route(dev):
    from interpolate_antialiasing_tpu_torch.models import ImageNetEvalPipeline, VideoDownscaler
    from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts

    def launched(fn, calls):
        before = launch_counts()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}

    frames = _input((4, 3, 2160, 3840), torch.bfloat16, dev, 42)
    video = VideoDownscaler((1080, 1920))
    assert launched(lambda: video(frames), 3) == {"resample2d_stream": 3}
    batch = _input((8, 3, 438, 906), torch.uint8, dev, 43)
    pipe = ImageNetEvalPipeline(size=(224, 224), short_side=256).to(dev)
    assert launched(lambda: pipe(batch), 2) == {"pil_resample_2pass": 2, "normalize": 2}


def test_resample2d_stream_plan_occupancy(dev):
    """The card holds at least the resident blocks config 5's streaming plan
    counts on (registers and shared memory both count)."""
    sh, sw = make_axis_spec(2160, 1080), make_axis_spec(3840, 1920)
    for dt in (torch.bfloat16, torch.float32):
        plan = cr.resize2d_plan(sh, sw, dt.itemsize, 192, plans.n_sm(dev))
        assert isinstance(plan, plans.PlanStream)
        assert cr.occupancy_stream(plan, dt, dt) >= plan.resident


# ---------------------------------------------------------------------------
# Kernel B and pil_resample_axis since their redesign for Hopper: the axis
# kinds of the tile plan (the last axis, a narrow and a wide inner), rows
# and planes that start off 16 bytes, one output, an upsample and the
# unstaged body where no tile fits
# ---------------------------------------------------------------------------

# (name, x shape, axis, n_out, mode)
AXIS_EDGES = [
    ("last", (3, 40, 83), -1, 29, "bicubic"),
    ("inner3", (2, 57, 83, 3), 2, 31, "bicubic"),
    ("inner5", (2, 57, 5), 1, 23, "lanczos3"),
    ("inner960", (1, 60, 960), 1, 27, "bilinear"),
    ("n_out_1", (2, 50, 7), 1, 1, "bilinear"),
    ("upsample", (2, 31, 70), 1, 90, "bicubic"),
    ("upsample_last", (3, 4, 31), -1, 77, "lanczos3"),
]


def _view3(x, axis):
    ax = axis % x.ndim
    return x.reshape(math.prod(x.shape[:ax]), x.shape[ax], math.prod(x.shape[ax + 1:]))


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
@pytest.mark.parametrize("name,shape,axis,n_out,mode", AXIS_EDGES,
                         ids=[c[0] for c in AXIS_EDGES])
def test_resample_axis_edges_match_plain(dev, name, shape, axis, n_out, mode, fused,
                                         dt, offset):
    x = _input(shape, dt, dev, seed=14)
    if offset:  # a plane offset of one plane: rows start off 16 bytes
        x = _input((shape[0] + 1, *shape[1:]), dt, dev, seed=14)[1:]
    spec = make_axis_spec(x.shape[axis], n_out, mode)
    before = _counts("resample_axis", "resample_axis_fused")
    got = cr.resize_axis(x, spec, axis, dt, fused=fused)
    torch.cuda.synchronize()
    assert _counts("resample_axis", "resample_axis_fused") == \
        (before[0] + (not fused), before[1] + fused)
    plain = cr._resample_axis_fused_plain if fused else cr._resample_axis_plain
    _assert_equal(got, plain(_view3(x, axis), spec, dt).reshape(got.shape))


@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
def test_resample_axis_unstaged_body_matches_plain(dev, fused):
    """A window of ~2,000 (box) or ~4,000 (bilinear) rows of 64 float32
    columns fits no tile: the kernel runs its unstaged body."""
    mode = "bilinear" if fused else "box"
    x = _input((2, 2000, 64), torch.float32, dev, seed=15)
    spec = make_axis_spec(2000, 1, mode)
    assert cr.plan_axis_spec(spec, fused, 2, 64, 4, plans.n_sm(dev), True) is None
    got = cr.resize_axis(x, spec, 1, fused=fused)
    plain = cr._resample_axis_fused_plain if fused else cr._resample_axis_plain
    _assert_equal(got, plain(x, spec, torch.float32))


# (name, x shape, axis, n_in, n_out, mode): inner 1, 3, 5, 6 (not a multiple
# of 4), 8, 960 and 962 (not a multiple of 16 or 4)
PIL_AXIS_EDGES = [
    ("last", (3, 40, 83), 2, 29, "bicubic"),
    ("inner3", (2, 83, 3), 1, 31, "lanczos3"),
    ("inner5", (2, 57, 5), 1, 23, "hamming"),
    ("inner6", (2, 57, 6), 1, 23, "bilinear"),
    ("inner8", (2, 57, 8), 1, 23, "bilinear"),
    ("inner960", (1, 60, 960), 1, 27, "bilinear"),
    ("inner962", (1, 60, 962), 1, 27, "bicubic"),
    ("n_out_1", (2, 50, 8), 1, 1, "box"),
    ("upsample", (2, 31, 72), 1, 90, "bicubic"),
]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("name,shape,axis,n_out,mode", PIL_AXIS_EDGES,
                         ids=[c[0] for c in PIL_AXIS_EDGES])
def test_pil_resample_axis_edges_match_plain(dev, name, shape, axis, n_out, mode, offset):
    x = _input(shape, torch.uint8, dev, seed=16)
    if offset:  # one byte off: no vector path, no aligned row
        x = _input((math.prod(shape) + 1,), torch.uint8, dev, seed=16)[1:].reshape(shape)
        assert x.data_ptr() % 4 != 0
    tables = pe._int_tables(shape[axis], n_out, mode)
    before = native.launches["pil_resample_axis"]
    got = pe._resample_axis(x, tables, axis)
    torch.cuda.synchronize()
    assert native.launches["pil_resample_axis"] == before + 1
    assert torch.equal(got, pe._resample_axis_plain(_view3(x, axis), tables).reshape(got.shape))


def test_pil_resample_axis_unstaged_body_matches_plain(dev):
    x = _input((2, 5000, 64), torch.uint8, dev, seed=17)
    tables = pe._int_tables(5000, 1, "box")
    assert plans._plan_axis(tables[0].astype("int64"), tables[1].shape[1], 5000, 2, 64, 1,
                            plans.n_sm(dev), True) is None
    got = pe._resample_axis(x, tables, 1)
    assert torch.equal(got, pe._resample_axis_plain(x, tables))


def test_resample_axis_plan_occupancy(dev):
    """Config 5's passes in NHWC, with tables and synthesised weights, and
    the NHWC headline's at 64 frames launch at least a block per SM of this
    card, and the card holds at least two of them per SM; so does the
    sharded uint8 W pass.  The one-frame headline runs the unstaged body."""
    n_sm = plans.n_sm(dev)
    for n_in, n_out, outer, inner, itemsize, fused in (
            (906, 320, 438 * 64, 3, 4, True), (438, 196, 64, 960, 4, False),
            (3840, 1920, 64 * 2160, 3, 2, False), (2160, 1080, 64, 5760, 2, True)):
        spec = make_axis_spec(n_in, n_out)
        plan = cr.plan_axis_spec(spec, fused, outer, inner, itemsize, n_sm, True)
        assert plan.blocks >= n_sm
        dt = torch.float32 if itemsize == 4 else torch.bfloat16
        assert cr.occupancy_axis(plan, "fused" if fused else "table", dt, dt,
                                 spec.ntaps) >= 2
    assert cr.plan_axis_spec(make_axis_spec(906, 320), False, 438, 3, 4, n_sm, True) is None
    tw = pe._int_tables(32768, 8192, "bilinear")
    plan = plans._plan_axis(tw[0].astype("int64"), tw[1].shape[1], 32768, 96, 1, 1, n_sm, True)
    assert plan.blocks >= n_sm
    assert cr.occupancy_axis(plan, "pil", torch.uint8, torch.uint8, tw[1].shape[1]) >= 2


# The plan runs the unstaged body for passes as small as the edge cases
# above: each is run again at every tile the plan considers, forced past it
# (partial last tiles along each axis, uint8 four columns per thread where
# the offset allows, more than 16 taps in the loop bucket).

TAPS_GT16 = [
    ("taps_gt16_last", (3, 5, 240), -1, 30, "lanczos3"),
    ("taps_gt16_inner5", (2, 240, 5), 1, 30, "lanczos3"),
    ("taps_gt16_inner7", (3, 241, 7), 1, 25, "bicubic"),
]


def _every_tile(first, ntaps, x3):
    """Every tile plans._axis_candidates lists for a pass over ``x3``,
    then None (the unstaged body)."""
    outer, n_in, inner = x3.shape
    cands = [p for _, p in plans._axis_candidates(
        np.asarray(first, np.int64), ntaps, n_in, outer, inner, x3.element_size(),
        plans.n_sm(x3.device), x3.data_ptr() % 4 == 0)]
    return list(dict.fromkeys(cands)) + [None]


def _offset_input(shape, dtype, dev, seed):
    """``shape`` starting one element past a 16-byte boundary."""
    return _input((math.prod(shape) + 1,), dtype, dev, seed)[1:].reshape(shape)


def _axis_every_tile(monkeypatch, x, spec, axis, odt, fused):
    x3 = _view3(x, axis)
    first, w = plans.tables(spec)
    first, ntaps = (cr._synth_first(spec), spec.ntaps) if fused else (first, w.shape[1])
    want = (cr._resample_axis_fused_plain if fused else cr._resample_axis_plain)(x3, spec, odt)
    cands = _every_tile(first, ntaps, x3)
    assert len(cands) > 1
    for plan in cands:
        monkeypatch.setattr(plans, "plan_axis_first", lambda *a, p=plan: p)
        got = cr.resize_axis(x, spec, axis, odt, fused=fused)
        _assert_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
@pytest.mark.parametrize("name,shape,axis,n_out,mode", AXIS_EDGES + TAPS_GT16,
                         ids=[c[0] for c in AXIS_EDGES + TAPS_GT16])
def test_resample_axis_edges_every_tile(dev, monkeypatch, name, shape, axis, n_out, mode,
                                        fused, dt, offset):
    x = (_offset_input(shape, dt, dev, 18) if offset else _input(shape, dt, dev, 18))
    spec = make_axis_spec(shape[axis], n_out, mode)
    _axis_every_tile(monkeypatch, x, spec, axis, dt, fused)


@pytest.mark.parametrize("odt", DTYPES)
@pytest.mark.parametrize("idt", DTYPES)
@pytest.mark.parametrize("fused", [False, True], ids=["tables", "fused"])
@pytest.mark.parametrize("shape,axis,n_out,mode", [((2, 37, 83), -1, 29, "bicubic"),
                                                   ((2, 57, 83, 3), 1, 23, "lanczos3")],
                         ids=["last", "inner249"])
def test_resample_axis_pairs_every_tile(dev, monkeypatch, shape, axis, n_out, mode, fused,
                                        idt, odt):
    x = _input(shape, idt, dev, 19)
    spec = make_axis_spec(shape[axis], n_out, mode)
    _axis_every_tile(monkeypatch, x, spec, axis, odt, fused)


PIL_TAPS_GT16 = [("taps_gt16", (2, 240, 8), 1, 20, "bicubic"),
                 ("taps_gt16_last", (3, 6, 240), 2, 20, "lanczos3")]


@pytest.mark.parametrize("offset", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("name,shape,axis,n_out,mode", PIL_AXIS_EDGES + PIL_TAPS_GT16,
                         ids=[c[0] for c in PIL_AXIS_EDGES + PIL_TAPS_GT16])
def test_pil_resample_axis_edges_every_tile(dev, monkeypatch, name, shape, axis, n_out, mode,
                                            offset):
    x = (_offset_input(shape, torch.uint8, dev, 20) if offset
         else _input(shape, torch.uint8, dev, 20))
    tables = pe._int_tables(shape[axis], n_out, mode)
    x3 = _view3(x, axis)
    want = pe._resample_axis_plain(x3, tables)
    cands = _every_tile(tables[0], tables[1].shape[1], x3)
    assert len(cands) > 1
    for plan in cands:
        monkeypatch.setattr(plans, "plan_axis_first", lambda *a, p=plan: p)
        got = pe._resample_axis(x, tables, axis)
        assert torch.equal(got, want.reshape(got.shape)), plan


@pytest.mark.parametrize("kind", ["table", "fused", "pil"])
def test_axis_staged_offset_matches_plain(dev, kind):
    """A pass above the unstaged body's cut, on an input that starts off 16
    bytes, runs the staged body through the plan itself."""
    shape, axis, n_out, mode, dt = (((8, 2001, 4001), 2, 1000, "bilinear", torch.uint8)
                                    if kind == "pil" else
                                    ((16, 437, 905, 3), 2, 300, "bicubic", torch.float32))
    x = _offset_input(shape, dt, dev, 21)
    x3 = _view3(x, axis)
    if kind == "pil":
        tables = pe._int_tables(shape[axis], n_out, mode)
        plan = plans.plan_axis_first(np.asarray(tables[0], np.int64).tobytes(),
                                     tables[1].shape[1], shape[axis], x3.shape[0], x3.shape[2],
                                   1, plans.n_sm(dev), False)
        assert plan is not None
        got = pe._resample_axis(x, tables, axis)
        assert torch.equal(got, pe._resample_axis_plain(x3, tables).reshape(got.shape))
        return
    fused = kind == "fused"
    spec = make_axis_spec(shape[axis], n_out, mode)
    assert cr._axis_plan(x3, spec, fused) is not None
    got = cr.resize_axis(x, spec, axis, dt, fused=fused)
    plain = cr._resample_axis_fused_plain if fused else cr._resample_axis_plain
    _assert_equal(got, plain(x3, spec, dt).reshape(got.shape))


# The Pillow two-pass kernel (kernel A over Pillow's tables) and the crop
# passes (kernel B with per-image tables) at their edges: each case through
# the production plan, then with every tile the plan considers forced, byte
# for byte against the plain version.

# (name, x3 shape, (oh, ow), mode, pb, offset): the bench batch and the
# 4K -> HD frame, 70,000 planes, lanczos3 past 16 taps (the loop bucket),
# pb 14 (digits=2), an upsample, a one-row and a one-column output, an
# input off 16 bytes, and a heavy downscale where no tile fits (two
# pil_resample_axis passes)
PIL_2PASS_EDGES = [
    ("bench", (192, 438, 906), (196, 320), "bilinear", 22, False),
    ("4k_hd", (3, 2160, 3840), (1080, 1920), "bilinear", 22, False),
    ("70000_planes", (70000, 8, 8), (4, 5), "bilinear", 22, False),
    ("lanczos3_gt16", (2, 300, 400), (40, 50), "lanczos3", 22, False),
    ("pb14", (3, 57, 83), (24, 31), "bicubic", 14, False),
    ("upsample", (2, 31, 72), (90, 150), "bicubic", 22, False),
    ("one_row", (2, 40, 60), (1, 30), "hamming", 22, False),
    ("one_col", (2, 40, 60), (20, 1), "box", 22, False),
    ("offset", (2, 57, 83), (24, 31), "bicubic", 22, True),
    ("no_tile_fits", (1, 20000, 64), (10, 32), "lanczos3", 22, False),
]


def _pil_case(dev, shape, ohw, mode, pb, offset, box=None):
    x3 = (_offset_input(shape, torch.uint8, dev, 30) if offset
          else _input(shape, torch.uint8, dev, 30))
    span_w = span_h = None
    if box is not None:
        span_w, span_h = (box[0], box[2]), (box[1], box[3])
    tw = pe._int_tables(shape[2], ohw[1], mode, span_w, pb)
    th = pe._int_tables(shape[1], ohw[0], mode, span_h, pb)
    return x3, tw, th, pe._resample_2pass_plain(x3, tw, th, pb)


@pytest.mark.parametrize("name,shape,ohw,mode,pb,offset", PIL_2PASS_EDGES,
                         ids=[c[0] for c in PIL_2PASS_EDGES])
def test_pil_2pass_edges_match_plain(dev, name, shape, ohw, mode, pb, offset):
    x3, tw, th, want = _pil_case(dev, shape, ohw, mode, pb, offset)
    before, before_axis = _counts("pil_resample_2pass", "pil_resample_axis")
    got = pe._resample_2pass(x3, tw, th, pb)
    torch.cuda.synchronize()
    if name == "no_tile_fits":
        assert plans.plan_pil_2pass(tw, th, shape[0], shape[1], shape[2]) is None
        assert _counts("pil_resample_2pass", "pil_resample_axis") == (before, before_axis + 2)
    else:
        assert _counts("pil_resample_2pass", "pil_resample_axis") == (before + 1, before_axis)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,shape,ohw,mode,pb,offset",
                         [c for c in PIL_2PASS_EDGES if c[0] != "no_tile_fits"],
                         ids=[c[0] for c in PIL_2PASS_EDGES if c[0] != "no_tile_fits"])
def test_pil_2pass_edges_every_tile(dev, monkeypatch, name, shape, ohw, mode, pb, offset):
    x3, tw, th, want = _pil_case(dev, shape, ohw, mode, pb, offset)
    cands = [p for _, p in plans._rows_candidates(
        th[0], th[1].shape[1], shape[1], tw[0], tw[1].shape[1], shape[2], 1, shape[0],
        plans.n_sm(dev), inter_size=1)]
    assert cands
    for plan in cands:
        monkeypatch.setattr(plans, "plan_pil_2pass", lambda *a, p=plan: p)
        got = pe._resample_2pass(x3, tw, th, pb)
        assert torch.equal(got, want), plan


def test_pil_2pass_box_route_every_tile(dev, monkeypatch):
    box = (3.3, 4.25, 61.7, 45.5)
    x3, tw, th, want = _pil_case(dev, (3, 50, 70), (20, 31), "lanczos3", 22, False, box)
    assert torch.equal(pe._resample_2pass(x3, tw, th), want)
    assert torch.equal(pe.resize_pil_exact(x3, (20, 31), method="lanczos3", box=box), want)
    for _, plan in plans._rows_candidates(th[0], th[1].shape[1], 50, tw[0], tw[1].shape[1], 70,
                                          1, 3, plans.n_sm(dev), inter_size=1):
        monkeypatch.setattr(plans, "plan_pil_2pass", lambda *a, p=plan: p)
        assert torch.equal(pe._resample_2pass(x3, tw, th), want), plan


def test_pil_2pass_plan_occupancy(dev):
    """The bench batch's and the 4K frame's plans launch at least a block
    per SM, and the card holds at least two of them per SM."""
    import ctypes

    lib = native.build()
    for planes, H, W, OH, OW in ((192, 438, 906, 196, 320), (3, 2160, 3840, 1080, 1920)):
        tw, th = pe._int_tables(W, OW, "bilinear"), pe._int_tables(H, OH, "bilinear")
        plan = plans.plan_pil_2pass(tw, th, planes, H, W, plans.n_sm(dev))
        assert plan.blocks >= plans.n_sm(dev)
        blocks = ctypes.c_int(0)
        assert lib.ia_pil_resample_2pass_occupancy(tw[1].shape[1], th[1].shape[1],
                                                   *plan[:6], ctypes.byref(blocks)) == 0
        assert blocks.value >= 2


def _crop_boxes(name):
    if name == "subpixel":
        return torch.tensor([[0.47, 0.55, 0.4701, 0.5502], [0.0, 0.0, 1e-4, 1e-4],
                             [0.9999, 0.9999, 1.0, 1.0], [0.2, 0.3, 0.2 + 1 / 256, 0.31]])
    if name == "edges":
        return torch.tensor([[0.0, 0.0, 1.0, 1.0], [0.0, 0.3, 0.5, 0.7], [0.5, 0.3, 1.0, 0.7],
                             [0.3, 0.0, 0.7, 0.5], [0.3, 0.5, 0.7, 1.0], [0.6, 0.0, 1.0, 1.0]])
    if name == "wide":  # boxes wider than the image (rows past T) beside ones within it
        return torch.tensor(ZOOM_OUT)
    return sample_boxes(torch.Generator().manual_seed(5), 6, 300, 520)


# (name, x shape, (oh, ow), boxes, max_box_frac)
CROP_EDGES = [
    ("subpixel frac1", (4, 3, 300, 520), (96, 112), "subpixel", 1.0),
    ("edges frac1", (6, 3, 300, 520), (96, 112), "edges", 1.0),
    ("edges frac045", (6, 3, 300, 520), (96, 112), "edges", 0.45),
    ("rrc frac045", (6, 3, 300, 520), (160, 200), "rrc", 0.45),
    ("wide out", (6, 1, 300, 520), (150, 300), "rrc", 1.0),
    ("wide boxes frac1", (6, 3, 300, 520), (96, 112), "wide", 1.0),
    ("wide boxes frac05", (6, 3, 300, 520), (160, 200), "wide", 0.5),
]


def _forced_crop(monkeypatch, which, plan, real):
    """The crop pass ``which`` ("h": inner > 1, "w": inner == 1) launches
    ``plan``; the other pass keeps the production plan ``real``."""

    def pick(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize):
        if (inner > 1) == (which == "h"):
            return plan
        return real(wins, n_in, n_out, T, N, R, inner, n_sm, vec4, itemsize)

    monkeypatch.setattr(cc, "_crop_plan", pick)


def _crop_every_tile(dev, monkeypatch, x, tables, want, inter_dtype=torch.uint8):
    """Every tile the plan considers, forced on each pass in turn, through
    an intermediate of ``inter_dtype`` (the W pass stages its elements);
    returns the count of calls."""
    N, C, H, W = x.shape
    tab_h, tab_w = tables[0], tables[1]
    OH, OW = tab_h.first.shape[1], tab_w.first.shape[1]
    real, n = cc._crop_plan, 0
    isz_w = torch.empty((), dtype=inter_dtype).element_size()
    for which, tab, n_in, n_out, R, inner, isz in (("h", tab_h, H, OH, C, W, 1),
                                                   ("w", tab_w, W, OW, C * OH, 1, isz_w)):
        T = tab.w.shape[-1]
        cands = [p for _, p in plans.axis_tiles(
            tab.wins, n_out, T, n_in, N * R, inner, isz, plans.n_sm(dev), x.data_ptr() % 4 == 0,
            per_img=R)]
        for plan in list(dict.fromkeys(cands)) + [None]:
            _forced_crop(monkeypatch, which, plan, real)
            got = cc._crop_resample(x, *tables, inter_dtype)
            assert torch.equal(got, want), (which, plan)
            n += 1
    return n


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name,shape,ohw,boxes,frac", CROP_EDGES, ids=[c[0] for c in CROP_EDGES])
def test_crop_edges_every_tile(dev, monkeypatch, name, shape, ohw, boxes, frac, precision):
    x = _input(shape, torch.uint8, dev, seed=31)
    tables = cc._windowed_tables(x, _crop_boxes(boxes).to(dev), ohw, "bilinear", True, frac,
                                 precision)
    want = cc._crop_resample_plain(x, *tables)
    before = native.launches["crop_resample"]
    assert torch.equal(cc._crop_resample(x, *tables), want)
    assert native.launches["crop_resample"] == before + 2
    assert _crop_every_tile(dev, monkeypatch, x, tables, want) > 4


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_4k_random_resized_crop_every_tile(dev, monkeypatch, precision):
    x = _input((8, 3, 2160, 3840), torch.uint8, dev, seed=32)
    boxes = sample_boxes(torch.Generator().manual_seed(1), 8, 2160, 3840).to(dev)
    tables = cc._windowed_tables(x, boxes, (224, 224), "bilinear", True,
                                 box_fracs(2160, 3840), precision)
    want = cc._crop_resample_plain(x, *tables)
    assert torch.equal(cc._crop_resample(x, *tables), want)
    _crop_every_tile(dev, monkeypatch, x, tables, want)


def _zoom_out_every_tile(dev, monkeypatch, shape, ohw, boxes, frac, precision, seed):
    """A crop whose tables hold rows past T, through the plan and with
    every tile the plan considers forced on each pass, byte for byte
    against the plain version; returns the tables."""
    x = _input(shape, torch.uint8, dev, seed=seed)
    tables = cc._windowed_tables(x, torch.as_tensor(boxes, dtype=torch.float32).to(dev), ohw,
                                 "bilinear", True, frac, precision)
    assert all(bool((t.cnt > t.w.shape[-1]).any()) for t in tables[:2])
    want = cc._crop_resample_plain(x, *tables)
    _assert_equal(cc._crop_resample(x, *tables), want)
    assert _crop_every_tile(dev, monkeypatch, x, tables, want) > 4
    return tables


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_b64_zoom_out_every_tile(dev, monkeypatch, precision):
    """The b64 zoom-out boxes at the train shape: the tiles holding rows
    past T are staged in chunks, at every tile size the plan considers."""
    (shape, ohw) = TRAIN_B64
    _zoom_out_every_tile(dev, monkeypatch, shape, ohw, _zoom_out_boxes(shape[0]), 1.0,
                         precision, 37)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_tiles_mixing_wide_and_in_bound_rows_every_tile(dev, monkeypatch, precision):
    """Boxes half past the image: a tile at its edge holds rows past T
    beside rows within it (and one-hot rows past the image), which one
    chunk stages together, each row over its own count."""
    tables = _zoom_out_every_tile(dev, monkeypatch, (6, 3, 300, 520), (96, 112), MIXED_TILE,
                                  1.0, precision, 38)
    for tab in tables[:2]:
        T, n_out = tab.w.shape[-1], tab.cnt.shape[1]
        cnt = torch.nn.functional.pad(tab.cnt, (0, -n_out % 32), value=1).view(
            tab.cnt.shape[0], -1, 32)
        assert bool(((cnt > T).any(2) & ((cnt <= T) & (cnt > 1)).any(2)).any())


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_row_past_every_chunk_reads_device_memory(dev, monkeypatch, precision):
    """A box ten times the image on a quarter bound: a row counts more taps
    than a tile's window holds and reads device memory, its weights
    computed once per block (in groups of the tile's slots where they pass
    them), the rows beside it still staged in chunks."""
    tables = _zoom_out_every_tile(dev, monkeypatch, (2, 3, 150, 260), (16, 16),
                                  ROW_PAST_EVERY_CHUNK, 0.25, precision, 39)
    assert all(int(t.cnt.max()) > min(w for _, w in t.wins) for t in tables[:2])


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_4k_zoom_out_every_tile(dev, monkeypatch, precision):
    """Zoom-out boxes on 4K frames (the RandomResizedCrop call's shape)."""
    (shape, ohw) = CROP_4K
    _zoom_out_every_tile(dev, monkeypatch, shape, ohw, _zoom_out_boxes(shape[0]), 1.0,
                         precision, 40)


def _tables_equal(got, want):
    """Two ``_windowed_tables`` results table by table: ``first`` and
    ``cnt`` equal, ``w`` equal bit for bit, the same pb and windows."""
    assert got[2:] == want[2:]
    for g, w in zip(got[:2], want[:2]):
        assert g.wins == w.wins
        for f in ("first", "cnt", "w"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), f


def _plain_tables(monkeypatch):
    """From here on the table kernel's wrapper runs its plain version on
    the card (no count moves)."""
    monkeypatch.setattr(cc, "_windowed_tables_cuda", cc._windowed_tables_plain)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("mode", ["bilinear", "box", "hamming"])
@pytest.mark.parametrize("name,shape,ohw,boxes,frac", CROP_EDGES, ids=[c[0] for c in CROP_EDGES])
def test_crop_tables_kernel_matches_plain(dev, monkeypatch, name, shape, ohw, boxes, frac, mode,
                                          precision):
    x = torch.empty(shape, dtype=torch.uint8, device=dev)
    args = (x, _crop_boxes(boxes).to(dev), ohw, mode, True, frac, precision)
    before = native.launches["crop_tables"]
    got = cc._windowed_tables(*args)
    torch.cuda.synchronize()
    assert native.launches["crop_tables"] == before + 1
    _plain_tables(monkeypatch)
    _tables_equal(got, cc._windowed_tables(*args))
    assert native.launches["crop_tables"] == before + 1


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_tables_kernel_matches_plain_4k(dev, monkeypatch, precision):
    x = torch.empty((8, 3, 2160, 3840), dtype=torch.uint8, device=dev)
    boxes = sample_boxes(torch.Generator().manual_seed(1), 8, 2160, 3840).to(dev)
    args = (x, boxes, (224, 224), "bilinear", True, box_fracs(2160, 3840), precision)
    got = cc._windowed_tables(*args)
    _plain_tables(monkeypatch)
    _tables_equal(got, cc._windowed_tables(*args))


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("mode", ["bilinear", "box", "hamming"])
@pytest.mark.parametrize("name,shape,ohw,boxes,frac", TABLE_EDGES, ids=[e[0] for e in TABLE_EDGES])
def test_crop_tables_kernel_group_edges_match_plain(dev, monkeypatch, name, shape, ohw, boxes,
                                                    frac, mode, precision):
    """The group-per-row table kernel at its edges (chip_smoke.TABLE_EDGES:
    rows over three sum windows, two sum levels, rows past every segment,
    sub-pixel and zero-count rows, rows per block that do not divide the
    rows), the boxes dense and as a strided view."""
    x = torch.empty(shape, dtype=torch.uint8, device=dev)
    b = torch.tensor(boxes, device=dev)
    strided = torch.cat([b, torch.ones_like(b[:, :1])], 1)[:, :4]
    assert not strided.is_contiguous()
    got = [cc._windowed_tables(x, bx, ohw, mode, True, frac, precision) for bx in (b, strided)]
    _plain_tables(monkeypatch)
    want = cc._windowed_tables(x, b, ohw, mode, True, frac, precision)
    for g in got:
        _tables_equal(g, want)


@pytest.mark.parametrize("lanes", [1, 8, 16, 32])
@pytest.mark.parametrize("precision", ["pil_int8", "split"])
@pytest.mark.parametrize("name", [e[0] for e in TABLE_EDGES] + ["4k rrc", "b64 zoom-out"])
def test_crop_tables_kernel_at_every_group_size(dev, monkeypatch, name, precision, lanes):
    """Every group size, and one thread per row, on every edge and at the 4K
    and b64 zoom-out calls: rows longer than G (its chunks), and than 4 G
    (the long path, whose weights are computed again), give the plain
    build's tables."""
    edges = {e[0]: e[1:] for e in TABLE_EDGES}
    (b64, ohw64), (k4, ohw4k) = TRAIN_B64, CROP_4K
    edges["4k rrc"] = (k4, ohw4k, sample_boxes(torch.Generator().manual_seed(1), k4[0],
                                               *k4[2:]).tolist(), box_fracs(*k4[2:]))
    edges["b64 zoom-out"] = (b64, ohw64, _zoom_out_boxes(b64[0]).tolist(), 1.0)
    shape, ohw, boxes, frac = edges[name]
    axes = [a for a, _ in cc._table_geometry(shape[2], shape[3], *ohw, "bilinear", True,
                                             cc._fracs(frac), precision)]
    monkeypatch.setattr(cc, "_table_plan", lambda axes, N, n_sm: (lanes, lanes))
    b = torch.tensor(boxes, dtype=torch.float32, device=dev)
    before = native.launches["crop_tables"]
    got = cc._windowed_tables_cuda(b, "bilinear", True, axes)
    torch.cuda.synchronize()
    assert native.launches["crop_tables"] == before + 1
    want = cc._windowed_tables_plain(b, "bilinear", True, axes)
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_and_resize_equals_the_plain_table_build(dev, monkeypatch, precision):
    """The b64 call of the main path, byte for byte against the same call
    with the plain table build; one table launch and two crop launches."""
    x = _input((64, 3, 438, 906), torch.uint8, dev, seed=33)
    rng = np.random.default_rng(0)
    boxes = torch.from_numpy(np.concatenate(
        [rng.uniform(0.0, 0.35, (64, 2)), rng.uniform(0.65, 1.0, (64, 2))], 1
    ).astype(np.float32)).to(dev)
    if precision == "pil_int8":  # the default: crop_and_resize's route
        def call():
            return iat.crop_and_resize(x, boxes, (224, 224))
    else:
        def call():
            return cc.crop_and_resize_windowed(x, boxes, (224, 224), precision=precision)
    before = _counts("crop_tables", "crop_resample")
    got = call()
    torch.cuda.synchronize()
    assert _counts("crop_tables", "crop_resample") == (before[0] + 1, before[1] + 2)
    _plain_tables(monkeypatch)
    want = call()
    assert _counts("crop_tables", "crop_resample") == (before[0] + 1, before[1] + 4)
    _assert_equal(got, want)


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_wide_boxes_then_an_in_bound_call(dev, precision):
    """Boxes wider than the image at the train shape (rows past the tables'
    bound T, served whole by the kernel) byte for byte against the plain
    version; then a call within the image in the same process, as it was:
    the context is still usable."""
    x = _input((8, 3, 438, 906), torch.uint8, dev, seed=35)
    wide = torch.tensor(ZOOM_OUT[1:3] * 4, device=dev)
    tables = cc._windowed_tables(x, wide, (224, 224), "bilinear", True, 1.0, precision)
    assert all(int(t.cnt.max()) > t.w.shape[-1] for t in tables[:2])
    _assert_equal(cc._crop_resample(x, *tables), cc._crop_resample_plain(x, *tables))
    inside = torch.tensor(ZOOM_OUT[4:5] * 8, device=dev)
    tables = cc._windowed_tables(x, inside, (224, 224), "bilinear", True, 1.0, precision)
    _assert_equal(cc._crop_resample(x, *tables), cc._crop_resample_plain(x, *tables))


@pytest.mark.parametrize("precision", ["pil_int8", "split"])
def test_crop_strided_zoom_out_boxes_match_plain(dev, precision, monkeypatch):
    """Zoom-out boxes as a strided view (the first four columns of ``[N,
    5]`` detections): the windowed call, whose crop passes read the boxes
    of rows past the tables' bound, gives the plain version's bytes over
    the same boxes made dense."""
    x = _input((6, 3, 300, 520), torch.uint8, dev, seed=36)
    dense = torch.tensor(ZOOM_OUT, device=dev)
    dets = torch.cat([dense, torch.ones_like(dense[:, :1])], 1)
    strided = dets[:, :4]
    assert not strided.is_contiguous()
    got = cc.crop_and_resize_windowed(x, strided, (96, 112), precision=precision)
    _plain_tables(monkeypatch)
    tables = cc._windowed_tables(x, dense, (96, 112), "bilinear", True, 1.0, precision)
    assert all(int(t.cnt.max()) > t.w.shape[-1] for t in tables[:2])
    _assert_equal(got, cc._crop_resample_plain(x, *tables))


# ---------------------------------------------------------------------------
# The float32-intermediate crop route (flips on the card)
# ---------------------------------------------------------------------------

# (name, x shape, (oh, ow), boxes, filter): the train cell's call, a small
# one, 4K frames, and boxes wider than the image (rows past T, mirrored);
# the small and the wide-box calls under each filter the route admits
F32_METHODS = ["bilinear", "hamming", "box"]
F32_CASES = [
    *((f"small {m}", (6, 3, 300, 520), (96, 112), "rrc", m) for m in F32_METHODS),
    ("train b64", *TRAIN_B64, "rrc", "bilinear"),
    ("4k rrc", *CROP_4K, "rrc", "bilinear"),
    *((f"wide boxes {m}", (6, 3, 300, 520), (96, 112), "wide", m) for m in F32_METHODS),
    ("b64 zoom-out", *TRAIN_B64, "zoom-out", "bilinear"),
]


def _f32_call(dev, shape, boxes, seed):
    """``(x, boxes, flip)`` on the card: RandomResizedCrop boxes
    (``sample_boxes``), ZOOM_OUT, or zoom-out boxes per image, and flips at
    0.5 holding both values."""
    N, _, H, W = shape
    x = _input(shape, torch.uint8, dev, seed=seed)
    g = torch.Generator().manual_seed(seed)
    if boxes == "rrc":
        b = sample_boxes(g, N, H, W)
    elif boxes == "wide":
        b = torch.tensor(ZOOM_OUT)
    else:
        b = torch.as_tensor(_zoom_out_boxes(N), dtype=torch.float32)
    flip = torch.rand(N, generator=g) < 0.5
    flip[:2] = torch.tensor([True, False])
    return x, b.to(dev), flip.to(dev)


@pytest.mark.parametrize("name,shape,ohw,boxes,method", F32_CASES,
                         ids=[c[0] for c in F32_CASES])
def test_crop_f32_kernels_match_plain(dev, monkeypatch, name, shape, ohw, boxes, method):
    """The route's table launch and its two passes, bit for bit against
    their plain versions on the card (tables with the flip folded in, the
    float32 intermediate, one rounding), and a flipped output is exactly
    the mirror of the unflipped one."""
    x, b, flip = _f32_call(dev, shape, boxes, 41)
    before = _counts("crop_tables", "crop_f32", "crop_resample")
    got = cc.crop_and_resize_f32(x, b, ohw, method, flip=flip)
    torch.cuda.synchronize()
    assert _counts("crop_tables", "crop_f32", "crop_resample") == (
        before[0] + 1, before[1] + 2, before[2])
    tables = cc._f32_tables(x, b, ohw, method, flip)
    if boxes != "rrc":
        assert all(int(t.cnt.max()) > t.w.shape[-1] for t in tables[:2])
    _plain_tables(monkeypatch)
    want_tables = cc._f32_tables(x, b, ohw, method, flip)
    _tables_equal(tables, want_tables)
    _assert_equal(got, cc._crop_resample_plain(x, *want_tables, torch.float32))
    unflipped = cc.crop_and_resize_f32(x, b, ohw, method)
    _assert_equal(got, torch.where(flip[:, None, None, None], unflipped.flip(-1), unflipped))


@pytest.mark.parametrize("method", F32_METHODS)
@pytest.mark.parametrize("boxes", ["rrc", "wide"])
def test_crop_f32_every_tile(dev, monkeypatch, boxes, method):
    """Every tile the plan considers on each float32-intermediate pass (the
    W pass stages float32 rows), mirrored rows past T included, byte for
    byte against the plain version."""
    x, b, flip = _f32_call(dev, (6, 3, 300, 520), boxes, 42)
    tables = cc._f32_tables(x, b, (96, 112), method, flip)
    want = cc._crop_resample_plain(x, *tables, torch.float32)
    assert _crop_every_tile(dev, monkeypatch, x, tables, want, torch.float32) > 4


def test_crop_routes_on_the_card(dev, monkeypatch):
    """uint8 with flips takes the float32-intermediate route (one table
    launch, two ``crop_f32`` passes: uint8 -> float32 -> uint8 over float32
    tables); float input, a negative-lobe filter, ``antialias=False`` and
    ``use_windowed=False`` stay dense (no hand-written launch); without
    flips the windowed route keeps its integer tables (PilTaps), uint8 in
    and out."""
    from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts

    x, b, flip = _f32_call(dev, (4, 3, 300, 520), "rrc", 43)
    seen = []
    real = cc._launch
    monkeypatch.setattr(cc, "_launch", lambda xi, out, tab, *a: seen.append(
        (xi.dtype, out.dtype, tab.w.dtype)) or real(xi, out, tab, *a))
    u8, f32, i32 = torch.uint8, torch.float32, torch.int32
    for inp, kw, launches, passes in [
        (x, dict(flip=flip), {"crop_tables": 1, "crop_f32": 2}, [(u8, f32, f32), (f32, u8, f32)]),
        (x, dict(flip=flip, use_windowed=True), {"crop_tables": 1, "crop_f32": 2},
         [(u8, f32, f32), (f32, u8, f32)]),
        (x, dict(flip=flip, use_windowed=False), {}, []),
        (x, dict(flip=flip, method="bicubic"), {}, []),
        (x, dict(flip=flip, antialias=False), {}, []),
        (x.float(), dict(flip=flip), {}, []),
        (x, {}, {"crop_tables": 1, "crop_resample": 2}, [(u8, u8, i32), (u8, u8, i32)]),
    ]:
        seen.clear()
        before = launch_counts()
        y = iat.crop_and_resize(inp, b, (96, 112), **kw)
        torch.cuda.synchronize()
        assert y.shape == (4, 3, 96, 112) and y.dtype == inp.dtype
        got = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
        assert (got, seen) == (launches, passes), kw
    dense = iat.crop_and_resize(x, b, (96, 112), flip=flip, use_windowed=False).int()
    diff = (iat.crop_and_resize(x, b, (96, 112), flip=flip).int() - dense).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3


@pytest.mark.parametrize("seed", [5100000010, 3200000011, 2**31 + 12345])
def test_crop_f32_route_against_the_reference(dev, seed):
    """The train cell's call (b64 u8 3x438x906 -> 224^2, its boxes and
    flips at 0.5 from the seed) against ``perfbench.reference.crop
    .crop_dense`` (float64, one rounding) under the cell's limits:
    ``mismatch_pct`` <= 1.5 (the worst image's share of levels off the
    reference) and ``level_gap`` <= 1."""
    from perfbench.harness import traffic as gen
    from perfbench.reference import crop as ref

    H, W = 438, 906
    g = gen.generator(seed, dev)
    x = gen.images(g, 1, 64, (3, H, W), dev)[0]
    b = gen.resized_crop_boxes(g, 64, H, W, (0.08, 1.0), (0.75, 4 / 3), dev)
    flip = gen.flips(g, 64, 0.5, dev)
    before = native.launches["crop_f32"]
    y = iat.crop_and_resize(x, b, (224, 224), flip=flip, max_box_frac=box_fracs(H, W))
    assert native.launches["crop_f32"] == before + 2
    sides = (-1, 1) if ref.on_edge(b, H, W) else (0,)
    refs = torch.stack([ref.crop_dense(x, b, 224, 224, flip, side=s) for s in sides])
    off = (y.double()[None] - refs).abs().amin(0)
    mismatch_pct = float((off != 0).flatten(1).double().mean(1).max()) * 100.0
    assert mismatch_pct <= 1.5 and float(off.max()) <= 1.0, (mismatch_pct, float(off.max()))


def test_random_resized_crop_launches_the_table_kernel_once(dev):
    x = _input((4, 3, 300, 520), torch.uint8, dev, seed=34)
    before = native.launches["crop_tables"]
    for i in range(3):
        iat.random_resized_crop(torch.Generator().manual_seed(i), x, (96, 112))
        assert native.launches["crop_tables"] == before + i + 1


# ---------------------------------------------------------------------------
# The inspection and timing tools on the card
# ---------------------------------------------------------------------------

REPORT_CASES = [
    ("u8_pil", (4, 3, 438, 906), (196, 320), "bilinear", torch.uint8, None),
    ("f32_nchw", (1, 3, 438, 906), (196, 320), "bicubic", torch.float32, None),
    ("f32_nhwc", (1, 438, 906, 3), (196, 320), "bilinear", torch.float32, "NHWC"),
    ("bf16", (2, 3, 216, 384), (108, 192), "bilinear", torch.bfloat16, None),
    ("f32_no_tile", (2, 58200, 4), (1, 4), "box", torch.float32, None),
    ("u8_no_tile", (1, 20000, 64), (10, 32), "lanczos3", torch.uint8, None),
    ("f64_plain", (1, 3, 43, 90), (19, 32), "bilinear", torch.float64, None),
    ("bf16_stream", (4, 3, 2160, 3840), (1080, 1920), "bilinear", torch.bfloat16, None),
]


@pytest.mark.parametrize("name,shape,ohw,mode,dtype,fmt", REPORT_CASES,
                         ids=[c[0] for c in REPORT_CASES])
def test_kernel_report_route_matches_the_launch_counters(dev, name, shape, ohw, mode, dtype,
                                                         fmt):
    from interpolate_antialiasing_tpu_torch.utils.inspect import kernel_report, launch_counts

    rep = kernel_report(shape, ohw, mode=mode, dtype=dtype, data_format=fmt)
    assert not rep.n_sm_assumed and rep.n_sm == plans.n_sm(dev)
    x = _input(shape, dtype, dev)
    before = launch_counts()
    iat.resize(x, ohw, method=mode, data_format=fmt)
    torch.cuda.synchronize()
    got = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
    assert got == rep.launches, rep.route


def test_compiled_text_shows_the_launched_kernels_sass(dev):
    from interpolate_antialiasing_tpu_torch.utils.inspect import compiled_text

    x = _input((2, 3, 64, 96), torch.uint8, dev)
    txt = compiled_text(lambda t: iat.resize(t, (30, 40)), x)
    assert "[hand-written]" in txt
    assert re.search(r"Function : \S*resample2d_kernel", txt)
    assert re.search(r"Used \d+ registers", txt)


def test_device_time_per_call_times_the_kernel(dev):
    from interpolate_antialiasing_tpu_torch.utils.timing import (
        device_seconds_from_trace,
        device_time_per_call,
    )

    x = _input((3, 97, 131), torch.float32, dev)
    sh, sw = make_axis_spec(97, 40), make_axis_spec(131, 60)

    def call():
        return cr.resize2d(x, sh, sw)

    per_launch = device_time_per_call(call, iters=5, match="resample2d_kernel")
    per_call = device_time_per_call(call, iters=5)
    assert 0 < per_launch < 10 and 0 < per_call < 10

    def run_once():
        call()
        torch.cuda.synchronize()

    assert 0 < device_seconds_from_trace(run_once, "resample2d_kernel") < 0.01
    with pytest.raises(RuntimeError, match="no device time"):
        device_time_per_call(call, iters=2, match="no_such_kernel")


def test_a_hand_written_call_makes_its_launches_in_kernel_records(dev):
    """One crop call's profile holds one record per hand-written launch (the
    launch counters' delta: the table kernel once, the crop kernel twice),
    and the timer requires ``iters`` times that many."""
    from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts
    from interpolate_antialiasing_tpu_torch.utils.timing import (
        _records_per_call,
        device_seconds_from_trace,
        device_time_per_call,
    )

    x = _input((4, 3, 300, 520), torch.uint8, dev, seed=36)
    boxes = sample_boxes(torch.Generator().manual_seed(2), 4, 300, 520).to(dev)

    def call():
        return iat.crop_and_resize(x, boxes, (96, 112))

    call()
    before = launch_counts()
    call()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
    assert launched == {"crop_tables": 1, "crop_resample": 2}
    assert _records_per_call(call, (), "crop_tables_kernel") == 1
    assert _records_per_call(call, (), "resample_axis_kernel") == 2
    assert _records_per_call(call, (), None) >= 3

    def three():
        for _ in range(3):
            call()
        torch.cuda.synchronize()

    assert 0 < device_seconds_from_trace(three, "resample_axis_kernel", expect=6) < 0.01
    with pytest.raises(RuntimeError, match="not the 5 expected"):
        device_seconds_from_trace(three, "resample_axis_kernel", expect=5)
    assert 0 < device_time_per_call(call, iters=4, match="resample_axis_kernel") < 10


@pytest.mark.parametrize("route", ["eval", "train", "train_noflip", "video"])
def test_native_spans_per_call_equal_the_launch_counters(dev, route):
    """Under the profiler, the ``ia.native.<kernel>`` spans of two pipeline
    calls equal the launch counters' deltas, kernel by kernel, on the eval
    route, the float32-intermediate crop (flips), the windowed crop and the
    video downscale (kernel A's streaming twin)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    from interpolate_antialiasing_tpu_torch.models import (ImageNetEvalPipeline,
                                                           ImageNetTrainPipeline,
                                                           VideoDownscaler)
    from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts

    x = _input((8, 3, 438, 906), torch.uint8, dev, seed=37)
    if route == "video":
        frames = _input((4, 3, 2160, 3840), torch.bfloat16, dev, seed=38)
        video = VideoDownscaler((1080, 1920))

        def call():
            return video(frames)
    elif route == "eval":
        pipe = ImageNetEvalPipeline(size=(224, 224), short_side=256).to(dev)

        def call():
            return pipe(x)
    else:
        pipe = ImageNetTrainPipeline(size=(224, 224)).to(dev)
        boxes, flip = pipe.sample(torch.Generator(device=dev).manual_seed(3), x)
        flip = flip if route == "train" else None

        def call():
            return pipe.apply(x, boxes, flip)

    call()
    torch.cuda.synchronize()
    before = launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        call()
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in launch_counts().items() if v > before[k]}
    host = torch.autograd.DeviceType.CPU
    spans = Counter(e.name.removeprefix("ia.native.") for e in prof.events()
                    if e.name.startswith("ia.native.") and e.device_type == host)
    assert dict(spans) == launched
    assert launched == {"eval": {"pil_resample_2pass": 2, "normalize": 2},
                        "train": {"crop_tables": 2, "crop_f32": 4, "normalize": 2},
                        "train_noflip": {"crop_tables": 2, "crop_resample": 4, "normalize": 2},
                        "video": {"resample2d_stream": 2}}[route]


@pytest.mark.parametrize("case", NORMALIZE_CASES, ids=lambda c: c[0])
def test_normalize_kernel_matches_plain(dev, case):
    """The kernel (one launch; none for an empty batch) against the plain
    expression on the card, bit for bit: the pipelines' calls at b64, tails,
    channel counts, float32 in, bfloat16 out, misaligned views, and the
    route's casts around the kernel (float64 in, float16 and float64 out,
    channels last)."""
    from interpolate_antialiasing_tpu_torch.ops import normalize as nz

    y, mean, std = normalize_input(case, dev, 70)
    dtype = case[3]
    before = native.launches["normalize"]
    got = nz.normalize(y, mean, std, dtype)
    torch.cuda.synchronize()
    assert native.launches["normalize"] == before + (1 if y.numel() else 0)
    assert got.is_contiguous()
    want = nz._normalize_plain(y, mean, std, dtype)
    if y.numel():
        _assert_equal(got, want)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("pipeline", ["eval", "eval bf16", "eval f32 domain", "train"])
def test_the_pipelines_on_the_card_equal_their_plain_run(dev, pipeline):
    """Each pipeline's call against the same call with every kernel's plain
    version (``chip_smoke._plain_kernels``), byte for byte, and its launches:
    the resize or crop, then one ``normalize``."""
    from chip_smoke import _plain_kernels
    from interpolate_antialiasing_tpu_torch.models import (ImageNetEvalPipeline,
                                                           ImageNetTrainPipeline)
    from interpolate_antialiasing_tpu_torch.utils.inspect import launch_counts

    x = _input((8, 3, 438, 906), torch.uint8, dev, seed=88)
    if pipeline == "train":
        pipe = ImageNetTrainPipeline(size=(224, 224)).to(dev)
        boxes, _ = pipe.sample(torch.Generator(device=dev).manual_seed(5), x)
        flip = torch.tensor([True, False] * 4, device=dev)

        def call():
            return pipe.apply(x, boxes, flip)
        want = {"crop_tables": 1, "crop_f32": 2, "normalize": 1}
    else:
        pipe = ImageNetEvalPipeline(
            size=(224, 224), short_side=256,
            dtype=torch.bfloat16 if pipeline == "eval bf16" else torch.float32,
            resize_domain="float32" if pipeline == "eval f32 domain" else "uint8").to(dev)

        def call():
            return pipe(x)
        want = ({"resample2d": 1, "normalize": 1} if pipeline == "eval f32 domain"
                else {"pil_resample_2pass": 1, "normalize": 1})
    before = launch_counts()
    got = call()
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in launch_counts().items() if v > before[k]} == want
    with _plain_kernels():
        before = launch_counts()
        plain = call()
        torch.cuda.synchronize()
        assert launch_counts() == before
    _assert_equal(got, plain)
