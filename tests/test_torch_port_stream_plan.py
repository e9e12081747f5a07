"""The streaming twin of kernel A (``csrc/resample2d_stream.cu``) on the CPU:
which launches its plan takes, that every tap of every output lies inside
the rows and columns a warp stages, that its shared bytes are the kernel's
layout, and that its in-axis tables sum to the plain version's bits.  The
kernel itself runs only on the card (``tests/test_torch_port_cuda.py``)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.ops import plans
from interpolate_antialiasing_tpu_torch.ops.resize_xla import gather_reduce_weights
from interpolate_antialiasing_tpu_torch.ops.weights import Tables, adjoint_tables, make_axis_spec
from interpolate_antialiasing_tpu_torch.utils.inspect import kernel_report

N_SM = plans.H100_SMS
CONFIG5 = ((2160, 3840), (1080, 1920))  # BASELINE config 5: 4K -> 1080p frames


def _specs(hw, ohw, mode="bilinear"):
    return make_axis_spec(hw[0], ohw[0], mode), make_axis_spec(hw[1], ohw[1], mode)


def _candidates(sh, sw, itemsize, planes):
    """The bucket, both in-axis tables and every plan _plan_stream weighs."""
    nt = plans._stream_ntaps(sh, sw)
    th, tw = plans.stream_tables(sh, nt), plans.stream_tables(sw, nt)
    cands = list(dict.fromkeys(p for _, p in plans._stream_candidates(
        th[0], sh.in_size, tw[0], sw.in_size, nt, itemsize, planes, N_SM)))
    return nt, th, tw, cands


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_config5_takes_the_streaming_plan(dtype):
    sh, sw = _specs(*CONFIG5)
    plan = cr.resize2d_plan(sh, sw, dtype.itemsize, 192, N_SM)
    assert isinstance(plan, plans.PlanStream) and plan.ntaps == 4
    warps = 192 * -(-1080 // plan.seg) * -(-1920 // plans._stream_tc(plan.ntaps))
    assert plan.blocks == -(-warps // plans._STREAM_WARPS)
    assert warps >= plans._stream_min_warps(N_SM) == \
        plans._STREAM_WAVES * plans._STREAM_RESIDENT * plans._STREAM_WARPS * N_SM
    rep = kernel_report((64, 3, *CONFIG5[0]), CONFIG5[1], dtype=dtype)
    assert rep.route == "resample2d_stream" and rep.launches == {"resample2d_stream": 1}
    assert rep.plan == plan._asdict()


SHORT = [
    # the f32 headline at batch 1: a few waves of tiles
    ("headline_b1", (438, 906), (196, 320), "bilinear", 4, 3, False),
    # an adjoint upscale (transposed tables)
    ("adjoint_b8", (196, 320), (438, 906), "bilinear", 4, 24, True),
    # 12 effective taps along W: past the kernel's buckets
    ("bicubic_b64", (438, 906), (196, 320), "bicubic", 4, 192, False),
    # one 4K frame: too few strips to fill the card
    ("uhd_b1", (2160, 3840), (1080, 1920), "bilinear", 2, 3, False),
]


@pytest.mark.parametrize("name,hw,ohw,mode,itemsize,planes,adjoint", SHORT,
                         ids=[c[0] for c in SHORT])
def test_short_launches_keep_the_tile_plan(name, hw, ohw, mode, itemsize, planes, adjoint):
    if adjoint:
        sh = adjoint_tables(make_axis_spec(ohw[0], hw[0], mode))
        sw = adjoint_tables(make_axis_spec(ohw[1], hw[1], mode))
    else:
        sh, sw = _specs(hw, ohw, mode)
    plan = cr.resize2d_plan(sh, sw, itemsize, planes, N_SM)
    assert isinstance(plan, plans.Plan2d)
    assert plan == plans.plan2d(sh, sw, itemsize, planes, N_SM)


# (name, [H, W], [OH, OW], mode, itemsize, planes): long launches past
# config 5 that stream, some of them with a tile plan of fewer than 8 waves
LONG = [
    ("uhd_b4", (2160, 3840), (1080, 1920), "bilinear", 2, 12),
    ("uhd_bicubic_u8_b2", (2160, 3840), (1080, 1920), "bicubic", 1, 6),
    ("x2_64px_f32", (64, 64), (32, 32), "bilinear", 4, 6144),
    ("x2_128px_u8", (128, 128), (64, 64), "bilinear", 1, 3072),
    ("x2.3_512px_u8", (512, 512), (224, 224), "bilinear", 1, 192),
]


@pytest.mark.parametrize("name,hw,ohw,mode,itemsize,planes", LONG, ids=[c[0] for c in LONG])
def test_long_launches_take_the_streaming_plan(name, hw, ohw, mode, itemsize, planes):
    sh, sw = _specs(hw, ohw, mode)
    plan = cr.resize2d_plan(sh, sw, itemsize, planes, N_SM)
    assert isinstance(plan, plans.PlanStream)
    assert plan == plans.plan2d_stream(sh, sw, itemsize, planes, N_SM)


@pytest.mark.parametrize("name,hw,ohw,mode,itemsize,planes,adjoint",
                         [c[:5] + (p, False) for c in LONG
                          for p in (c[5] // 2, c[5], c[5] + 1)] + SHORT,
                         ids=[f"{c[0]}_{k}" for c in LONG for k in ("half", "at", "more")]
                         + [c[0] for c in SHORT])
def test_the_early_warp_bound_refuses_no_launch_the_candidates_take(name, hw, ohw, mode,
                                                                     itemsize, planes, adjoint):
    """_plan2d_stream refuses a short launch before it builds tables; that
    check only bounds the warps of every candidate, so it gives what the
    candidates alone give."""
    sh, sw = _specs(hw, ohw, mode)
    if adjoint:
        sh = adjoint_tables(make_axis_spec(ohw[0], hw[0], mode))
        sw = adjoint_tables(make_axis_spec(ohw[1], hw[1], mode))
    nt = plans._stream_ntaps(sh, sw)
    want = None
    if nt is not None:
        th, tw = plans.stream_tables(sh, nt), plans.stream_tables(sw, nt)
        want = plans._plan_stream(th[0], hw[0], tw[0], hw[1], nt, itemsize, planes, N_SM)
    assert plans.plan2d_stream(sh, sw, itemsize, planes, N_SM) == want


# The Pillow kernel's plans at the eval cell's resize, the bench batch and a
# 4K frame, field for field as the parent commit of the streaming kernel
# planned them: the Pillow route never takes the streaming plan.
PIL_PLANS = [
    ((438, 906), (256, 529), 192, (64, 128, 113, 223, 113, 48768, 3840, 4)),
    ((438, 906), (196, 320), 192, (64, 64, 148, 186, 148, 47232, 3840, 4)),
    ((2160, 3840), (1080, 1920), 3, (64, 128, 131, 259, 131, 61968, 765, 3)),
]


@pytest.mark.parametrize("hw,ohw,planes,want", PIL_PLANS, ids=["eval", "bench", "uhd"])
def test_the_pillow_plan_is_unchanged(hw, ohw, planes, want):
    tw, th = pe._int_tables(hw[1], ohw[1], "bilinear"), pe._int_tables(hw[0], ohw[0], "bilinear")
    plan = plans.plan_pil_2pass(tw, th, planes, *hw, N_SM)
    assert isinstance(plan, plans.Plan2d) and tuple(plan) == want


# (name, [H, W], [OH, OW], mode, itemsize, planes): config 5 and its bicubic
# twin at their batch, and ragged and odd shapes at 2x, 2.5x and 3x with
# planes enough to pass the gate
STRIP_CASES = [
    ("config5", (2160, 3840), (1080, 1920), "bilinear", 2, 192),
    ("config5_bicubic", (2160, 3840), (1080, 1920), "bicubic", 2, 192),
    ("ragged_odd", (1003, 1499), (401, 653), "bilinear", 2, 4096),
    ("ragged_bicubic_f32", (997, 1301), (499, 651), "bicubic", 4, 4096),
    ("x3_u8", (900, 1500), (300, 500), "bilinear", 1, 4096),
]


@pytest.mark.parametrize("name,hw,ohw,mode,itemsize,planes", STRIP_CASES,
                         ids=[c[0] for c in STRIP_CASES])
def test_every_tap_lies_in_the_strips_staged_rows_and_span(name, hw, ohw, mode, itemsize,
                                                            planes):
    sh, sw = _specs(hw, ohw, mode)
    nt, (fh, _), (fw, _), cands = _candidates(sh, sw, itemsize, planes)
    assert cands and nt in plans._STREAM_TAPS
    tc = plans._stream_tc(nt)
    for plan in cands:
        assert plan.ntaps == nt
        # a warp's input rows, as the kernel computes them from its segment
        for oy0 in range(0, ohw[0], plan.seg):
            f = fh[oy0:oy0 + plan.seg].astype(np.int64)
            r0, r1 = f[0], f[-1] + nt
            taps = f[:, None] + np.arange(nt)
            assert 0 <= r0 <= taps.min() and taps.max() < r1 <= hw[0], (plan, oy0)
        # and its columns, from its strip
        for ox0 in range(0, ohw[1], tc):
            f = fw[ox0:ox0 + tc].astype(np.int64)
            c_lo, span = f[0], f[-1] + nt - f[0]
            taps = f[:, None] + np.arange(nt)
            assert 0 <= c_lo <= taps.min() and taps.max() < c_lo + span <= hw[1], (plan, ox0)
            assert span <= plan.cols_cap


@pytest.mark.parametrize("name,hw,ohw,mode,itemsize,planes", STRIP_CASES,
                         ids=[c[0] for c in STRIP_CASES])
def test_the_rings_bytes_are_the_kernels_layout(name, hw, ohw, mode, itemsize, planes):
    src = (Path(cr.__file__).parent.parent / "csrc" / "resample2d_stream.cu").read_text()
    assert int(re.search(r"constexpr int kWarps = (\d+);", src).group(1)) == plans._STREAM_WARPS
    assert int(re.search(r"constexpr int kMinBlocks = (\d+);", src).group(1)) == \
        plans._STREAM_RESIDENT
    sh, sw = _specs(hw, ohw, mode)
    nt, _, _, cands = _candidates(sh, sw, itemsize, planes)
    for plan in cands:
        # a staged row: its span, up to 15 bytes of head and of tail
        stride = -(-plan.cols_cap * itemsize // 16) * 16 + 32
        assert stride >= plan.cols_cap * itemsize + 30
        assert plan.smem == plans._STREAM_WARPS * plan.stages * nt * stride
        assert 2 <= plan.stages <= 4 and plan.smem <= plans._SMEM_BUDGET < plans._SMEM_LIMIT
        assert plan.resident == min(plans._SM_THREADS // (32 * plans._STREAM_WARPS),
                                    plans._STREAM_RESIDENT,
                                    plans._SM_SMEM // (plan.smem + plans._SM_SMEM_PER_BLOCK))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("n_in,n_out", [(2160, 1080), (1500, 500), (1000, 400)],
                         ids=["2x", "3x", "2.5x"])
def test_effective_taps_end_at_the_last_nonzero_weight_column(mode, n_in, n_out):
    _, w = plans.tables(make_axis_spec(n_in, n_out, mode))
    last = max(k for k in range(w.shape[1]) if np.any(w[:, k] != 0))
    assert plans._effective_taps(w) == last + 1 <= w.shape[1]
    assert not np.any(w[:, last + 1:])
    if n_in == 2 * n_out:  # 2x: 4 of 5 taps bilinear, 8 of 9 bicubic
        assert (w.shape[1], last + 1) == ((5, 4) if mode == "bilinear" else (9, 8))


def _plain_over(x3, tables_h, tables_w, out_dtype):
    """The plain version's arithmetic over given tables."""
    def one(x, tables, axis):
        first, w = (torch.from_numpy(np.array(a)) for a in tables)
        return gather_reduce_weights(x, first.long(), w, axis, torch.float32)

    y = one(x3, tables_w, 2)
    if x3.dtype == out_dtype == torch.uint8:
        y = cr._quant_u8(y)
    return cr._store(one(y, tables_h, 1), out_dtype)


@pytest.mark.parametrize("idt,odt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32),
                                     (torch.uint8, torch.float32), (torch.uint8, torch.uint8)],
                         ids=["bf16", "f32", "u8_f32", "u8_u8"])
@pytest.mark.parametrize("hw,ohw,mode", [((64, 96), (32, 48), "bilinear"),
                                         ((62, 98), (31, 49), "bicubic"),
                                         ((75, 90), (30, 36), "bilinear"),
                                         ((40, 70), (13, 23), "bilinear")],
                         ids=["2x", "bicubic_ragged", "2.5x", "3x"])
def test_in_axis_tables_give_the_plain_versions_bits(hw, ohw, mode, idt, odt):
    sh, sw = _specs(hw, ohw, mode)
    nt = plans._stream_ntaps(sh, sw)
    th, tw = plans.stream_tables(sh, nt), plans.stream_tables(sw, nt)
    for (first, w), (f0, w0), n_in in ((th, plans.tables(sh), hw[0]),
                                       (tw, plans.tables(sw), hw[1])):
        assert w.shape[1] == nt and first.min() >= 0 and first.max() + nt <= n_in
        # every output keeps its nonzero weights on the same inputs, in order
        for o in range(len(first)):
            old = [(f0[o] + k, w0[o, k]) for k in range(w0.shape[1]) if w0[o, k] != 0]
            new = [(first[o] + k, w[o, k]) for k in range(nt) if w[o, k] != 0]
            assert old == new
    g = torch.Generator().manual_seed(sum(hw))
    x3 = (torch.rand((3, *hw), generator=g) * 255).to(idt)
    assert torch.equal(_plain_over(x3, th, tw, odt), cr._resample2d_plain(x3, sh, sw, odt))


def test_in_axis_tables_refuse_a_weighted_tap_outside_the_axis():
    w = np.full((3, 2), 0.5)
    edge = Tables(in_size=10, out_size=3, xmin=np.array([-1, 3, 9], np.int32), w=w)
    assert plans.stream_tables(edge, 4) is None  # taps -1 and 10 carry weight
    w = np.array([[0.0, 1.0], [0.5, 0.5], [1.0, 0.0]])
    inside = Tables(in_size=10, out_size=3, xmin=np.array([-1, 3, 9], np.int32), w=w)
    first, w4 = plans.stream_tables(inside, 4)
    assert first.tolist() == [0, 3, 6] and w4.tolist() == [[1, 0, 0, 0], [0.5, 0.5, 0, 0],
                                                            [0, 0, 0, 1]]
    with pytest.raises(ValueError):
        plans.stream_tables(make_axis_spec(2160, 1080, "bicubic"), 4)  # 8 taps carry weight
