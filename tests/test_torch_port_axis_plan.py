"""The host plan of the per-axis kernels (kernel B, ``resample_axis`` with
host tables or synthesised weights, and ``pil_resample_axis``):
``ops/cuda_resize.py::_plan_axis``.  It runs on the CPU, so these tests
state its invariants at the shapes the card runs: the bytes the plan asks
for are the kernel's layout and fit a block, every tile's staged window
holds every tap of its outputs, a launch fills the card where the shape
allows, and the plan gives up exactly where the smallest tile does not fit
(the kernel then runs its unstaged body)."""

import numpy as np
import pytest
import torch

from interpolate_antialiasing_tpu_torch.ops import cuda_resize as cr
from interpolate_antialiasing_tpu_torch.ops import pil_exact as pe
from interpolate_antialiasing_tpu_torch.ops.weights import make_axis_spec
from interpolate_antialiasing_tpu_torch.parallel import halo


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pass(n_in, n_out, mode="bilinear", source="table"):
    """(first taps int64, ntaps) of a pass: float tables, synthesised first
    taps, or Pillow's int32 tables."""
    if source == "pil":
        xmin, wb = pe._int_tables(n_in, n_out, mode)
        return np.asarray(xmin, np.int64), wb.shape[1]
    spec = make_axis_spec(n_in, n_out, mode)
    if source == "fused":
        return cr._synth_first(spec), spec.ntaps
    first, w = cr._tables(spec)
    return first.astype(np.int64), w.shape[1]


# (name, n_in, n_out, mode, outer, inner, itemsize): the NHWC headline's W
# and H passes, config 5 NHWC, a last-axis pass, the shard passes (row 3's
# uint8 W and H pass, row 9's float H pass, cut to a few planes), an
# upsample and one output
SHAPES = [
    ("nhwc_w", 906, 320, "bilinear", 438, 3, 4),
    ("nhwc_h", 438, 196, "bilinear", 1, 960, 4),
    ("config5_w", 3840, 1920, "bilinear", 64 * 2160, 3, 2),
    ("config5_h", 2160, 1080, "bilinear", 64, 5760, 2),
    ("last_axis", 906, 320, "bicubic", 3 * 438, 1, 4),
    ("row3_w", 32768, 8192, "bilinear", 96, 1, 1),
    ("row3_h", 8196, 2048, "bilinear", 3, 8192, 1),
    ("row9_h", 4112, 1024, "bicubic", 3, 4096, 4),
    ("upsample", 31, 90, "lanczos3", 2, 70, 4),
    ("one_output", 50, 1, "bilinear", 2, 7, 1),
    ("inner5", 57, 23, "lanczos3", 2, 5, 2),
]
SOURCES = ["table", "fused", "pil"]


def _shapes(sources=SOURCES):
    for name, n_in, n_out, mode, outer, inner, itemsize in SHAPES:
        for source in sources:
            if source == "pil" and itemsize != 1:
                continue
            yield pytest.param(n_in, n_out, mode, outer, inner, itemsize, source,
                               id=f"{name}-{source}")


def _assert_plan_holds(plan, first, ntaps, n_in, outer, inner, itemsize, vec4):
    n_out = len(first)
    assert plan.tile_o in cr._AXIS_TILE_O and plan.tile_j in cr._AXIS_TILE_J
    assert plan.tile_i == inner or (plan.tile_i in cr._AXIS_TILE_I and plan.tile_j == 1
                                    and plan.tile_i < inner)
    # the bytes are the kernel's layout of the plan, within a block's budget
    assert plan.smem == cr._axis_smem_bytes(plan.tile_j, plan.tile_o, plan.tile_i, plan.win,
                                            ntaps, itemsize, n_in, inner)
    assert plan.smem <= cr._SMEM_BUDGET < cr._SMEM_LIMIT
    # the staged window holds every run with its 15-byte head and tail
    if plan.tile_i == inner:
        stride = cr._align16(plan.win * inner * itemsize + 15) + 16
        assert plan.tile_j * stride <= plan.smem
    else:
        stride = cr._align16(plan.tile_i * itemsize + 15) + 16
        assert plan.win * stride <= plan.smem
    assert stride >= (plan.win * inner if plan.tile_i == inner else plan.tile_i) * itemsize + 30
    # every tap of every output lies in its tile's window, the win rows
    # from the tile's first row in the host's table (the kernel copies
    # those; a tap outside them traps)
    taps = np.clip(first[:, None] + np.arange(ntaps), 0, n_in - 1)
    win0 = cr._win0(first, n_in, plan.tile_o)
    assert win0.dtype == np.int32 and len(win0) == -(-n_out // plan.tile_o)
    for t in range(-(-n_out // plan.tile_o)):
        r = taps[t * plan.tile_o:(t + 1) * plan.tile_o]
        assert r.max() - r.min() + 1 <= plan.win
        assert win0[t] == r.min() and r.max() < win0[t] + min(plan.win, n_in - win0[t])
    assert plan.blocks == (-(-outer // plan.tile_j) * -(-n_out // plan.tile_o)
                           * -(-inner // plan.tile_i))
    # four uint8 columns per thread only where every access is aligned
    assert plan.vec in (1, 4)
    if plan.vec == 4:
        assert itemsize == 1 and vec4 and inner % 4 == 0 and plan.tile_i % 4 == 0


@pytest.mark.parametrize("vec4", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("n_in,n_out,mode,outer,inner,itemsize,source", _shapes())
def test_axis_plan_is_the_kernel_layout_and_covers_every_tap(n_in, n_out, mode, outer, inner,
                                                             itemsize, source, vec4):
    first, ntaps = _pass(n_in, n_out, mode, source)
    plan = cr._plan_axis(first, ntaps, n_in, outer, inner, itemsize, 132, vec4)
    assert plan is not None
    _assert_plan_holds(plan, first, ntaps, n_in, outer, inner, itemsize, vec4)


def _most_blocks(n_out, outer, inner):
    """The most blocks any tile could give: one plane, one output and the
    narrowest inner span per block."""
    spans = -(-inner // min(cr._AXIS_TILE_I)) if inner > min(cr._AXIS_TILE_I) else 1
    return outer * n_out * spans


@pytest.mark.parametrize("n_sm", [132, 114, 66])
@pytest.mark.parametrize("n_in,n_out,mode,outer,inner,itemsize,source",
                         _shapes(["table", "pil"]))
def test_axis_plan_fills_the_card(n_in, n_out, mode, outer, inner, itemsize, source, n_sm):
    first, ntaps = _pass(n_in, n_out, mode, source)
    plan = cr._plan_axis(first, ntaps, n_in, outer, inner, itemsize, n_sm, True)
    # a block per SM where the shape has that many tiles, else the most it
    # has, and two of them resident
    assert plan.blocks >= min(n_sm, _most_blocks(n_out, outer, inner))
    assert plan.resident >= 2
    _assert_plan_holds(plan, first, ntaps, n_in, outer, inner, itemsize, True)


def test_axis_plan_fills_the_card_at_the_nhwc_headline():
    """Both passes of the NHWC headline (438 rows of 906 x 3, then one
    plane of 438 x 960) give a block per SM at least; a huge batch keeps
    large tiles (a block's chain of copies is then paid once per 4096
    rows)."""
    for n_in, n_out, outer, inner in ((906, 320, 438, 3), (438, 196, 1, 960)):
        first, ntaps = _pass(n_in, n_out)
        plan = cr._plan_axis(first, ntaps, n_in, outer, inner, 4, 132)
        assert plan.blocks >= 132
    first, ntaps = _pass(3840, 1920)
    big = cr._plan_axis(first, ntaps, 3840, 64 * 2160, 3, 2, 132)
    assert big.tile_j * big.tile_o >= 1024 and big.blocks >= 10000


def _smallest_block(first, ntaps, n_in, inner, itemsize):
    """The least shared memory any tile could take: one plane, one output,
    the narrowest inner span."""
    win = cr._window(first, ntaps, n_in, 1)
    spans = [inner] + [t for t in cr._AXIS_TILE_I if t < inner]
    return min(cr._axis_smem_bytes(1, 1, t, win, ntaps, itemsize, n_in, inner) for t in spans)


@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("n_in,inner", [(1000, 1), (3000, 64), (5000, 64), (20000, 1),
                                        (60000, 1), (2000, 64), (900, 960)])
def test_axis_plan_gives_up_only_when_no_tile_fits(n_in, inner, itemsize):
    first, ntaps = _pass(n_in, 1, "box")
    plan = cr._plan_axis(first, ntaps, n_in, 2, inner, itemsize, 132)
    fits = _smallest_block(first, ntaps, n_in, inner, itemsize) <= cr._SMEM_BUDGET
    assert (plan is not None) == fits
    if plan is not None:
        _assert_plan_holds(plan, first, ntaps, n_in, 2, inner, itemsize, False)


def test_axis_plan_gives_up_for_the_58200_row_box():
    """The case chip_smoke.py runs through the unstaged body: a 58,200-tap
    box window of four float32 columns, tables and synthesised weights."""
    spec = make_axis_spec(58200, 1, "box")
    assert cr._plan_axis_spec(spec, False, 2, 4, 4) is None
    assert cr.axis_launch_args(None, b"", 1, torch.device("cpu")) == (0, 0, 0, 0, 0, 1, 0)
    spec = make_axis_spec(58200, 1, "bilinear")
    assert cr._plan_axis_spec(spec, True, 2, 4, 4) is None


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "lanczos3"])
def test_axis_plan_of_every_shard_table(mode):
    """Each shard's compact tables (the sharded float H pass and its
    adjoint, and the byte-exact route's H pass) plan like any pass."""
    plan = halo.plan_halo_banded(129, 40, mode, True, 4)
    for d in range(4):
        for t in halo._shard_tables(plan, d):
            first, w = cr._tables(t)
            first = first.astype(np.int64)
            p = cr._plan_axis(first, w.shape[1], t.in_size, 2, 37, 4, 132)
            _assert_plan_holds(p, first, w.shape[1], t.in_size, 2, 37, 4, False)
    iplan, starts, wsh = halo._int_halo_tables(97, 41, mode, 4)
    for d in range(4):
        first = np.asarray(starts[d], np.int64)
        p = cr._plan_axis(first, wsh[d].shape[1], iplan.ext, 3, 72, 1, 132, True)
        _assert_plan_holds(p, first, wsh[d].shape[1], iplan.ext, 3, 72, 1, True)
        assert p.vec == 4


def test_axis_plan_is_cached_per_shape():
    spec = make_axis_spec(906, 320)
    a = cr._plan_axis_spec(spec, True, 438 * 64, 3, 4, 132, True)
    assert cr._plan_axis_spec(spec, True, 438 * 64, 3, 4, 132, True) is a
    assert cr._plan_axis_spec(spec, True, 438 * 32, 3, 4, 132, True) is not a


@pytest.mark.parametrize("source", SOURCES)
def test_small_passes_run_the_unstaged_body(source):
    """A pass that moves at most _AXIS_UNSTAGED_BYTES (synthesised weights:
    _AXIS_UNSTAGED_BYTES_FUSED) gets no tile (the unstaged body ran such
    passes faster); a larger one keeps its tile, and :func:`_plan_axis`
    gives every pass its tile."""
    first, ntaps = _pass(906, 320, "bilinear", source)
    itemsize = 1 if source == "pil" else 4
    fused = source == "fused"
    cut = cr._AXIS_UNSTAGED_BYTES_FUSED if fused else cr._AXIS_UNSTAGED_BYTES
    for outer in (1, 438, 438 * 4, 438 * 64):  # ~15 kB to ~420 MB in float32
        small = outer * 3 * (906 + 320) * itemsize <= cut
        plan = cr._plan_axis_first(first.tobytes(), ntaps, 906, outer, 3, itemsize, 132, True,
                                   fused)
        assert (plan is None) == small
        assert cr._plan_axis(first, ntaps, 906, outer, 3, itemsize, 132, True) is not None
    spec = make_axis_spec(438, 196)
    for fused in (False, True):  # the NHWC headline's H pass, one frame: 2.4 MB
        assert cr._plan_axis_spec(spec, fused, 1, 960, 4, 132, True) is None
        assert cr._plan_axis_spec(spec, fused, 64, 960, 4, 132, True) is not None
    # its W pass, 6.4 MB: the unstaged body with tables, a tile when fused
    spec = make_axis_spec(906, 320)
    assert cr._plan_axis_spec(spec, False, 438, 3, 4, 132, True) is None
    assert cr._plan_axis_spec(spec, True, 438, 3, 4, 132, True) is not None


def test_first_taps_key_is_derived_once_per_read_only_table():
    """The Pillow wrapper and the float wrappers share one first-taps key:
    computed once per read-only table (by identity), anew for a table that
    may change, and equal to the taps' int64 bytes either way."""
    xmin, _ = pe._int_tables(906, 320, "bilinear")
    assert not xmin.flags.writeable
    key = cr._first_taps_key(xmin)
    assert key == np.asarray(xmin, np.int64).tobytes()
    assert cr._first_taps_key(xmin) is key
    mutable = np.array(xmin)
    assert cr._first_taps_key(mutable) == key
    mutable[0] += 1
    assert cr._first_taps_key(mutable) != key
    spec = make_axis_spec(906, 320)
    assert cr._first_key(spec, False) == np.asarray(cr._tables(spec)[0], np.int64).tobytes()
    assert cr._first_key(spec, True) == np.asarray(cr._synth_first(spec), np.int64).tobytes()
