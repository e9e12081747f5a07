"""The bfloat16 check (``perfbench/checks/bf16_ulps.py``): exact roundings
read nought, a plain float32 resize of bfloat16 frames passes, and every
control of that route fails at one set of limits that the sound route
passes with room, also through a whole run of ``run.py``.

The route is the one bfloat16 video takes (``VideoDownscaler``): float32
weight tables, float32 sums over each axis, one rounding to bfloat16; its
float64 twin is the reference.  The controls are that route one
precision lower in one stage (a bfloat16 intermediate, bfloat16 weights,
a store that truncates), and faults planted in its output: a band of a
fourteenth of the rows of one channel one ulp up, a NaN, a wrong shape,
one frame repeated in the next one's place, the right values in float32.
"""

from __future__ import annotations

import math
import time
import types

import pytest
import torch

import small_cells
from perfbench import run
from perfbench.harness import compare
from perfbench.harness import traffic as gen
from perfbench.reference import crop

bf16_ulps = run.load("checks", "bf16_ulps")
BF16, F32, F64 = torch.bfloat16, torch.float32, torch.float64

# one set of limits for every case below: the sound route reads at most
# 0.5 ulp plus its float32 error, and flips a few elements near ties
LIMITS = {"mismatch_pct": 0.5, "ulp_gap": 0.51}
SOUND_GAP = 0.5 + 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_ulp_by_hand():
    r = torch.tensor([1.0, 1.5, -1.9, 2.0, -3.0, 255.0, 256.0, 2.0 ** -126, 2.0 ** -130, 0.0,
                      3.0e38], dtype=F64)
    want = [-7, -7, -7, -6, -6, 0, 1, -133, -133, -133, math.frexp(3.0e38)[1] - 8]
    assert bf16_ulps.ulp(r).tolist() == [2.0 ** e for e in want]


def _exact_cases() -> torch.Tensor:
    """float32 values cast to float64 (so that one rounding to bfloat16 is
    exact): a wide range of magnitudes and signs, bfloat16 subnormals,
    zeros, and ties between two bfloat16 numbers."""
    g = torch.Generator().manual_seed(3)
    mag = torch.exp2(torch.randint(-140, 120, (2, 3, 8, 8), generator=g).to(F32))
    r = (torch.rand((2, 3, 8, 8), generator=g) + 0.5) * mag
    r[0, 0, 0] = torch.tensor([0.0, -0.0, 2.0 ** -133, 3 * 2.0 ** -134, -(2.0 ** -126),
                               1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8, -(255.5)])
    r[1] = -r[1]
    return r.to(F64)


def test_exact_roundings_read_nought():
    r = _exact_cases()
    out = r.to(F32).to(BF16)
    assert torch.equal(bf16_ulps.round_bf16(r), out.to(F64))
    reading = bf16_ulps.compare(out, r)
    assert reading["mismatch_pct"] == 0.0 and reading["ulp_gap"] <= 0.5, reading
    # ties go to even: 1 + 2**-8 to 1, 1 + 3 * 2**-8 to 1 + 2**-6, both 0.5 ulp off
    assert out[0, 0, 0, 5:7].tolist() == [1.0, 1 + 2.0 ** -6]
    # stacked readings: each element takes the reading nearest it
    far = r + 100 * bf16_ulps.ulp(r)
    assert bf16_ulps.compare(out, torch.stack([far, r])) == reading
    assert bf16_ulps.compare(out, far)["mismatch_pct"] == 100.0


def _tables(n_in: int, n_out: int) -> torch.Tensor:
    """float64 ``[n_out, n_in]`` bilinear weights with antialiasing over the
    whole axis (the PIL definition, :func:`perfbench.reference.crop.band`)."""
    return crop.band(torch.zeros(1), torch.full((1,), float(n_in)), n_in, n_out)[0]


def _frames(seed: int, shape) -> torch.Tensor:
    """bfloat16 frames on the scale of 8-bit video, from the seed."""
    g = gen.generator(seed, "cpu")
    return (torch.rand(shape, generator=g) * 255).to(BF16)


def _two_pass(x, wh, ww, dtype, inter=None):
    """An H pass, then a W pass, with tables, products and sums in
    ``dtype``; ``inter`` rounds the intermediate to that type between."""
    y = torch.einsum("oh,nchw->ncow", wh.to(dtype), x.to(dtype))
    if inter is not None:
        y = y.to(inter).to(dtype)
    return torch.einsum("ncow,pw->ncop", y, ww.to(dtype))


def _truncate(y: torch.Tensor) -> torch.Tensor:
    """float32 to bfloat16 by dropping the low 16 bits (toward zero)."""
    return (y.contiguous().view(torch.int32) & -65536).view(F32).to(BF16)


def _one_ulp_up(out: torch.Tensor, rows: slice) -> torch.Tensor:
    o = out.to(F64)
    o[:, 0, rows] += bf16_ulps.ulp(o[:, 0, rows])
    return o.to(BF16)


def _repeat_frame(out: torch.Tensor) -> torch.Tensor:
    o = out.clone()
    o[1] = o[0]
    return o


def _with_nan(out: torch.Tensor) -> torch.Tensor:
    o = out.clone()
    o[1, 2, 3, 4] = float("nan")
    return o


WH, WW = _tables(64, 32), _tables(96, 48)
ROUTES = {  # each a route from frames to the bfloat16 output, given the tables
    "sound": lambda x, wh, ww: _two_pass(x, wh, ww, F32).to(BF16),
    "bf16_intermediate": lambda x, wh, ww: _two_pass(x, wh, ww, F32, inter=BF16).to(BF16),
    "bf16_weights": lambda x, wh, ww: _two_pass(x, wh.to(BF16), ww.to(BF16), F32).to(BF16),
    "truncating_store": lambda x, wh, ww: _truncate(_two_pass(x, wh, ww, F32)),
}
FAULTS = {  # each applied to the sound route's output
    "row_band_one_ulp": lambda out: _one_ulp_up(out, slice(0, max(1, out.shape[-2] // 14))),
    "nan": _with_nan,
    "wrong_shape": lambda out: out[..., :-1],
    "frame_repeated": _repeat_frame,
    "not_bf16": lambda out: out.to(F32),
}


@pytest.mark.parametrize("seed", [1, 2, 2 ** 31 + 5])
def test_a_float32_route_passes_against_its_float64_twin(seed):
    x = _frames(seed, (2, 3, 64, 96))
    reading = bf16_ulps.compare(ROUTES["sound"](x, WH, WW), _two_pass(x, WH, WW, F64))
    assert reading["ulp_gap"] <= SOUND_GAP, reading
    # room under each limit: the gap is the rounding's own half ulp; the
    # flips near ties are at most half the limit
    assert reading["mismatch_pct"] <= LIMITS["mismatch_pct"] / 2, reading
    assert compare.verdict(reading, LIMITS, bf16_ulps.NUMBERS)


@pytest.mark.parametrize("control", [k for k in ROUTES if k != "sound"] + sorted(FAULTS))
def test_every_control_fails_with_room(control):
    x = _frames(7, (2, 3, 64, 96))
    ref = _two_pass(x, WH, WW, F64)
    if control in ROUTES:
        out = ROUTES[control](x, WH, WW)
    else:
        out = FAULTS[control](ROUTES["sound"](x, WH, WW))
    reading = bf16_ulps.compare(out, ref)
    assert not compare.verdict(reading, LIMITS, bf16_ulps.NUMBERS), reading
    # the margin: some number reads twice its limit or more
    assert max(reading[k] / LIMITS[k] for k in bf16_ulps.NUMBERS) >= 2, reading


class _VideoEntry:
    """An entry of bfloat16 frames ``[batch, 3, 64, 96]`` → 32×48 over a
    pool drawn from the seed, through ``route``; the reference is the
    route's float64 twin."""

    def __init__(self, traffic: dict, seed: int, route):
        self.pool, self.images_per_call = traffic["pool"], traffic["batch"]
        self.x = _frames(seed, (self.pool, self.images_per_call, 3, 64, 96))
        self.route = route

    def call(self, i: int) -> torch.Tensor:
        return self.route(self.x[i % self.pool], WH, WW)

    def reference(self, i: int) -> torch.Tensor:
        return _two_pass(self.x[i % self.pool], WH, WW, F64)

    def release(self) -> None:
        pass


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_run_whose_traffic_names_bf16_ulps(route, monkeypatch):
    traffic = {"batch": 2, "pool": 2, "loop": "closed", "in_flight": 1, "warmup_calls": 1,
               "trace_calls": 3,
               "check": {"kind": "bf16_ulps", "sample_calls": 4, "limits": dict(LIMITS)}}
    real = run.load

    def load(kind, name):
        if kind == "entries" and name == "video_frames":
            return types.SimpleNamespace(
                make=lambda config, traffic, seed, device: _VideoEntry(traffic, seed,
                                                                       ROUTES[route]))
        return real(kind, name)

    monkeypatch.setattr(run, "load", load)
    r = run.run_cell(small_cells.bench(), "video_frames", {"entry": "video_frames"}, traffic,
                     2 ** 31 + 99, 0.3, False, "cpu", time.perf_counter())
    assert list(r["check"]) == list(bf16_ulps.NUMBERS) and list(r)[-1] == "check"
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["correct"] is (route == "sound"), r["check"]
