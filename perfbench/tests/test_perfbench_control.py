"""``correct`` comes out true for the port and false for each control and
each fault a cell can have, at sizes a test run holds.

The controls (each entry's :meth:`controls`: one stage of the path one
precision lower, in the port's place) are compared on the same calls as
the port.  The faults run the rest of a run (set-up, window, comparison)
on the CPU, past the harness's look for a card, with the timed call broken
underneath: a call that hands back the previous call's output (state left
unchanged), a batch whose second half repeats the first (half the batch
left out), one image of every output moved by a grey level (an answer
altered where it is produced), and a band of a fourteenth of the output
rows, in one channel of every image, holding grey level 0 (a tile group
of a kernel that wrote nothing: too few elements for ``mismatch_pct``
where the route's rounding leaves it room).  A single chip has no exchange to leave
out.
"""

from __future__ import annotations

import time
import types

import pytest
import torch

import small_cells
from perfbench import run
from perfbench.harness import compare


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", small_cells.CELLS)
def test_the_port_passes_and_every_control_fails(workload):
    config, traffic = small_cells.small(workload, batch=4, pool=2)
    limits = traffic["check"]["limits"]
    check = run.checker(traffic)
    entry = run.load("entries", config["entry"]).make(config, traffic, 12345, "cpu")
    calls = range(4)
    sound = run._check(entry, [(i, entry.call(i)) for i in calls], check)
    assert compare.verdict(sound, limits, check.NUMBERS), sound
    controls = entry.controls()
    assert len(controls) == 2
    for name, fn in controls.items():
        reading = run._check(entry, [(i, fn(i)) for i in calls], check)
        assert not compare.verdict(reading, limits, check.NUMBERS), (name, reading)


def _stale(call):
    last = {}

    def broken(i):
        out = last.get("out")
        last["out"] = call(i)
        return out if out is not None else last["out"]
    return broken


def _half(call):
    def broken(i):
        out = call(i)
        n = out.shape[0] // 2
        return torch.cat([out[:n], out[:out.shape[0] - n]])
    return broken


def _altered(call, std):
    def broken(i):
        out = call(i).clone()
        out[0] += torch.tensor(std, dtype=out.dtype).reshape(-1, 1, 1).reciprocal() / 255
        return out
    return broken


def _band(call, mean, std):
    def broken(i):
        out = call(i).clone()
        out[:, 0, :max(1, out.shape[-2] // 14)] = -mean[0] / std[0]
        return out
    return broken


FAULTS = {"state_unchanged": lambda call, e: _stale(call),
          "half_batch": lambda call, e: _half(call),
          "answer_altered": lambda call, e: _altered(call, e.std),
          "row_band": lambda call, e: _band(call, e.mean, e.std)}


def _run(workload, monkeypatch, fault=None):
    config, traffic = small_cells.small(workload, batch=4, pool=3)
    real = run.load

    def load(kind, name):
        mod = real(kind, name)
        if kind != "entries" or fault is None:
            return mod

        def make(*a, **kw):
            e = mod.make(*a, **kw)
            e.call = FAULTS[fault](e.call, e)
            return e
        return types.SimpleNamespace(make=make)

    monkeypatch.setattr(run, "load", load)
    return run.run_cell(small_cells.bench(), workload, config, traffic, 2024, 0.3, False,
                        "cpu", time.perf_counter())


@pytest.mark.parametrize("workload", small_cells.CELLS)
def test_a_sound_run_is_correct(workload, monkeypatch):
    r = _run(workload, monkeypatch)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", small_cells.CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    r = _run(workload, monkeypatch, fault)
    assert not r["correct"], r["check"]
