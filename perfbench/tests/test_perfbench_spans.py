"""The arithmetic on the port's own spans (``perfbench/harness/spans.py``)
on synthetic records, and the span metrics of a traced run of each cell on
the CPU."""

from __future__ import annotations

import time

import pytest
import torch

import small_cells
from perfbench import run
from perfbench.harness import spans, trace
from perfbench.harness.trace import Record

HOST_METRICS = ("host_models_us", "host_ops_us", "host_tables_us", "host_launch_us")
SPAN_METRICS = HOST_METRICS + ("host_builds_per_call", "idle_in_program_pct")

WINDOW = Record(trace.WINDOW_SPAN, 0.0, 100.0)
# two calls: a models span holding an ops span, which holds a tables span
# (with a build inside it) and a launch; aten operators inside each
SPANS = [Record("ia.models.eval", 2.0, 40.0), Record("ia.ops.resize", 5.0, 30.0),
         Record("ia.tables.pil", 6.0, 12.0), Record("ia.build._int_tables", 7.0, 9.0),
         Record("ia.native.pil_resample_2pass", 20.0, 24.0),
         Record("ia.models.normalize", 31.0, 39.0),
         Record("ia.models.eval", 50.0, 70.0), Record("ia.ops.resize", 52.0, 60.0),
         Record("ia.native.pil_resample_2pass", 55.0, 57.0)]
HOST = [WINDOW, Record(trace.CALL_SPAN, 1.0, 41.0), Record("aten::empty", 21.0, 22.0),
        Record("aten::mul", 32.0, 34.0), Record(trace.SYNC_SPAN, 41.0, 48.0),
        Record(trace.CALL_SPAN, 49.0, 71.0), Record(trace.SYNC_SPAN, 71.0, 90.0)] + SPANS
DEVICE = [Record("kernel", 25.0, 45.0), Record("kernel", 58.0, 80.0)]


def _rec(**kw):
    rec = {"device": DEVICE, "host": HOST, "trace_window": WINDOW, "trace_calls": 2}
    rec.update(kw)
    return rec


def _value(name, rec):
    return run.load("metrics", name).value(rec)


def test_layer_of_a_name():
    assert spans.layer("ia.models.eval") == "models"
    assert spans.layer("ia.native.crop_resample") == "native"
    assert spans.layer("ia.build._crop_plan") == "tables"


def test_self_time_is_less_the_direct_children():
    got = spans.self_us_by_layer(SPANS)
    # models: 38 less ops 25 and normalize 8 = 5, normalize 8, the second 20 - 8 = 12
    # ops: 25 less tables 6 and the launch 4 = 15, the second 8 - 2 = 6
    # tables: 6 less the build 2 = 4, the build 2; native 4 + 2
    assert got == {"models": pytest.approx(25.0), "ops": pytest.approx(21.0),
                   "tables": pytest.approx(6.0), "native": pytest.approx(6.0)}


def test_the_layers_add_up_to_the_outermost_spans():
    outer = spans.outermost(SPANS)
    assert [r.name for r in outer] == ["ia.models.eval", "ia.models.eval"]
    assert sum(spans.self_us_by_layer(SPANS).values()) == pytest.approx(
        sum(r.end - r.start for r in outer))
    rec = _rec()
    assert sum(_value(m, rec) for m in HOST_METRICS) == pytest.approx((38.0 + 20.0) / 2)


def test_span_metrics_per_call():
    rec = _rec()
    assert _value("host_models_us", rec) == pytest.approx(12.5)
    assert _value("host_ops_us", rec) == pytest.approx(10.5)
    assert _value("host_tables_us", rec) == pytest.approx(3.0)
    assert _value("host_launch_us", rec) == pytest.approx(3.0)
    assert _value("host_builds_per_call", rec) == pytest.approx(0.5)


def test_idle_inside_the_program_spans():
    # idle gaps [0, 25), [45, 58), [80, 100); program spans [2, 40), [50, 70)
    assert trace.idle_gaps(DEVICE, WINDOW) == [(0.0, 25.0), (45.0, 58.0), (80.0, 100.0)]
    assert spans.idle_in_program_us(DEVICE, SPANS, WINDOW) == pytest.approx(23.0 + 8.0)
    assert _value("idle_in_program_pct", _rec()) == pytest.approx(31.0)
    assert _value("idle_in_program_pct", _rec()) <= _value("device_idle_pct", _rec())
    assert spans.idle_in_program_us([], SPANS, WINDOW) == pytest.approx(58.0)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_program_spans(name):
    untraced = {"images": 1, "window_s": 1.0}
    parent = _rec(host=[r for r in HOST if not r.name.startswith("ia.")])
    assert _value(name, untraced) is None
    assert _value(name, parent) is None


def test_idle_in_program_reads_nothing_without_device_records():
    assert _value("idle_in_program_pct", _rec(device=[])) is None


@pytest.fixture()
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("workload", small_cells.CELLS)
def test_a_traced_cpu_run_reads_the_span_metrics(workload, _one_thread):
    config, traffic = small_cells.small(workload, batch=2, pool=1)
    r = run.run_cell(small_cells.bench(), workload, config, traffic, 7, 0.05, True, "cpu",
                     time.perf_counter())
    m = r["metrics"]
    for name in HOST_METRICS + ("host_builds_per_call",):
        assert name in m and m[name]["value"] >= 0.0, (name, m)
    assert m["host_models_us"]["value"] > 0 and m["host_ops_us"]["value"] > 0
    # warmed on every input of the pool: no cache misses in the stretch
    assert m["host_builds_per_call"]["value"] == 0.0
    # the CPU has no device records
    assert "idle_in_program_pct" not in m
