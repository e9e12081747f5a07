"""The metric arithmetic on synthetic records, and the entries' essential
bytes at the cells' own shapes."""

from __future__ import annotations

import pytest
import torch

import small_cells
from perfbench import run
from perfbench.harness import stats, trace
from perfbench.harness.trace import Record


def test_percentile_is_nearest_rank_over_every_sample():
    v = list(range(1, 1001))
    assert stats.percentile(v, 99) == 990
    assert stats.percentile(list(reversed(v)), 99) == 990
    assert stats.percentile([5.0], 99) == 5.0
    assert stats.percentile([1, 2, 3, 100], 99) == 100
    assert stats.percentile(list(range(1, 101)), 50) == 50
    with pytest.raises(ValueError):
        stats.percentile([], 99)


WINDOW = Record(trace.WINDOW_SPAN, 0.0, 100.0)
DEVICE = [Record("k1", 10.0, 20.0), Record("k2", 15.0, 30.0), Record("k1", 50.0, 60.0),
          Record("copy", 90.0, 120.0)]
HOST = [WINDOW, Record(trace.CALL_SPAN, 0.0, 40.0), Record("aten::mm", 1.0, 9.0),
        Record(trace.SYNC_SPAN, 40.0, 48.0), Record(trace.CALL_SPAN, 48.0, 95.0),
        Record("aten::add", 62.0, 80.0), Record(trace.SYNC_SPAN, 95.0, 100.0)]


def test_device_time_busy_and_idle_from_intervals():
    assert trace.device_seconds(DEVICE) == pytest.approx((10 + 15 + 10 + 30) / 1e6)
    # union inside the window: [10, 30) + [50, 60) + [90, 100)
    assert trace.busy_seconds(DEVICE, WINDOW) == pytest.approx(40 / 1e6)
    assert trace.idle_gaps(DEVICE, WINDOW) == [(0.0, 10.0), (30.0, 50.0), (60.0, 90.0)]
    assert trace.idle_gaps([], WINDOW) == [(0.0, 100.0)]
    assert trace.busy_seconds([], WINDOW) == 0.0


def test_breakdown_sums_by_name_and_labels_gaps_by_the_host():
    b = trace.breakdown(DEVICE, HOST, WINDOW)
    assert b["device_ops"] == [["copy", pytest.approx(30e-6)], ["k1", pytest.approx(20e-6)],
                               ["k2", pytest.approx(15e-6)]]
    # gap middles: 5 (in a call, in aten::mm), 40 (sync), 75 (in a call, aten::add)
    assert dict((k, v) for k, v in b["idle_gaps"]) == {
        f"{trace.CALL_SPAN} > aten::mm": pytest.approx(10e-6),
        trace.SYNC_SPAN: pytest.approx(20e-6),
        f"{trace.CALL_SPAN} > aten::add": pytest.approx(30e-6)}
    assert len(trace.breakdown([Record(f"k{i}", i, i + 0.5) for i in range(30)], HOST,
                               WINDOW)["device_ops"]) == 10


def _rec(**kw):
    rec = {"setup_s": 7.5, "window_s": 2.0, "latency_s": [0.001] * 98 + [0.002, 0.004],
           "enqueue_s": [1e-4, 3e-4], "images": 6400}
    rec.update(kw)
    return rec


def _value(name, rec):
    return run.load("metrics", name).value(rec)


def test_end_to_end_metrics():
    rec = _rec()
    assert _value("images_per_s", rec) == 3200.0
    assert _value("batch_ms_p99", rec) == pytest.approx(2.0)
    assert _value("setup_s", rec) == 7.5


def test_per_layer_metrics_from_records():
    rec = _rec(device=DEVICE, host=HOST, trace_window=WINDOW, trace_calls=2,
               essential_bytes=3.35e6 * 13, peak_bytes_per_s=3.35e12)
    assert _value("enqueue_us", rec) == pytest.approx(200.0)
    # records per call: [0, 48) holds k1 and k2, [48, 100) k1 and the copy
    assert trace.records_per_call(DEVICE, HOST) == [2, 2]
    assert _value("launches_per_batch", rec) == 2.0
    assert _value("device_ms_per_batch", rec) == pytest.approx(65e-3 / 2)
    # 13 us of essential bytes over 65 us of device time
    assert _value("roofline_pct", rec) == pytest.approx(20.0)
    assert _value("device_idle_pct", rec) == pytest.approx(60.0)


@pytest.mark.parametrize("name", ["launches_per_batch", "device_ms_per_batch",
                                  "roofline_pct", "device_idle_pct"])
def test_device_metrics_read_nothing_without_device_records(name):
    assert _value(name, _rec()) is None
    assert _value(name, _rec(device=[], host=HOST, trace_window=WINDOW, trace_calls=2,
                             essential_bytes=1, peak_bytes_per_s=3.35e12)) is None


def test_roofline_reads_nothing_for_a_card_without_a_published_peak():
    rec = _rec(device=DEVICE, host=HOST, trace_window=WINDOW, trace_calls=2,
               essential_bytes=100, peak_bytes_per_s=None)
    assert _value("roofline_pct", rec) is None


def _entry(workload, batch=2):
    config, traffic = small_cells.small(workload, batch=batch, pool=1)
    real = run.cell_files(small_cells.bench(), workload)[1]
    config["image"], config["constructor"], config["preset"] = (
        real["image"], real["constructor"], real["preset"])
    return run.load("entries", config["entry"]).make(config, traffic, 99, "cpu")


def test_eval_essential_bytes_at_the_cells_shape():
    # Resize(256) of 438 x 906 is 256 x 529; the centre crop keeps rows
    # 16..239 and columns 152..375, whose taps read input rows 27..410
    # (trunc(16.5 s - s + 0.5) to trunc(239.5 s + s + 0.5), s = 438 / 256)
    # and columns 259..644 (s = 906 / 529): 384 x 386 bytes a channel, read
    # once, and 224 x 224 float32 written once
    e = _entry("eval_u8.b64")
    assert e.essential_bytes(0) == 2 * 3 * (384 * 386 + 224 * 224 * 4)


@pytest.mark.parametrize("workload", ["train_u8.b64", "train_u8.b64.noflip"])
def test_train_essential_bytes_count_the_boxes(workload):
    e = _entry(workload, batch=4)
    b = e.boxes[0].to(torch.float64)
    area = ((b[:, 2] - b[:, 0]) * 438 * (b[:, 3] - b[:, 1]) * 906).sum().item()
    got = e.essential_bytes(0) - 4 * 3 * 224 * 224 * 4
    # pixel centres inside each box: its area to within a row and a column
    assert abs(got / 3 - area) <= 4 * (438 + 906 + 1)
