"""The video cell (``video_bf16.b64``): its essential bytes at the cell's
shape, the plane route's spans as the layers' metrics read them on
synthetic records, and the cut that the CPU tests make of it."""

from __future__ import annotations

import types

import pytest
import torch

import small_cells
from perfbench import run
from perfbench.harness import trace
from perfbench.harness.trace import Record

CELL = "video_bf16.b64"


def _value(name, rec):
    return run.load("metrics", name).value(rec)


def test_essential_bytes_at_the_cells_shape():
    # 64 frames of 3 x 2160 x 3840 bf16 read once (3,185,049,600 B) and
    # 64 x 3 x 1080 x 1920 bf16 written once (796,262,400 B); taken from the
    # cell's files, without making its 6.4 GB of frames
    _, config, traffic = run.cell_files(small_cells.bench(), CELL)
    entry = types.SimpleNamespace(shape=tuple(config["image"]["shape"]),
                                  size=tuple(config["constructor"]["size"]),
                                  images_per_call=traffic["batch"])
    cls = run.load("entries", config["entry"]).Entry
    assert cls.essential_bytes(entry, 0) == 3_981_312_000


WINDOW = Record(trace.WINDOW_SPAN, 0.0, 100.0)
# two calls: the video span holds the plane route's ops span, which holds
# the tables span (a build inside it on the first call), a second tables
# span and the launch
SPANS = [Record("ia.models.video", 2.0, 40.0), Record("ia.ops.resize_plane", 4.0, 38.0),
         Record("ia.tables.resize2d", 10.0, 16.0), Record("ia.build._plan2d", 11.0, 14.0),
         Record("ia.tables.resize2d", 18.0, 20.0), Record("ia.native.resample2d", 22.0, 30.0),
         Record("ia.models.video", 50.0, 70.0), Record("ia.ops.resize_plane", 51.0, 69.0),
         Record("ia.tables.resize2d", 53.0, 55.0), Record("ia.tables.resize2d", 56.0, 57.0),
         Record("ia.native.resample2d", 58.0, 64.0)]
HOST = [WINDOW, Record(trace.CALL_SPAN, 1.0, 41.0), Record(trace.SYNC_SPAN, 41.0, 48.0),
        Record(trace.CALL_SPAN, 49.0, 71.0), Record(trace.SYNC_SPAN, 71.0, 90.0)] + SPANS
KERNEL_A = ("void ia::r2d::resample2d_kernel<__nv_bfloat16, __nv_bfloat16, ia::TableTaps, 128, 8>"
            "(__nv_bfloat16 const*, __nv_bfloat16*, ia::TableTaps, ia::TableTaps, ia::Plan2d)")
DEVICE = [Record(KERNEL_A, 25.0, 45.0), Record("void at::native::elementwise_kernel", 45.0, 46.0),
          Record(KERNEL_A, 60.0, 80.0)]


def _rec(**kw):
    rec = {"device": DEVICE, "host": HOST, "trace_window": WINDOW, "trace_calls": 2,
           "essential_bytes": 3.35e6 * 10, "peak_bytes_per_s": 3.35e12}
    rec.update(kw)
    return rec


def test_the_layers_metrics_read_the_plane_route():
    # first call: ops 34 less its tables 6 + 2 and the launch 8 = 18, the
    # tables (6 - 3) + 2 = 5 and the build 3; second: ops 18 - 2 - 1 - 6 = 9,
    # the tables 2 + 1 = 3; the launches are left to host_launch_us
    assert _value("host_models_us", _rec()) == pytest.approx((4.0 + 2.0) / 2)
    assert _value("host_ops_us", _rec()) == pytest.approx((18.0 + 9.0) / 2)
    assert _value("host_tables_us", _rec()) == pytest.approx((8.0 + 3.0) / 2)
    assert _value("host_builds_per_call", _rec()) == pytest.approx(0.5)
    # 10 us of essential bytes over the device's 41 us: kernel A and the aten kernel
    assert _value("roofline_pct", _rec()) == pytest.approx(100.0 * 10 / 41)


def test_the_small_cut_is_a_downscale_to_28_square():
    config, traffic = small_cells.small(CELL, batch=2, pool=2)
    C, H, W = config["image"]["shape"]
    assert (H, W) == (60, 124) and config["constructor"]["size"] == [28, 28]
    entry = run.load("entries", config["entry"]).make(config, traffic, 2**33 + 5, "cpu")
    x = entry.x[0]
    assert x.dtype == torch.bfloat16 and float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    y = entry.call(0)
    assert y.shape == (2, C, 28, 28) and y.dtype == torch.bfloat16
    assert entry.reference(0).shape == (2, C, 28, 28)
    assert entry.mean == [0.0] * C and entry.std == [1.0] * C
