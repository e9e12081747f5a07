"""What the port's spans (``interpolate_antialiasing_tpu_torch/utils/trace.py``)
cost on this host, with the profiler off and on, and how many each call of
each benchmark cell opens.

    python3 tools/time_spans.py [--device cuda] [--batch N] [--pool N] [--calls N]

Readings, in microseconds, each the least of five means over a loop (less
the same loop with an empty body, so the loop's own cost is left out):

  * ``off_span_us``: ``with span(name)`` with no profiler running (the
    gate: a flag read, a call, the shared null context);
  * ``off_spanned_us``: a call through ``spanned(name)`` with no profiler
    (a flag read and the decorator's extra call);
  * ``bare_record_function_us``: ``with record_function(name)`` with no
    profiler, what an ungated span would cost;
  * ``on_span_us``: ``with span(name)`` while a profiler runs (CPU and, on
    a card, CUDA activity, as the benchmark's traced stretch).

Then per cell of ``BENCHMARK.json``, its entry built from its own files
(``--batch`` and ``--pool`` cut them down for a CPU rehearsal): the
``ia.`` spans of one warm call (``spans_per_call``; ``builds_per_call``
of them ``ia.build.*``), and their cost per call with the profiler off
(``gate_us_per_call``: every span at the larger of ``off_span_us`` and
``off_spanned_us``, an upper bound) and on (``on_us_per_call``).

The profiler adds its own cost to every aten operator and span, so the
benchmark's traced layer times read above the host's untraced time.  For
scale, ``untraced_us`` is the same split with no profiler: for
``--calls`` synchronised calls this tool alone times each span with
``time.perf_counter`` in ``record_function``'s place (the flag the gate
reads set meanwhile), self times by ``perfbench/harness/spans.py``;
``untraced_enqueue_us`` is the mean call-to-return time of those calls,
the timing's own cost (``clock_us_per_span`` a span) included.  One JSON
line per reading, the card's name first.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.autograd.profiler as autograd_profiler  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from interpolate_antialiasing_tpu_torch.utils.trace import span, spanned  # noqa: E402
from perfbench.harness.spans import self_us_by_layer  # noqa: E402
from perfbench.harness.trace import Record  # noqa: E402

NAME = "ia.ops.resize"


def _per_iter_us(body, n: int) -> float:
    """Least of five means of ``body(n)``'s iterations, in microseconds."""
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        body(n)
        best = min(best, (time.perf_counter() - t) / n * 1e6)
    return best


def _empty(n):
    for _ in range(n):
        pass


def _spans(n):
    for _ in range(n):
        with span(NAME):
            pass


def _bare(n):
    for _ in range(n):
        with record_function(NAME):
            pass


def _nothing():
    return None


_decorated = spanned(NAME)(_nothing)


def _plain_calls(n):
    for _ in range(n):
        _nothing()


def _decorated_calls(n):
    for _ in range(n):
        _decorated()


def _activities(device: torch.device):
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])


def gate_costs(device: torch.device) -> dict:
    empty = _per_iter_us(_empty, 200_000)
    out = {"off_span_us": _per_iter_us(_spans, 200_000) - empty,
           "off_spanned_us": (_per_iter_us(_decorated_calls, 200_000)
                              - _per_iter_us(_plain_calls, 200_000)),
           "bare_record_function_us": _per_iter_us(_bare, 20_000) - empty}
    with profile(activities=_activities(device)):
        out["on_span_us"] = _per_iter_us(_spans, 5_000) - _per_iter_us(_empty, 5_000)
    return out


class _Clock:
    """``record_function``'s stand-in for the untraced split: the span's
    host-clock interval, appended to ``spans``."""

    def __init__(self, name: str, spans: list):
        self.name, self.spans = name, spans

    def __enter__(self):
        self.start = time.perf_counter()

    def __exit__(self, *exc):
        self.spans.append(Record(self.name, self.start * 1e6, time.perf_counter() * 1e6))


def _clocked(fn, spans: list):
    """``fn()`` with every span timed by :class:`_Clock`."""
    saved = torch.profiler.record_function, autograd_profiler._is_profiler_enabled
    torch.profiler.record_function = lambda name: _Clock(name, spans)
    autograd_profiler._is_profiler_enabled = True
    try:
        return fn()
    finally:
        torch.profiler.record_function, autograd_profiler._is_profiler_enabled = saved


def _clock_us_per_span() -> float:
    spans: list = []
    return _clocked(lambda: _per_iter_us(_spans, 20_000), spans) - _per_iter_us(_empty, 20_000)


def cell_spans(bench: dict, workload: str, device: torch.device, batch, pool,
               calls: int) -> dict:
    """``ia.`` spans and ``ia.build.*`` spans of one warm call of the cell,
    and the untraced split over ``calls`` calls."""
    from perfbench import run

    _, config, traffic = run.cell_files(bench, workload)
    if batch:
        traffic["batch"] = batch
    if pool:
        traffic["pool"] = pool
    entry = run.load("entries", config["entry"]).make(config, traffic, 2024, device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    for i in range(entry.pool):
        entry.call(i)
    sync()
    with profile(activities=_activities(device)) as prof:
        for i in range(4):
            entry.call(i)
        sync()
    host = torch.autograd.DeviceType.CPU
    names = [e.name for e in prof.events() if e.device_type == host and e.name.startswith("ia.")]

    gc.collect()
    gc.freeze()  # as the benchmark's set-up does
    spans: list = []
    enqueue = []

    def timed():
        for i in range(calls):
            t = time.perf_counter()
            entry.call(i)
            enqueue.append(time.perf_counter() - t)
            sync()

    _clocked(timed, spans)
    split = {k: v / calls for k, v in sorted(self_us_by_layer(spans).items())}
    return {"spans_per_call": len(names) / 4,
            "builds_per_call": sum(n.startswith("ia.build.") for n in names) / 4,
            "names": sorted(set(names)), "untraced_us": split,
            "untraced_sum_us": sum(split.values()),
            "untraced_enqueue_us": sum(enqueue) / calls * 1e6}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--pool", type=int, default=None)
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args()
    device = torch.device(args.device)
    torch.set_num_threads(1)
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(json.dumps({"device": card, "torch": torch.__version__}), flush=True)
    costs = gate_costs(device)
    costs["clock_us_per_span"] = _clock_us_per_span()
    print(json.dumps({"gate": costs}), flush=True)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        r = cell_spans(bench, w["name"], device, args.batch, args.pool, args.calls)
        r.update(workload=w["name"],
                 gate_us_per_call=r["spans_per_call"] * max(costs["off_span_us"],
                                                            costs["off_spanned_us"]),
                 on_us_per_call=r["spans_per_call"] * costs["on_span_us"])
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
