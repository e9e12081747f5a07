#!/usr/bin/env python3
"""Run one cell of the benchmark of ``interpolate_antialiasing_tpu_torch``
once, on the CUDA card of this machine:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name:
``BENCHMARK.json`` names the cell's configuration file and traffic mix
(``perfbench/traffic/<traffic>.json``); the configuration names its entry
(``perfbench/entries/<entry>.py``), the traffic its loop
(``perfbench/loops/<loop>.py``) and its check
(``perfbench/checks/<kind>.py``), and each metric is read by
``perfbench/metrics/<metric>.py``.

Set-up makes the inputs on the card from the seed, builds the entry and
warms it up on every input of the pool.  The window then drives the loop
for ``--seconds``.  With ``--trace 1`` a profiled stretch of the traffic's
``trace_calls`` calls follows, and the per-layer metrics are read from it;
with ``--trace 0`` the end-to-end metrics.  After the window a sample of
its outputs, drawn from the seed, is compared with the plain reference
(``perfbench/reference``) by the traffic's check.  The last line of
standard output is the result, as JSON; the numbers compared, each beside
its limit, are the last lines of standard error.  Exits non-zero with no
result where there is no card, fewer cards than the cell asks for, or
where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T_PROCESS = time.perf_counter()  # as near to the process's start as a script reads

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "perfbench"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench.harness import compare, guard, trace  # noqa: E402
from perfbench.harness.peaks import peak  # noqa: E402
from perfbench.harness.traffic import Reservoir  # noqa: E402

_WARM_PROFILE_CALLS = 2


def load(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` as a module."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} named {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """``(cell, configuration, traffic)`` of the cell named ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def _sync(device: torch.device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _traced_stretch(entry, first: int, calls: int, sync, device) -> dict:
    """Profile ``calls`` calls from index ``first``; the records the
    per-layer metrics read."""
    from torch.profiler import record_function

    with _profile(device) as prof:
        with record_function(trace.WINDOW_SPAN):
            for j in range(calls):
                with record_function(trace.CALL_SPAN):
                    entry.call(first + j)
                with record_function(trace.SYNC_SPAN):
                    sync()
    dev, host, window = trace.records(prof.events())
    return {"device": dev, "host": host, "trace_window": window, "trace_calls": calls}


def checker(traffic: dict):
    """The traffic's check: ``perfbench/checks/<check.kind>.py``, which
    names its ``NUMBERS`` and gives ``compare(out, ref, entry)``."""
    return load("checks", traffic["check"]["kind"])


def _check(entry, kept: list, check) -> dict:
    """The worst reading of each of ``check``'s numbers over the kept
    outputs, the reference computed once per input of the pool."""
    by_input = defaultdict(list)
    for i, out in kept:
        by_input[i % entry.pool].append(out)
    readings = []
    for k in sorted(by_input):
        ref = entry.reference(k)
        readings += [check.compare(out, ref, entry) for out in by_input[k]]
    if not readings:
        return {k: float("inf") for k in check.NUMBERS}
    return compare.worst(readings, check.NUMBERS)


def setup(config: dict, traffic: dict, seed: int, device: torch.device):
    """``(entry, sync)``: the cell's entry on its seeded inputs, warmed up on
    every input of its pool."""
    sync = _sync(device)
    entry = load("entries", config["entry"]).make(config, traffic, seed, device)
    for i in range(entry.pool + traffic.get("warmup_calls", 0)):
        entry.call(i)
    sync()
    # set-up's objects move out of the collector's generations, so its
    # passes in the window scan only what the calls themselves leave
    gc.collect()
    gc.freeze()
    return entry, sync


def run_window(entry, traffic: dict, seed: int, seconds: float, sync):
    """``(window record, sampler)``: the traffic's loop for ``seconds``,
    with the sample of outputs to compare drawn from the seed."""
    sampler = Reservoir(traffic["check"]["sample_calls"], seed)
    loop = load("loops", traffic["loop"])
    win = loop.run(entry.call, seconds, sync, sampler.offer, traffic.get("in_flight", 1))
    return win, sampler


def run_cell(bench: dict, workload: str, config: dict, traffic: dict, seed: int,
             seconds: float, traced: bool, device, t_process: float) -> dict:
    """One run of a cell: the result's fields, ``check`` last."""
    device = torch.device(device)
    check = checker(traffic)
    entry, sync = setup(config, traffic, seed, device)
    if traced:  # the profiler's own first use, outside the stretch
        with _profile(device):
            for i in range(_WARM_PROFILE_CALLS):
                entry.call(i)
            sync()
    win, sampler = run_window(entry, traffic, seed, seconds, sync)
    rec = {
        "setup_s": win["start"] - t_process,
        "window_s": win["end"] - win["start"],
        "latency_s": win["latency_s"],
        "enqueue_s": win["enqueue_s"],
        "images": (win["calls"] - len(win["failed_calls"])) * entry.images_per_call,
    }
    if traced:
        n = traffic["trace_calls"]
        rec.update(_traced_stretch(entry, win["calls"], n, sync, device))
        per_input = {k: entry.essential_bytes(k) for k in range(entry.pool)}
        rec["essential_bytes"] = sum(per_input[(win["calls"] + j) % entry.pool]
                                     for j in range(n))
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rec["peak_bytes_per_s"] = peak(kind, "bytes_per_s")
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                "count": 1,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                      if device.type == "cuda" else 0)}
    entry.release()
    reading = _check(entry, sampler.kept, check)
    limits = traffic["check"]["limits"]
    correct = compare.verdict(reading, limits, check.NUMBERS) and not win["failed_calls"]

    metrics = {}
    for m in bench["per_layer" if traced else "end_to_end"]:
        value = load("metrics", m["name"]).value(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(correct),
              "attempted": win["calls"] * entry.images_per_call,
              "failed": len(win["failed_calls"]) * entry.images_per_call,
              "metrics": metrics, "device": dev_info}
    if traced:
        window = rec["trace_window"]
        dev_info["busy_s"] = trace.busy_seconds(rec["device"], window)
        dev_info["window_s"] = (window.end - window.start) / 1e6
        result["breakdown"] = trace.breakdown(rec["device"], rec["host"], window)
    result["check"] = {k: {"value": reading[k], "limit": limits[k]} for k in check.NUMBERS}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, config, traffic = cell_files(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    # run the port as the configuration states: none of its own dials
    for k in [k for k in os.environ if k.startswith("IA_TPU_")]:
        del os.environ[k]
    torch.set_num_threads(1)
    result = run_cell(bench, args.workload, config, traffic, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", _T_PROCESS)
    found = guard.forbidden_modules()
    if found:
        print(f"loaded modules the benchmark must not load: {found}", file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
