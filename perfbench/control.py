#!/usr/bin/env python3
"""Readings that set a cell's limits of ``correct``, on the card:

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <k>] [--seconds <s>]

For each seed: the cell's set-up, a short window of the cell's own loop at
its own load, and the comparison of the same sample of outputs that a run
compares (the lower readings: sound runs of the port).  On the first
``--control-seeds`` seeds, each of the entry's controls (one stage of the
path one precision lower, in the port's place) is compared on the same
calls (the upper readings), each by the traffic's check
(``perfbench/checks/<kind>.py``).  One JSON line per seed, then the largest
sound reading and the least control reading of each number.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

import run
from perfbench.harness import compare


def readings(bench: dict, workload: str, seed: int, seconds: float, controls: bool,
             device="cuda:0") -> dict:
    """The sound reading of one seed and, with ``controls``, each control's."""
    cell, config, traffic = run.cell_files(bench, workload)
    check = run.checker(traffic)
    entry, sync = run.setup(config, traffic, seed, torch.device(device))
    _, sampler = run.run_window(entry, traffic, seed, seconds, sync)
    out = {"seed": seed, "sound": run._check(entry, sampler.kept, check)}
    if controls:
        out["controls"] = {}
        for name, fn in entry.controls().items():
            kept = [(i, fn(i)) for i, _ in sampler.kept]
            out["controls"][name] = run._check(entry, kept, check)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control.py reads the card; there is none", file=sys.stderr)
        return 2
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    numbers = run.checker(run.cell_files(bench, args.workload)[2]).NUMBERS
    torch.set_num_threads(1)
    sound, ctrl = [], {}
    for j, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(bench, args.workload, seed, args.seconds, j < args.control_seeds)
        r["s"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(r), flush=True)
        sound.append(r["sound"])
        for name, reading in r.get("controls", {}).items():
            ctrl.setdefault(name, []).append(reading)
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "seeds": len(args.seeds),
               "lower": compare.worst(sound, numbers),
               "controls": {name: {k: min(x[k] for x in rs) for k in numbers}
                            for name, rs in ctrl.items()}}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
