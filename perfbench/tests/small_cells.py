"""The benchmark's cells at sizes a CPU test run holds: the same files,
with the image, the output and the batch cut down."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run  # noqa: E402


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


CELLS = tuple(w["name"] for w in bench()["workloads"])


def small(workload: str, batch: int = 4, pool: int = 2) -> tuple[dict, dict]:
    """``(config, traffic)`` of ``workload`` on small images."""
    _, config, traffic = run.cell_files(bench(), workload)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if config["entry"] == "imagenet_eval":
        config["image"]["shape"] = [3, 44, 90]
        config["constructor"].update(size=[22, 22], short_side=26)
        config["preset"].update(resize_size=26, crop_size=22)
    else:
        config["image"]["shape"] = [3, 60, 124]
        config["constructor"].update(size=[28, 28])
        config["preset"].update(crop_size=28)
    traffic.update(batch=min(batch, traffic["batch"]), pool=min(pool, traffic["pool"]),
                   warmup_calls=1, trace_calls=3)
    traffic["check"]["sample_calls"] = 4
    return config, traffic
