"""``BENCHMARK.json`` and the files it finds by name."""

from __future__ import annotations

import json
import re

import small_cells
from perfbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    b = small_cells.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"] and b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in {e["name"] for e in b["end_to_end"]} and "\n" not in m["layer"]


def test_every_name_finds_its_files():
    b = small_cells.bench()
    for w in b["workloads"]:
        cell, config, traffic = run.cell_files(b, w["name"])
        conf = {c["name"]: c for c in b["configs"]}[cell["config"]]
        assert config["name"] == conf["name"] and config["reduced"] == conf["reduced"]
        assert config["source"] == conf["source"]
        assert (run.HERE / "entries" / f"{config['entry']}.py").exists()
        assert (run.HERE / "loops" / f"{traffic['loop']}.py").exists()
        check = traffic["check"]
        assert (run.HERE / "checks" / f"{check['kind']}.py").exists()
        assert set(check["limits"]) == set(run.checker(traffic).NUMBERS)
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(run.load("metrics", m["name"]).value)
    for f in (run.HERE / "traffic").glob("*.json"):
        json.loads(f.read_text())
