"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit file and per-layer metric parses and is found by its
name, within the contract's limits."""
import importlib
import json
import os
import re

import pytest

from perfbench import harness

ROOT = os.path.dirname(harness.HERE)
BENCH = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["perfbench"]
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in seen
        seen.add(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.CellSpec(ROOT, cell, BENCH)
    assert spec.config["name"] == spec.workload["config"]
    assert spec.traffic["name"] == spec.workload["traffic"]
    assert spec.driver().Cell
    names = {n for n in spec.limits if not n.startswith("_")}
    assert names, "limits file is empty"
    assert spec.end_to_end() and spec.per_layer()


@pytest.mark.parametrize("entry", BENCH["per_layer"],
                         ids=[m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(entry):
    mod = importlib.import_module(
        "perfbench.metrics." + entry["name"].split(".")[0])
    assert callable(mod.read)
    assert entry["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert 1 <= len(entry["layer"]) <= 200 and "\n" not in entry["layer"]
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS and harness.name_in(cell, moves)


@pytest.mark.parametrize("cfg", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(cfg):
    data = harness.load_json(os.path.join(ROOT, cfg["file"]))
    assert data["name"] == cfg["name"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert importlib.import_module("perfbench.drivers." + data["integrator"])
