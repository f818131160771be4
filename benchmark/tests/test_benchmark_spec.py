"""``BENCHMARK.json`` against the rules it is checked by, and the files it
names: every name and unit, each configuration, traffic, limit and metric a
file of its own that the harness finds by name."""

from __future__ import annotations

import json
import math
from typing import Dict, List

import pytest

from benchmark import spec
from benchmark.check import COMPARED

BENCH = spec.load_benchmark(spec.HERE.parent)
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def names_and_units(bench: dict) -> Dict[str, List[str]]:
    """Every name and unit ``BENCHMARK.json`` gives, by kind."""
    out = {"names": [], "units": []}
    for entry in bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]:
        out["names"].append(entry["name"])
        if "unit" in entry:
            out["units"].append(entry["unit"])
    for w in bench["workloads"]:
        out["names"] += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        out["names"] += list(c["reduced"])
    return out


def test_keys_and_names():
    assert set(BENCH) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[kind]:
            assert set(entry) - {"workloads"} == KEYS[kind], entry["name"]
    found = names_and_units(BENCH)
    for name in found["names"]:
        assert spec.NAME.fullmatch(name), name
    for unit in found["units"]:
        assert spec.UNIT.fullmatch(unit), unit
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_lines_and_command():
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"] and "\t" not in entry["why"]
    for entry in BENCH["per_layer"]:
        assert 1 <= len(entry["layer"]) <= 200
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32 and all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_has_its_files_and_metrics(cell):
    w = spec.cell(BENCH, cell)
    assert w["chips"] == 1
    config = spec.load_json("configs", w["config"])
    assert config["name"] == w["config"] and config["reduced"] == next(
        c["reduced"] for c in BENCH["configs"] if c["name"] == w["config"])
    traffic = spec.load_json("traffic", w["traffic"])
    assert traffic["name"] == w["traffic"]
    limits = spec.load_json("limits", cell)
    assert {"s", "momentum", "water"} <= set(limits) <= set(COMPARED)
    assert all(math.isfinite(v) and v > 0 for v in limits.values())
    e2e = [m["name"] for m in spec.metrics_of(BENCH, trace=False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec.metrics_of(BENCH, trace=True)
    assert per_layer
    for m in spec.metrics_of(BENCH, False) + per_layer:
        assert callable(spec.reader(m["name"]))


def test_config_files_are_the_configs_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        data = json.loads((spec.HERE.parent / c["file"]).read_text())
        assert data["source"] == c["source"]
