"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``), its
limits (``limits/<cell>.json``) and the metrics it reports, each metric read
by ``metrics/<name>.py``.  A later cell, configuration, traffic or metric is
a new file and a new entry; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, List

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {[w['name'] for w in bench['workloads']]})")


def load_json(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r}")
    return json.loads((HERE / kind / f"{name}.json").read_text())


def metrics_of(bench: dict, trace: bool) -> List[dict]:
    """The metrics a run reports: with ``trace`` the per-layer metrics,
    else the end-to-end ones."""
    return bench["per_layer"] if trace else bench["end_to_end"]


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    if not NAME.fullmatch(name):
        raise ValueError(f"metric name {name!r}")
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
