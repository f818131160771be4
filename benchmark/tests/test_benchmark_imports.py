"""What the harness and the reference load: never a module of JAX or of the
JAX package (compared by whole top-level names), and the reference nothing
of the port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def loaded(*modules) -> set:
    """The top-level names in ``sys.modules`` of a fresh interpreter after
    importing ``modules``."""
    code = ";".join(f"import {m}" for m in modules) + (
        ";import sys,json;print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = loaded("benchmark.run", "benchmark.control", "benchmark.program", "benchmark.tracing",
                  "benchmark.reference.model")
    assert not tops & {"jax", "jaxlib", "flax", "tasmania_tpu"}


def test_a_built_program_loads_no_jax():
    code = ("import json,sys,torch;from benchmark.tests.conftest import tiny_config;"
            "from benchmark.program import Program;Program(tiny_config('fc', niter=1)['namelist'], 'cpu');"
            "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tasmania_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tasmania_tpu"}


def test_reference_loads_nothing_of_the_program():
    tops = loaded("benchmark.reference.model")
    assert not tops & {"jax", "jaxlib", "flax", "tasmania_tpu", "tasmania_tpu_torch"}


def test_reference_sources_import_torch_and_the_standard_library_only():
    allowed = {"torch", "numpy", "math", "typing", "__future__"}
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in allowed or top in sys.stdlib_module_names, (path.name, name)
