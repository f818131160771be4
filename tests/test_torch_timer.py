"""The port's timer (``tasmania_tpu_torch/utils/timer.py``) against the JAX
package's (``tasmania_tpu/utils/timer.py``), on the CPU.

* The same starts and stops, on a clock both modules read from a shared
  counter, give the same tree: the same ``log``, ``get_time`` and CSV rows
  (the backend column aside: ``"torch"`` and ``"jax"`` by default).
* One eager SUS step of the port at 17x17x8 on the CPU enters the same
  labels as often as one step of the JAX package's chain on the route the
  port's parity tests hold it to (``"pallas:interpret"``,
  ``tests/test_torch_flagship.py``).  The JAX step runs under
  ``jax.eval_shape``: its Python runs once, as un-jitted, with abstract
  arrays, so every label is entered as often as in an un-jitted step,
  without the seconds of the interpreted Pallas kernels.  No label of the
  JAX step is named otherwise (``LABEL_MAP`` is empty); the port also
  labels the operations that step a process in one kernel (``PORT_ONLY``).
* ``profile_trace`` writes a Chrome trace on the CPU.
"""

from __future__ import annotations

import csv
import itertools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
import tasmania_tpu.utils.timer as jax_timer_module
import tasmania_tpu_torch.utils.timer as port_timer_module
from drivers.driver_namelist_sus import build_domain_and_state as jax_build_domain_and_state
from drivers.driver_namelist_sus import build_model as jax_build_model
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.timer import Timer, profile_trace

SIZE = {"nx": 17, "ny": 17, "nz": 8}
#: a JAX label -> the port's, where the port must name a call otherwise
LABEL_MAP: dict = {}
#: (depth, label) -> calls the port records and the JAX step does not: the
#: port labels each operation that steps a process in one kernel (a fused RK
#: step of a component or a chain, the Kessler + saturation adjustment pair)
#: with its components' names; the JAX package's Pallas route calls the same
#: kernels unlabelled
PORT_ONLY = {
    (1, "IsentropicSmagorinsky"): 1,
    (1, "KesslerMicrophysics+KesslerSaturationAdjustmentPrognostic"): 1,
    (1, "IsentropicVerticalAdvection"): 1,
    (1, "KesslerFallVelocity+KesslerSedimentation"): 1,
}


@pytest.fixture
def timers(monkeypatch):
    """Both timers, reset and on, reading a clock that advances 0.25 s a
    read; restored afterwards."""
    clock = itertools.count()
    fake = SimpleNamespace(perf_counter=lambda: 0.25 * next(clock))
    classes = (jax_timer_module.Timer, port_timer_module.Timer)
    for module in (jax_timer_module, port_timer_module):
        monkeypatch.setattr(module, "time", fake)
    for cls in classes:
        monkeypatch.setattr(cls, "enabled", True)
        cls.reset()
    yield classes
    for cls in classes:
        cls.reset()


def _drive(cls):
    with cls.timing("step"):
        for _ in range(2):
            with cls.timing("stage"):
                with cls.timing("kernel"):
                    pass
        cls.start("physics")
        cls.stop()
    with cls.timing("kernel"):
        pass


def _tree(cls):
    lines = []

    def walk(node, depth):
        lines.append((depth, node.label, node.total, node.count))
        for c in node.children.values():
            walk(c, depth + 1)

    walk(cls._root, 0)
    return lines


def test_tree_log_and_csv_match_jax(timers, tmp_path):
    jax_cls, port_cls = timers
    for cls in timers:
        _drive(cls)
    assert _tree(port_cls) == _tree(jax_cls)
    for units in ("s", "ms", "us"):
        assert port_cls.log(units=units) == jax_cls.log(units=units)
        for label in ("step", "stage", "kernel", "physics", "absent"):
            assert port_cls.get_time(label, units) == jax_cls.get_time(label, units)
    assert port_cls.get_time("kernel") == 0.25 * 3  # both nodes that carry the label
    port_cls.log(out=str(tmp_path / "port.log"))
    assert (tmp_path / "port.log").read_text() == port_cls.log() + "\n"

    port_cls.to_csv(str(tmp_path / "port.csv"), run_label="r")
    port_cls.to_csv(str(tmp_path / "port.csv"), run_label="r2", backend="jax")
    jax_cls.to_csv(str(tmp_path / "jax.csv"), run_label="r", backend="torch")
    jax_cls.to_csv(str(tmp_path / "jax.csv"), run_label="r2")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    rows = list(csv.reader(open(tmp_path / "port.csv")))
    assert rows[0] == ["run", "backend", "label", "total_s", "calls"]
    assert rows[1][:3] == ["r", "torch", "step"] and rows[2][2] == "step/stage"


def test_disabled_timer_records_nothing():
    Timer.reset()
    assert not Timer.enabled
    with Timer.timing("x"):
        pass
    assert Timer.log() == "" and Timer.get_time("x") == 0.0


def _jax_step_labels():
    import jax
    import jax.numpy as jnp

    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend="pallas:interpret", so=JaxStorageOptions(dtype=np.float64))
    nl = SimpleNamespace(**values)
    domain, state, pt = jax_build_domain_and_state(nl)
    dycore, physics = jax_build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")

    def step(fields):
        st = {k: JaxFieldArray(v, state[k].units, state[k].dims) for k, v in fields.items()}
        st["topography_height"] = JaxFieldArray(jnp.zeros((nl.nx, nl.ny)), "m", ("x", "y"))
        st = physics(dycore(st, {}, 5.0), 5.0)
        return {k: st[k].data for k in names}

    cls = jax_timer_module.Timer
    cls.reset()
    cls.enabled = True
    try:
        jax.eval_shape(step, {k: state[k].data for k in names})
    finally:
        cls.enabled = False
    return {(d, label): n for d, label, _, n in _tree(cls)[1:]}


def _port_step_labels():
    nl = load_namelist(**SIZE, so=StorageOptions(dtype=torch.float64, device="cpu"))
    domain, state, pt = port_driver.build_domain_and_state(nl)
    dycore, physics = port_driver.build_model(nl, domain, pt)
    st = {k: v for k, v in state.items() if k != "time"}
    st["topography_height"] = FieldArray(torch.zeros((nl.nx, nl.ny), dtype=torch.float64), "m", ("x", "y"))
    Timer.reset()
    Timer.enabled = True
    try:
        physics(dycore(st, {}, 5.0), 5.0)
    finally:
        Timer.enabled = False
    return {(d, label): n for d, label, _, n in _tree(Timer)[1:]}


def test_sus_step_labels_match_jax():
    jax_labels = {(d, LABEL_MAP.get(label, label)): n for (d, label), n in _jax_step_labels().items()}
    port_labels = _port_step_labels()
    Timer.reset()
    jax_timer_module.Timer.reset()
    assert {k: n for k, n in port_labels.items() if k not in PORT_ONLY} == jax_labels
    assert {k: port_labels.get(k) for k in PORT_ONLY} == PORT_ONLY
    assert port_labels[(1, "stage")] == 3
    assert {label for _, label in port_labels} >= {"IsentropicDiagnostics", "IsentropicHorizontalSmoothing",
                                                   "IsentropicVelocityComponents", "KesslerFallVelocity",
                                                   "Precipitation"}


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profile_trace(str(log_dir)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    (path,) = log_dir.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_profile_flag_writes_a_trace(tmp_path):
    """``--profile LOGDIR`` on the driver's eager loop, on the CPU."""
    port_driver.main(["--nx", "17", "--nz", "8", "--niter", "2", "--device", "cpu",
                      "--profile", str(tmp_path / "prof")])
    (path,) = (tmp_path / "prof").glob("*.json")
    assert json.loads(path.read_text())["traceEvents"]
