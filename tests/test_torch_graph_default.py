"""The port's drivers step through a CUDA graph of the step by default on a
CUDA device, as the JAX drivers ``jax.jit`` every step, and eagerly on the
CPU or on request (``--no-jit``, ``fused_loop=False``).

* ``graph_mode`` resolves the mode without a card: None is the graph on a
  CUDA device and eager steps on the CPU, True the graph (``ValueError`` on
  the CPU), False eager steps; naming ``cuda`` on a machine without a GPU
  still raises.
* The command lines: ``--no-jit`` parses and steps eagerly, beside
  ``--fused-loop`` it is the parser's error; ``--fused-loop`` still refuses
  the checkpoint flags (as the JAX driver does) and takes ``--profile``;
  ``fused_loop=True`` raises on the CPU in every driver, and every driver
  steps eagerly on the CPU by default.
* The graph branch of ``step_sequence`` with its recovery, run on the CPU
  through a stand-in for ``StepGraph`` whose capture runs nothing (as a
  real capture) and leaves the outputs NaN until a replay, and whose replay
  calls the ``StepBody`` eagerly.  At 17x17x8, float64, 1 + 7 steps,
  checkpoints every 3: the checkpoints at 3 and 6 and the final 7 equal the
  eager run's bit for bit; a resume from 3 and one from 7 (nothing
  replayed) end on the uninterrupted bits; a NaN written through a device
  counter the step reads trips the guard at the same step, with the same
  message and checkpoints, as the eager run; ``--profile`` writes its trace
  around the replays.  The final fields agree with the JAX ``"jax"``
  backend's step sequence, built as ``tests/test_torch_flagship.py`` builds
  it, at its tolerance.

The capture and replay themselves run on the card (``chip_smoke.py``
phase 20, ``tests/test_torch_kernels.py::test_graph_default_recovery_on_card``).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state, build_model
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_burgers as burgers
from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers import driver_profile as dprof
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy
from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 7
EVERY = 3
POISON = 4
TOL = 1e-11  # tests/test_torch_flagship.py's
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
BASE = ["--nx", "17", "--ny", "17", "--nz", "8", "--device", "cpu"]
MW = dict(nx=17, nz=20, hours=3 * 20.0 / 3600.0, dt=20.0)


# ---------------------------------------------------------------- the mode


@pytest.mark.parametrize("device, fused_loop, graph", [
    ("cpu", None, False), ("cuda", None, True), ("cuda:0", None, True),
    ("cpu", False, False), ("cuda", False, False), ("cuda", True, True),
])
def test_graph_mode_resolves_by_device(device, fused_loop, graph):
    assert port_driver.graph_mode(device, fused_loop) is graph
    assert port_driver.graph_mode(torch.device(device), fused_loop) is graph


def test_graph_mode_refuses_the_graph_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA graph"):
        port_driver.graph_mode("cpu", True)


def test_check_device_returns_the_mode_and_refuses_a_missing_card():
    assert port_driver.check_device("cpu") is False
    assert port_driver.check_device("cpu", fused_loop=False) is False
    if torch.cuda.is_available():
        assert port_driver.check_device("cuda") is True
        return
    for fused_loop in (None, False, True):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_driver.check_device("cuda", fused_loop=fused_loop)


@pytest.mark.parametrize("argv, mode", [([], None), (["--no-jit"], False), (["--fused-loop"], True)])
def test_cli_mode(argv, mode):
    parser = port_driver.size_parser("")
    parser.add_argument("--no-jit", action="store_true")
    assert port_driver.cli_mode(parser.parse_args(argv)) is mode
    # the other drivers' command lines have no --no-jit
    assert port_driver.cli_mode(port_driver.size_parser("").parse_args(
        [a for a in argv if a != "--no-jit"])) is (None if mode is False else mode)


def test_no_jit_steps_eagerly():
    res = port_driver.main(BASE + ["--niter", "1", "--no-jit"])
    assert res["capture_s"] is None and res["start"] == 0


def test_no_jit_and_fused_loop_are_refused_together(capsys):
    with pytest.raises(SystemExit) as err:
        port_driver.main(BASE + ["--niter", "1", "--no-jit", "--fused-loop"])
    assert err.value.code == 2
    assert "give one" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--checkpoint-dir", "ck"], ["--checkpoint-dir", "ck", "--resume"],
                                   ["--nan-guard"]])
def test_fused_loop_still_refuses_the_checkpoint_flags(flags, capsys):
    with pytest.raises(SystemExit) as err:
        port_driver.main(BASE + ["--niter", "1", "--fused-loop"] + flags)
    assert err.value.code == 2
    assert "Drop --fused-loop" in capsys.readouterr().err


def test_fused_loop_takes_profile(tmp_path):
    """The parser passes ``--fused-loop --profile`` on; the CPU then refuses
    the graph before a model or a trace is made."""
    trace = tmp_path / "trace"
    with pytest.raises(ValueError, match="CUDA graph"):
        port_driver.main(BASE + ["--niter", "1", "--fused-loop", "--profile", str(trace)])
    assert not trace.exists()


def _drivers():
    """Each driver's entry point at a tiny size on the CPU, as a function of
    ``fused_loop`` (None: not passed)."""
    nl = load_namelist(**SIZE, niter=1, so=CPU64)

    def kw(fused_loop):
        return {} if fused_loop is None else {"fused_loop": fused_loop}

    return {
        "sus": lambda f: port_driver.run(nl, verbose=False, **kw(f)),
        "moist_fc": lambda f: moist.run(moist.load_namelist("fc", **SIZE, niter=1, so=CPU64), "fc",
                                        verbose=False, **kw(f)),
        "mountain_wave": lambda f: mw.run_case(MW["nx"], MW["nz"], MW["hours"], MW["dt"], so=CPU64,
                                               verbose=False, **kw(f)),
        "burgers": lambda f: burgers.run_case("bench", 16, steps=1, so=CPU64, verbose=False, **kw(f)),
        "profile": lambda f: dprof.run_variant(nl, "full", **kw(f)),
    }


@pytest.mark.parametrize("driver", ["sus", "moist_fc", "mountain_wave", "burgers", "profile"])
def test_every_driver_steps_eagerly_on_the_cpu_by_default(driver):
    run = _drivers()[driver]
    default, eager = run(None), run(False)
    assert default["capture_s"] is None and eager["capture_s"] is None
    for name, fa in eager["fields"].items():
        assert torch.equal(default["fields"][name].data, fa.data), name
    with pytest.raises(ValueError, match="CUDA graph"):
        run(True)


# ------------------------------------------- the graph branch and recovery


class EagerGraph:
    """``StepGraph`` on the CPU: the capture runs nothing, as a real
    capture, and leaves the outputs NaN (a real capture leaves them
    unwritten) until the first replay; a replay calls the body."""

    def __init__(self, body):
        self.body = body
        body.out = {k: v.with_data(torch.full_like(v.data, float("nan"))) for k, v in body.out.items()}

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.body()

    def fields(self):
        return self.body.fields()


@pytest.fixture
def graph_on_cpu(monkeypatch):
    """The drivers' graph branch on the CPU through :class:`EagerGraph`."""
    monkeypatch.setattr(port_driver, "graph_mode", lambda device, fused_loop=None: fused_loop is not False)
    monkeypatch.setattr(port_driver, "StepGraph", EagerGraph)


def _model(niter=NSTEPS):
    nl = load_namelist(**SIZE, niter=niter, so=CPU64, sedimentation_vt_mode="stage")
    domain, state, pt = port_driver.build_domain_and_state(nl)
    dycore, physics = port_driver.build_model(nl, domain, pt)
    return nl, state, dycore, physics


def _run(fused_loop, ck=None, poison=None, **recovery):
    """The SUS sequence, 1 + NSTEPS steps, checkpointed every EVERY with the
    NaN guard; with ``poison`` the step writes a NaN at that step, through a
    device counter it reads (the same tensor operations eager and in a
    graph)."""
    nl, state, dycore, physics = _model()
    calls = torch.zeros((), dtype=torch.long)

    def step_impl(st, dt):
        out = physics(dycore(st, {}, dt), dt)
        if poison is not None:
            calls.add_(1)
            s = out["air_isentropic_density"].data
            s[3, 4, 2] = torch.where(calls == 1 + poison, float("nan"), s[3, 4, 2])
        return out

    return port_driver.run_steps(nl, state, step_impl, dycore.topography_steady, verbose=False,
                                 fused_loop=fused_loop, checkpoint_dir=None if ck is None else str(ck),
                                 checkpoint_every=EVERY, nan_guard=True, **recovery)


def _assert_bitwise(got, ref):
    assert set(got) == set(ref)
    for name in sorted(ref):
        assert torch.equal(got[name].data, ref[name].data), name


@pytest.fixture(scope="module")
def eager_run(tmp_path_factory):
    ck = tmp_path_factory.mktemp("eager") / "ck"
    return _run(False, ck), CheckpointManager(str(ck))


def test_graph_checkpoints_equal_the_eager_run(graph_on_cpu, eager_run, tmp_path):
    eager, eager_mgr = eager_run
    graph = _run(None, tmp_path / "ck")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == eager_mgr.all_steps() == [3, 6, 7]
    for step in (3, 6, 7):
        got, ref = mgr.restore(step), eager_mgr.restore(step)
        _assert_bitwise({k: v for k, v in got.items() if k != "time"},
                        {k: v for k, v in ref.items() if k != "time"})
    _assert_bitwise(graph["fields"], eager["fields"])


@pytest.mark.parametrize("resume", [3, NSTEPS])
def test_graph_resume_gives_the_uninterrupted_bits(graph_on_cpu, eager_run, tmp_path, resume):
    """A resume loads the checkpoint into the body's buffers and sets its
    counter; from the last step it replays nothing and ends on the restored
    fields."""
    eager, _ = eager_run
    ck = tmp_path / "ck"
    full = _run(None, ck)
    _assert_bitwise(full["fields"], eager["fields"])
    resumed = _run(None, ck, resume=resume)
    assert resumed["start"] == resume
    _assert_bitwise(resumed["fields"], full["fields"])
    assert CheckpointManager(str(ck)).all_steps() == [3, 6, 7]


def test_graph_resume_sets_the_counter(graph_on_cpu, monkeypatch, tmp_path):
    """After a resume from 3 the next replay steps at ``facts[3]``: the
    body's counter ends at 7, as after the uninterrupted run."""
    bodies = []

    class Recorded(EagerGraph):
        def __init__(self, body):
            super().__init__(body)
            bodies.append(body)

    monkeypatch.setattr(port_driver, "StepGraph", Recorded)
    ck = tmp_path / "ck"
    _run(None, ck)
    _run(None, ck, resume=3)
    assert [int(b.counter) for b in bodies] == [NSTEPS, NSTEPS]


def test_graph_nan_guard_trips_as_the_eager_one(graph_on_cpu, tmp_path):
    messages, left = [], []
    for mode, ck in ((False, tmp_path / "eager"), (None, tmp_path / "graph")):
        with pytest.raises(RuntimeError, match="non-finite state") as err:
            _run(mode, ck, poison=POISON)
        messages.append(str(err.value))
        left.append(CheckpointManager(str(ck)).all_steps())
    assert messages[0] == messages[1]
    assert "at step 6; last good checkpoint: step 3 (restart with --resume)" in messages[1]
    assert left == [[3], [3]]


def test_graph_profile_traces_the_replays(graph_on_cpu, tmp_path):
    nl, state, dycore, physics = _model(niter=2)
    res = port_driver.run_steps(nl, state, lambda st, dt: physics(dycore(st, {}, dt), dt),
                                dycore.topography_steady, verbose=False, profile=str(tmp_path / "trace"))
    assert res["capture_s"] is not None
    assert len(list((tmp_path / "trace").glob("trace_*.json"))) == 1


def _run_jax(niter):
    import jax.numpy as jnp

    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend="jax", so=JaxStorageOptions(dtype=np.float64))
    nl = SimpleNamespace(**values)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    for i in range(-1, niter):
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = dict(fields)
        st["topography_height"] = JaxFieldArray(fact * hs, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        fields = {k: st[k] for k in names}
    return {k: np.asarray(v.data) for k, v in fields.items()}


def test_graph_run_agrees_with_jax(graph_on_cpu, tmp_path):
    """The graph branch's final fields, checkpointed, against the JAX
    ``"jax"`` backend's 1 + 7 steps, within TOL of each field's largest
    magnitude."""
    graph = _run(None, tmp_path / "ck")
    assert graph["capture_s"] is not None
    got = {k: a for k, (a, _) in state_to_numpy(graph["fields"]).items()}
    ref = _run_jax(NSTEPS)
    assert set(got) == set(ref)
    for name in sorted(ref):
        assert np.all(np.isfinite(got[name])), name
        scale = np.max(np.abs(ref[name])) or 1.0
        np.testing.assert_allclose(got[name] / scale, ref[name] / scale, rtol=0, atol=TOL, err_msg=name)
