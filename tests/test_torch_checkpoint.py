"""Checkpoints, resume and the NaN guard of the port
(``tasmania_tpu_torch/utils/checkpoint.py``, the SUS driver's recovery
flags), on the CPU.

* The manager mirrors ``tests/test_checkpoint.py``: save and restore (time,
  units, dims, values), rotation to ``max_to_keep`` and ``latest_step``, a
  missing checkpoint raising ``FileNotFoundError``; and what orbax also
  gives: a step written under a temporary name is not a step, a step not
  newer than the latest is refused unless forced, a restore lays the fields
  on the device asked for.
* The driver mirrors ``tests/test_drivers_smoke.py:57-95`` through the
  port's ``main([... "--device", "cpu"])`` at 17x17x8 (float32, the
  namelist's type): a run checkpointed at step 4 and resumed to step 6 ends
  on the uninterrupted run's fields bit for bit; the dt = 600 s run trips
  the guard at the same step as the JAX driver on the same setup (both at
  step 5: the state turns non-finite within the first five steps, and the
  guard probes every fifth); ``--fused-loop`` beside a checkpoint flag is
  the parser's error, as in the JAX driver, which takes ``--profile``
  beside it (on the CPU the run then refuses the graph).
"""

from __future__ import annotations

import os
import re
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers import namelist_sus as port_nl
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

DIMS3 = ("x", "y", "z")
BASE = ["--nx", "17", "--ny", "17", "--nz", "8", "--device", "cpu"]


def _state():
    rng = np.random.default_rng(7)
    return {
        "time": datetime(2000, 1, 1, 6, 30),
        "air_isentropic_density": FieldArray(torch.as_tensor(rng.random((16, 8, 4))), "kg m^-2 K^-1", DIMS3),
        "x_momentum_isentropic": FieldArray(torch.as_tensor(rng.random((17, 8, 4))), "kg m^-1 K^-1 s^-1",
                                            ("x_at_u_locations", "y", "z")),
    }


def _assert_same(got, ref):
    assert got["time"] == ref["time"]
    for name in ("air_isentropic_density", "x_momentum_isentropic"):
        assert got[name].units == ref[name].units
        assert got[name].dims == ref[name].dims
        assert torch.equal(got[name].data, ref[name].data)


def test_save_restore(tmp_path):
    state = _state()
    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        assert mgr.save(3, state)
        mgr.wait_until_finished()
        out = mgr.restore()
        assert mgr.all_steps() == [3]
        assert mgr.nbytes(3) > 2 * 16 * 8 * 4 * 8
    _assert_same(out, state)
    state["air_isentropic_density"].data.add_(1.0)  # the checkpoint is a copy
    assert not torch.equal(out["air_isentropic_density"].data, state["air_isentropic_density"].data)


def test_restore_on_a_device(tmp_path):
    """``device=`` lays the fields out on load (the JAX class's ``sharding=``);
    a tensor time (seconds from the run's start) comes back a tensor."""
    state = _state()
    state["time"] = torch.tensor(12.5, dtype=torch.float64)
    with CheckpointManager(str(tmp_path / "ckpt")) as mgr:
        mgr.save(1, state)
        out = mgr.restore(1, device="cpu")
    assert torch.equal(out["time"], state["time"])
    assert out["air_isentropic_density"].data.device == torch.device("cpu")
    assert torch.equal(out["air_isentropic_density"].data, state["air_isentropic_density"].data)


def test_rotation_and_latest(tmp_path):
    state = _state()
    with CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2) as mgr:
        for step in (1, 2, 3):
            mgr.save(step, state, force=True)
        mgr.wait_until_finished()
        assert mgr.latest_step == 3
        assert set(mgr.all_steps()) == {2, 3}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "ckpt")).restore(1)


def test_half_written_step_is_not_a_step(tmp_path):
    """A run killed while saving leaves only a temporary directory, which
    neither ``latest_step`` nor ``restore`` takes for a step."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, state)
    os.makedirs(tmp_path / "ckpt" / ".4.tmp-killed")
    (tmp_path / "ckpt" / ".4.tmp-killed" / "arrays.pt").write_bytes(b"partial")
    os.makedirs(tmp_path / "ckpt" / "6")  # a step directory without its metadata
    assert mgr.all_steps() == [2]
    _assert_same(mgr.restore(), state)


def test_save_refuses_an_old_step_unless_forced(tmp_path):
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(4, state)
    assert not mgr.save(4, state) and not mgr.save(2, state)
    state["air_isentropic_density"].data.mul_(2.0)
    assert mgr.save(4, state, force=True)
    assert mgr.all_steps() == [4]
    _assert_same(mgr.restore(4), state)


# --------------------------------------------------------------------------- #
# the driver's flags                                                          #
# --------------------------------------------------------------------------- #


def test_checkpoint_resume_bitwise(tmp_path):
    """Kill and resume: checkpointed at step 4 (every 2), resumed to step 6,
    the fields are the uninterrupted run's bit for bit; the resumed run
    times the 2 steps after step 4 and checkpoints step 6."""
    full = port_driver.main(BASE + ["--niter", "6"])
    ck = str(tmp_path / "ck")
    port_driver.main(BASE + ["--niter", "4", "--checkpoint-dir", ck, "--checkpoint-every", "2"])
    assert CheckpointManager(ck).all_steps() == [2, 4]
    resumed = port_driver.main(BASE + ["--niter", "6", "--checkpoint-dir", ck, "--resume"])
    assert resumed["start"] == 4
    assert resumed["ms_per_step"] == pytest.approx(1e3 * resumed["elapsed"] / 2)
    assert set(resumed["fields"]) == set(full["fields"])
    for name, fa in full["fields"].items():
        assert torch.equal(resumed["fields"][name].data, fa.data), name
    assert CheckpointManager(ck).all_steps() == [2, 4, 6]
    assert resumed["umax"] == full["umax"] and resumed["vmax"] == full["vmax"]


def test_final_checkpoint_off_the_boundary(tmp_path):
    """A last step that is not a multiple of ``checkpoint_every`` is saved
    too, and the saved step is the run's final state."""
    ck = str(tmp_path / "ck")
    nl = load_namelist(nx=17, ny=17, nz=8, niter=5, so=StorageOptions(dtype=torch.float64, device="cpu"))
    res = port_driver.run(nl, verbose=False, checkpoint_dir=ck, checkpoint_every=2)
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 4, 5]
    last = mgr.restore()
    for name, fa in res["fields"].items():
        assert torch.equal(last[name].data, fa.data), name


def test_nan_guard_same_step_as_jax(monkeypatch):
    """The dt = 600 s run of ``tests/test_drivers_smoke.py``: each driver's
    guard names the same step and no checkpoint."""
    import importlib

    import drivers.namelist_sus as jax_nl

    importlib.reload(jax_nl)
    monkeypatch.setattr(jax_nl, "timestep", timedelta(seconds=600))
    monkeypatch.setattr(port_nl, "timestep", timedelta(seconds=600))
    from drivers.driver_namelist_sus import main as jax_main

    args = ["--nx", "17", "--ny", "17", "--nz", "8", "--niter", "40", "--nan-guard", "--checkpoint-every", "5"]
    messages = []
    for main, extra in ((jax_main, []), (port_driver.main, ["--device", "cpu"])):
        with pytest.raises(RuntimeError, match="non-finite state") as err:
            main(args + extra)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert re.search(r"at step 5; last good checkpoint: step None", messages[1])


def test_nan_guard_saves_nothing_after_the_last_good_step(tmp_path):
    """A step wrapper poisons one field at step 7: the guard raises at the
    boundary after it, step 8, naming step 6, and no later step is saved."""
    nl = load_namelist(nx=17, ny=17, nz=8, niter=12, so=StorageOptions(dtype=torch.float64, device="cpu"))
    domain, state, pt = port_driver.build_domain_and_state(nl)
    dycore, physics = port_driver.build_model(nl, domain, pt)
    calls = []

    def step_impl(st, dt):
        out = physics(dycore(st, {}, dt), dt)
        calls.append(1)
        if len(calls) == 1 + 7:  # the warm-up step, then step 7
            out["air_isentropic_density"].data[3, 4, 2] = float("nan")
        return out

    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match=r"at step 8; last good checkpoint: step 6 \(restart with --resume\)"):
        port_driver.run_steps(nl, state, step_impl, dycore.topography_steady, verbose=False,
                              checkpoint_dir=ck, checkpoint_every=2, nan_guard=True)
    assert CheckpointManager(ck).all_steps() == [2, 4, 6]


@pytest.mark.parametrize("flags", [["--checkpoint-dir", "ck"], ["--checkpoint-dir", "ck", "--resume"],
                                   ["--nan-guard"], ["--profile", "trace"]])
def test_fused_loop_refuses_recovery_flags(flags, capsys):
    if flags[0] == "--profile":
        # the parser takes it; the CPU refuses the graph before anything is built
        with pytest.raises(ValueError, match="CUDA graph"):
            port_driver.main(BASE + ["--niter", "2", "--fused-loop"] + flags)
        return
    with pytest.raises(SystemExit) as err:
        port_driver.main(BASE + ["--niter", "2", "--fused-loop"] + flags)
    assert err.value.code == 2
    assert "Drop --fused-loop" in capsys.readouterr().err


def test_resume_needs_a_directory(capsys):
    with pytest.raises(SystemExit):
        port_driver.main(BASE + ["--niter", "2", "--resume"])
    assert "--resume needs --checkpoint-dir" in capsys.readouterr().err
