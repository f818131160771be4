"""The port's slice of the moist SUS benchmark against the JAX package.

Three steps of the port's first slice, the chain dycore -> diagnostics ->
smoothing -> velocities (``namelist_sus.slice_skip``), at 17x17x8 in float64: the port on the CPU (through the plain versions of its
kernels) against the JAX driver's ``build_model`` with the same ``skip`` on
the plain ``"jax"`` backend.  Tolerance: every field within 1e-11 of the
field's largest magnitude; the two packages take cumulative sums and
filter sums in different orders, so agreement is to rounding, not bitwise.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state, build_model
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist, slice_skip
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy

SIZE = {"nx": 17, "ny": 17, "nz": 8}
NSTEPS = 3
ROOT = Path(__file__).resolve().parent.parent


def _jax_namelist():
    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend="jax", so=JaxStorageOptions(dtype=np.float64))
    return SimpleNamespace(**values)


def _run_jax():
    import jax.numpy as jnp

    nl = _jax_namelist()
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip=slice_skip)
    names = sorted(k for k in state if k != "time")
    hs_steady = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    )
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    initial = {k: np.asarray(v.data) for k, v in fields.items()}
    for i in range(-1, NSTEPS):  # the warm-up step at zero height, then NSTEPS
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = dict(fields)
        st["topography_height"] = JaxFieldArray(fact * hs_steady, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        fields = {k: st[k] for k in names}
    return initial, {k: np.asarray(v.data) for k, v in fields.items()}


def _run_port():
    nl = load_namelist(**SIZE, niter=NSTEPS, so=StorageOptions(dtype=torch.float64, device="cpu"))
    domain, state, pt = port_driver.build_domain_and_state(nl)
    initial = {k: v[0] for k, v in state_to_numpy(state).items() if k != "time"}
    res = port_driver.run(nl, skip=slice_skip, verbose=False)
    return initial, {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.fixture(scope="module")
def both_runs():
    return _run_jax(), _run_port()


def test_initial_states_agree(both_runs):
    (jax_init, _), (port_init, _) = both_runs
    assert set(jax_init) == set(port_init)
    for name in sorted(jax_init):
        np.testing.assert_array_equal(port_init[name], jax_init[name], err_msg=name)


def test_slice_three_steps_agree(both_runs):
    (_, jax_out), (_, port_out) = both_runs
    assert set(jax_out) == set(port_out)
    for name in sorted(jax_out):
        ref = jax_out[name]
        got = port_out[name]
        assert got.shape == ref.shape, name
        assert np.all(np.isfinite(got)), name
        scale = np.max(np.abs(ref)) or 1.0
        np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=1e-11, err_msg=name)


def test_port_imports_no_jax():
    """Importing the port and running a CPU step of the full flagship chain
    (the driver's default), of each coupling of the variant driver and two
    steps of the mountain-wave driver leaves JAX and the JAX package
    unloaded."""
    code = (
        "import sys, torch\n"
        "from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist\n"
        "from tasmania_tpu_torch.drivers.driver_namelist_sus import run\n"
        "from tasmania_tpu_torch.drivers.namelist_sus import load_namelist\n"
        "from tasmania_tpu_torch.framework.options import StorageOptions\n"
        "so = StorageOptions(dtype=torch.float32, device='cpu')\n"
        "size = dict(nx=17, ny=17, nz=8, niter=1, so=so)\n"
        "run(load_namelist(**size), verbose=False)\n"
        "for coupling in moist.COUPLINGS:\n"
        "    moist.run(moist.load_namelist(coupling, **size), coupling, verbose=False)\n"
        "from tasmania_tpu_torch.drivers import driver_mountain_wave as mw\n"
        "mw.run_case(17, 20, 40.0 / 3600.0, 20.0, so=so, verbose=False)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'tasmania_tpu.')) or m == 'tasmania_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)
