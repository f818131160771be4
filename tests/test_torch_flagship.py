"""The port's full moist SUS step against the JAX package.

Three steps (after the warm-up step at zero mountain height) of the whole
chain dycore -> diagnostics -> smoothing -> Smagorinsky -> velocities ->
Kessler + saturation adjustment -> vertical advection -> sedimentation ->
precipitation, at 17x17x8 in float64, the port on the CPU (through the plain
versions of its kernels):

* against the JAX driver's ``build_model`` on the plain ``"jax"`` backend,
  with the port's ``sedimentation_vt_mode="stage"``: that backend evaluates
  the fall velocity at every RK stage (``physics/microphysics/kessler.py:352``);
* against the ``"pallas:interpret"`` backend with ``vt_mode="step"``, the
  flagship's own setting: the Pallas kernels run in interpret mode.

Tolerance: every field within 1e-11 of the field's largest magnitude.  The
two packages sum in different orders (cumulative sums, filter sums, the kernels' hoisted coefficients), so
agreement is to rounding, not bitwise.

A ``slow`` test holds the port against the committed golden trajectory
``tests/baseline_datasets/isentropic_golden.h5`` (33x33x16, 50 steps, no
warm-up step, float64, ``"jax"`` backend; ``tests/make_golden.py``), at the
same tolerance.
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
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy

# a supersaturated start (relative humidity 1.2), so that saturation
# adjustment makes cloud water above the autoconversion threshold and every
# branch of the Kessler scheme, rain and precipitation run within 3 steps
SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 3
TOL = 1e-11
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")


def _run_jax(backend):
    import jax.numpy as jnp

    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(SIZE, backend=backend, so=JaxStorageOptions(dtype=np.float64))
    nl = SimpleNamespace(**values)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    for i in range(-1, NSTEPS):
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = dict(fields)
        st["topography_height"] = JaxFieldArray(fact * hs, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        fields = {k: st[k] for k in names}
    return {k: np.asarray(v.data) for k, v in fields.items()}


def _run_port(vt_mode):
    nl = load_namelist(**SIZE, niter=NSTEPS, so=CPU64, sedimentation_vt_mode=vt_mode)
    res = port_driver.run(nl, verbose=False)
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


def assert_fields_agree(got, ref, tol=TOL):
    assert set(got) == set(ref)
    for name in sorted(ref):
        assert got[name].shape == ref[name].shape, name
        assert np.all(np.isfinite(got[name])), name
        scale = np.max(np.abs(ref[name])) or 1.0
        np.testing.assert_allclose(got[name] / scale, ref[name] / scale, rtol=0, atol=tol, err_msg=name)


def test_flagship_three_steps_agree_with_jax_backend():
    ref = _run_jax("jax")
    got = _run_port("stage")
    # the moist physics ran: cloud water beyond the threshold, rain, and
    # rain at the ground
    assert ref["mass_fraction_of_cloud_liquid_water_in_air"].max() > 1e-4
    assert ref["mass_fraction_of_precipitation_water_in_air"].max() > 0.0
    assert ref["accumulated_precipitation"].max() > 0.0
    assert_fields_agree(got, ref)


def test_flagship_three_steps_agree_with_pallas_interpret():
    assert_fields_agree(_run_port("step"), _run_jax("pallas:interpret"))


@pytest.mark.slow
def test_flagship_matches_golden_trajectory():
    """50 steps at 33x33x16 from the initial state, no warm-up step, against
    the committed JAX trajectory (snapshots after 25 and 50 steps)."""
    import make_golden
    from tasmania_tpu.utils.iox import load_hdf5_dataset

    _, _, states = load_hdf5_dataset(str(make_golden.GOLDEN))
    nl = load_namelist(nx=make_golden.NX, ny=make_golden.NY, nz=make_golden.NZ,
                       so=CPU64, sedimentation_vt_mode="stage")
    domain, state, pt = port_driver.build_domain_and_state(nl)
    dycore, physics = port_driver.build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    step = port_driver.fields_step(lambda st, dt: physics(dycore(st, {}, dt), dt), names, dt_s)
    fields = {k: state[k] for k in names}
    snaps = []
    for i in range(make_golden.NSTEPS):
        fields = step(fields, min((i + 1) * dt_s / topo_time, 1.0) * dycore.topography_steady)
        if (i + 1) % make_golden.SNAP_EVERY == 0:
            snaps.append({k: a for k, (a, _) in state_to_numpy(fields).items()})
    assert len(snaps) == len(states)
    for snap, golden in zip(snaps, states):
        ref = {k: np.asarray(golden[k].data) for k in names}
        assert_fields_agree({k: snap[k] for k in names}, ref)

