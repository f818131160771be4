"""The port's five other couplings of the moist model (fc, lfc, ps, sts,
ssus) against the JAX package, on the CPU in float64.

* Three steps (after the warm-up step at zero mountain height) of
  ``tasmania_tpu_torch/drivers/driver_isentropic_moist.py`` at 17x17x8 against
  the JAX driver's ``build_variant`` on the plain ``"jax"`` backend, with the
  port's ``sedimentation_vt_mode="stage"`` (that backend evaluates the fall
  velocity at every RK stage), and under ``"pallas:interpret"``, with the
  flagship's ``"step"``.  On that backend the JAX dycore takes the two-kernel
  stage (``fused_advection_fields``, ``fused_momentum_epilogue``) for fc and
  lfc, and the parallel splitting of ps runs Kessler and saturation
  adjustment through ``fused_kessler_rk2`` and ``fused_satadj_rk2``, all in
  interpret mode; the port runs the plain versions of its kernels.  The
  start is supersaturated (relative humidity 1.2), so that every branch of
  the moist physics acts.  Tolerance: every field within 1e-10 of its
  largest magnitude (the packages sum in different orders; fc and lfc step
  the physics inside each stage, so rounding differences pass through more
  operations than in the flagship's 1e-11).  Both backends' runs are in
  this one file so that they share one process's JAX warm-up.
* ``ParallelSplitting``, ``SequentialTendencySplitting`` and the three
  sequential-tendency steppers against the JAX classes on a two-process
  chain (Kessler, then saturation adjustment) from a state with cloud and
  rain, to 1e-12 of each field's scale.
* The parallel splitting's precipitation: both packages leave the
  precipitation fields at their initial zeros (see ``ParallelSplitting``).
"""

from __future__ import annotations

import functools
import importlib
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_isentropic_moist as port_driver
from tasmania_tpu_torch.drivers.driver_namelist_sus import build_components, build_domain_and_state
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions, TimeIntegrationOptions
from tasmania_tpu_torch.framework.splitting import ParallelSplitting, SequentialTendencySplitting
from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper
from tasmania_tpu_torch.interop import state_to_numpy
from tests.test_torch_flagship import assert_fields_agree

SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 3
TOL = 1e-10
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
VARIANTS = ("fc", "lfc", "ps", "sts", "ssus")
QC = "mass_fraction_of_cloud_liquid_water_in_air"
QR = "mass_fraction_of_precipitation_water_in_air"
DIMS = ("x", "y", "z")


def jax_namelist(coupling, backend, **overrides):
    jnl = importlib.import_module(f"drivers.namelist_{coupling}")
    values = {k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")}
    values.update(SIZE, backend=backend, so=JaxStorageOptions(dtype=np.float64), **overrides)
    return SimpleNamespace(**values)


@functools.lru_cache(maxsize=None)
def run_jax(coupling, backend):
    """The JAX driver's step sequence (``drivers/driver_isentropic_moist.py:344-353``)."""
    import jax.numpy as jnp
    from drivers.driver_isentropic_moist import build_variant

    nl = jax_namelist(coupling, backend)
    domain, state, step_impl = build_variant(nl, coupling)
    names = sorted(k for k in state if k != "time")
    hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    for i in range(-1, NSTEPS):
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = dict(fields)
        st["topography_height"] = JaxFieldArray(fact * hs, "m", ("x", "y"))
        st = step_impl(st, dt_s)
        fields = {k: st[k] for k in names}
    return {k: np.asarray(v.data) for k, v in fields.items()}


@functools.lru_cache(maxsize=None)
def run_port(coupling, vt_mode):
    nl = port_driver.load_namelist(coupling, **SIZE, niter=NSTEPS, so=CPU64, sedimentation_vt_mode=vt_mode)
    res = port_driver.run(nl, coupling, verbose=False)
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.mark.parametrize("coupling", VARIANTS)
def test_variant_three_steps_agree_with_jax_backend(coupling):
    ref = run_jax(coupling, "jax")
    # the moist physics ran: cloud water beyond the autoconversion threshold
    assert ref[QC].max() > 1e-4
    assert_fields_agree(run_port(coupling, "stage"), ref, TOL)


@pytest.mark.parametrize("coupling", VARIANTS)
def test_variant_three_steps_agree_with_pallas_interpret(coupling):
    ref = run_jax(coupling, "pallas:interpret")
    assert ref[QC].max() > 1e-4
    assert_fields_agree(run_port(coupling, "step"), ref, TOL)


def test_parallel_splitting_leaves_precipitation_at_zero():
    """The precipitation process has no scheme.  ``ParallelSplitting`` calls
    it as a stepper, so its diagnostics take the place of the stepped state,
    and a coupling has no output variables to add: in both packages the
    precipitation and the accumulated precipitation stay at their initial
    zeros, while the same model under SUS rains at the ground."""
    assert run_port("sus", "stage")["accumulated_precipitation"].max() > 0.0
    for fields in (run_jax("ps", "jax"), run_port("ps", "stage")):
        assert fields[QR].max() > 0.0
        for name in ("precipitation", "accumulated_precipitation"):
            np.testing.assert_array_equal(fields[name], 0.0, err_msg=name)


# -------------------------------------------------------- the splittings alone


def _two_process_chain(scheme):
    """Kessler then saturation adjustment, as options of both packages, and
    one state with cloud and rain, as both packages' dicts."""
    from drivers.driver_isentropic_moist import build_components as jax_components
    from drivers.driver_namelist_sus import build_domain_and_state as jax_domain_and_state
    from tasmania_tpu.framework import ConcurrentCoupling as JaxCoupling
    from tasmania_tpu.framework import TimeIntegrationOptions as JaxOptions

    jnl = jax_namelist("sus", "jax")
    common = dict(backend="jax", backend_options=jnl.bo, storage_options=jnl.so)
    jdomain, jstate, jpt = jax_domain_and_state(jnl)
    jc = jax_components(jnl, jdomain, jpt, common)
    jax_options = [
        JaxOptions(component=JaxCoupling(jc["ke"], jc["t2d"]), scheme=scheme),
        JaxOptions(component=JaxCoupling(jc["d2t"], jc["sa"], jc["t2d"]), scheme=scheme),
    ]
    nl = port_driver.load_namelist("sus", **SIZE, so=CPU64)
    domain, state, pt = build_domain_and_state(nl)
    c = build_components(nl, domain, pt)
    options = [
        TimeIntegrationOptions(component=ConcurrentCoupling(c["ke"], c["t2d"]), scheme=scheme),
        TimeIntegrationOptions(component=ConcurrentCoupling(c["d2t"], c["sa"], c["t2d"]), scheme=scheme),
    ]
    rng = np.random.default_rng(7)
    shape = state[QC].shape
    extra = {
        QC: rng.uniform(0.0, 3e-4, shape),
        QR: rng.uniform(0.0, 1e-4, shape) * (rng.uniform(size=shape) > 0.3),
        "tendency_of_air_potential_temperature": rng.normal(0.0, 1e-3, shape),
    }
    units = {QC: "g g^-1", QR: "g g^-1", "tendency_of_air_potential_temperature": "K s^-1"}
    # the provisional state: the current one with less water vapour
    qv = "mass_fraction_of_water_vapor_in_air"
    extra[qv] = np.asarray(jstate[qv].data) * 0.99
    units[qv] = "g g^-1"
    jprv, prv = dict(jstate), dict(state)
    for name, a in extra.items():
        target_j, target = (jprv, prv) if name == qv else (jstate, state)
        target_j[name] = JaxFieldArray(a, units[name], DIMS)
        target[name] = FieldArray(torch.as_tensor(a), units[name], DIMS)
        if name != qv:
            jprv[name], prv[name] = jstate[name], state[name]
    return (jax_options, jstate, jprv), (options, state, prv)


def _assert_dicts_agree(got, ref, tol=1e-12):
    names = sorted(k for k in ref if k != "time")
    assert names == sorted(k for k in got if k != "time")
    assert_fields_agree({k: got[k].data.numpy() for k in names},
                        {k: np.asarray(ref[k].data) for k in names}, tol)


@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
@pytest.mark.parametrize("kind", ["parallel", "sequential_tendency"])
def test_splitting_matches_jax(kind, scheme):
    from tasmania_tpu.framework.splitting import ParallelSplitting as JaxParallel
    from tasmania_tpu.framework.splitting import SequentialTendencySplitting as JaxSequentialTendency

    (jopts, jstate, jprv), (opts, state, prv) = _two_process_chain(scheme)
    if kind == "parallel":
        jsplit, split = JaxParallel(*jopts), ParallelSplitting(*opts)
    else:
        jsplit, split = JaxSequentialTendency(*jopts), SequentialTendencySplitting(*opts)
        assert all(isinstance(p, SequentialTendencyStepper) for p in split.components)
    jcur, jnew = jsplit(jstate, jprv, timedelta(seconds=5.0))
    cur, new = split(state, prv, timedelta(seconds=5.0))
    _assert_dicts_agree(cur, jcur)
    _assert_dicts_agree(new, jnew)
    # the processes acted on the provisional state
    assert float((new[QC].data - prv[QC].data).abs().max()) > 0.0
