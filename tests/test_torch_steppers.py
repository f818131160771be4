"""The port's coupling, steppers and splitting, on the CPU in float64 and
without JAX: each fused operation of the moist chain against the generic
stage-by-stage path through the components' ``array_call``.

The state is the flagship chain's after four steps at 17x17x8, started
supersaturated so that every process acts.  Tolerance: within 1e-12 of each
field's largest magnitude (the fused operations hoist coefficients and
reorder products, so agreement is to rounding).
"""

from __future__ import annotations

from datetime import timedelta
from unittest import mock

import numpy as np
import pytest
import torch

from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.splitting import _pair_plan
from tasmania_tpu_torch.framework.steppers import RK2, RK3WS, TendencyStepper
from tasmania_tpu_torch.isentropic.physics.turbulence import IsentropicSmagorinsky
from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
from tasmania_tpu_torch.physics.microphysics.kessler import KesslerSedimentation
from tasmania_tpu_torch.framework.options import StorageOptions

DT = 5.0
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")


def _model(vt_mode="stage"):
    nl = load_namelist(nx=17, ny=17, nz=8, relative_humidity=1.2, so=CPU64,
                       sedimentation_vt_mode=vt_mode)
    domain, state, pt = drv.build_domain_and_state(nl)
    dycore, physics = drv.build_model(nl, domain, pt)
    state["topography_height"] = FieldArray(dycore.topography_steady, "m", ("x", "y"))
    for _ in range(4):  # rain forms in the fourth step
        state = physics(dycore(state, {}, DT), DT)
    return dycore, physics, state


@pytest.fixture(scope="module")
def model():
    return _model()


def _assert_close(got, ref, names):
    for n in names:
        a, b = got[n].data.numpy(), ref[n].data.numpy()
        scale = np.max(np.abs(b)) or 1.0
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=1e-12, err_msg=n)


def _generic(stepper, state):
    with mock.patch.object(stepper, "_try_fused", return_value=None):
        return stepper(state, DT)


def _find(physics, component_type):
    for p in physics.components:
        if isinstance(p, TendencyStepper) and any(isinstance(c, component_type) for c in p.coupling.components):
            return p
    raise AssertionError(f"no stepper of {component_type.__name__}")


def test_chain_plan_pairs_kessler_with_saturation_adjustment(model):
    _, physics, _ = model
    plan = _pair_plan(physics._processes)
    kinds = [e[0] for e in plan]
    assert kinds.count("pair") == 1
    pair = plan[kinds.index("pair")]
    assert pair[1].name == pair[2].name == "rk2"
    # smoothing, Smagorinsky, velocities, the pair, vertical advection,
    # sedimentation, precipitation, after the diagnostics
    assert len(plan) == 8


def test_smagorinsky_fused_matches_generic_rk2(model):
    _, physics, state = model
    stepper = _find(physics, IsentropicSmagorinsky)
    assert isinstance(stepper, RK2)
    names = list(stepper.output_properties)
    _assert_close(stepper(state, DT)[1], _generic(stepper, state)[1], names)


def test_vertical_advection_fused_matches_generic_rk3ws(model):
    _, physics, state = model
    stepper = _find(physics, IsentropicVerticalAdvection)
    assert isinstance(stepper, RK3WS)
    assert float(state["tendency_of_air_potential_temperature"].data.abs().max()) > 0.0
    _assert_close(stepper(state, DT)[1], _generic(stepper, state)[1], list(stepper.output_properties))


def test_sedimentation_fused_matches_generic_rk3ws(model):
    _, physics, state = model
    stepper = _find(physics, KesslerSedimentation)
    diags, out = stepper(state, DT)
    gdiags, gout = _generic(stepper, state)
    name = "mass_fraction_of_precipitation_water_in_air"
    assert float(state[name].data.max()) > 0.0
    _assert_close(out, gout, [name])
    _assert_close(diags, gdiags, ["raindrop_fall_velocity"])


def test_kessler_pair_matches_the_two_processes(model):
    _, physics, state = model
    plan = _pair_plan(physics._processes)
    _, ke, sa, fuser = next(e for e in plan if e[0] == "pair")
    diags, stepped = fuser(ke, sa, state, timedelta(seconds=DT))
    # the two processes one after the other, each through its generic RK2
    d1, s1 = ke(state, DT)
    mid = dict(state)
    mid.update(d1)
    mid.update(s1)
    d2, s2 = sa(mid, DT)
    ref = dict(s1)
    ref.update(s2)
    names = ["mass_fraction_of_water_vapor_in_air", "mass_fraction_of_cloud_liquid_water_in_air",
             "mass_fraction_of_precipitation_water_in_air"]
    _assert_close(stepped, ref, names)
    _assert_close(diags, d2, ["tendency_of_air_potential_temperature"])


def test_precipitation_uses_the_recomputed_fall_velocity(model):
    """[fall velocity, precipitation] without a scheme: the fall velocity is
    recomputed from the state the coupling is given, then read."""
    _, physics, state = model
    coupling = physics.components[-1]
    assert isinstance(coupling, ConcurrentCoupling)
    _, diags = coupling(state, DT)
    fv = coupling.components[0](state)["raindrop_fall_velocity"].data
    rho = state["air_density"].data
    qr = state["mass_fraction_of_precipitation_water_in_air"].data
    expected = 3.6e6 * rho[:, :, -1:] * qr[:, :, -1:] * fv[:, :, -1:] / 1000.0
    assert diags["precipitation"].data.shape == (17, 17, 1)
    torch.testing.assert_close(diags["precipitation"].data, expected, rtol=1e-14, atol=0)
    acc = state["accumulated_precipitation"].data + DT * expected / 3.6e3
    torch.testing.assert_close(diags["accumulated_precipitation"].data, acc, rtol=1e-14, atol=0)


def test_forward_euler_is_one_stage(model):
    _, physics, state = model
    turb = _find(physics, IsentropicSmagorinsky).coupling.components[0]
    fe = TendencyStepper.factory("forward_euler", turb)
    k, _ = fe.coupling(state, DT)
    _, out = fe(state, DT)
    for n in fe.output_properties:
        torch.testing.assert_close(out[n].data, state[n].data + DT * k[n].data, rtol=0, atol=0)


def test_enforced_boundary_steps_stage_by_stage(model):
    """With the lateral boundary enforced between stages the fused operation
    is not taken: each RK2 stage is enforced, and the output is pinned to the
    reference state where the relaxation coefficient is 1."""
    _, physics, state = model
    turb = _find(physics, IsentropicSmagorinsky).coupling.components[0]
    stepper = TendencyStepper.factory("rk2", turb, enforce_horizontal_boundary=True)
    hb = turb.horizontal_boundary
    with mock.patch.object(turb, "fused_rk_step") as fused:
        _, out = stepper(state, DT)
    fused.assert_not_called()

    def enforced_stage(at, c):
        k, _ = turb(at, DT)
        return {n: FieldArray(hb.enforce_field(state[n].data + c * k[n].data, n, state[n].units),
                              state[n].units, state[n].dims) for n in k}

    stage1 = dict(state)
    stage1.update(enforced_stage(state, 0.5 * DT))
    expected = enforced_stage(stage1, DT)
    nx, ny = state["air_isentropic_density"].shape[:2]
    pinned = hb.gamma[:nx, :ny] == 1.0
    for n in stepper.output_properties:
        torch.testing.assert_close(out[n].data, expected[n].data, rtol=1e-14, atol=0)
        assert torch.equal(out[n].data[pinned], hb.ref_field(n, out[n].units)[pinned]), n


def test_run_needs_the_namelist_device():
    """The namelist names the GPU; without one, ``run`` raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drv.run(load_namelist(nx=17, ny=17, nz=8, niter=1), verbose=False)
