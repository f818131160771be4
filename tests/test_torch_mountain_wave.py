"""The port's dry mountain-wave core (BASELINE config 3) against the JAX
package, on the CPU in float64.

* Three steps of ``tasmania_tpu_torch/drivers/driver_mountain_wave.py`` at
  41x1x20 (damping depth 8) against the JAX dycore and Montgomery refresh of
  ``drivers/driver_mountain_wave.py``'s ``run_case``, under the ``"jax"``
  backend and under ``"pallas:interpret"`` (its unfused stage then runs
  ``fused_advection_fields`` at third order, ``fused_momentum_step`` and
  ``fused_isentropic_diagnostics`` in interpret mode), and with a growing
  mountain.  Tolerance: every field within 1e-10 of its largest magnitude
  (the packages sum the column scans in different orders).
* The one-dimensional relaxed boundary (``ny == 1``): the numerical axes,
  γ, the padded fields, ``enforce_field`` with its y-frame copy and the
  outermost layers, against the JAX ``Relaxed``, to rounding.
* The user-defined topography, the initial state on the ``ny == 1`` grid
  (and its round trip through ``interop.py``) and the analytic solution
  against the JAX package's.
* A ``slow`` test: the shallow analytic gate of
  ``tests/test_mountain_wave_validation.py:36-112`` (81x1x60, 5 h at dt
  20 s) on the port's CPU path, with its thresholds.
"""

from __future__ import annotations

import functools
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.isentropic import (
    IsentropicDynamicalCore as JaxDycore,
    get_isentropic_state_from_brunt_vaisala_frequency as jax_state,
)
from tasmania_tpu.isentropic.dynamics.diagnostics import IsentropicDiagnostics as JaxDynDiag
from tasmania_tpu.utils.meteo import (
    get_isothermal_isentropic_analytical_solution as jax_analytic,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_from_numpy, state_to_numpy
from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tasmania_tpu_torch.isentropic.state import get_isentropic_state_from_brunt_vaisala_frequency
from tasmania_tpu_torch.utils.exceptions import FactoryRegistryError
from tasmania_tpu_torch.utils.meteo import get_isothermal_isentropic_analytical_solution
from tests.test_torch_flagship import assert_fields_agree

NX, NZ, DAMP_DEPTH = 41, 20, 8
DT, NSTEPS = 20.0, 3
TOL = 1e-10
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
DIMS = ("x", "y", "z")


def profile(x, y):
    return mw.H_MOUNTAIN * mw.A_HALF**2 / (x**2 + mw.A_HALF**2)


def jax_build(nx, nz, growth_hours=0.0, backend="jax", theta_top=360.0):
    """The JAX ``run_case``'s domain, state, dycore and diagnostics
    (``drivers/driver_mountain_wave.py:49-92``) on ``backend``."""
    topo = {"profile": profile}
    if growth_hours > 0.0:
        topo["time"] = timedelta(hours=growth_hours)
    domain = JaxDomain(
        (-2e5, 2e5), nx, (0.0, 1.0), 1, JaxFieldArray(np.array([theta_top, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
        topography_type="user_defined", topography_kwargs=topo, backend=backend,
    )
    cgrid = domain.numerical_grid
    state = jax_state(
        cgrid, datetime(2000, 1, 1), JaxFieldArray(np.asarray(mw.U0), "m s^-1", ()),
        JaxFieldArray(np.asarray(0.0), "m s^-1", ()),
        JaxFieldArray(np.asarray(mw.G0 / np.sqrt(mw.CP * mw.T0)), "s^-1", ()),
    )
    domain.horizontal_boundary.reference_state = state
    return domain, state


@functools.lru_cache(maxsize=None)
def run_jax(backend, growth_hours):
    """NSTEPS steps of the JAX ``run_case``'s step (``:98-106``), every field."""
    import jax
    import jax.numpy as jnp

    domain, state = jax_build(NX, NZ, growth_hours, backend)
    cgrid = domain.numerical_grid
    pt = float(np.asarray(state["air_pressure_on_interface_levels"].data)[0, 0, 0])
    core = JaxDycore(
        domain, moist=False, time_integration_scheme="rk3ws_si",
        horizontal_flux_scheme="third_order_upwind",
        time_integration_properties={"pt": pt, "eps": 0.5},
        damp=True, damp_depth=DAMP_DEPTH, damp_max=5e-4, damp_at_every_stage=False,
        smooth=False, backend=backend,
    )
    dd = JaxDynDiag(cgrid, backend=backend)
    names = sorted(k for k in state if k != "time")
    hs_steady = jnp.asarray(np.asarray(cgrid.topography.steady_profile.to_units("m").data))

    @jax.jit
    def step(fields, hs):
        st = {k: JaxFieldArray(v, state[k].units, state[k].dims) for k, v in fields.items()}
        st["topography_height"] = JaxFieldArray(hs, "m", ("x", "y"))
        st = core(st, {}, DT)
        mtg = dd.get_montgomery_potential(st["air_isentropic_density"].data, pt, hs=hs)
        st["montgomery_potential"] = st["montgomery_potential"].with_data(mtg)
        return {k: st[k].data for k in names}

    growth_s = growth_hours * 3600.0
    fields = {k: state[k].data for k in names}
    for i in range(NSTEPS):
        fact = min((i + 1) * DT / growth_s, 1.0) if growth_s > 0.0 else 1.0
        fields = step(fields, fact * hs_steady)
    return {k: np.asarray(v) for k, v in fields.items()}


def run_port(growth_hours):
    res = mw.run_case(NX, NZ, NSTEPS * DT / 3600.0, DT, growth_hours, damp_depth=DAMP_DEPTH,
                      so=CPU64, verbose=False)
    assert res["steps"] == NSTEPS
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.mark.parametrize("backend,growth_hours", [
    ("jax", 0.0), ("pallas:interpret", 0.0), ("jax", 0.01),
])
def test_mountain_wave_three_steps_agree(backend, growth_hours):
    ref = run_jax(backend, growth_hours)
    got = run_port(growth_hours)
    # the wave has started: u departs from the uniform 10 m/s
    assert np.abs(ref["x_velocity_at_u_locations"] - mw.U0).max() > 1e-4
    assert_fields_agree(got, ref, TOL)
    # every y row of the numerical grid carries the physical row
    for name, a in got.items():
        if a.ndim == 3 and name != "y_velocity_at_v_locations":
            np.testing.assert_array_equal(a, np.repeat(a[:, 3:4], a.shape[1], axis=1), err_msg=name)


def _both_boundaries(nx=23, nz=6):
    """The port's and the JAX package's ``ny == 1`` domains and states."""
    jdomain, jstate = jax_build(nx, nz)
    domain = Domain(
        (-2e5, 2e5), nx, (0.0, 1.0), 1, FieldArray(np.array([360.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
        topography_type="user_defined", topography_kwargs={"profile": profile}, storage_options=CPU64,
    )
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        domain.numerical_grid, datetime(2000, 1, 1), FieldArray(np.asarray(mw.U0), "m s^-1", ()),
        FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(mw.G0 / np.sqrt(mw.CP * mw.T0)), "s^-1", ()), storage_options=CPU64,
    )
    domain.horizontal_boundary.reference_state = state
    return (jdomain, jstate), (domain, state)


def test_one_dimensional_relaxed_boundary_matches_jax():
    (jdomain, _), (domain, _) = _both_boundaries()
    jhb, hb = jdomain.horizontal_boundary, domain.horizontal_boundary
    assert (hb.ni, hb.nj) == (jhb.ni, jhb.nj) == (23, 7)
    np.testing.assert_array_equal(hb.gamma.numpy(), jhb._gamma)
    jg, g = jdomain.numerical_grid, domain.numerical_grid
    assert (g.nx, g.ny) == (jg.nx, jg.ny)
    for axis in ("x", "y", "x_at_u_locations", "y_at_v_locations", "dx", "dy"):
        np.testing.assert_array_equal(np.asarray(getattr(g, axis).data),
                                      np.asarray(getattr(jg, axis).data), err_msg=axis)
    rng = np.random.default_rng(3)
    cases = {
        "air_isentropic_density": ("kg m^-2 K^-1", (23, 7, 6)),
        "x_momentum_isentropic": ("kg m^-1 K^-1 s^-1", (23, 7, 6)),
        "x_velocity_at_u_locations": ("m s^-1", (24, 7, 6)),
        "y_velocity_at_v_locations": ("m s^-1", (23, 8, 6)),
    }
    for name, (units, shape) in cases.items():
        field = rng.normal(size=shape)
        ref = np.asarray(jhb.enforce_field(field, name, units))
        got = hb.enforce_field(torch.as_tensor(field), name, units).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0, err_msg=name)
        # the y-frame repeats row nb, and its mirror
        np.testing.assert_array_equal(got[:, :3], np.repeat(got[:, 3:4], 3, axis=1), err_msg=name)
        for layers in ("set_outermost_layers_x", "set_outermost_layers_y"):
            np.testing.assert_array_equal(
                getattr(hb, layers)(torch.as_tensor(field), name, units).numpy(),
                np.asarray(getattr(jhb, layers)(field, name, units)), err_msg=f"{name} {layers}",
            )
    plane = rng.normal(size=(23, 1))
    padded = hb.get_numerical_field(plane)
    np.testing.assert_array_equal(padded, jhb.get_numerical_field(plane))
    assert padded.flags["C_CONTIGUOUS"]


def test_user_defined_topography_matches_jax():
    for growth in (None, timedelta(hours=1)):
        topo = {"profile": profile} if growth is None else {"profile": profile, "time": growth}
        jd = JaxDomain((-2e5, 2e5), 23, (0.0, 1.0), 1, JaxFieldArray(np.array([360.0, 300.0]), "K", ("z",)),
                       6, horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
                       topography_type="user_defined", topography_kwargs=topo)
        d = Domain((-2e5, 2e5), 23, (0.0, 1.0), 1, FieldArray(np.array([360.0, 300.0]), "K", ("z",)), 6,
                   horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
                   topography_type="user_defined", topography_kwargs=topo, storage_options=CPU64)
        for grid, jgrid in ((d.physical_grid, jd.physical_grid), (d.numerical_grid, jd.numerical_grid)):
            for attr in ("steady_profile", "profile"):
                np.testing.assert_array_equal(np.asarray(getattr(grid.topography, attr).data),
                                              np.asarray(getattr(jgrid.topography, attr).data))
        assert float(np.asarray(d.numerical_grid.topography.steady_profile.data).max()) == pytest.approx(1.0)
        d.update_topography(timedelta(minutes=30))
        jd.update_topography(timedelta(minutes=30))
        np.testing.assert_array_equal(np.asarray(d.numerical_grid.topography.profile.data),
                                      np.asarray(jd.numerical_grid.topography.profile.data))
    # an array profile, as the JAX package takes it
    arr = np.linspace(0.0, 2.0, 23)[:, None]
    d = Domain((0.0, 1e5), 23, (0.0, 1.0), 1, FieldArray(np.array([360.0, 300.0]), "K", ("z",)), 6,
               horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
               topography_type="user_defined", topography_kwargs={"profile": arr}, storage_options=CPU64)
    np.testing.assert_array_equal(np.asarray(d.physical_grid.topography.steady_profile.data), arr)


def test_dry_state_on_the_one_dimensional_grid_matches_jax():
    (_, jstate), (_, state) = _both_boundaries()
    names = sorted(k for k in jstate if k != "time")
    assert names == sorted(k for k in state if k != "time")
    for name in names:
        np.testing.assert_allclose(state[name].data.numpy(), np.asarray(jstate[name].data),
                                   rtol=1e-13, atol=0, err_msg=name)
    back = state_from_numpy(state_to_numpy(state), device="cpu", dtype=torch.float64)
    for name in names:
        assert back[name].units == state[name].units and back[name].dims == state[name].dims
        torch.testing.assert_close(back[name].data, state[name].data, rtol=0, atol=0)


@pytest.mark.parametrize("x_staggered,z_staggered", [(True, False), (False, True)])
def test_analytic_solution_matches_jax(x_staggered, z_staggered):
    (jdomain, _), (domain, _) = _both_boundaries(nx=41, nz=20)
    args = (FieldArray(np.asarray(mw.U0), "m s^-1", ()), FieldArray(np.asarray(mw.T0), "K", ()),
            FieldArray(np.asarray(1.0), "m", ()), FieldArray(np.asarray(1e4), "m", ()))
    jargs = tuple(JaxFieldArray(np.asarray(a.data), a.units, ()) for a in args)
    got = get_isothermal_isentropic_analytical_solution(domain.physical_grid, *args, x_staggered, z_staggered)
    ref = jax_analytic(jdomain.physical_grid, *jargs, x_staggered, z_staggered)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-14, atol=0)
    assert got[0].shape == (42 if x_staggered else 41, 1, 21 if z_staggered else 20)


def test_unported_paths_raise():
    """What the port leaves out raises: the ``centered_si`` stub (a stub in
    the reference too); so does a flux scheme the reference does not have.
    What it has ported since builds: the relaxed boundary of a grid one cell
    deep in x (numerically 2 nb + 1 columns, on the generic stage as the
    JAX package routes it), the moist stage on a one-dimensional boundary,
    third and first orders there and on a two-dimensional relaxed grid, and
    tendencies on the generic stage."""
    (_, _), (domain, _) = _both_boundaries()
    yz = Domain((0.0, 1.0), 1, (-2e5, 2e5), 23, FieldArray(np.array([360.0, 300.0]), "K", ("z",)), 6,
                horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
                storage_options=CPU64)
    assert (yz.horizontal_boundary.ni, yz.horizontal_boundary.nj) == (7, 23)
    assert not IsentropicDynamicalCore(yz, horizontal_flux_scheme="third_order_upwind",
                                       storage_options=CPU64).prognostic.fused
    with pytest.raises(NotImplementedError, match="stub"):
        IsentropicDynamicalCore(domain, time_integration_scheme="centered_si", storage_options=CPU64).stages
    with pytest.raises(FactoryRegistryError, match="unknown"):
        IsentropicDynamicalCore(domain, horizontal_flux_scheme="maccormack", storage_options=CPU64)
    two_d = Domain((0.0, 1e5), 17, (0.0, 1e5), 17, FieldArray(np.array([360.0, 300.0]), "K", ("z",)), 6,
                   horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
                   storage_options=CPU64)
    assert not IsentropicDynamicalCore(domain, moist=True, horizontal_flux_scheme="third_order_upwind",
                                       storage_options=CPU64).prognostic.fused
    assert IsentropicDynamicalCore(two_d, horizontal_flux_scheme="third_order_upwind",
                                   storage_options=CPU64).prognostic.fused
    assert not IsentropicDynamicalCore(domain, horizontal_flux_scheme="upwind",
                                       storage_options=CPU64).prognostic.fused
    # the generic stage takes tendencies
    _, state, core, _, _ = mw.build(17, 20, so=CPU64)
    s = state["air_isentropic_density"]
    tendency = FieldArray(torch.full_like(s.data, 1e-4), "kg m^-2 K^-1 s^-1", DIMS)
    out = core(state, {"air_isentropic_density": tendency}, 20.0)
    assert bool(torch.isfinite(out["air_isentropic_density"].data).all())


def test_driver_requires_a_gpu_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mw.run_case(17, 8, 20.0 / 3600.0, 20.0, verbose=False)


@pytest.mark.slow
def test_shallow_analytic_gate_on_the_port():
    """``tests/test_mountain_wave_validation.py::test_linear_mountain_wave_matches_analytic_solution``
    on the port: 81x1x60, 5 h at dt 20 s, damping depth 12, its thresholds."""
    res = mw.run_case(81, 60, 5.0, 20.0, damp_depth=12, so=CPU64, verbose=False)
    u_num = res["fields"]["x_velocity_at_u_locations"].data.numpy()[:, 3, :]
    domain = mw.build(81, 60, damp_depth=12, so=CPU64)[0]
    du_num = u_num - mw.U0
    du_an = mw.analytic_u(domain) - mw.U0
    sl = (slice(10, -10), slice(15, None))
    corr = np.corrcoef(du_num[sl].ravel(), du_an[sl].ravel())[0, 1]
    amp = np.abs(du_num[sl]).max() / np.abs(du_an[sl]).max()
    assert corr > 0.6, f"wave-pattern correlation too low: {corr}"
    assert 0.5 < amp < 1.2, f"wave amplitude ratio off: {amp}"
    xs = np.asarray(domain.physical_grid.x_at_u_locations.data)
    m = np.abs(xs) <= 6.0 * mw.A_HALF
    corr_f = np.corrcoef(du_num[m, 15:].ravel(), du_an[m, 15:].ravel())[0, 1]
    assert corr_f > 0.85, f"focused wave-pattern correlation too low: {corr_f}"
