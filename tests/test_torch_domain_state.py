"""The port's domain, initial state and constant fields against the JAX
package's, at small size, in float64.  All of it is host-side numpy in both
packages with the same recurrences, so agreement is bitwise."""

from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.dwarfs.horizontal_diffusion import build_damped_coeff as jax_damped_coeff
from tasmania_tpu.dwarfs.vertical_damping import VerticalDamping
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.isentropic import (
    get_isentropic_state_from_brunt_vaisala_frequency as jax_state_from_bv,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.dwarfs.horizontal_smoothing import build_damped_coeff
from tasmania_tpu_torch.dwarfs.vertical_damping import Rayleigh
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.interop import state_from_numpy, state_to_numpy
from tasmania_tpu_torch.isentropic.state import (
    get_isentropic_state_from_brunt_vaisala_frequency,
)

NX, NY, NZ = 17, 19, 8


def _domains(nb=3, nr=6, time=timedelta(seconds=1800)):
    common = dict(
        horizontal_boundary_type="relaxed", nb=nb, horizontal_boundary_kwargs={"nr": nr},
        topography_type="gaussian",
    )
    km = lambda v: ("km", v)
    jax_topo = {"time": time, "smooth": False,
                **{k: JaxFieldArray(np.asarray(v), u, ()) for k, (u, v) in
                   {"max_height": km(0.5), "width_x": km(50.0), "width_y": km(50.0)}.items()}}
    port_topo = {"time": time, "smooth": False,
                 **{k: FieldArray(np.asarray(v), u, ()) for k, (u, v) in
                    {"max_height": km(0.5), "width_x": km(50.0), "width_y": km(50.0)}.items()}}
    jd = JaxDomain((-176e3, 176e3), NX, (-150e3, 150e3), NY,
                   JaxFieldArray(np.array([400.0, 280.0]), "K", ("z",)), NZ,
                   topography_kwargs=jax_topo, **common)
    pd = Domain((-176e3, 176e3), NX, (-150e3, 150e3), NY,
                FieldArray(np.array([400.0, 280.0]), "K", ("z",)), NZ,
                topography_kwargs=port_topo, **common)
    return jd, pd


def test_grid_matches():
    jd, pd = _domains()
    for which in ("physical_grid", "numerical_grid"):
        jg, pg = getattr(jd, which), getattr(pd, which)
        assert (pg.nx, pg.ny, pg.nz) == (jg.nx, jg.ny, jg.nz)
        for name in ("x", "y", "x_at_u_locations", "y_at_v_locations", "z",
                     "z_on_interface_levels", "dx", "dy", "dz"):
            a, b = getattr(pg, name), getattr(jg, name)
            assert a.units == b.units and a.dims == b.dims, name
            np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data), err_msg=name)


@pytest.mark.parametrize("seconds", [0, 1800])
def test_topography_matches(seconds):
    jd, pd = _domains(time=timedelta(seconds=seconds))
    jt, pt = jd.numerical_grid.topography, pd.numerical_grid.topography
    np.testing.assert_array_equal(pt.steady_profile.data, np.asarray(jt.steady_profile.data))
    np.testing.assert_array_equal(pt.profile.data, np.asarray(jt.profile.data))
    for t in (600, 3600):
        jd.update_topography(timedelta(seconds=t))
        pd.update_topography(timedelta(seconds=t))
        np.testing.assert_array_equal(pt.profile.data, np.asarray(jt.profile.data))


@pytest.mark.parametrize("nb,nr", [(3, 6), (3, 3), (2, 8)])
def test_relaxed_gamma_matches(nb, nr):
    jd, pd = _domains(nb=nb, nr=nr)
    np.testing.assert_array_equal(
        pd.horizontal_boundary.gamma.numpy(), jd.horizontal_boundary._gamma
    )


@pytest.mark.parametrize("depth", [0, 4, 15])
def test_rayleigh_profile_matches(depth):
    jd, pd = _domains()
    jr = VerticalDamping.factory("rayleigh", jd.numerical_grid, depth, 0.0005, "s")
    pr = Rayleigh(pd.numerical_grid, depth, 0.0005)
    ref = np.asarray(jr._rmat[False][0, 0, :])
    np.testing.assert_array_equal(pr.rmat.numpy(), ref)
    nz = np.nonzero(ref)[0]
    assert pr.dd == (int(nz[-1]) + 1 if nz.size else 0)


@pytest.mark.parametrize("coeff,cmax,depth", [(1.0, 1.0, 0), (0.03, 0.24, 5)])
def test_smoothing_profile_matches(coeff, cmax, depth):
    np.testing.assert_array_equal(
        build_damped_coeff(NZ, coeff, cmax, depth, np.float64),
        jax_damped_coeff(NZ, coeff, cmax, depth, np.float64)[0, 0],
    )


def _states():
    jd, pd = _domains(time=timedelta(seconds=0))
    args = (datetime(1992, 2, 20),)
    jax_state = jax_state_from_bv(
        jd.numerical_grid, *args,
        JaxFieldArray(np.asarray(22.5), "m s^-1", ()), JaxFieldArray(np.asarray(1.5), "m s^-1", ()),
        JaxFieldArray(np.asarray(0.015), "s^-1", ()),
        moist=True, precipitation=True, relative_humidity=0.95,
    )
    port_state = get_isentropic_state_from_brunt_vaisala_frequency(
        pd.numerical_grid, *args,
        FieldArray(np.asarray(22.5), "m s^-1", ()), FieldArray(np.asarray(1.5), "m s^-1", ()),
        FieldArray(np.asarray(0.015), "s^-1", ()),
        moist=True, precipitation=True, relative_humidity=0.95,
    )
    return jax_state, port_state


def test_initial_state_matches():
    jax_state, port_state = _states()
    assert set(port_state) == set(jax_state)
    assert port_state["time"] == jax_state["time"]
    for name, fa in jax_state.items():
        if name == "time":
            continue
        got = port_state[name]
        assert isinstance(got.data, torch.Tensor), name
        assert (got.units, got.dims) == (fa.units, fa.dims), name
        np.testing.assert_array_equal(got.data.numpy(), np.asarray(fa.data), err_msg=name)


def test_interop_round_trip():
    jax_state, _ = _states()
    arrays = {k: (np.asarray(v.data), v.units) if k != "time" else v for k, v in jax_state.items()}
    state = state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    assert state["time"] == jax_state["time"]
    back = state_to_numpy(state)
    assert set(back) == set(arrays)
    for name, entry in arrays.items():
        if name == "time":
            continue
        assert state[name].dims == jax_state[name].dims, name
        assert back[name][1] == entry[1]
        np.testing.assert_array_equal(back[name][0], entry[0], err_msg=name)


def test_interop_casts_to_dtype():
    a = np.arange(6.0).reshape(1, 2, 3)
    state = state_from_numpy({"air_isentropic_density": (a, "kg m^-2 K^-1")}, "cpu", torch.float32)
    assert state["air_isentropic_density"].data.dtype == torch.float32
    np.testing.assert_array_equal(state_to_numpy(state)["air_isentropic_density"][0], a.astype(np.float32))


def test_reference_state_buffers_move_with_the_boundary():
    _, pd = _domains()
    hb = pd.horizontal_boundary
    _, port_state = _states()
    hb.reference_state = port_state
    names = {n for n, b in hb.named_buffers()}
    assert "gamma" in names and "ref_air_isentropic_density" in names
    hb.to(torch.float32)
    assert hb.ref_field("air_isentropic_density").dtype == torch.float32
    ref_g = hb.ref_field("mass_fraction_of_water_vapor_in_air", "g kg^-1")
    np.testing.assert_allclose(
        ref_g.numpy(), 1e3 * port_state["mass_fraction_of_water_vapor_in_air"].data.numpy(),
        rtol=1e-6,
    )


@pytest.mark.parametrize("name,units", [
    ("air_isentropic_density", "kg m^-2 K^-1"),
    ("x_velocity_at_u_locations", "m s^-1"),
    ("y_velocity_at_v_locations", "km hr^-1"),
])
def test_relaxed_enforcement_matches(name, units):
    """``enforce_field`` and ``set_outermost_layers_x/y`` against the JAX
    boundary, on a perturbed field, with a unit conversion of the reference."""
    jd, pd = _domains(time=timedelta(seconds=0))
    jax_state, port_state = _states()
    jd.horizontal_boundary.reference_state = jax_state
    pd.horizontal_boundary.reference_state = port_state
    base = np.asarray(jax_state[name].to_units(units).data)
    field = base * (1.0 + 0.1 * np.random.default_rng(5).standard_normal(base.shape))
    jhb, phb = jd.horizontal_boundary, pd.horizontal_boundary
    t = torch.as_tensor(field)
    np.testing.assert_array_equal(
        phb.enforce_field(t, name, units).numpy(), np.asarray(jhb.enforce_field(field, name, units))
    )
    np.testing.assert_array_equal(
        phb.set_outermost_layers_x(t, name, units).numpy(),
        np.asarray(jhb.set_outermost_layers_x(field, name, units)),
    )
    np.testing.assert_array_equal(
        phb.set_outermost_layers_y(t, name, units).numpy(),
        np.asarray(jhb.set_outermost_layers_y(field, name, units)),
    )


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="periodic"):
        Domain((0.0, 1.0), 9, (0.0, 1.0), 9, FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 4,
               horizontal_boundary_type="periodic")
    with pytest.raises(NotImplementedError, match="schaer"):
        Domain((0.0, 1.0), 9, (0.0, 1.0), 9, FieldArray(np.array([400.0, 300.0]), "K", ("z",)), 4,
               topography_type="schaer")
