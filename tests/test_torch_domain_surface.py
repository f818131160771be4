"""The rest of the port's domain against the JAX package's, on the CPU in
float64: the Schaer mountain, the relaxed boundary of a grid one cell deep
in x (``nx == 1``), the terrain-following grids and the storage utilities,
each on seeded numpy inputs; and the SUS chain on a y-z slice and over the
Schaer mountain.

* The topography, the boundary and the grids are host numpy with the same
  recurrences in both packages, or the same selects on tensors: bitwise.
* The SUS chain, 1 + 2 steps from relative humidity 1.05 (the warm-up step
  at zero mountain height, as the drivers run it), on a 1x17x8 y-z slice
  (numerically 7x17x8, the flagship's wind along y) and on a 17x17x8 grid
  over the Schaer mountain, the port's plain path against the JAX chain
  under ``"pallas:interpret"``: every field within ``TOL`` of its largest
  magnitude (the packages sum in different orders).
* The port's y-z run against its x-z run (``ny == 1``, the wind along x)
  with x and y swapped: within ``MIRROR_TOL``.  The JAX package's own two
  runs agree within 5e-14 at float64 (``"jax"`` backend).
"""

from __future__ import annotations

from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state, build_model
from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.domain.grids import GalChen3d as JaxGalChen3d
from tasmania_tpu.domain.grids import SLEVE3d as JaxSLEVE3d
from tasmania_tpu.domain.grids import Sigma3d as JaxSigma3d
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu.utils.storage import deepcopy_state as jax_deepcopy_state
from tasmania_tpu.utils.storage import get_numerical_state as jax_get_numerical_state
from tasmania_tpu.utils.storage import get_physical_state as jax_get_physical_state
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.domain.grids import GalChen3d, Sigma3d, SLEVE3d
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy
from tasmania_tpu_torch.utils.array import to_numpy
from tasmania_tpu_torch.utils.storage import deepcopy_state, get_numerical_state, get_physical_state
from tests.test_torch_flagship import assert_fields_agree

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
TOL = 1e-11
MIRROR_TOL = 1e-12
THETA = (np.array([400.0, 280.0]), "K")
# the namelist's mountain dimensions, and a growth time
TOPO = {"max_height": (0.5, "km"), "width_x": (50.0, "km"), "width_y": (50.0, "km")}


def topo_kwargs(field_array, time=None, smooth=False, **extra):
    out = {k: field_array(np.asarray(v), u, ()) for k, (v, u) in TOPO.items()}
    out.update(extra, smooth=smooth)
    if time is not None:
        out["time"] = time
    return out


def domains(nx, ny, topography="schaer", time=None, smooth=False, nb=3, nr=6, boundary="relaxed", nz=8):
    """The same domain in both packages (the port's on the CPU)."""
    kw = dict(horizontal_boundary_type=boundary, nb=nb,
              horizontal_boundary_kwargs={"nr": nr} if boundary == "relaxed" else {},
              topography_type=topography)
    jd = JaxDomain((-176e3, 176e3), nx, (-150e3, 150e3), ny, JaxFieldArray(*THETA, ("z",)), nz,
                   topography_kwargs=topo_kwargs(JaxFieldArray, time, smooth), **kw)
    pd = Domain((-176e3, 176e3), nx, (-150e3, 150e3), ny, FieldArray(*THETA, ("z",)), nz,
                topography_kwargs=topo_kwargs(FieldArray, time, smooth), storage_options=CPU64, **kw)
    return jd, pd


# ---------------------------------------------------------------- Schaer


@pytest.mark.parametrize("nx, ny", [(17, 19), (1, 19)])
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("growth", [None, timedelta(seconds=1800)])
def test_schaer_profile_matches(nx, ny, smooth, growth):
    """The steady profile and the grown one, on the physical and the
    numerical grid, before and while it grows, bit for bit."""
    jd, pd = domains(nx, ny, time=growth, smooth=smooth)
    for t in (None, timedelta(seconds=600), timedelta(seconds=3600)):
        if t is not None:
            jd.update_topography(t)
            pd.update_topography(t)
        for which in ("physical_grid", "numerical_grid"):
            jt, pt = getattr(jd, which).topography, getattr(pd, which).topography
            for attr in ("steady_profile", "profile"):
                np.testing.assert_array_equal(np.asarray(getattr(pt, attr).data),
                                              np.asarray(getattr(jt, attr).data), err_msg=f"{which} {attr}")
    assert pd.physical_grid.topography.type == "schaer"
    steady = np.asarray(pd.physical_grid.topography.steady_profile.data)
    assert 0.0 < steady.max() <= 500.0


def test_schaer_defaults_match():
    """No keyword: 500 m, widths of 1 in the grid's units, the centre at
    mid-domain."""
    jd = JaxDomain((0.0, 10.0), 11, (0.0, 8.0), 9, JaxFieldArray(*THETA, ("z",)), 4,
                   horizontal_boundary_type="identity", nb=1, topography_type="schaer")
    pd = Domain((0.0, 10.0), 11, (0.0, 8.0), 9, FieldArray(*THETA, ("z",)), 4,
                horizontal_boundary_type="identity", nb=1, topography_type="schaer", storage_options=CPU64)
    got = np.asarray(pd.physical_grid.topography.steady_profile.data)
    np.testing.assert_array_equal(got, np.asarray(jd.physical_grid.topography.steady_profile.data))
    assert got[5, 4] == 500.0 and got[6, 4] == pytest.approx(500.0 / 2.0**1.5)


# ---------------------------------------------------------------- nx == 1


@pytest.mark.parametrize("nb, nr", [(3, 6), (2, 8), (3, 3)])
def test_yz_relaxed_boundary_matches(nb, nr):
    """γ, the numerical axes, enforcement and the outermost layers of every
    staggering, the numerical and physical fields (host arrays and
    tensors), bit for bit; the x-frame repeats column nb."""
    jd, pd = domains(1, 19, nb=nb, nr=nr, nz=6)
    jhb, hb = jd.horizontal_boundary, pd.horizontal_boundary
    ni = 2 * nb + 1
    assert (hb.ni, hb.nj) == (jhb.ni, jhb.nj) == (ni, 19)
    assert hb.one_dy and not hb.one_dx
    np.testing.assert_array_equal(hb.gamma.numpy(), jhb._gamma)
    jg, g = jd.numerical_grid, pd.numerical_grid
    assert (g.nx, g.ny, g.nz) == (jg.nx, jg.ny, jg.nz)
    for axis in ("x", "y", "x_at_u_locations", "y_at_v_locations", "dx", "dy"):
        np.testing.assert_array_equal(np.asarray(getattr(g, axis).data), np.asarray(getattr(jg, axis).data),
                                      err_msg=axis)
    rng = np.random.default_rng(17)
    cases = {
        "air_isentropic_density": ("kg m^-2 K^-1", (ni, 19, 6)),
        "y_momentum_isentropic": ("kg m^-1 K^-1 s^-1", (ni, 19, 6)),
        "x_velocity_at_u_locations": ("m s^-1", (ni + 1, 19, 6)),
        "y_velocity_at_v_locations": ("km hr^-1", (ni, 20, 6)),
        "air_pressure_on_interface_levels": ("Pa", (ni, 19, 7)),
    }
    ref_units = {"y_velocity_at_v_locations": "m s^-1"}
    jref = {n: JaxFieldArray(rng.normal(size=shape), ref_units.get(n, u), ()) for n, (u, shape) in cases.items()}
    jhb.reference_state = jref
    hb.reference_state = {n: FieldArray(torch.as_tensor(np.asarray(fa.data)), fa.units, ())
                          for n, fa in jref.items()}
    for name, (units, shape) in cases.items():
        field = rng.normal(size=shape)
        got = hb.enforce_field(torch.as_tensor(field), name, units).numpy()
        np.testing.assert_array_equal(got, np.asarray(jhb.enforce_field(field, name, units)), err_msg=name)
        mi = shape[0]
        np.testing.assert_array_equal(got[:nb], np.repeat(got[nb : nb + 1], nb, axis=0), err_msg=name)
        np.testing.assert_array_equal(got[mi - nb :], np.repeat(got[mi - nb - 1 : mi - nb], nb, axis=0),
                                      err_msg=name)
        for layers in ("set_outermost_layers_x", "set_outermost_layers_y"):
            np.testing.assert_array_equal(
                getattr(hb, layers)(torch.as_tensor(field), name, units).numpy(),
                np.asarray(getattr(jhb, layers)(field, name, units)), err_msg=f"{name} {layers}",
            )
    plane = rng.normal(size=(1, 19, 4))
    padded = hb.get_numerical_field(plane)
    np.testing.assert_array_equal(padded, np.asarray(jhb.get_numerical_field(plane)))
    assert padded.flags["C_CONTIGUOUS"]
    tpadded = hb.get_numerical_field(torch.as_tensor(plane))
    np.testing.assert_array_equal(tpadded.numpy(), padded)
    np.testing.assert_array_equal(hb.get_physical_field(padded), plane)
    np.testing.assert_array_equal(hb.get_physical_field(tpadded).numpy(), plane)


def test_yz_relaxed_boundary_checks_nr():
    """nr may not exceed ny / 2 on a y-z slice, as in the JAX package."""
    with pytest.raises(AssertionError):
        domains(1, 9, nr=6)[0]
    with pytest.raises(ValueError, match="ny/2"):
        Domain((0.0, 1.0), 1, (0.0, 8.0), 9, FieldArray(*THETA, ("z",)), 4, horizontal_boundary_type="relaxed",
               nb=3, horizontal_boundary_kwargs={"nr": 6}, storage_options=CPU64)


# ---------------------------------------------------------------- grids

GRIDS = {"sigma": (JaxSigma3d, Sigma3d, (np.array([0.2, 1.0]), "1"), {}),
         "gal_chen": (JaxGalChen3d, GalChen3d, (np.array([10000.0, 0.0]), "m"), {}),
         "sleve": (JaxSLEVE3d, SLEVE3d, (np.array([10000.0, 0.0]), "m"), {"niter": 5, "s1": 7e3})}


@pytest.mark.parametrize("topography", ["schaer", "gaussian"])
@pytest.mark.parametrize("kind", list(GRIDS))
def test_vertical_coordinate_grid_matches(kind, topography):
    """The heights and reference pressures on the levels and their
    interfaces, bit for bit, at once and after ``update_topography`` with
    the mountain growing; the port's fields are tensors on the storage
    device."""
    jcls, cls, (zv, zu), kw = GRIDS[kind]
    common = dict(topography_type=topography, **kw)
    jg = jcls((-5e4, 5e4), 11, (-4e4, 4e4), 9, JaxFieldArray(zv, zu, ("z",)), 12,
              topography_kwargs=topo_kwargs(JaxFieldArray, timedelta(seconds=100), width_x=JaxFieldArray(
                  np.asarray(2e4), "m", ())), **common)
    g = cls((-5e4, 5e4), 11, (-4e4, 4e4), 9, FieldArray(zv, zu, ("z",)), 12,
            topography_kwargs=topo_kwargs(FieldArray, timedelta(seconds=100), width_x=FieldArray(
                np.asarray(2e4), "m", ())), storage_options=CPU64, **common)
    names = ("height", "height_on_interface_levels", "reference_pressure",
             "reference_pressure_on_interface_levels")
    for t in (None, timedelta(seconds=50), timedelta(seconds=200)):
        if t is not None:
            jg.update_topography(t)
            g.update_topography(t)
        for name in names:
            got, ref = getattr(g, name), getattr(jg, name)
            assert isinstance(got.data, torch.Tensor) and got.data.dtype == torch.float64, name
            assert (got.units, got.dims) == (ref.units, ref.dims), name
            np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data), err_msg=f"{name} at {t}")
    if kind != "sigma":  # a height-based coordinate follows the terrain at the surface
        np.testing.assert_allclose(g.height_on_interface_levels.data.numpy()[:, :, -1],
                                   np.asarray(g.topography.profile.data), rtol=0, atol=1e-8)


def test_sigma_grid_checks_its_coordinate():
    with pytest.raises(AssertionError):
        Sigma3d((0.0, 1e5), 5, (0.0, 1e5), 5, FieldArray(np.array([0.2, 0.9]), "1", ("z",)), 4,
                storage_options=CPU64)


# ---------------------------------------------------------------- storage


@pytest.mark.parametrize("nx, ny, boundary", [(1, 19, "relaxed"), (17, 1, "relaxed"), (17, 19, "periodic")])
def test_storage_utilities_match(nx, ny, boundary):
    """``get_numerical_state``, ``get_physical_state`` and ``deepcopy_state``
    on a seeded physical state, against the JAX package's, bit for bit; the
    copy owns its tensors."""
    jd, pd = domains(nx, ny, boundary=boundary, nz=5)
    rng = np.random.default_rng(nx + ny)
    shapes = {"air_isentropic_density": (nx, ny, 5), "x_velocity_at_u_locations": (nx + 1, ny, 5),
              "y_velocity_at_v_locations": (nx, ny + 1, 5)}
    arrays = {n: rng.normal(size=s) for n, s in shapes.items()}
    jstate = {n: JaxFieldArray(a, "1", ()) for n, a in arrays.items()}
    jstate["time"] = 7
    state = {n: FieldArray(torch.as_tensor(a), "1", ()) for n, a in arrays.items()}
    state["time"] = 7
    jnum, num = jax_get_numerical_state(jd, jstate), get_numerical_state(pd, state)
    for name in arrays:
        np.testing.assert_array_equal(to_numpy(num[name].data), np.asarray(jnum[name].data), err_msg=name)
    back, jback = get_physical_state(pd, num), jax_get_physical_state(jd, jnum)
    for name in arrays:
        np.testing.assert_array_equal(to_numpy(back[name].data), np.asarray(jback[name].data), err_msg=name)
        np.testing.assert_array_equal(to_numpy(back[name].data), arrays[name], err_msg=name)
    assert back["time"] == num["time"] == 7
    copy, jcopy = deepcopy_state(num), jax_deepcopy_state(jnum)
    for name in arrays:
        np.testing.assert_array_equal(copy[name].data.numpy(), np.asarray(jcopy[name].data))
        assert copy[name].data.data_ptr() != num[name].data.data_ptr()
    copy["air_isentropic_density"].data.zero_()
    assert num["air_isentropic_density"].data.abs().max() > 0.0


# ---------------------------------------------------------------- SUS chain

NSTEPS = 2
VELOCITIES = ("x_velocity", "y_velocity")
CASES = {
    "yz": {"nx": 1, "ny": 17, "nz": 8, "x_velocity": 0.0, "y_velocity": 22.5},
    "schaer": {"nx": 17, "ny": 17, "nz": 8, "topo_type": "schaer"},
}


def namelist(values, field_array):
    """Overrides with the velocities (m s^-1) as ``field_array`` scalars."""
    return {k: field_array(np.asarray(v), "m s^-1", ()) if k in VELOCITIES else v for k, v in values.items()}


def run_jax(values, backend="pallas:interpret"):
    import jax.numpy as jnp

    nl = SimpleNamespace(**{**{k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")},
                            **namelist(values, JaxFieldArray), "relative_humidity": 1.05,
                            "backend": backend, "so": JaxStorageOptions(dtype=np.float64)})
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    fields = {k: state[k] for k in names}
    for i in range(-1, NSTEPS):
        fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
        st = {**fields, "topography_height": JaxFieldArray(fact * hs, "m", ("x", "y"))}
        st = physics(dycore(st, {}, dt_s), dt_s)
        fields = {k: st[k] for k in names}
    return {k: np.asarray(v.data) for k, v in fields.items()}


def run_port(values):
    nl = load_namelist(**namelist(values, FieldArray), relative_humidity=1.05, niter=NSTEPS, so=CPU64)
    res = port_driver.run(nl, verbose=False)
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.mark.parametrize("case", list(CASES))
def test_sus_chain_matches_pallas_interpret(case):
    """1 + 2 steps of the whole chain; on the y-z slice no x-momentum forms,
    and the port's path takes the generic stage."""
    got = run_port(CASES[case])
    assert_fields_agree(got, run_jax(CASES[case]), TOL)
    if case == "yz":
        assert not np.any(got["x_momentum_isentropic"]) and not np.any(got["x_velocity_at_u_locations"])


def test_yz_run_mirrors_the_xz_run():
    """The y-z slice with the wind along y against the x-z slice with the
    wind along x, x and y swapped (the momenta and the staggered velocities
    with them)."""
    yz = run_port(CASES["yz"])
    xz = run_port({"nx": 17, "ny": 1, "nz": 8, "x_velocity": 22.5, "y_velocity": 0.0})
    swap = {"x_momentum_isentropic": "y_momentum_isentropic", "y_momentum_isentropic": "x_momentum_isentropic",
            "x_velocity_at_u_locations": "y_velocity_at_v_locations",
            "y_velocity_at_v_locations": "x_velocity_at_u_locations"}
    assert_fields_agree(yz, {k: np.swapaxes(xz[swap.get(k, k)], 0, 1) for k in xz}, MIRROR_TOL)
