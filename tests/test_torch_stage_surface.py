"""The port's isentropic dynamical core on every boundary, flux scheme and
time integration against the JAX package, on the CPU in float64.

The dycore alone (no physics), two steps of 5 s at 17x17x8 (nb = 3), from
the drivers' initial state (``build_domain_and_state`` of both packages)
perturbed with seeded noise, with the grown mountain as the topography:

* {periodic, Dirichlet, relaxed} x {upwind, centered, third_order_upwind,
  fifth_order_upwind} x {dry, moist} under ``rk3ws_si`` against the JAX
  ``"jax"`` backend; the orders 3 and 5 also against ``"pallas:interpret"``,
  where the JAX stage reaches its kernels (the generic stage's
  ``fused_advection_fields`` and ``fused_momentum_step``; on the relaxed
  boundary the whole-stage kernel).  The port takes the fused route on the
  relaxed boundary at orders 3 and 5 and the generic stage everywhere else;
* tendencies of s, su and a mass fraction (sv's and the others' absent) on
  the generic stage (periodic, Dirichlet) and on the two-kernel stage
  (relaxed);
* ``forward_euler_si`` on each boundary;
* the moist stage on the one-dimensional relaxed boundary (17x1x8, third
  order).

The Dirichlet boundary pins its frame to the perturbed initial state (the
default core's zeros would leave s = 0 there, and the velocities 0/0).
Both packages start from the same arrays: the port's state and reference
state are the JAX package's.  Tolerance: every field within ``TOL`` of its
largest magnitude (the packages sum the Montgomery scans in different
orders).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import drivers.namelist_sus as jax_nl
from drivers.driver_namelist_sus import build_domain_and_state as jax_build_domain_and_state
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu.isentropic import IsentropicDynamicalCore as JaxDycore
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray, field_dims
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_from_numpy, state_to_numpy
from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tests.test_torch_flagship import assert_fields_agree

SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 0.95}
DT, NSTEPS, SEED = 5.0, 2, 13
TOL = 2.6e-13
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
BOUNDARIES = ("periodic", "dirichlet", "relaxed")
SCHEMES = ("upwind", "centered", "third_order_upwind", "fifth_order_upwind")
S, SU, SV = "air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic"
QV, QC, QR = (f"mass_fraction_of_{w}" for w in ("water_vapor_in_air", "cloud_liquid_water_in_air",
                                                 "precipitation_water_in_air"))
# the fields a dycore step gives, dry and moist
DRY = (S, SU, SV, "x_velocity_at_u_locations", "y_velocity_at_v_locations")
MOIST = DRY + (QV, QC, QR)
# tendencies: s, su and qv (sv's absent, so the stage takes a zero one)
TENDENCIES = {S: ("kg m^-2 K^-1 s^-1", 1e-4), SU: ("kg m^-1 K^-1 s^-2", 5e-2),
              QV: ("g g^-1 s^-1", 1e-7)}


class FrozenCore:
    """A Dirichlet core that pins the frame to given arrays (``values``:
    name -> (array, units), filled once the state exists)."""

    def __init__(self):
        self.values = {}

    def __call__(self, time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
        arr, units = self.values[field_name]
        assert field_units in (None, units), (field_name, field_units, units)
        return arr[slice_x or slice(None), slice_y or slice(None)]


def hb_kwargs(boundary, core):
    return {"periodic": {}, "dirichlet": {"core": core}, "relaxed": {"nr": 6}}[boundary]


def perturbed(state, rng):
    """The state's arrays (name -> (array, units)) with seeded noise on s,
    the momenta and the mass fractions, and cloud and rain (zero in the
    initial state) of up to 1e-4 everywhere."""
    out = {}
    for name, fa in state.items():
        if name == "time":
            continue
        arr = np.array(fa.data, dtype=np.float64)
        if name in (QC, QR):
            arr = arr + 1e-4 * rng.uniform(0.0, 1.0, arr.shape)
        if name in (S, QV, QC, QR):
            arr = arr * (1.0 + 1e-3 * rng.standard_normal(arr.shape))
        elif name in (SU, SV):
            arr = arr + 0.01 * np.abs(arr).max() * rng.standard_normal(arr.shape) + (0.5 if name == SV else 0.0)
        out[name] = (arr, fa.units)
    return out


def dycore_kwargs(moist, scheme, integration, pt):
    return dict(moist=moist, time_integration_scheme=integration, horizontal_flux_scheme=scheme,
                time_integration_properties={"pt": pt, "eps": 0.5}, damp=True, damp_depth=4,
                damp_max=0.0005, damp_at_every_stage=False)


def run_both(boundary, scheme, moist, backend, integration="rk3ws_si", tendencies=False, ny=17):
    """NSTEPS dycore steps of both packages from the same arrays: the port's
    fields, the JAX fields and the start, each name -> numpy array."""
    size = {**SIZE, "ny": ny}
    core = FrozenCore()
    values = {k: getattr(jax_nl, k) for k in dir(jax_nl) if not k.startswith("_")}
    values.update(size, backend=backend, so=JaxStorageOptions(dtype=np.float64), hb_type=boundary,
                  hb_kwargs=hb_kwargs(boundary, core))
    domain, state, pt = jax_build_domain_and_state(SimpleNamespace(**values))
    reference = {k: (np.asarray(fa.data), fa.units) for k, fa in state.items() if k != "time"}
    arrays = perturbed(state, np.random.default_rng(SEED))
    core.values.update(arrays)
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    rng = np.random.default_rng(SEED + 1)
    shape = arrays[S][0].shape
    tnds = {n: (scale * rng.standard_normal(shape), units)
            for n, (units, scale) in TENDENCIES.items()} if tendencies else {}
    names = MOIST if moist else DRY
    pt_value = float(np.asarray(pt.to_units("Pa").data))

    # the JAX package
    jcore = JaxDycore(domain, **dycore_kwargs(moist, scheme, integration, pt), smooth=False,
                      backend=backend, storage_options=JaxStorageOptions(dtype=np.float64))
    jstate = {k: JaxFieldArray(a, u, state[k].dims) for k, (a, u) in arrays.items()}
    jstate["time"] = state["time"]
    jstate["topography_height"] = JaxFieldArray(hs, "m", ("x", "y"))
    jtnds = {k: JaxFieldArray(a, u, ("x", "y", "z")) for k, (a, u) in tnds.items()}
    for _ in range(NSTEPS):
        jstate = {**jstate, **jcore(jstate, jtnds, DT)}
    ref = {k: np.asarray(jstate[k].data) for k in names}

    # the port, on the JAX package's arrays
    nl = load_namelist(**size, so=CPU64, hb_type=boundary, hb_kwargs=hb_kwargs(boundary, core))
    pdomain, _, _ = port_driver.build_domain_and_state(nl)
    pdomain.horizontal_boundary.reference_state = state_from_numpy(reference, "cpu", torch.float64)
    pcore = IsentropicDynamicalCore(pdomain, **dycore_kwargs(moist, scheme, integration, pt_value),
                                    storage_options=CPU64)
    pstate = state_from_numpy({**arrays, "time": state["time"]}, "cpu", torch.float64)
    pstate["topography_height"] = FieldArray(torch.as_tensor(hs), "m", ("x", "y"))
    ptnds = {k: FieldArray(torch.as_tensor(a), u, field_dims(k)) for k, (a, u) in tnds.items()}
    for _ in range(NSTEPS):
        pstate = {**pstate, **pcore(pstate, ptnds, DT)}
    got = {k: a for k, (a, _) in state_to_numpy({k: pstate[k] for k in names}).items()}
    return got, ref, {k: arrays[k][0] for k in names}


def check(boundary, scheme, moist, backend, **kw):
    got, ref, start = run_both(boundary, scheme, moist, backend, **kw)
    # every field moved from its start by far more than the tolerance
    for name, a in ref.items():
        assert np.abs(a - start[name]).max() > 1e3 * TOL * np.abs(a).max(), name
    assert_fields_agree(got, ref, TOL)


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stage_agrees_with_jax_backend(boundary, scheme, moist):
    check(boundary, scheme, moist, "jax")


@pytest.mark.parametrize("moist", [False, True], ids=["dry", "moist"])
@pytest.mark.parametrize("scheme", SCHEMES[2:])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_stage_agrees_with_pallas_interpret(boundary, scheme, moist):
    check(boundary, scheme, moist, "pallas:interpret")


@pytest.mark.parametrize("backend", ["jax", "pallas:interpret"])
@pytest.mark.parametrize("boundary,scheme", [
    ("periodic", "fifth_order_upwind"), ("dirichlet", "third_order_upwind"),
    ("relaxed", "third_order_upwind"), ("periodic", "centered"),
])
def test_stage_with_tendencies(boundary, scheme, backend):
    check(boundary, scheme, True, backend, tendencies=True)


@pytest.mark.parametrize("backend", ["jax", "pallas:interpret"])
@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_forward_euler_si(boundary, backend):
    check(boundary, "fifth_order_upwind", True, backend, integration="forward_euler_si")


@pytest.mark.parametrize("backend", ["jax", "pallas:interpret"])
def test_moist_stage_on_the_one_dimensional_boundary(backend):
    check("relaxed", "third_order_upwind", True, backend, ny=1)
