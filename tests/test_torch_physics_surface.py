"""The port's Coriolis process, implicit vertical advection and the rest of
the isentropic physics surface against the JAX package, on the CPU in
float64.

* ``IsentropicConservativeCoriolis`` on the relaxed and the periodic
  boundary, f given as a ``FieldArray`` and as a float: the tendencies equal
  the JAX component's (the oracle pattern of ``tests/test_physics.py:154``
  and ``tests/test_isentropic_physics_extra.py:164``).
* The six couplings with ``coriolis_parameter`` set, 1 + 2 steps at
  17x17x8 from relative humidity 1.2, against the JAX drivers on the
  ``"jax"`` backend (``sedimentation_vt_mode="stage"``): every field within
  ``TOL`` = 1e-10 of its largest magnitude, as ``tests/test_torch_variants.py``.
* ``thomas`` against ``thomas_numpy`` and ``thomas_jax`` on seeded
  diagonally dominant systems (one right-hand side, and several sharing the
  matrix through ``thomas_level_major``): within 1e-14 of the largest
  magnitude.
* ``IsentropicImplicitVerticalAdvectionDiagnostic`` and ``...Prognostic``
  (dry and moist, w on the main levels and on the interfaces) and the STS
  stepper ``"isentropic_vertical_advection"`` against the JAX classes on a
  seeded state: within 1e-13 of each field's largest magnitude.
* SUS with implicit vertical advection and Coriolis, 1 + 2 steps, against
  the JAX chain under ``"pallas:interpret"`` (``vt_mode="step"``), without
  merges and with both: ``vadv_sed`` finds no explicit vertical advection
  to merge, so sedimentation runs alone, and the result is the same chain's.
* Each of the smaller components (``KesslerSaturationAdjustmentDiagnostic``
  alone and under ``RK2SA``, ``Clipping``, ``PrescribedSurfaceHeating``, the
  static energies, ``get_isentropic_state_from_temperature``,
  ``goff_gratch_formula``, ``HorizontalVelocity``, ``WaterConstituent``,
  ``VerticalDamping``) against its JAX counterpart, within 1e-13.
* The decomposed step with Coriolis (four gloo ranks, 2x2) equals the
  single device's, as ``tests/test_torch_distributed.py`` holds the chain.
"""

from __future__ import annotations

import functools
import importlib
from datetime import datetime, timedelta
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu_torch.drivers import driver_isentropic_moist as port_driver
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_sus
from tasmania_tpu_torch.framework.field import FieldArray, field_dims
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.framework.splitting import _pair_plan
from tasmania_tpu_torch.framework.stencil_definitions import thomas, thomas_level_major
from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper, TendencyStepper
from tasmania_tpu_torch.interop import state_to_numpy
from tasmania_tpu_torch.isentropic.physics.coriolis import IsentropicConservativeCoriolis
from tasmania_tpu_torch.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
    IsentropicImplicitVerticalAdvectionPrognostic,
)
from tests.test_torch_flagship import assert_fields_agree

SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 2
TOL = 1e-10
F = 1e-4  # rad s^-1
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
COUPLINGS = ("sus", "fc", "lfc", "ps", "sts", "ssus")
PERIODIC = {"hb_type": "periodic", "hb_kwargs": {}}
QV = "mass_fraction_of_water_vapor_in_air"
QC = "mass_fraction_of_cloud_liquid_water_in_air"
QR = "mass_fraction_of_precipitation_water_in_air"
S, SU, SV = "air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic"
TTD = "tendency_of_air_potential_temperature"


def assert_scaled(got, ref, tol, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = np.max(np.abs(ref)) or 1.0
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol, err_msg=name)


def as_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------- the setup


def jax_namelist(coupling="sus", backend="jax", **overrides):
    jnl = importlib.import_module(f"drivers.namelist_{coupling}")
    values = {k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")}
    values.update(SIZE, backend=backend, so=JaxStorageOptions(dtype=np.float64), **overrides)
    return SimpleNamespace(**values)


def port_namelist(coupling="sus", **overrides):
    return port_driver.load_namelist(coupling, **SIZE, niter=NSTEPS, so=CPU64, **overrides)


@functools.lru_cache(maxsize=None)
def _models(hb: str = "relaxed"):
    """The JAX and the port's domain, state and top pressure at SIZE."""
    from drivers.driver_namelist_sus import build_domain_and_state as jax_build

    overrides = PERIODIC if hb == "periodic" else {}
    return jax_build(jax_namelist(**overrides)), port_sus.build_domain_and_state(port_namelist(**overrides))


def seeded_state(seed: int = 0, hb: str = "relaxed"):
    """Both packages' domains and one seeded state as both packages' dicts:
    the initial state with perturbed momenta and vapour, cloud and rain
    water, a vertical velocity of a few hundredths of K/s and the potential
    temperature."""
    import jax.numpy as jnp

    (jdomain, _, _), (domain, state, _) = _models(hb)
    rng = np.random.default_rng(seed)
    arrays = {k: (v[0].copy(), v[1]) for k, v in state_to_numpy(state).items() if k != "time"}
    shape = arrays[S][0].shape
    for name, rel in ((SU, 0.1), (SV, 0.1), (QV, 0.05), (S, 0.02)):
        a, u = arrays[name]
        arrays[name] = (a * (1.0 + rel * rng.standard_normal(shape)) + (rel if name == SV else 0.0), u)
    arrays[QC] = (rng.uniform(0.0, 2e-3, shape), "g g^-1")
    arrays[QR] = (rng.uniform(0.0, 1e-3, shape), "g g^-1")
    arrays[TTD] = (0.05 * rng.standard_normal(shape), "K s^-1")
    arrays["tendency_of_air_potential_temperature_on_interface_levels"] = (
        0.05 * rng.standard_normal(shape[:2] + (shape[2] + 1,)), "K s^-1")
    arrays["air_potential_temperature"] = (280.0 + 100.0 * rng.uniform(size=shape), "K")
    port = {k: FieldArray(torch.as_tensor(a), u, field_dims(k)) for k, (a, u) in arrays.items()}
    jax = {k: JaxFieldArray(jnp.asarray(a), u, port[k].dims) for k, (a, u) in arrays.items()}
    return jdomain, domain, jax, port


def assert_outputs_agree(got, ref, tol, tag=""):
    """Two dicts of each package's ``FieldArray``s: the same names, units
    and, within ``tol`` of each field's largest magnitude, data."""
    assert set(got) == set(ref), tag
    for name in ref:
        assert got[name].units == ref[name].units, (tag, name)
        assert_scaled(as_numpy(got[name].data), as_numpy(ref[name].data), tol, f"{tag} {name}")


# -------------------------------------------------------------------- Coriolis


@pytest.mark.parametrize("hb", ["relaxed", "periodic"])
@pytest.mark.parametrize("given", ["field", "float"])
def test_coriolis_matches_jax(hb, given):
    from tasmania_tpu.isentropic.physics import IsentropicConservativeCoriolis as JaxCoriolis

    jdomain, domain, jstate, state = seeded_state(1, hb)
    f = {"field": (JaxFieldArray(np.asarray(F), "rad s^-1", ()), FieldArray(np.asarray(F), "rad s^-1", ())),
         "float": (F, F)}[given]
    ref, _ = JaxCoriolis(jdomain, "numerical", f[0])(jstate)
    got, diags = IsentropicConservativeCoriolis(domain, "numerical", f[1], storage_options=CPU64)(state)
    assert diags == {}
    assert_outputs_agree(got, ref, 0.0, hb)
    nb = domain.horizontal_boundary.nb
    tnd = as_numpy(got[SU].data)
    assert np.all(tnd[:nb] == 0.0) and np.all(tnd[nb:-nb, nb:-nb] != 0.0)


@functools.lru_cache(maxsize=None)
def run_jax(coupling, backend, **overrides):
    """The JAX drivers' step sequence, 1 + NSTEPS steps."""
    import jax.numpy as jnp
    from drivers.driver_isentropic_moist import build_variant

    nl = jax_namelist(coupling, backend, **overrides)
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


def run_port(coupling, **overrides):
    res = port_driver.run(port_namelist(coupling, **overrides), coupling, verbose=False)
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.mark.parametrize("coupling", COUPLINGS)
def test_coupling_with_coriolis_matches_jax(coupling):
    ref = run_jax(coupling, "jax", coriolis_parameter=F)
    assert ref[QC].max() > 1e-4
    got = run_port(coupling, coriolis_parameter=F, sedimentation_vt_mode="stage")
    assert_fields_agree(got, ref, TOL)
    # the f-plane turned the flow: v left its initial zero
    assert np.abs(ref["y_velocity_at_v_locations"]).max() > 1e-3


def test_ssus_split_moves_with_coriolis():
    """ssus splits its process list at len // 2; Coriolis lengthens it by
    one, and the halves move with it as in the JAX driver."""
    nl = port_namelist("ssus", coriolis_parameter=F)
    domain, _, pt = port_sus.build_domain_and_state(nl)
    options = port_sus.physics_options(nl, port_sus.build_components(nl, domain, pt))
    names = [type(o.component).__name__ for o in options]
    assert len(options) == 10 and names[1] == "IsentropicConservativeCoriolis"
    assert names[len(options) // 2] == "ConcurrentCoupling"  # Kessler begins the second half


# --------------------------------------------------------------------- Thomas


def diagonally_dominant(rng, shape):
    a = rng.uniform(-1.0, 1.0, shape)
    c = rng.uniform(-1.0, 1.0, shape)
    b = 2.5 + rng.uniform(0.0, 1.0, shape)
    return a, b, c, rng.standard_normal(shape)


def test_thomas_matches_numpy_and_jax():
    import jax.numpy as jnp

    from tasmania_tpu.framework.stencil_definitions import thomas_jax, thomas_numpy

    rng = np.random.default_rng(3)
    a, b, c, d = diagonally_dominant(rng, (5, 4, 12))
    got = as_numpy(thomas(*(torch.as_tensor(x) for x in (a, b, c, d))))
    assert_scaled(got, thomas_numpy(a, b, c, d), 1e-14, "numpy")
    assert_scaled(got, np.asarray(thomas_jax(*(jnp.asarray(x) for x in (a, b, c, d)))), 1e-14, "jax")
    # the tridiagonal product gives back the right-hand side
    x = got
    lhs = b * x
    lhs[..., 1:] += a[..., 1:] * x[..., :-1]
    lhs[..., :-1] += c[..., :-1] * x[..., 1:]
    assert_scaled(lhs, d, 1e-13, "residual")


def test_thomas_right_hand_sides_share_the_sweep():
    from tasmania_tpu.framework.stencil_definitions import thomas_numpy

    rng = np.random.default_rng(4)
    a, b, c, _ = diagonally_dominant(rng, (9, 3, 5))  # level-major (n, nx, ny)
    d = rng.standard_normal((9, 4, 3, 5))  # four right-hand sides
    got = as_numpy(thomas_level_major(*(torch.as_tensor(x) for x in (a, b, c, d))))
    for i in range(4):
        ref = thomas_numpy(*(np.moveaxis(x, 0, -1) for x in (a, b, c, d[:, i])))
        np.testing.assert_array_equal(got[:, i], np.moveaxis(ref, -1, 0), err_msg=str(i))


# -------------------------------------------- implicit vertical advection


@pytest.mark.parametrize("moist", [False, True])
@pytest.mark.parametrize("stgz", [False, True])
@pytest.mark.parametrize("flavour", ["Diagnostic", "Prognostic"])
def test_implicit_vertical_advection_matches_jax(flavour, stgz, moist):
    from tasmania_tpu.isentropic import physics as jax_physics

    jdomain, domain, jstate, state = seeded_state(2)
    kw = dict(moist=moist, tendency_of_air_potential_temperature_on_interface_levels=stgz)
    jax_cls = getattr(jax_physics, f"IsentropicImplicitVerticalAdvection{flavour}")
    port_cls = {"Diagnostic": IsentropicImplicitVerticalAdvectionDiagnostic,
                "Prognostic": IsentropicImplicitVerticalAdvectionPrognostic}[flavour]
    dt = timedelta(seconds=10)
    ref = jax_cls(jdomain, **kw)(jstate, dt)
    got = port_cls(domain, storage_options=CPU64, **kw)(state, dt)
    for r, g, tag in zip(ref, got, ("tendencies", "diagnostics")):
        assert_outputs_agree(g, r, 1e-13, tag)
    assert len(got[0 if flavour == "Prognostic" else 1]) == (6 if moist else 3)


@pytest.mark.parametrize("moist", [False, True])
def test_sts_stepper_matches_jax(moist):
    from tasmania_tpu.framework.steppers import SequentialTendencyStepper as JaxSTS
    from tasmania_tpu.isentropic.physics import IsentropicImplicitVerticalAdvectionDiagnostic as JaxDiag

    jdomain, domain, jstate, state = seeded_state(5)
    _, _, jprv, prv = seeded_state(6)
    jstate["time"] = state["time"] = datetime(2000, 1, 1)
    ref_stepper = JaxSTS.factory("isentropic_vertical_advection", JaxDiag(jdomain, moist=moist))
    stepper = SequentialTendencyStepper.factory(
        "isentropic_vertical_advection",
        IsentropicImplicitVerticalAdvectionDiagnostic(domain, moist=moist, storage_options=CPU64))
    dref, ref = ref_stepper(jstate, jprv, timedelta(seconds=10))
    dgot, got = stepper(state, prv, timedelta(seconds=10))
    assert dgot == dref == {}
    assert got.pop("time") == ref.pop("time") == datetime(2000, 1, 1, 0, 0, 10)
    assert_outputs_agree(got, ref, 1e-13)
    with pytest.raises(TypeError, match="IsentropicImplicitVerticalAdvectionDiagnostic"):
        SequentialTendencyStepper.factory("isentropic_vertical_advection",
                                          IsentropicConservativeCoriolis(domain, storage_options=CPU64))


def register_interpret_thomas():
    """The JAX registry resolves the Thomas solve for ``"pallas"`` (its
    ``lax.scan`` version, ``thomas_jax``) but not for ``"pallas:interpret"``,
    the CPU emulation of ``"pallas"``: register the same function there, in
    this process, so that the JAX chain with implicit vertical advection runs
    under interpretation as it runs on the TPU."""
    from tasmania_tpu.framework.stencil import STENCIL_REGISTRY
    from tasmania_tpu.framework.stencil_definitions import thomas_jax

    STENCIL_REGISTRY.register(thomas_jax, "thomas", "pallas:interpret")


@functools.lru_cache(maxsize=None)
def _jax_chain_interpret():
    register_interpret_thomas()
    return run_jax("sus", "pallas:interpret", coriolis_parameter=F, implicit_vertical_advection=True)


@pytest.mark.parametrize("merges", [(), ("smooth_smag", "vadv_sed")])
def test_sus_implicit_coriolis_matches_jax_chain(merges):
    ref = _jax_chain_interpret()
    assert ref[QC].max() > 1e-4 and ref[QR].max() > 0.0
    nl = port_namelist("sus", coriolis_parameter=F, implicit_vertical_advection=True,
                       process_merges=merges)
    domain, _, pt = port_sus.build_domain_and_state(nl)
    _, physics = port_sus.build_model(nl, domain, pt)
    plan = _pair_plan(physics._processes, physics.merges)
    ivf = [e for e in plan if isinstance(e[1], IsentropicImplicitVerticalAdvectionDiagnostic)]
    assert len(ivf) == 1 and ivf[0][0] == "one"  # vadv_sed declines it: sedimentation alone
    assert sum(e[0] == "pair" for e in plan) == 1 + ("smooth_smag" in merges)
    assert_fields_agree(run_port("sus", coriolis_parameter=F, implicit_vertical_advection=True,
                                 process_merges=merges), ref, TOL)


def test_other_couplings_advect_explicitly():
    """Only the SUS chain takes the implicit process, as in the JAX drivers:
    another coupling's step is the same with the switch on."""
    for coupling in ("ps", "fc"):
        off = run_port(coupling)
        on = run_port(coupling, implicit_vertical_advection=True)
        for name, a in off.items():
            np.testing.assert_array_equal(on[name], a, err_msg=f"{coupling} {name}")


# ------------------------------------------------------------ the small ones


def _kessler_diag(jdomain, domain, jstate, state):
    from tasmania_tpu.physics import KesslerSaturationAdjustmentDiagnostic as Jax
    from tasmania_tpu_torch.physics import KesslerSaturationAdjustmentDiagnostic as Port

    dt = timedelta(seconds=5)
    return Jax(jdomain, "numerical")(jstate, dt), Port(domain, "numerical", storage_options=CPU64)(state, dt)


def _rk2sa(jdomain, domain, jstate, state):
    from tasmania_tpu.framework.steppers import TendencyStepper as JaxStepper
    from tasmania_tpu.physics import KesslerSaturationAdjustmentDiagnostic as Jax
    from tasmania_tpu_torch.physics import KesslerSaturationAdjustmentDiagnostic as Port

    jstate["time"] = state["time"] = datetime(2000, 1, 1)
    dt = timedelta(seconds=5)
    ref = JaxStepper.factory("rk2sa", Jax(jdomain, "numerical"))(jstate, dt)
    stepper = TendencyStepper.factory("rk2sa", Port(domain, "numerical", storage_options=CPU64))
    with mock.patch.object(stepper.coupling, "fused_rk_step") as fused:
        got = stepper(state, dt)
    fused.assert_not_called()
    assert got[1].pop("time") == ref[1].pop("time")
    ref[0].pop("time")  # the JAX coupling's diagnostics carry the stage's time
    return ref, got


def _clipping(jdomain, domain, jstate, state):
    from tasmania_tpu.physics import Clipping as Jax
    from tasmania_tpu_torch.physics import Clipping as Port

    for st in (jstate, state):
        st[QC] = st[QC].with_data(st[QC].data - 1e-3)  # half the cells negative
    return (Jax(jdomain, "numerical")(jstate),), (Port(domain, "numerical", storage_options=CPU64)(state),)


def _heating(jdomain, domain, jstate, state):
    from tasmania_tpu.isentropic.physics import PrescribedSurfaceHeating as Jax
    from tasmania_tpu_torch.isentropic.physics import PrescribedSurfaceHeating as Port

    # at the 12 h the JAX package evaluates, the default frequencies' two
    # terms cancel exactly: other frequencies, so that the heating is not zero
    kw = dict(characteristic_length=FieldArray(np.asarray(60.0), "km", ()), frequency_sw=0.1,
              frequency_fw=0.3)
    jkw = dict(kw, characteristic_length=JaxFieldArray(np.asarray(60.0), "km", ()))
    out = []
    for in_diags in (False, True):
        out.append((Jax(jdomain, tendency_of_air_potential_temperature_in_diagnostics=in_diags, **jkw)(jstate),
                    Port(domain, tendency_of_air_potential_temperature_in_diagnostics=in_diags,
                         storage_options=CPU64, **kw)(state)))
    return tuple(o[0][i] for o in out for i in (0, 1)), tuple(o[1][i] for o in out for i in (0, 1))


def _static_energy(jdomain, domain, jstate, state):
    from tasmania_tpu.physics import DryStaticEnergy as JaxDry
    from tasmania_tpu.physics import MoistStaticEnergy as JaxMoist
    from tasmania_tpu_torch.physics import DryStaticEnergy, MoistStaticEnergy

    jdse = JaxDry(jdomain, "numerical")(jstate)
    dse = DryStaticEnergy(domain, "numerical", storage_options=CPU64)(state)
    jmse = JaxMoist(jdomain, "numerical")({**jstate, **jdse})
    mse = MoistStaticEnergy(domain, "numerical", storage_options=CPU64)({**state, **dse})
    return (jdse, jmse), (dse, mse)


def _state_from_temperature(jdomain, domain, jstate, state):
    from tasmania_tpu.isentropic import get_isentropic_state_from_temperature as jax_state
    from tasmania_tpu_torch.isentropic import get_isentropic_state_from_temperature as port_state

    kw = dict(bubble_center_x=1e4, bubble_center_y=-2e4, bubble_center_height=3e3,
              bubble_radius=4e4, bubble_maximum_perturbation=2.0, moist=True, precipitation=True,
              relative_humidity=0.8)
    t0 = datetime(2000, 1, 1)
    ref = jax_state(jdomain.numerical_grid, t0, 10.0, 1.0, 250.0, backend="jax",
                    storage_options=JaxStorageOptions(dtype=np.float64), **kw)
    got = port_state(domain.numerical_grid, t0, 10.0, 1.0, 250.0, storage_options=CPU64, **kw)
    assert got.pop("time") == ref.pop("time") == t0
    return (ref,), (got,)


def _goff_gratch(jdomain, domain, jstate, state):
    from tasmania_tpu.utils import meteo as jax_meteo
    from tasmania_tpu_torch.utils import meteo

    t = np.linspace(230.0, 310.0, 41)
    p = np.linspace(2e4, 1e5, 41)
    rh = np.linspace(0.1, 1.1, 41)

    def fa(cls, a):
        return {"x": cls(np.asarray(a), "1", ("x",))}

    ref = (fa(JaxFieldArray, jax_meteo.goff_gratch_formula(t)),
           fa(JaxFieldArray, jax_meteo.convert_relative_humidity_to_water_vapor("goff_gratch", p, t, rh)))
    got = (fa(FieldArray, meteo.goff_gratch_formula(t)),
           fa(FieldArray, meteo.convert_relative_humidity_to_water_vapor("goff_gratch", p, t, rh)))
    return ref, got


def _horizontal_velocity(jdomain, domain, jstate, state):
    from tasmania_tpu.dwarfs import HorizontalVelocity as Jax
    from tasmania_tpu_torch.dwarfs import HorizontalVelocity as Port

    names = (S, "x_velocity_at_u_locations", "y_velocity_at_v_locations")
    ref, got = [], []
    for staggering in (True, False):
        jhv = Jax(jdomain.numerical_grid, staggering)
        hv = Port(domain.numerical_grid, staggering, storage_options=CPU64)
        js, ju, jv = (jstate[n].data for n in names)
        s, u, v = (state[n].data for n in names)
        if not staggering:  # velocities at the cells
            ju, jv, u, v = ju[:-1], jv[:, :-1], u[:-1], v[:, :-1]
        jm, m = jhv.get_momenta(js, ju, jv), hv.get_momenta(s, u, v)
        ref.append(dict(enumerate(jm + jhv.get_velocity_components(js, *jm))))
        got.append(dict(enumerate(m + hv.get_velocity_components(s, *m))))
    wrap = lambda cls, d: {k: cls(a, "1", ()) for k, a in d.items()}  # noqa: E731
    return tuple(wrap(JaxFieldArray, r) for r in ref), tuple(wrap(FieldArray, g) for g in got)


def _water_constituent(jdomain, domain, jstate, state):
    from tasmania_tpu.dwarfs import WaterConstituent as Jax
    from tasmania_tpu_torch.dwarfs import WaterConstituent as Port

    ref, got = [], []
    for clipping in (False, True):
        jw = Jax(jdomain.numerical_grid, clipping)
        w = Port(domain.numerical_grid, clipping, storage_options=CPU64)
        jq, q = jstate[QC].data - 1e-3, state[QC].data - 1e-3
        ref.append({"sq": JaxFieldArray(jw.get_density_of_water_constituent(jstate[S].data, jq)),
                    "q": JaxFieldArray(jw.get_mass_fraction_of_water_constituent_in_air(jstate[S].data, jq))})
        got.append({"sq": FieldArray(w.get_density_of_water_constituent(state[S].data, q)),
                    "q": FieldArray(w.get_mass_fraction_of_water_constituent_in_air(state[S].data, q))})
    return tuple(ref), tuple(got)


def _vertical_damping(jdomain, domain, jstate, state):
    from tasmania_tpu.dwarfs import VerticalDamping as Jax
    from tasmania_tpu_torch.dwarfs import VerticalDamping as Port

    ref, got = {}, {}
    for name in (S, "air_pressure_on_interface_levels"):
        jd = Jax.factory("rayleigh", jdomain.numerical_grid, 6, 0.002, "s")
        d = Port.factory("rayleigh", domain.numerical_grid, 6, 0.002, "s", storage_options=CPU64)
        jnow, now = jstate[name].data, state[name].data
        ref[name] = JaxFieldArray(jd(timedelta(seconds=5), jnow, 1.01 * jnow, 0.99 * jnow))
        got[name] = FieldArray(d(5.0, now, 1.01 * now, 0.99 * now))
    return (ref,), (got,)


COMPONENTS = {
    "kessler_saturation_adjustment_diagnostic": _kessler_diag,
    "rk2sa": _rk2sa,
    "clipping": _clipping,
    "prescribed_surface_heating": _heating,
    "static_energy": _static_energy,
    "state_from_temperature": _state_from_temperature,
    "goff_gratch": _goff_gratch,
    "horizontal_velocity": _horizontal_velocity,
    "water_constituent": _water_constituent,
    "vertical_damping": _vertical_damping,
}


@pytest.mark.parametrize("name", sorted(COMPONENTS))
def test_component_matches_jax(name):
    jdomain, domain, jstate, state = seeded_state(7)
    ref, got = COMPONENTS[name](jdomain, domain, jstate, state)
    assert len(ref) == len(got)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert_outputs_agree(g, r, 1e-13, f"{name} output {i}")
    assert any(np.abs(as_numpy(fa.data)).max() > 0.0 for g in got for fa in g.values())


def test_rayleigh_keeps_its_bits():
    """``Rayleigh``, now on the ``VerticalDamping`` base, gives the bits of
    its former expression, ``new - dt·rmat·(now - ref)``."""
    from tasmania_tpu_torch.dwarfs.vertical_damping import Rayleigh

    _, domain, _, state = seeded_state(8)
    d = Rayleigh(domain.numerical_grid, 6, 0.002, storage_options=CPU64)
    now = state[S].data
    assert torch.equal(d(5.0, now, 1.01 * now, 0.99 * now), 1.01 * now - 5.0 * d.rmat * (now - 0.99 * now))
    assert d.dd == 5 and d.rmat_if.shape[0] == now.shape[2] + 1  # zero at the depth's bottom level


# ------------------------------------------------------------ decomposed


def test_decomposed_coriolis_matches_single_device(tmp_path):
    """Four gloo ranks (2x2) of the SUS chain with Coriolis against the
    single device: Coriolis zeroes only the global frame on a shard
    (``DistributedBoundary.zero_physical_frame``), so the gathered fields
    equal the single device's within 1e-13 of their largest magnitudes."""
    from tasmania_tpu_torch.drivers import driver_sharded as shd

    size = dict(nx=32, ny=32, nz=8)
    overrides = {"relative_humidity": 1.2, "coriolis_parameter": F}
    nl = shd.namelist("cpu", f64=True, niter=NSTEPS, **size, **overrides)
    single = shd.single_device_run(nl, physics=True, warmup=False)["fields"]
    res = shd.run(ranks=4, comm="gloo", device="cpu", niter=NSTEPS, physics=True, f64=True, mesh=(2, 2),
                  warmup=False, verbose=False, overrides=overrides, workdir=tmp_path, timeout_s=120.0,
                  **size)
    assert res["imported_by_rank"] == [[]] * 4
    assert set(res["fields"]) == set(single)
    for name, a in single.items():
        assert_scaled(res["fields"][name], a, 1e-13, name)
    assert np.abs(single["y_velocity_at_v_locations"]).max() > 1e-3


def test_profile_slice_physics_switches():
    """``profile_slice.py --coriolis F --implicit-vadv`` gives the profile
    ``chip_smoke.py``'s ``sus_coriolis_implicit`` namelist; the implicit
    switch refuses the runs without the SUS chain's vertical advection."""
    from chip_smoke import SURFACE_PATHS
    from tasmania_tpu_torch.drivers import profile_slice

    nl = profile_slice.namelist(profile_slice.parse(["--coriolis", "1e-4", "--implicit-vadv"]))
    coupling, overrides, _ = SURFACE_PATHS["sus_coriolis_implicit"]
    assert coupling == "sus"
    assert {k: getattr(nl, k) for k in overrides} == overrides
    plain = profile_slice.namelist(profile_slice.parse(["--coupling", "fc", "--coriolis", "1e-4"]))
    assert plain.coriolis_parameter == 1e-4 and not plain.implicit_vertical_advection
    for other in (["--coupling", "fc"], ["--slice"], ["--mountain-wave"]):
        with pytest.raises(SystemExit):
            profile_slice.parse(other + ["--implicit-vadv"])
    with pytest.raises(SystemExit):
        profile_slice.parse(["--burgers", "bench", "--coriolis", "1e-4"])
