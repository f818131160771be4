"""The rest of the port's framework against the JAX package's, on the CPU in
float64, on seeded numpy inputs: the base-component mixins, the diagnostic
composite and the concurrent coupling under both execution policies,
substepping with the superfast components, the static checkers, the offline
diagnostics, the fakes and the finiteness checks.

The same toy components are built on each package's base classes (their
``array_call`` is arithmetic that numpy, JAX and PyTorch share), so every
result is compared with the JAX package's; the algebra is the same in both
packages, and agreement is bitwise unless a test states a tolerance.  The
substepping cases are ``tests/test_substepping.py``'s ``ToyCore`` cases,
held to the same hand-stepped numpy forward Euler and to the JAX core.
The composite of the isentropic diagnostics and the velocity components
runs on the flagship's initial state (17x17x8) under both policies.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import tasmania_tpu.framework.base_components as jax_base
import tasmania_tpu.framework.composite as jax_composite
import tasmania_tpu.framework.concurrent_coupling as jax_cc
import tasmania_tpu.framework.core_components as jax_core
import tasmania_tpu.framework.dycore as jax_dycore
import tasmania_tpu.framework.fakes as jax_fakes
import tasmania_tpu.framework.offline_diagnostics as jax_offline
import tasmania_tpu.framework.promoter as jax_promoter
import tasmania_tpu.framework.static_checkers as jax_checkers
import tasmania_tpu.utils.exceptions as jax_exceptions
from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
import tasmania_tpu_torch.framework.base_components as port_base
import tasmania_tpu_torch.framework.composite as port_composite
import tasmania_tpu_torch.framework.concurrent_coupling as port_cc
import tasmania_tpu_torch.framework.core_components as port_core
import tasmania_tpu_torch.framework.dycore as port_dycore
import tasmania_tpu_torch.framework.fakes as port_fakes
import tasmania_tpu_torch.framework.offline_diagnostics as port_offline
import tasmania_tpu_torch.framework.promoter as port_promoter
import tasmania_tpu_torch.framework.static_checkers as port_checkers
import tasmania_tpu_torch.utils.exceptions as port_exceptions
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.framework.validation import assert_all_finite, checked
from tasmania_tpu_torch.isentropic.physics.diagnostics import (
    IsentropicDiagnostics,
    IsentropicVelocityComponents,
)

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
DIMS3 = ("x", "y", "z")
SHAPE = (6, 5, 2)
THETA = (np.array([400.0, 300.0]), "K")


def port_domain(nx=6, ny=5, nz=2):
    return Domain((0.0, 1e3), nx, (0.0, 1e3), ny, FieldArray(*THETA, ("z",)), nz,
                  horizontal_boundary_type="identity", nb=1, storage_options=CPU64)


def jax_domain(nx=6, ny=5, nz=2):
    return JaxDomain((0.0, 1e3), nx, (0.0, 1e3), ny, JaxFieldArray(*THETA, ("z",)), nz,
                     horizontal_boundary_type="identity", nb=1)


PORT = SimpleNamespace(core=port_core, cc=port_cc, composite=port_composite, dycore=port_dycore,
                       promoter=port_promoter, FieldArray=FieldArray, domain=port_domain,
                       array=lambda a: torch.as_tensor(np.asarray(a)), kw={"storage_options": CPU64})
JAX = SimpleNamespace(core=jax_core, cc=jax_cc, composite=jax_composite, dycore=jax_dycore,
                      promoter=jax_promoter, FieldArray=JaxFieldArray, domain=jax_domain,
                      array=np.asarray, kw={})
PKGS = {"port": PORT, "jax": JAX}
U = {"dims": DIMS3, "units": "m s^-1"}
DU = {"dims": DIMS3, "units": "m s^-2"}


def toys(pkg):
    """The toy components of ``tests/test_framework.py`` and
    ``tests/test_substepping.py`` on ``pkg``'s base classes."""
    D, T = pkg.core.DiagnosticComponent, pkg.core.TendencyComponent

    class Linear(T):
        """d(phi)/dt = alpha·phi (``field`` names phi)."""

        def __init__(self, domain, alpha, field="phi"):
            super().__init__(domain, "numerical", **pkg.kw)
            self.alpha, self.field = alpha, field

        input_properties = property(lambda self: {self.field: U})
        tendency_properties = property(lambda self: {self.field: DU})

        def array_call(self, state):
            return {self.field: self.alpha * state[self.field]}, {}

    class Quadratic(Linear):
        """d(phi)/dt = a·phi², in ``units``."""

        def __init__(self, domain, a, units="m s^-2"):
            super().__init__(domain, a)
            self.units = units

        tendency_properties = property(lambda self: {"phi": {"dims": DIMS3, "units": self.units}})

        def array_call(self, state):
            return {"phi": self.alpha * state["phi"] * state["phi"]}, {}

    class Doubler(D):
        """``out`` = 2·``inp``."""

        def __init__(self, domain, inp="phi", out="psi"):
            super().__init__(domain, "numerical", **pkg.kw)
            self.inp, self.out = inp, out

        input_properties = property(lambda self: {self.inp: U})
        diagnostic_properties = property(lambda self: {self.out: U})

        def array_call(self, state):
            return {self.out: 2.0 * state[self.inp]}

    class PsiConsumer(T):
        """d(phi)/dt = psi, and the diagnostic chi = psi + 1."""

        def __init__(self, domain):
            super().__init__(domain, "numerical", **pkg.kw)

        input_properties = property(lambda self: {"psi": U})
        tendency_properties = property(lambda self: {"phi": DU})
        diagnostic_properties = property(lambda self: {"chi": U})

        def array_call(self, state):
            return {"phi": state["psi"]}, {"chi": state["psi"] + 1.0}

    class PhiToDiagnostic(pkg.promoter.FromTendencyToDiagnostic):
        input_tendency_properties = property(lambda self: {"phi": {**DU, "diagnostic_name": "dphi"}})

    return SimpleNamespace(Linear=Linear, Quadratic=Quadratic, Doubler=Doubler, PsiConsumer=PsiConsumer,
                           PhiToDiagnostic=PhiToDiagnostic)


def state_of(pkg, seed=0, names=("phi",)):
    rng = np.random.default_rng(seed)
    out = {n: pkg.FieldArray(pkg.array(rng.uniform(0.5, 1.5, SHAPE)), "m s^-1", DIMS3) for n in names}
    out["time"] = datetime(2000, 1, 1)
    return out


def as_numpy(fields):
    return {k: np.asarray(v.data) for k, v in fields.items() if k != "time"}


def assert_same(got, ref, rtol=0.0):
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=rtol, atol=0, err_msg=name)


# ---------------------------------------------------------------- base components


def test_base_components_match():
    """Staggered shapes, the grid types and the physical constants with an
    override in other units."""
    pd, jd = port_domain(7, 4, 3), jax_domain(7, 4, 3)
    for name in ("air_isentropic_density", "x_velocity_at_u_locations", "y_velocity_at_v_locations",
                 "air_pressure_on_interface_levels"):
        assert (port_base.GridComponent(pd.numerical_grid).get_field_shape(name)
                == jax_base.GridComponent(jd.numerical_grid).get_field_shape(name))
    for grid_type in ("numerical", "physical"):
        p, j = port_base.DomainComponent(pd, grid_type), jax_base.DomainComponent(jd, grid_type)
        assert (p.grid.nx, p.grid.ny, p.grid_type) == (j.grid.nx, j.grid.ny, j.grid_type)
        assert p.horizontal_boundary is pd.horizontal_boundary and p.domain is pd
    for mod in (port_base, jax_base):
        with pytest.raises(ValueError, match="grid_type"):
            mod.DomainComponent(pd if mod is port_base else jd, "staggered")

    def constants(mod, field_array):
        class C(mod.PhysicalConstantsComponent):
            default_physical_constants = {"g": (9.81, "m s^-2"), "rd": (287.0, "J K^-1 kg^-1")}

        return C({"g": field_array(np.asarray(981.0), "cm s^-2", ())}).rpc

    assert constants(port_base, FieldArray) == constants(jax_base, JaxFieldArray)


# ---------------------------------------------------------------- composite


@pytest.mark.parametrize("policy", ["serial", "as_parallel", "unknown"])
def test_diagnostic_composite_matches(policy):
    """A chain that reads its own diagnostic (psi, then 2·psi): threaded
    under ``"serial"`` (an unknown policy is serial), from the input state
    under ``"as_parallel"``; its properties and outputs as the JAX
    composite's."""
    out = {}
    for key, pkg in PKGS.items():
        d, t = pkg.domain(), toys(pkg)
        comp = pkg.composite.DiagnosticComponentComposite(
            t.Doubler(d), t.Doubler(d, "psi", "omega"), execution_policy=policy)
        state = state_of(pkg, 3, names=("phi", "psi"))
        res = comp(state)
        assert res["time"] == state["time"]
        out[key] = (comp.execution_policy, sorted(comp.input_properties), sorted(comp.diagnostic_properties),
                    as_numpy(res))
    assert out["port"][:3] == out["jax"][:3]
    assert out["port"][0] == ("as_parallel" if policy == "as_parallel" else "serial")
    assert_same(out["port"][3], out["jax"][3])
    rng = np.random.default_rng(3)
    phi, psi = rng.uniform(0.5, 1.5, SHAPE), rng.uniform(0.5, 1.5, SHAPE)
    np.testing.assert_array_equal(out["port"][3]["omega"], 2.0 * (psi if policy == "as_parallel" else 2.0 * phi))


def test_diagnostic_composite_checks_units():
    class Other(toys(PORT).Doubler):
        input_properties = property(lambda self: {self.inp: {"dims": DIMS3, "units": "K"}})

    d = port_domain()
    with pytest.raises(port_exceptions.PropertyError):
        port_composite.DiagnosticComponentComposite(toys(PORT).Doubler(d), Other(d, "phi", "zeta"))


# ---------------------------------------------------------------- concurrent coupling


@pytest.mark.parametrize("policy", ["serial", "as_parallel", "unknown"])
def test_concurrent_coupling_policies_match(policy):
    """Doubler -> PsiConsumer -> a tendency promoter -> two tendencies of
    phi (km s^-2 and m s^-2): the derived properties, the overwrite flags
    and the tendencies and diagnostics, under each policy, as the JAX
    coupling's.  Under ``"as_parallel"`` the consumer reads psi from the
    input state, and the promoter, whose input depends on the order, is
    skipped."""
    out = {}
    for key, pkg in PKGS.items():
        d, t = pkg.domain(), toys(pkg)
        cc = pkg.cc.ConcurrentCoupling(
            t.Doubler(d), t.PsiConsumer(d), t.PhiToDiagnostic(d), t.Quadratic(d, 0.3, "km s^-2"),
            t.Linear(d, -0.2), execution_policy=policy)
        tends, diags = cc(state_of(pkg, 4, names=("phi", "psi")), timedelta(seconds=1))
        out[key] = (cc.execution_policy, {k: dict(v) for k, v in cc.input_properties.items()},
                    sorted(cc.tendency_properties), sorted(cc.diagnostic_properties), cc.overwrite_tendencies,
                    as_numpy(tends), as_numpy(diags))
    for a, b in zip(out["port"][:5], out["jax"][:5]):
        assert a == b
    assert_same(out["port"][5], out["jax"][5], rtol=1e-15)
    assert_same(out["port"][6], out["jax"][6], rtol=1e-15)
    serial = policy != "as_parallel"
    assert ("psi" in out["port"][1]) is not serial
    assert ("dphi" in out["port"][6]) is serial


@pytest.mark.parametrize("policy", ["serial", "as_parallel"])
def test_concurrent_coupling_sums_tendencies(policy):
    """``tests/test_suite_steppers_couplers.py``'s case: two nonlinear
    processes, no diagnostics, the plain sum under either policy."""
    a1, a2 = 0.37, -0.11
    cc = port_cc.ConcurrentCoupling(toys(PORT).Quadratic(port_domain(), a1),
                                    toys(PORT).Quadratic(port_domain(), a2), execution_policy=policy)
    state = state_of(PORT, 5)
    tends, _ = cc(state, timedelta(seconds=1.0))
    phi0 = state["phi"].data.numpy()
    np.testing.assert_allclose(tends["phi"].data.numpy(), (a1 + a2) * phi0 * phi0, rtol=1e-12, atol=1e-15)


def test_as_parallel_inputs_are_the_plain_union():
    """``tests/test_coupling_properties.py``'s invariant: under
    ``"as_parallel"`` the inputs are every component's, a diagnostic of
    one included."""
    d, t = port_domain(), toys(PORT)
    comps = (t.Doubler(d, "phi", "psi"), t.PsiConsumer(d), t.Linear(d, 0.1, "eta"))
    cc = port_cc.ConcurrentCoupling(*comps, execution_policy="as_parallel")
    assert set(cc.input_properties) == {"phi", "psi", "eta"}
    assert set(port_cc.ConcurrentCoupling(*comps).input_properties) == {"phi", "eta"}


def test_chain_fusers_are_serial_only():
    """A registered fuser takes a serial chain, never an as_parallel one."""
    calls = []
    port_cc.register_chain_fuser(lambda comps, scheme: scheme == "toy", lambda *a: calls.append(a) or "fused")
    try:
        d = port_domain()
        serial = port_cc.ConcurrentCoupling(toys(PORT).Linear(d, 0.1))
        parallel = port_cc.ConcurrentCoupling(toys(PORT).Linear(d, 0.1), execution_policy="as_parallel")
        assert serial.fused_rk_step("toy", {}, 1.0, {}) == "fused"
        assert parallel.fused_rk_step("toy", {}, 1.0, {}) is None
        assert len(calls) == 1
    finally:
        port_cc._CHAIN_FUSERS.pop()


def test_coupling_checks_units():
    class Kelvin(toys(PORT).Linear):
        tendency_properties = property(lambda self: {"phi": {"dims": DIMS3, "units": "K s^-1"}})

    d = port_domain()
    with pytest.raises(port_exceptions.PropertyError):
        port_cc.ConcurrentCoupling(toys(PORT).Linear(d, 0.1), Kelvin(d, 0.1))


@pytest.mark.parametrize("policy", ["serial", "as_parallel"])
def test_isentropic_diagnostics_composite(policy):
    """The isentropic diagnostics and the velocity components as one
    composite on the flagship's initial state (17x17x8): each output as
    the component's own, under either policy (neither reads the other's
    diagnostics)."""
    nl = load_namelist(nx=17, ny=17, nz=8, so=CPU64)
    domain, state, pt = port_driver.build_domain_and_state(nl)
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    state["topography_height"] = FieldArray(torch.as_tensor(hs), "m", ("x", "y"))
    dv = IsentropicDiagnostics(domain, "numerical", moist=True, pt=pt, storage_options=CPU64)
    vc = IsentropicVelocityComponents(domain, storage_options=CPU64)
    comp = port_composite.DiagnosticComponentComposite(dv, vc, execution_policy=policy)
    res = comp(state)
    ref = {**dv(state), **vc(state)}
    assert set(res) - {"time"} == set(ref)
    for name, fa in ref.items():
        assert torch.equal(res[name].data, fa.data), name
    cc = port_cc.ConcurrentCoupling(comp, execution_policy=policy)
    _, diags = cc(state, 5.0)
    assert set(diags) - {"time"} == set(ref)


# ---------------------------------------------------------------- substepping


def toy_core(pkg, n_stages=1, fractions=None):
    """``tests/test_substepping.py``'s ``ToyCore`` on ``pkg``: a forward
    Euler stage on a, b substepped (its tendency from the superfast
    component)."""
    base = pkg.dycore.DynamicalCore

    class ToyCore(base):
        if pkg is JAX:
            def __init__(self, domain, **kw):
                super().__init__(domain, **kw)
        else:
            def __init__(self, domain, **kw):
                super().__init__(**kw)

        stages = property(lambda self: n_stages)
        stage_input_properties = property(lambda self: {"a": U})
        stage_tendency_properties = property(lambda self: {"a": DU})
        stage_output_properties = property(lambda self: {"a": U})
        substep_input_properties = property(lambda self: {"b": U})
        substep_tendency_properties = property(lambda self: {"b": DU})
        substep_output_properties = property(lambda self: {"b": U})

        if fractions is not None:
            substep_fractions = property(lambda self: fractions)

        def stage_array_call(self, stage, raw_state, raw_tendencies, timestep):
            a = raw_state["a"]
            if "a" in raw_tendencies and n_stages == 1:
                a = a + timestep * raw_tendencies["a"]
            return {"a": a}

        def substep_array_call(self, stage, substep, raw_state, raw_stage_state, raw_substep_state,
                               raw_tendencies, timestep):
            return {"b": raw_substep_state["b"] + (timestep / self.substeps) * raw_tendencies.get("b", 0.0)}

    return ToyCore


@pytest.mark.parametrize("case", ["forward_euler", "substeps_zero", "fractions", "truncated"])
def test_substepping_matches(case):
    """The four ``ToyCore`` cases: forward Euler at dt/substeps, substeps =
    0 (b untouched), two stages of fractions (0.5, 1) and three of (1/3,
    1/2, 1) with substeps = 2 (int(2/3) = 0 substeps at stage 0): b against
    the hand-stepped oracle and the JAX core; a, the time and the merged
    input properties as the JAX core's."""
    substeps, alpha, dt, stages, fractions = {
        "forward_euler": (4, 0.25, 8.0, 1, None),
        "substeps_zero": (0, 0.25, 2.0, 1, None),
        "fractions": (4, 0.1, 8.0, 2, (0.5, 1.0)),
        "truncated": (2, 0.1, 6.0, 3, (1.0 / 3.0, 0.5, 1.0)),
    }[case]
    out = {}
    for key, pkg in PKGS.items():
        d, t = pkg.domain(), toys(pkg)
        core = toy_core(pkg, stages, fractions)(
            d, substeps=substeps, superfast_tendency_component=t.Linear(d, alpha, "b"))
        state = state_of(pkg, 7, names=("a", "b"))
        tendencies = {"a": pkg.FieldArray(pkg.array(np.full(SHAPE, 0.01)), "m s^-2", DIMS3)}
        res = core(state, tendencies, timedelta(seconds=dt))
        out[key] = (as_numpy(res), res["time"], sorted(core.input_properties))
    assert_same(out["port"][0], out["jax"][0], rtol=1e-15)
    assert out["port"][1:] == out["jax"][1:]
    rng = np.random.default_rng(7)
    a0, b0 = rng.uniform(0.5, 1.5, SHAPE), rng.uniform(0.5, 1.5, SHAPE)
    growth = 1.0 + alpha * dt / substeps if substeps else 1.0
    n = {"forward_euler": 4, "substeps_zero": 0, "fractions": 2 + 4, "truncated": 0 + 1 + 2}[case]
    np.testing.assert_allclose(out["port"][0]["b"], b0 * growth**n, rtol=1e-12)
    if stages == 1:
        np.testing.assert_allclose(out["port"][0]["a"], a0 + dt * 0.01, rtol=1e-12)
    assert out["port"][2] == ["a", "b"]


def test_superfast_diagnostic_component_runs_after_each_substep():
    """The superfast diagnostic component's diagnostics update the substep
    state after every substep: c = 2·b of the last substep."""
    d, t = port_domain(), toys(PORT)
    core = toy_core(PORT)(d, substeps=3, superfast_tendency_component=t.Linear(d, 0.5, "b"),
                          superfast_diagnostic_component=t.Doubler(d, "b", "c"))
    state = state_of(PORT, 8, names=("a", "b"))
    res = core(state, {}, timedelta(seconds=3.0))
    np.testing.assert_allclose(res["b"].data.numpy(), state["b"].data.numpy() * 1.5**3, rtol=1e-14)
    assert "c" not in res  # the substeps' diagnostics stay in the substep state


def test_isentropic_core_takes_substeps_and_superfast_components():
    """The isentropic core takes them as the JAX core does; it declares no
    substep variable, so its step is the one without them."""
    from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore

    nl = load_namelist(nx=17, ny=17, nz=8, so=CPU64)
    domain, state, pt = port_driver.build_domain_and_state(nl)
    kw = dict(moist=True, time_integration_properties={"pt": pt, "eps": 0.5}, storage_options=CPU64)
    plain = IsentropicDynamicalCore(domain, **kw)
    core = IsentropicDynamicalCore(domain, None, None, 2, None,
                                   IsentropicVelocityComponents(domain, storage_options=CPU64), **kw)
    assert core.substeps == 2 and core.superfast_diagnostic_component is not None
    assert core.substep_output_properties == {}
    a, b = plain(state, {}, 5.0), core(state, {}, 5.0)
    for name in ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic"):
        assert torch.equal(a[name].data, b[name].data), name


# ---------------------------------------------------------------- checkers, offline, fakes, validation


@pytest.mark.parametrize("mismatch", ["units", "dims", "missing", "none"])
def test_static_checkers_match(mismatch):
    """Each checker raises the JAX checker's error (the port's own class of
    the same name) on the same properties, and passes where it passes."""
    props = {"phi": {"dims": DIMS3, "units": "m s^-1"}, "psi": {"dims": DIMS3, "units": "m s^-1"}}
    other = {
        "units": {"phi": {"dims": DIMS3, "units": "K"}},
        "dims": {"phi": {"dims": ("x", "y", "z_on_interface_levels"), "units": "km hr^-1"}},
        "missing": {"phi": {"dims": DIMS3, "units": "m s^-1"}, "chi": {"units": "m s^-1"}},
        "none": {"psi": {"units": "km s^-1"}},
    }[mismatch]
    a = SimpleNamespace(diagnostic_properties=props)
    b = SimpleNamespace(input_properties=other)
    errors = []
    for checkers, exceptions in ((port_checkers, port_exceptions), (jax_checkers, jax_exceptions)):
        try:
            checkers.check_properties_are_compatible(a, "diagnostic", b, "input")
            checkers.check_missing_fields(a, "diagnostic", b, "input")
            errors.append(None)
        except Exception as err:  # the class of each package
            errors.append((type(err).__name__, str(err)))
            assert type(err) is getattr(exceptions, type(err).__name__)
    assert errors[0] == errors[1]
    assert (errors[0] is None) == (mismatch == "none")
    for checkers, exceptions in ((port_checkers, port_exceptions), (jax_checkers, jax_exceptions)):
        with pytest.raises(exceptions.PropertyError):
            checkers.get_properties(SimpleNamespace(), "tendency")


def test_offline_diagnostics_match():
    """RMSD, RRMSD (over slices too) and the column sum of tensors, in other
    units, against the JAX package's on the same arrays."""
    rng = np.random.default_rng(9)
    a, b = rng.normal(size=(6, 5, 4)), rng.normal(size=(6, 5, 4))
    fields = {"phi": {"units": "km hr^-1"}}
    p1 = {"phi": FieldArray(torch.as_tensor(a), "m s^-1", DIMS3)}
    p2 = {"phi": FieldArray(torch.as_tensor(b), "m s^-1", DIMS3)}
    j1, j2 = ({"phi": JaxFieldArray(x, "m s^-1", DIMS3)} for x in (a, b))
    for cls in ("RMSD", "RRMSD"):
        for sl in ({}, {"x": slice(1, 4), "z": slice(0, 2)}):
            got = getattr(port_offline, cls)(None, fields, **sl)(p1, p2)
            ref = getattr(jax_offline, cls)(None, fields, **sl)(j1, j2)
            assert got.keys() == ref.keys()
            np.testing.assert_allclose(got["phi"], ref["phi"], rtol=1e-14)
    zero = {"phi": FieldArray(torch.zeros(6, 5, 4, dtype=torch.float64), "m s^-1", DIMS3)}
    assert port_offline.RRMSD(None, fields)(p1, zero) == {"phi": 0.0}
    np.testing.assert_allclose(port_offline.ColumnSum(None, "phi", "km hr^-1")(p1),
                               jax_offline.ColumnSum(None, "phi", "km hr^-1")(j1), rtol=1e-14)


def test_fakes_match():
    d = port_domain()
    fake = port_fakes.FakeTendencyComponent(d, "numerical", storage_options=CPU64)
    jfake = jax_fakes.FakeTendencyComponent(jax_domain(), "numerical")
    for attr in ("input_properties", "tendency_properties", "diagnostic_properties"):
        assert getattr(fake, attr) == getattr(jfake, attr) == {}
    tends, diags = fake({"time": 0}, 1.0)
    assert (tends, diags) == ({}, {})
    src = toys(PORT).Doubler(d)
    shell = port_fakes.FakeComponent(src, {"input_properties": "diagnostic_properties"})
    jshell = jax_fakes.FakeComponent(src, {"input_properties": "diagnostic_properties"})
    assert shell.input_properties == jshell.input_properties == src.diagnostic_properties


def test_validation_raises_on_non_finite_outputs():
    """``assert_all_finite`` names the first non-finite array of a nest;
    ``checked`` raises on a non-finite output and returns a finite one."""
    ok = {"a": torch.ones(3), "b": [np.ones(2), FieldArray(torch.zeros(2), "1", ("x",))], "n": 3}
    assert_all_finite(ok)
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]: 1 non-finite"):
        assert_all_finite({"a": torch.ones(3), "b": [np.ones(2), FieldArray(torch.tensor([0.0, np.inf]), "1",
                                                                           ("x",))]})
    with pytest.raises(FloatingPointError, match="phi: 2"):
        assert_all_finite([np.array([np.nan, 1.0, np.nan])], names=["phi"])
    step = checked(lambda x, y: {"ratio": x / y})
    assert torch.equal(step(torch.ones(2), torch.full((2,), 2.0))["ratio"], torch.full((2,), 0.5))
    with pytest.raises(FloatingPointError, match="ratio"):
        step(torch.ones(2), torch.zeros(2))
