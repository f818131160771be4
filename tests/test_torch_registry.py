"""The port's registries, stencil dispatch, allocators, registered scheme
families and package exports against the JAX package (CPU, float64).

* ``Registry`` resolves (exact backend, longest glob, wildcard, error) as the
  JAX ``Registry`` does on the same registrations;
* every factory family registers the JAX family's names, in its order;
* every registered stencil and subroutine under ``"torch"`` and ``"numpy"``
  (and the JAX names, which map to ``"torch"``) agrees with the JAX
  ``"jax"`` definition within 1e-12 of the largest magnitude;
* each family member built by name agrees with its JAX counterpart on the
  same seeded inputs: the horizontal and vertical flux schemes, the
  sedimentation fluxes, Burgers' advection schemes and steppers, the 24
  dwarfs and the four topographies;
* a topography and a boundary registered by the user under new names give
  the same domain in both packages, and a SUS step built through them
  equals the one built through the built-in names bit for bit;
* every name a JAX package exports exists in the port's package, and every
  public function or class of the modules this slice ports exists in the
  port's module, save the listed exceptions (each with its reason);
* the allocators and ``StencilFactory`` allocate on the CPU as asked.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil
from datetime import timedelta
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tasmania_tpu
import tasmania_tpu.domain  # noqa: F401  (registers the JAX boundaries)
import tasmania_tpu.framework.stencil_definitions  # noqa: F401
import tasmania_tpu.isentropic.physics.sequential_tendency_stepper  # noqa: F401
import tasmania_tpu_torch
import tasmania_tpu_torch.domain  # noqa: F401
import tasmania_tpu_torch.isentropic.physics.sequential_tendency_stepper  # noqa: F401
from tasmania_tpu.framework import registry as jax_registry
from tasmania_tpu.framework import stencil as jax_stencil
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import BackendOptions as JaxBackendOptions
from tasmania_tpu.utils import exceptions as jax_exceptions
from tasmania_tpu_torch.framework import allocators, registry, stencil
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.utils import exceptions

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
TOL = 1e-12
EXTERNALS = {"f": 0.7, "dt": 3.0, "dx": 1.3, "dy": 0.9}
SHAPE = (9, 8, 7)
THETA = (np.array([400.0, 280.0]), "K")

#: each factory family: the JAX base and the port's, by module and name
FAMILIES = {
    "boundary": ("domain.horizontal_boundary", "HorizontalBoundary"),
    "topography": ("domain.topography", "PhysicalTopography"),
    "tendency_stepper": ("framework.steppers", "TendencyStepper"),
    "sequential_tendency_stepper": ("framework.steppers", "SequentialTendencyStepper"),
    "horizontal_flux": ("isentropic.dynamics.horizontal_fluxes", "IsentropicMinimalHorizontalFlux"),
    "horizontal_flux_full": ("isentropic.dynamics.horizontal_fluxes", "IsentropicHorizontalFlux"),
    "vertical_flux": ("isentropic.dynamics.vertical_fluxes", "IsentropicMinimalVerticalFlux"),
    "prognostic": ("isentropic.dynamics.prognostic", "IsentropicPrognostic"),
    "burgers_advection": ("burgers.dynamics.advection", "BurgersAdvection"),
    "burgers_stepper": ("burgers.dynamics.stepper", "BurgersStepper"),
    "diffusion": ("dwarfs.horizontal_diffusion", "HorizontalDiffusion"),
    "hyperdiffusion": ("dwarfs.horizontal_hyperdiffusion", "HorizontalHyperDiffusion"),
    "smoothing": ("dwarfs.horizontal_smoothing", "HorizontalSmoothing"),
    "vertical_damping": ("dwarfs.vertical_damping", "VerticalDamping"),
    "sedimentation_flux": ("physics.microphysics.utils", "SedimentationFlux"),
}

#: names a JAX package or module has and the port has not, with the reason
EXCEPTIONS = {
    "tasmania_tpu.parallel.make_mesh": "returns a jax.sharding.Mesh; the port's counterpart is "
                                       "parallel.make_rank_grid",
    "tasmania_tpu.parallel.mesh.make_mesh": "returns a jax.sharding.Mesh; the port's counterpart is "
                                            "parallel.mesh.make_rank_grid",
    "tasmania_tpu.ops.si_stage.compute_frame_strips": "serves the Mosaic kernel's x-frame pipeline",
    "tasmania_tpu.ops.si_stage.tile_and_band": "chooses the Mosaic kernel's (8, 128) tiles",
    "tasmania_tpu.framework.stencil_definitions.thomas_jax": "the lax.scan sweep on jax arrays; the "
                                                             "port's \"torch\" entry is thomas",
    "tasmania_tpu.domain.horizontal_boundary.paste": "the functional slice assignment immutable jax "
                                                     "arrays need (.at[].set); tensors assign in place",
}

#: the modules whose public functions and classes this slice ports
PORTED_MODULES = (
    "framework.registry", "framework.stencil", "framework.allocators", "framework.options",
    "framework.stencil_definitions", "framework.dict_operator", "framework.core_components",
    "framework.steppers", "framework.field", "domain.topography", "domain.horizontal_boundary",
    "isentropic.dynamics.horizontal_fluxes", "isentropic.dynamics.vertical_fluxes",
    "isentropic.dynamics.prognostic", "isentropic.physics.sequential_tendency_stepper",
    "burgers.dynamics.advection", "burgers.dynamics.stepper", "dwarfs.horizontal_diffusion",
    "dwarfs.horizontal_hyperdiffusion", "dwarfs.horizontal_smoothing", "dwarfs.vertical_damping",
    "physics.microphysics.utils", "utils.array", "utils.units", "ops.advection_step", "ops.si_stage",
)


def bases(family):
    module, name = FAMILIES[family]
    return tuple(getattr(importlib.import_module(f"{pkg}.{module}"), name)
                 for pkg in ("tasmania_tpu", "tasmania_tpu_torch"))


def assert_scaled(got, ref, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=TOL, err_msg=what)


# ------------------------------------------------------------------ Registry

REGISTRATIONS = (("f", "torch*", "glob"), ("f", "torch:cuda*", "longer glob"), ("f", "numpy", "exact"),
                 ("f", "all", "wildcard"), ("g", "numpy", "g exact"), ("all", "numpy", "any name"))


@pytest.mark.parametrize("name, backend", [
    ("f", "numpy"), ("f", "torch:cuda:0"), ("f", "torch"), ("f", "cupy"), ("g", "numpy"),
    ("g", "torch"), ("h", "numpy"), ("h", "torch"),
])
def test_registry_resolves_as_the_jax_registry(name, backend):
    """Exact, then the longest glob, then the wildcard; an unknown name
    falls back to the name ``"all"``; an unresolved one raises."""
    outcome = []
    for reg, err in ((jax_registry.Registry(), jax_exceptions.FactoryRegistryError),
                     (registry.Registry(), exceptions.FactoryRegistryError)):
        for n, b, payload in REGISTRATIONS:
            reg.register(payload, n, b)
        try:
            outcome.append(reg.query(name, backend))
        except err:
            outcome.append("error")
        assert reg.names() == ("f", "g", "all") and "f" in reg and "h" not in reg
    assert outcome[0] == outcome[1], outcome


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_families_register_the_jax_names(family):
    jax_base, port_base = bases(family)
    assert registry.registered_names(port_base) == jax_registry.registered_names(jax_base)
    for name, cls in port_base.registry.items():
        assert cls.registry_name == name and cls.__name__ == jax_base.registry[name].__name__


def test_factorize_raises_on_unknown_names():
    _, port_base = bases("topography")
    with pytest.raises(exceptions.FactoryRegistryError, match="registered: .*'schaer'"):
        registry.factorize("witch_of_agnesi", port_base)
    with pytest.raises(exceptions.FactoryRegistryError, match="no registry"):
        registry.factorize("flat", FieldArray)

    class Orphan:
        pass

    with pytest.raises(exceptions.FactoryRegistryError, match="no factory base"):
        registry.factor_register("orphan")(Orphan)


# ------------------------------------------------------------------ stencils


def stencil_inputs(name, fn, seed):
    rng = np.random.default_rng(seed)
    if name == "thomas":
        a, c = rng.uniform(-1.0, 1.0, SHAPE), rng.uniform(-1.0, 1.0, SHAPE)
        return a, 2.5 + rng.uniform(0.0, 1.0, SHAPE), c, rng.standard_normal(SHAPE)
    arity = sum(p.kind == p.POSITIONAL_OR_KEYWORD for p in inspect.signature(fn).parameters.values())
    return tuple(rng.standard_normal(SHAPE) for _ in range(arity))


def port_call(compiled, args, backend):
    host = stencil.resolve_backend(backend) == "numpy"
    out = compiled(*(a.copy() if host else torch.as_tensor(a) for a in args))
    assert isinstance(out, np.ndarray if host else torch.Tensor)
    return out


STENCILS = sorted(jax_stencil.STENCIL_REGISTRY.names())
SUBROUTINES = sorted(jax_stencil.SUBROUTINE_REGISTRY.names())


def test_the_port_registers_the_jax_stencils():
    for jax_reg, port_reg in ((jax_stencil.STENCIL_REGISTRY, stencil.STENCIL_REGISTRY),
                              (jax_stencil.SUBROUTINE_REGISTRY, stencil.SUBROUTINE_REGISTRY)):
        assert sorted(port_reg.names()) == sorted(jax_reg.names())
        for name in port_reg.names():
            assert sorted(port_reg.backends(name)) == ["numpy", "torch"], name


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("name", STENCILS)
def test_stencil_matches_jax(name, backend):
    jbo, pbo = JaxBackendOptions(externals=EXTERNALS), BackendOptions(externals=EXTERNALS)
    ref = jax_stencil.compile_stencil(name, "jax", jbo)
    args = stencil_inputs(name, jax_stencil.STENCIL_REGISTRY.query(name, "jax"), 5)
    want = np.asarray(ref(*(jnp.asarray(a) for a in args)))
    assert_scaled(port_call(stencil.compile_stencil(name, backend, pbo), args, backend), want, name)


@pytest.mark.parametrize("backend", ["torch", "numpy"])
@pytest.mark.parametrize("name", SUBROUTINES)
def test_subroutine_matches_jax(name, backend):
    jbo, pbo = JaxBackendOptions(externals=EXTERNALS), BackendOptions(externals=EXTERNALS)
    ref = jax_stencil.compile_subroutine(name, "jax", jbo)
    args = stencil_inputs(name, jax_stencil.SUBROUTINE_REGISTRY.query(name, "jax"), 6)
    want = np.asarray(ref(*(jnp.asarray(a) for a in args)))
    assert_scaled(port_call(stencil.compile_subroutine(name, backend, pbo), args, backend), want, name)


@pytest.mark.parametrize("alias", ["jax", "pallas", "pallas:interpret"])
def test_jax_backend_names_map_to_torch(alias):
    """The JAX names resolve to the "torch" definitions at lookup and at
    registration, and choose nothing else."""
    assert stencil.resolve_backend(alias) == "torch"
    for name in STENCILS:
        assert stencil.STENCIL_REGISTRY.query(name, stencil.resolve_backend(alias)) is \
            stencil.STENCIL_REGISTRY.query(name, "torch")
    reg = registry.Registry()
    registry.make_decorator_registrar(reg, stencil.resolve_backend)("double", backend=alias)(lambda x: 2 * x)
    assert reg.backends("double") == ("torch",)
    scale = stencil.compile_stencil("scale", alias, BackendOptions(externals={"f": 2.0, "unused": 1}))
    assert torch.equal(scale(torch.ones(3)), torch.full((3,), 2.0))


def test_user_stencil_definition():
    """``@stencil_definition`` under the port's backend names, compiled with
    externals, through the factory mixin."""
    @stencil.stencil_definition("axpy_user_test", backend=("torch", "numpy"))
    def axpy(x, y, *, a):
        return a * x + y

    try:
        sf = stencil.StencilFactory("jax", BackendOptions(externals={"a": 3.0}), CPU64)
        x, y = torch.arange(4.0), torch.ones(4)
        assert torch.equal(sf.compile_stencil("axpy_user_test")(x, y), 3.0 * x + y)
        host = sf.compile_stencil("axpy_user_test", "numpy")(x.numpy(), y.numpy())
        np.testing.assert_array_equal(host, 3.0 * x.numpy() + y.numpy())
    finally:
        del stencil.STENCIL_REGISTRY._store["axpy_user_test"]


# ------------------------------------------------------------- flux schemes


@pytest.mark.parametrize("scheme", ["upwind", "centered", "third_order_upwind", "fifth_order_upwind"])
def test_horizontal_flux_matches(scheme):
    from tasmania_tpu.isentropic import IsentropicHorizontalFlux as JaxFull
    from tasmania_tpu.isentropic import IsentropicMinimalHorizontalFlux as Jax
    from tasmania_tpu_torch.isentropic import IsentropicHorizontalFlux as PortFull
    from tasmania_tpu_torch.isentropic import IsentropicMinimalHorizontalFlux as Port

    rng = np.random.default_rng(7)
    nx, ny, nz = 11, 10, 4
    u, v = rng.standard_normal((nx + 1, ny, nz)), rng.standard_normal((nx, ny + 1, nz))
    fields = [rng.standard_normal((nx, ny, nz)) for _ in range(6)]
    ref, port = Jax.factory(scheme), Port.factory(scheme, backend="jax")
    assert (port.extent, port.order) == (ref.extent, ref.order)
    assert type(PortFull.factory(scheme)) is type(port) and type(JaxFull.factory(scheme)) is type(ref)
    t = lambda a: torch.as_tensor(a)  # noqa: E731
    assert_scaled(port.flux_x(t(u), t(fields[0])), ref.flux_x(jnp.asarray(u), jnp.asarray(fields[0])), "x")
    assert_scaled(port.flux_y(t(v), t(fields[0])), ref.flux_y(jnp.asarray(v), jnp.asarray(fields[0])), "y")
    got = port.flux_moist(1.0, 1.0, 1.0, None, t(u), t(v), *(t(f) for f in fields[:3]))
    want = ref.flux_moist(1.0, 1.0, 1.0, None, jnp.asarray(u), jnp.asarray(v), *map(jnp.asarray, fields[:3]))
    for k, (g, w) in enumerate(zip(got, want)):
        assert_scaled(g, w, f"moist {k}")


@pytest.mark.parametrize("scheme", ["upwind", "centered", "third_order_upwind", "fifth_order_upwind"])
def test_vertical_flux_matches(scheme):
    jax_base, port_base = bases("vertical_flux")
    rng = np.random.default_rng(8)
    w, phi = rng.standard_normal((5, 4, 13)), rng.standard_normal((5, 4, 12))
    ref, port = jax_base.factory(scheme), port_base.factory(scheme)
    assert (port.extent, port.order) == (ref.extent, ref.order)
    assert_scaled(port(1.0, 1.0, torch.as_tensor(w), torch.as_tensor(phi)),
                  ref(1.0, 1.0, jnp.asarray(w), jnp.asarray(phi)), scheme)


@pytest.mark.parametrize("scheme", ["first_order_upwind", "second_order_upwind"])
def test_sedimentation_flux_matches(scheme):
    jax_base, port_base = bases("sedimentation_flux")
    rng = np.random.default_rng(9)
    h = np.cumsum(rng.uniform(50.0, 100.0, (4, 3, 10))[:, :, ::-1], axis=2)[:, :, ::-1]
    rho, q, vt = (rng.uniform(0.5, 1.5, (4, 3, 9)) for _ in range(3))
    ref, port = jax_base.factory(scheme), port_base.factory(scheme)
    assert port.nb == ref.nb
    args = (rho, 0.5 * (h[:, :, :-1] + h[:, :, 1:]), q, vt)
    assert_scaled(port(*map(torch.as_tensor, args)), ref(*map(jnp.asarray, args)), scheme)


# ------------------------------------------------------------------ Burgers


@pytest.mark.parametrize("scheme", ["first_order", "second_order", "third_order", "fourth_order",
                                    "fifth_order", "sixth_order"])
def test_burgers_advection_matches(scheme):
    jax_base, port_base = bases("burgers_advection")
    rng = np.random.default_rng(10)
    u, v = rng.standard_normal((12, 11, 1)), rng.standard_normal((12, 11, 1))
    ref, port = jax_base.factory(scheme), port_base.factory(scheme, backend="jax")
    assert type(port).__name__ == type(ref).__name__ and port.extent == ref.extent
    got = port(0.3, 0.7, torch.as_tensor(u), torch.as_tensor(v))
    for k, (g, w) in enumerate(zip(got, ref(0.3, 0.7, jnp.asarray(u), jnp.asarray(v)))):
        assert_scaled(g, w, f"term {k}")


@pytest.mark.parametrize("scheme", ["forward_euler", "rk2", "rk3ws"])
def test_burgers_stepper_matches(scheme):
    from tasmania_tpu.domain import Domain as JaxDomain
    from tasmania_tpu_torch.domain import Domain

    jax_base, port_base = bases("burgers_stepper")
    kw = dict(horizontal_boundary_type="identity", nb=3)
    jd = JaxDomain((0.0, 1.0), 14, (0.0, 1.0), 12, JaxFieldArray(np.array([1.0, 0.0]), "1", ("z",)), 1, **kw)
    pd = Domain((0.0, 1.0), 14, (0.0, 1.0), 12, FieldArray(np.array([1.0, 0.0]), "1", ("z",)), 1,
                storage_options=CPU64, **kw)
    ref = jax_base.factory(scheme, jd.numerical_grid.grid_xy, 3, "third_order")
    port = port_base.factory(scheme, pd.numerical_grid.grid_xy, 3, "third_order", storage_options=CPU64)
    assert type(port).__name__ == type(ref).__name__ and port.stages == ref.stages
    rng = np.random.default_rng(11)
    u, v = rng.standard_normal((14, 12, 1)), rng.standard_normal((14, 12, 1))
    js, ps = {"x_velocity": jnp.asarray(u), "y_velocity": jnp.asarray(v)}, \
        {"x_velocity": torch.as_tensor(u), "y_velocity": torch.as_tensor(v)}
    for stage in range(ref.stages):
        js, ps = ref(stage, js, {}, 0.01), port(stage, ps, {}, 0.01)
        for name in ("x_velocity", "y_velocity"):
            assert_scaled(ps[name], js[name], f"stage {stage} {name}")


# ------------------------------------------------------------------- dwarfs

DWARF_SHAPE, DWARF_DX, DWARF_DY, DWARF_NB = (17, 15, 6), 1.3e3, 0.9e3, 3
DWARFS = [(family, name) for family in ("diffusion", "hyperdiffusion", "smoothing")
          for name in registry.registered_names(bases(family)[1])]


@pytest.mark.parametrize("family, name", DWARFS)
def test_dwarf_built_by_name_matches(family, name):
    jax_base, port_base = bases(family)
    grid = () if family == "smoothing" else (DWARF_DX, DWARF_DY)
    args = (DWARF_SHAPE, *grid, 0.05, 0.2, 4, DWARF_NB)
    port = port_base.factory(name, *args, backend="jax", storage_options=CPU64)
    ref = jax_base.factory(name, *args)
    assert type(port) is port_base.registry[name] and type(port).__name__ == type(ref).__name__
    phi = np.random.default_rng(12).standard_normal(DWARF_SHAPE)
    assert_scaled(port(torch.as_tensor(phi)), ref(jnp.asarray(phi)), name)


# -------------------------------------------------------------- topographies


def topo_kwargs(cls, name):
    if name == "user_defined":
        return {"profile": lambda x, y: 300.0 * np.cos(x / 9e4) * np.sin(y / 7e4) ** 2}
    if name == "flat":
        return {}
    km = lambda v: cls(np.asarray(v), "km", ())  # noqa: E731
    return {"max_height": km(0.8), "width_x": km(40.0), "width_y": km(60.0), "center_x": km(12.0)}


def both_domains(topography, boundary="relaxed", time=timedelta(seconds=1800), smooth=True):
    from tasmania_tpu.domain import Domain as JaxDomain
    from tasmania_tpu_torch.domain import Domain

    kw = dict(horizontal_boundary_type=boundary, nb=3, horizontal_boundary_kwargs={"nr": 6},
              topography_type=topography)
    tk = {"time": time, "smooth": smooth}
    jd = JaxDomain((-176e3, 176e3), 19, (-150e3, 150e3), 17, JaxFieldArray(*THETA, ("z",)), 6,
                   topography_kwargs={**tk, **topo_kwargs(JaxFieldArray, topography.replace("user_", ""))},
                   **kw)
    pd = Domain((-176e3, 176e3), 19, (-150e3, 150e3), 17, FieldArray(*THETA, ("z",)), 6,
                topography_kwargs={**tk, **topo_kwargs(FieldArray, topography.replace("user_", ""))},
                storage_options=CPU64, **kw)
    return jd, pd


def assert_same_topography(jd, pd):
    for which in ("physical_grid", "numerical_grid"):
        jt, pt = getattr(jd, which).topography, getattr(pd, which).topography
        for t in (None, timedelta(seconds=900)):
            if t is not None:
                jd.update_topography(t)
                pd.update_topography(t)
            for attr in ("steady_profile", "profile"):
                np.testing.assert_array_equal(np.asarray(getattr(pt, attr).data),
                                              np.asarray(getattr(jt, attr).data), err_msg=f"{which} {attr}")


@pytest.mark.parametrize("name", ["flat", "gaussian", "schaer", "user_defined"])
def test_topography_built_by_name_matches(name):
    jd, pd = both_domains(name)
    topo = pd.physical_grid.topography
    assert type(topo).__name__ == type(jd.physical_grid.topography).__name__ and topo.type == name
    assert_same_topography(jd, pd)


# ------------------------------------------------------ user registrations


@pytest.fixture
def user_flavours():
    """A topography copying Gaussian and a boundary subclass of Relaxed,
    registered under new names in both packages, removed afterwards."""
    from chip_smoke import register_user_flavours
    from tasmania_tpu.domain.boundaries.relaxed import Relaxed as JaxRelaxed
    from tasmania_tpu.domain.topography import Gaussian as JaxGaussian

    names = register_user_flavours()
    jax_added = []
    for base, name in ((JaxGaussian, names["topography"]), (JaxRelaxed, names["boundary"])):
        cls = type(f"User{base.__name__}", (base,), {})
        jax_registry.factor_register(name)(cls)
        jax_added.append((cls, name))
    yield names
    for cls, name in jax_added:
        next(b for b in cls.__mro__[1:] if "registry" in b.__dict__).registry.pop(name)
    names["unregister"]()


def test_user_registrations_match_jax(user_flavours):
    from tasmania_tpu_torch.domain.boundaries.relaxed import Relaxed

    jd, pd = both_domains(user_flavours["topography"], user_flavours["boundary"])
    hb = pd.horizontal_boundary
    assert isinstance(hb, Relaxed) and hb.type == user_flavours["boundary"] and hb.family == "relaxed"
    assert pd.physical_grid.topography.type == user_flavours["topography"]
    assert_same_topography(jd, pd)
    g = np.asarray(jd.horizontal_boundary._gamma)
    np.testing.assert_array_equal(hb.gamma.numpy()[: g.shape[0], : g.shape[1]], g[: hb.gamma.shape[0],
                                                                                  : hb.gamma.shape[1]])


def test_user_registrations_step_as_the_built_in_names(user_flavours):
    """A SUS step built entirely through the user's names equals the step
    built through "gaussian" and "relaxed", bit for bit, under the backend
    names "torch" and "jax"."""
    from tasmania_tpu_torch.drivers.driver_namelist_sus import run
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

    size = dict(nx=17, ny=17, nz=8, niter=1, so=StorageOptions(dtype=torch.float32, device="cpu"))
    base = run(load_namelist(**size), verbose=False)["fields"]
    for backend in ("torch", "jax"):
        user = run(load_namelist(**size, backend=backend, topo_type=user_flavours["topography"],
                                 hb_type=user_flavours["boundary"]), verbose=False)["fields"]
        assert set(user) == set(base)
        for name, fa in base.items():
            assert torch.equal(user[name].data, fa.data), (backend, name)


# ---------------------------------------------------------------- exports


def jax_exports(pkg):
    mod = importlib.import_module(pkg)
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    # no __all__: the names its own source imports or defines
    tree = ast.parse(Path(mod.__file__).read_text())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
    return [n for n in names if not n.startswith("_") and n not in ("annotations", "tasmania_tpu")]


JAX_PACKAGES = ["tasmania_tpu"] + sorted(
    m.name for m in pkgutil.walk_packages(tasmania_tpu.__path__, "tasmania_tpu.") if m.ispkg)


@pytest.mark.parametrize("pkg", JAX_PACKAGES)
def test_package_exports_match(pkg):
    port = importlib.import_module(pkg.replace("tasmania_tpu", "tasmania_tpu_torch", 1))
    missing = [n for n in jax_exports(pkg) if not hasattr(port, n) and f"{pkg}.{n}" not in EXCEPTIONS]
    assert not missing, missing


@pytest.mark.parametrize("module", PORTED_MODULES)
def test_module_names_match(module):
    jax_mod = importlib.import_module(f"tasmania_tpu.{module}")
    port = importlib.import_module(f"tasmania_tpu_torch.{module}")
    public = [n for n, v in vars(jax_mod).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v)) and v.__module__ == jax_mod.__name__]
    missing = [n for n in public if not hasattr(port, n) and f"{jax_mod.__name__}.{n}" not in EXCEPTIONS]
    assert not missing, missing


def test_exceptions_are_still_missing():
    """Each listed exception names something the port indeed lacks."""
    for dotted in EXCEPTIONS:
        module, name = dotted.rsplit(".", 1)
        assert not hasattr(importlib.import_module(module.replace("tasmania_tpu", "tasmania_tpu_torch", 1)),
                           name), dotted


# ---------------------------------------------------------------- small names


def test_small_names_match():
    from tasmania_tpu.framework import field as jax_field
    from tasmania_tpu.isentropic.physics.sequential_tendency_stepper import setup_thomas_sts as jax_setup
    from tasmania_tpu.utils import units as jax_units
    from tasmania_tpu_torch.framework import field
    from tasmania_tpu_torch.isentropic.physics.sequential_tendency_stepper import setup_thomas_sts
    from tasmania_tpu_torch.utils import units
    from tasmania_tpu_torch.utils.array import get_namespace

    for name in ("air_isentropic_density", "x_velocity_at_u_locations", "tendency_on_interface_levels"):
        assert field.field_stagger_axes(name) == jax_field.field_stagger_axes(name)
    for a, b in (("", "s^-1"), ("m", "1"), ("kg m^-2", "s^-1"), ("dimensionless", "")):
        assert units.multiply_units(a, b) == jax_units.multiply_units(a, b)
    assert get_namespace(np.ones(2)) is np and get_namespace(2.0) is np and get_namespace(torch.ones(2)) is torch
    props = {"x_velocity": {"units": "m s^-1"}}
    raw = {"x_velocity": torch.ones(2, 2, 1), "time": 0}
    out = field.get_field_dict(raw, props, time=5)
    ref = jax_field.get_field_dict({"x_velocity": np.ones((2, 2, 1))}, props, time=5)
    assert out["time"] == 5 and (out["x_velocity"].units, out["x_velocity"].dims) == \
        (ref["x_velocity"].units, ref["x_velocity"].dims)
    rng = np.random.default_rng(13)
    w, phi, prv = (rng.standard_normal((3, 4, 9)) for _ in range(3))
    want = jax_setup(0.3, jnp.asarray(w), jnp.asarray(phi), jnp.asarray(prv), jnp)
    for xp, conv in ((np, np.asarray), (torch, torch.as_tensor)):
        for g, r in zip(setup_thomas_sts(0.3, conv(w), conv(phi), conv(prv), xp), want):
            assert_scaled(g, r)


def test_dict_operator_matches():
    from tasmania_tpu.framework import DictOperator as JaxDictOperator
    from tasmania_tpu_torch.framework import DictOperator

    rng = np.random.default_rng(14)

    def state(cls, conv, keys, units="m s^-1"):
        return {k: cls(conv(rng_arrays[k]), units, ("x", "y", "z")) for k in keys}

    rng_arrays = {k: rng.standard_normal((3, 2, 2)) for k in ("a", "b", "c")}
    jop, pop = JaxDictOperator(), DictOperator()
    ja, pa = state(JaxFieldArray, jnp.asarray, "ab"), state(FieldArray, torch.as_tensor, "ab")
    jb, pb = state(JaxFieldArray, jnp.asarray, "bc", "km s^-1"), state(FieldArray, torch.as_tensor, "bc", "km s^-1")
    for op, extra in (("add", ()), ("sub", ()), ("addsub", ("a",)), ("scale", ()), ("copy", ()),
                      ("fma", ())):
        if op == "addsub":
            jout, pout = jop.addsub(ja, jb, ja), pop.addsub(pa, pb, pa)
        elif op == "scale":
            jout, pout = jop.scale(ja, 1.5), pop.scale(pa, 1.5)
        elif op == "copy":
            jout, pout = jop.copy(jb, {"b": {"units": "m s^-1"}}), pop.copy(pb, {"b": {"units": "m s^-1"}})
        elif op == "fma":
            jt = {k: JaxFieldArray(v.data, "m s^-2", v.dims) for k, v in jb.items()}
            pt = {k: FieldArray(v.data, "m s^-2", v.dims) for k, v in pb.items()}
            jout, pout = jop.fma(ja, jt, 2.0), pop.fma(pa, pt, 2.0)
        else:
            jout, pout = getattr(jop, op)(ja, jb), getattr(pop, op)(pa, pb)
        assert set(pout) == set(jout), op
        for k in jout:
            assert pout[k].units == jout[k].units, (op, k)
            assert_scaled(pout[k].data, jout[k].data, f"{op} {k}")


# -------------------------------------------------- allocators and factory


@pytest.mark.parametrize("backend", ["torch", "jax", "numpy"])
def test_allocators_on_the_cpu(backend):
    so = StorageOptions(dtype=torch.float32, device="cpu")
    host = backend == "numpy"
    for fn, fill in ((allocators.zeros, 0.0), (allocators.ones, 1.0), (allocators.empty, 0.0)):
        out = fn(backend, (2, 3), storage_options=so)
        if host:
            assert isinstance(out, np.ndarray) and out.dtype == np.float32 and (out == fill).all()
        else:
            assert out.device.type == "cpu" and out.dtype == torch.float32 and bool((out == fill).all())
    data = allocators.as_storage(backend, np.arange(6.0).reshape(2, 3), storage_options=so)
    assert (data.dtype == np.float32) if host else (data.dtype == torch.float32 and data.device.type == "cpu")
    sf = stencil.StencilFactory(backend, storage_options=CPU64)
    assert sf.backend == backend and sf.storage_options is CPU64
    z = sf.zeros((4,), dtype=np.float32 if host else torch.float32)
    assert tuple(z.shape) == (4,) and (z.dtype == np.float32 if host else z.dtype == torch.float32)
    e = sf.empty((2,))
    assert (e == 0).all() and ((e.dtype == np.float64) if host else (e.dtype == torch.float64))
    o = sf.as_storage([1.0, 2.0])
    assert (o.dtype == np.float64) if host else (o.device.type == "cpu")


def test_components_take_the_backend_keywords():
    """Every component base, the dycore, the steppers and the boundaries
    keep the backend they were given; no backend name changes the
    device."""
    from tasmania_tpu_torch.drivers.driver_namelist_sus import build_components, build_domain_and_state, make_dycore
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework import TendencyStepper

    bo = BackendOptions(externals={"f": 1.0})
    nl = load_namelist(nx=17, ny=17, nz=4, backend="pallas", bo=bo, so=CPU64)
    domain, _, pt = build_domain_and_state(nl)
    assert domain.horizontal_boundary.backend == "pallas"
    comps = build_components(nl, domain, pt)
    dycore = make_dycore(nl, domain, pt)
    stepper = TendencyStepper.factory("rk2", comps["turb"], backend="pallas", backend_options=bo)
    for c in (*comps.values(), dycore, dycore.prognostic, dycore.damper, stepper):
        assert c.backend == "pallas" and c.backend_options is bo, type(c).__name__
