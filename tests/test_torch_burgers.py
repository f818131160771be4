"""The port's Burgers model (BASELINE config 1) and the Dirichlet, periodic
and identity boundaries against the JAX package, on the CPU in float64.

* The six advection schemes on 12x12x1 random fields: within 1e-12.
* One step of each stepper (forward Euler, RK2, RK3WS), with and without
  a tendency: u, v and each stage's time stamp, within 1e-12.
* The dycore with the diffusion tendency and the Dirichlet boundary whose
  core is the Zhao solution, 21x21, 10 steps of each scheme, the state's
  time a ``datetime`` and a tensor of seconds: interior, frames and time
  within 1e-12 of each field's largest magnitude.  The port's inputs come
  from the JAX ``ZhaoStateFactory`` through ``interop.py``.
* The analytic gates of ``tests/test_burgers.py:117-154`` and the
  first-order convergence ladder of ``tests/test_convergence.py:153-195``,
  on the port alone, with their thresholds.
* ``enforce_field`` and ``set_outermost_layers_x/y`` of the three
  boundaries on unstaggered and staggered fields, on a two-dimensional
  grid and with nx == 1 or ny == 1, and their numerical axes and fields:
  equal to the JAX boundaries'.
* ``driver_burgers --case bench`` at 64x64 (1 + 2 steps) against the stage
  algebra of ``bench.py::bench_burgers`` on the same input, within 1e-12;
  a small CPU run of the zhao case; the driver's refusals.
"""

from __future__ import annotations

from datetime import datetime, timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tasmania_tpu.burgers import (
    BurgersAdvection as JaxAdvection,
    BurgersDynamicalCore as JaxDycore,
    BurgersHorizontalDiffusion as JaxDiffusion,
    BurgersStepper as JaxStepper,
    ZhaoSolutionFactory as JaxZhao,
    ZhaoStateFactory as JaxZhaoState,
)
from tasmania_tpu.domain import Domain as JaxDomain
from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu_torch.burgers import (
    BurgersAdvection,
    BurgersDynamicalCore,
    BurgersHorizontalDiffusion,
    BurgersStepper,
    ZhaoSolutionFactory,
    ZhaoStateFactory,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers import driver_burgers as drv
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_from_numpy, state_to_numpy

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
ITIME = datetime(2000, 1, 1)
SCHEMES = ("forward_euler", "rk2", "rk3ws")
FLUXES = ("first_order", "second_order", "third_order", "fourth_order", "fifth_order", "sixth_order")
UV = ("x_velocity", "y_velocity")
Z1 = (np.array([1.0, 0.0]), "1", ("z",))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


def _domains(nx=21, ny=21, nb=3, boundary="dirichlet", kwargs=None, port_kwargs=None):
    jd = JaxDomain((0.0, 1.0), nx, (0.0, 1.0), ny, JaxFieldArray(*Z1), 1,
                   horizontal_boundary_type=boundary, nb=nb, horizontal_boundary_kwargs=kwargs)
    pd = Domain((0.0, 1.0), nx, (0.0, 1.0), ny, FieldArray(*Z1), 1, horizontal_boundary_type=boundary,
                nb=nb, horizontal_boundary_kwargs=port_kwargs if port_kwargs is not None else kwargs,
                storage_options=CPU64)
    return jd, pd


def _to_port(jax_state, time_origin=None):
    """A JAX state into the port through ``interop.state_from_numpy``."""
    arrays = {k: v if k == "time" else (np.asarray(v.data), v.units) for k, v in jax_state.items()}
    return state_from_numpy(arrays, "cpu", torch.float64, time_origin=time_origin)


def _assert_close(got, ref, tol=1e-12, name=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = np.max(np.abs(ref)) or 1.0
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=tol, err_msg=name)


# -- advection and steppers -----------------------------------------------------


@pytest.mark.parametrize("scheme", FLUXES)
def test_advection_matches(scheme):
    u, v = _rand((12, 12, 1), 0), _rand((12, 12, 1), 1)
    port = BurgersAdvection.factory(scheme)
    ref = JaxAdvection.factory(scheme)
    assert port.extent == ref.extent
    got = port(0.3, 0.7, torch.as_tensor(u), torch.as_tensor(v))
    want = ref(0.3, 0.7, jnp.asarray(u), jnp.asarray(v))
    for k, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12, err_msg=f"term {k}")


@pytest.mark.parametrize("tendency", [False, True])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_stepper_step_matches(scheme, tendency):
    """One step of the stepper alone (stages fed back without a boundary):
    u, v and each stage's time stamp."""
    jd, pd = _domains(nx=14, ny=12, boundary="identity")
    nb, dt = 3, 0.01
    u, v = _rand((14, 12, 1), 2), _rand((14, 12, 1), 3)
    tnd = {"x_velocity": _rand((14, 12, 1), 4), "y_velocity": _rand((14, 12, 1), 5)} if tendency else {}
    jst = JaxStepper.factory(scheme, jd.numerical_grid.grid_xy, nb, "third_order")
    pst = BurgersStepper.factory(scheme, pd.numerical_grid.grid_xy, nb, "third_order")
    assert pst.stages == jst.stages
    js = {"time": ITIME, "x_velocity": jnp.asarray(u), "y_velocity": jnp.asarray(v)}
    ps = {"time": ITIME, "x_velocity": torch.as_tensor(u), "y_velocity": torch.as_tensor(v)}
    jt = {k: jnp.asarray(a) for k, a in tnd.items()}
    pt = {k: torch.as_tensor(a) for k, a in tnd.items()}
    for stage in range(jst.stages):
        js = jst(stage, js, jt, dt)
        ps = pst(stage, ps, pt, dt)
        assert ps["time"] == js["time"], stage
        for n in UV:
            _assert_close(ps[n].numpy(), js[n], name=f"{n}, stage {stage}")


# -- the dycore with diffusion and the Dirichlet Zhao boundary ------------------


def _zhao_models(nx, scheme, flux="first_order", port_so=CPU64):
    eps = 0.1
    jz = JaxZhao(ITIME, JaxFieldArray(np.asarray(eps), "m^2 s^-1", ()))
    pz = ZhaoSolutionFactory(ITIME, FieldArray(np.asarray(eps), "m^2 s^-1", ()))
    jd, pd = _domains(nx=nx, ny=nx, kwargs={"core": jz}, port_kwargs={"core": pz})
    jcore = JaxDycore(jd, fast_tendency_component=JaxDiffusion(
        jd, "numerical", "second_order", JaxFieldArray(np.asarray(eps), "m^2 s^-1", ())),
        time_integration_scheme=scheme, flux_scheme=flux)
    pcore = BurgersDynamicalCore(pd, fast_tendency_component=BurgersHorizontalDiffusion(
        pd, "numerical", "second_order", FieldArray(np.asarray(eps), "m^2 s^-1", ()),
        storage_options=port_so), time_integration_scheme=scheme, flux_scheme=flux)
    return (jd, jz, jcore), (pd, pz, pcore)


@pytest.mark.parametrize("time_kind", ["datetime", "tensor"])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_dycore_matches(scheme, time_kind):
    """10 steps at 21x21 (dt 1 ms): the whole field (interior and the
    Dirichlet frames) and the state's time.  A tensor time (seconds from the
    initial time) takes the path of a CUDA graph of the step."""
    (jd, _, jcore), (pd, _, pcore) = _zhao_models(21, scheme, flux="third_order")
    jstate = JaxZhaoState(ITIME, 0.1)(ITIME, jd.numerical_grid)
    origin = ITIME if time_kind == "tensor" else None
    pstate = _to_port(jstate, origin)
    jd.horizontal_boundary.reference_state = jstate
    pd.horizontal_boundary.reference_state = pstate
    dt = timedelta(milliseconds=1)
    for _ in range(10):
        jstate = jcore(jstate, {}, dt)
        pstate = pcore(pstate, {}, dt)
    back = state_to_numpy(pstate, origin)
    assert back["time"] == jstate["time"] == ITIME + 10 * dt
    nb = 3
    for n in UV:
        got, ref = back[n][0], np.asarray(jstate[n].data)
        _assert_close(got, ref, name=n)
        _assert_close(got[:nb], ref[:nb], name=f"{n} west frame")
        _assert_close(got[:, -nb:], ref[:, -nb:], name=f"{n} north frame")


def test_zhao_state_matches():
    jd, pd = _domains()
    jstate = JaxZhaoState(ITIME, 0.1)(ITIME, jd.numerical_grid)
    pstate = ZhaoStateFactory(ITIME, 0.1, storage_options=CPU64)(ITIME, pd.numerical_grid)
    t = ITIME + timedelta(seconds=0.37)
    jz, pz = JaxZhao(ITIME, 0.1), ZhaoSolutionFactory(ITIME, 0.1)
    for n in UV:
        assert pstate[n].shape == (21, 21, 1)
        _assert_close(pstate[n].data.numpy(), jstate[n].data, name=n)
        sx, sy = slice(2, 9), slice(0, 3)
        ref = jz(t, jd.numerical_grid, sx, sy, n, "km hr^-1")
        _assert_close(pz(t, pd.numerical_grid, sx, sy, n, "km hr^-1").numpy(), ref, name=n)
        _assert_close(pz(torch.tensor(0.37, dtype=torch.float64), pd.numerical_grid, sx, sy, n,
                         "km hr^-1").numpy(), ref, name=n)


def test_interop_carries_the_zhao_state_and_its_time():
    jd, _ = _domains()
    t = ITIME + timedelta(seconds=2, microseconds=5)
    jstate = JaxZhaoState(ITIME, 0.1)(t, jd.numerical_grid)
    for origin in (None, ITIME):
        pstate = _to_port(jstate, origin)
        assert isinstance(pstate["time"], torch.Tensor) == (origin is not None)
        back = state_to_numpy(pstate, origin)
        assert back["time"] == t
        for n in UV:
            assert back[n][0].shape == (21, 21, 1) and back[n][1] == "m s^-1"
            np.testing.assert_array_equal(back[n][0], np.asarray(jstate[n].data))


# -- the analytic gates, on the port alone --------------------------------------


def _port_zhao_run(nx, scheme, flux, dt_s, nt):
    _, (pd, pz, pcore) = _zhao_models(nx, scheme, flux)
    state = ZhaoStateFactory(ITIME, 0.1, storage_options=CPU64)(ITIME, pd.numerical_grid)
    pd.horizontal_boundary.reference_state = state
    for _ in range(nt):
        state = pcore(state, {}, timedelta(seconds=dt_s))
    return state, pd, pz


@pytest.mark.parametrize("scheme", SCHEMES)
def test_dycore_tracks_exact_solution(scheme):
    """``tests/test_burgers.py::TestZhao::test_dycore_tracks_exact_solution``."""
    state, pd, pz = _port_zhao_run(21, scheme, "first_order", 1e-3, 10)
    t_end = ITIME + 10 * timedelta(seconds=1e-3)
    assert state["time"] == t_end
    exact = pz(t_end, pd.numerical_grid, field_name="x_velocity").numpy()
    err = np.abs(state["x_velocity"].data.numpy() - exact).max()
    assert err < 0.05 * np.abs(exact).max(), (scheme, err)


def test_rk_schemes_agree():
    """``tests/test_burgers.py::TestZhao::test_rk_schemes_agree``."""
    errs = {}
    for scheme in ("rk2", "rk3ws"):
        state, pd, pz = _port_zhao_run(21, scheme, "third_order", 0.004, 25)
        exact = pz(ITIME + 25 * timedelta(seconds=0.004), pd.numerical_grid, field_name="x_velocity").numpy()
        errs[scheme] = np.abs(state["x_velocity"].data.numpy() - exact).max()
        assert errs[scheme] < 0.01 * np.abs(exact).max(), (scheme, errs[scheme])
    assert errs["rk3ws"] == pytest.approx(errs["rk2"], rel=0.1)


def test_first_order_convergence_ladder():
    """``tests/test_convergence.py::test_burgers_full_solution_first_order_convergence``."""
    t_end_s, nb = 0.06, 3

    def err(nx, dt_s):
        state, pd, pz = _port_zhao_run(nx, "rk3ws", "first_order", dt_s, int(round(t_end_s / dt_s)))
        exact = pz(ITIME + timedelta(seconds=t_end_s), pd.numerical_grid, field_name="x_velocity").numpy()
        return np.abs(state["x_velocity"].data.numpy() - exact)[nb:-nb, nb:-nb].max()

    errors = [err(17, 3e-3), err(33, 1.5e-3), err(65, 7.5e-4)]
    orders = [float(np.log2(a / b)) for a, b in zip(errors[:-1], errors[1:])]
    assert orders[-1] == pytest.approx(1.0, abs=0.4), (errors, orders)


# -- the boundaries -------------------------------------------------------------


def _core(time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
    """A Dirichlet core that depends on the band, the field's staggering and
    the time."""
    name = field_name or ""
    x = np.asarray((grid.x_at_u_locations if "at_u" in name else grid.x).data)[slice_x or slice(None)]
    y = np.asarray((grid.y_at_v_locations if "at_v" in name else grid.y).data)[slice_y or slice(None)]
    t = (time - ITIME).total_seconds() if time is not None else 0.0
    return (np.sin(3.0 * x)[:, None] * np.cos(2.0 * y)[None, :] + t)[:, :, None]


GRIDS = {"2d": (9, 8), "nx1": (1, 8), "ny1": (9, 1)}
NAMES = ("x_velocity", "x_velocity_at_u_locations", "y_velocity_at_v_locations")


def _boundary_pair(boundary, grid):
    nx, ny = GRIDS[grid]
    kwargs = {"core": _core} if boundary == "dirichlet" else None
    jd, pd = _domains(nx=nx, ny=ny, nb=2, boundary=boundary, kwargs=kwargs)
    return jd.horizontal_boundary, pd.horizontal_boundary


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("boundary", ["periodic", "dirichlet", "identity"])
def test_boundary_matches(boundary, grid, name):
    jhb, phb = _boundary_pair(boundary, grid)
    ni, nj = phb.ni, phb.nj
    assert (ni, nj) == (jhb.ni, jhb.nj)
    shape = (ni + ("at_u" in name), nj + ("at_v" in name), 3)
    field = _rand(shape, 7)
    t = ITIME + timedelta(seconds=0.25)
    for method in ("enforce_field", "set_outermost_layers_x", "set_outermost_layers_y"):
        got = getattr(phb, method)(torch.as_tensor(field), name, "m s^-1", time=t)
        want = getattr(jhb, method)(field, name, "m s^-1", time=t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=method)


@pytest.mark.parametrize("grid", sorted(GRIDS))
@pytest.mark.parametrize("boundary", ["periodic", "dirichlet", "identity"])
def test_boundary_numerical_grid_matches(boundary, grid):
    jhb, phb = _boundary_pair(boundary, grid)
    for axis in ("x", "y", "x_at_u_locations", "y_at_v_locations"):
        np.testing.assert_array_equal(getattr(phb.numerical_grid, axis).data,
                                      np.asarray(getattr(jhb.numerical_grid, axis).data), err_msg=axis)
    nx, ny = GRIDS[grid]
    plane = _rand((nx, ny), 8)
    got = phb.get_numerical_field(plane)
    np.testing.assert_array_equal(got, np.asarray(jhb.get_numerical_field(plane)))
    np.testing.assert_array_equal(phb.get_physical_field(got), np.asarray(jhb.get_physical_field(got)))
    t = phb.get_numerical_field(torch.as_tensor(plane))
    np.testing.assert_array_equal(t.numpy(), got)


def test_domain_takes_the_three_boundaries():
    for boundary in ("periodic", "dirichlet", "identity"):
        _, pd = _domains(nx=9, ny=8, nb=2, boundary=boundary)
        assert pd.horizontal_boundary.type == boundary


# -- the driver -----------------------------------------------------------------


def test_bench_case_matches_bench_burgers():
    """``--case bench`` at 64x64, 1 + 2 steps, against the stage algebra of
    ``bench.py::bench_burgers`` (the JAX advection) on the same input."""
    nx, nb = 64, 3
    res = drv.run_case("bench", nx, steps=2, so=CPU64, verbose=False)
    start = drv.bench_fields(nx, nx, nb, 0, CPU64)
    u, v = (jnp.asarray(start[n].data.numpy()) for n in UV)
    adv = JaxAdvection.factory("third_order")
    ext, dx, dt = adv.extent, 1.0 / nx, 1e-4

    def stage(u, v, u0, v0, frac):  # bench.py:34-41
        iw = slice(nb - ext, u.shape[0] - nb + ext)
        jw = slice(nb - ext, u.shape[1] - nb + ext)
        a_ux, a_uy, a_vx, a_vy = adv(dx, dx, u[iw, jw], v[iw, jw])
        i = slice(nb, u.shape[0] - nb)
        j = slice(nb, u.shape[1] - nb)
        return u0.at[i, j].add(-frac * dt * (a_ux + a_uy)), v0.at[i, j].add(-frac * dt * (a_vx + a_vy))

    for _ in range(3):
        u1, v1 = stage(u, v, u, v, 1.0 / 3.0)
        u2, v2 = stage(u1, v1, u, v, 0.5)
        u, v = stage(u2, v2, u, v, 1.0)
    for n, ref in zip(UV, (u, v)):
        _assert_close(res["fields"][n].data.numpy(), ref, name=n)
    assert res["launches_per_step"] == {}


def test_zhao_case_runs_on_the_cpu():
    res = drv.run_case("zhao", 21, steps=3, so=CPU64, verbose=False)
    assert res["dt"] == pytest.approx(0.004)
    for n in UV:
        assert res["fields"][n].shape == (21, 21, 1)
        assert torch.isfinite(res["fields"][n].data).all()
    assert 0.0 < res["err_u"] < 0.05 * res["umax"] and res["err_v"] > 0.0


def test_driver_requires_a_gpu_unless_the_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a GPU is available")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        drv.main(["--case", "bench", "--nx", "16", "--steps", "1"])


@pytest.mark.parametrize("case", drv.CASES)
def test_fused_loop_is_refused_on_the_cpu(case):
    with pytest.raises(ValueError, match="CUDA"):
        drv.main(["--case", case, "--nx", "16", "--steps", "1", "--device", "cpu", "--fused-loop"])
