"""The port's 2-D domain decomposition (``tasmania_tpu_torch/parallel/``,
``drivers/driver_sharded.py``) against the JAX package's shard_map runner
and against the port's own single-device step, on the CPU in float64.

* The whole-stage stage's distributed mode: ``si_stage_plain(dist=True)``
  on halo-extended blocks (pad nb + 1) cut from a seeded 42x42x8 global
  state, for a corner, an edge and an interior shard of a 3x3 grid of
  ranks, at orders 3 and 5, the first stage and the last with damping,
  against JAX ``fused_si_stage(dist=True, interpret=True)`` with the ``yb``
  and ``epi_w`` the JAX prognostic passes, with the relaxed boundary's γ
  and with γ = 0 (where the global frame's kept "now" values show in the
  outputs): the owned cells within 1e-12 of
  each field's largest magnitude (the JAX kernel sums the Montgomery scans
  as triangular matrix products).  The same owned cells equal the
  single-device stage on the global arrays bit for bit.
* The decomposed step (``driver_sharded.rank_run`` on local gloo ranks):
  the flagship namelist at 48x48x8 from relative humidity 1.2, the whole
  moist SUS chain, 2 steps, on 2x2, 2x1, 1x2 and 1x1 grids of ranks,
  against the port's single-device run (bit for bit, every face of the
  staggered fields included, gathered from the step) and the JAX
  ``DistributedModel`` with ``pallas:interpret`` on the same mesh within
  1e-12 of each field's largest magnitude; the 1x1 grid takes the
  degenerate route, the ring nb + 1 deep (the momenta and the velocities held to their vector's
  largest magnitude: the JAX kernels sum the Montgomery scans as matrix
  products, and the pressure gradient carries their last digits into the
  y components, which are small beside the x ones).  The periodic boundary (the dycore alone) on 2x2 and
  2x1 against the port's 1x1 run (the decomposition's period-nx ring, as
  ``tests/test_distributed_framework.py::test_periodic_bc_topology_equivalence``
  holds the JAX one) and against the JAX runner, the ring nb deep as
  there; the identity and the Dirichlet boundary (a time-independent core
  pinning the frame to a perturbed start; the dycore alone) on 2x2 against
  the port's single device and the JAX runner.
* Every rank reports ``jax`` and ``tasmania_tpu`` absent from its
  ``sys.modules``.
* The refusals of the JAX package: a grid one cell deep, an nx the mesh
  does not divide, a block smaller than the halo, a time-dependent
  Dirichlet core; and NCCL with more ranks than GPUs, and the fused loop;
  ranks that fail end the run at once.
"""

from __future__ import annotations

import importlib
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tasmania_tpu.ops.si_stage import fused_si_stage
from tasmania_tpu.parallel import make_mesh
from tasmania_tpu.parallel.runner import DistributedModel as JaxDistributedModel
from tasmania_tpu_torch.domain.boundaries.dirichlet import ArrayCore
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers import driver_sharded as shd
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage_plain
from tasmania_tpu_torch.parallel import launch
from tasmania_tpu_torch.parallel.distributed import DistributedBoundary
from tasmania_tpu_torch.parallel.halo import Exchange
from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition, RankGrid, make_rank_grid
from tests.test_torch_kernels import (
    CONSTS,
    DTF,
    FRACS,
    NB,
    NR,
    assert_scaled,
    stage_inputs,
    stage_windows,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")

# ------------------------------------------------------- the stage's dist mode

GRID3 = RankGrid(3, 3)
GN, GZ, PAD = 42, 8, NB + 1
SHARDS = {"corner": 0, "edge": 1, "interior": 4}  # ranks of the 3x3 grid


def _port(inp, damp, c, order, **dist):
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    keys = ("u", "v", "s_now", "s_int", "q_now", "q_int", "su_now", "sv_now", "su_int",
            "sv_int", "mtg_now", "hs", "theta", "gamma", "s_ref", "su_ref", "sv_ref", "q_refs")
    args = [[t(a) for a in inp[k]] if isinstance(inp[k], list) else t(inp[k]) for k in keys]
    out = si_stage_plain(*args, t(inp["rmat"]) if damp else None, nb=NB, c=c,
                         dd=inp["dd"] if damp else 0, order=order, **dist)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("relaxed", [True, False], ids=["relaxed", "gamma0"])
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("shard", list(SHARDS))
@pytest.mark.parametrize("stage", [0, 2])
def test_dist_stage_twin_matches_pallas(order, shard, stage, relaxed):
    """With γ = 0 the keep-now frame shows in the outputs (under the relaxed
    boundary γ = 1 there pins the frame to the reference either way)."""
    damp = stage == 2  # the last stage, with damping
    inp = stage_inputs(seed=30 + stage, shape=(GN, GN, GZ))
    if not relaxed:
        inp["gamma"] = np.zeros_like(inp["gamma"])
    decomp = CartesianDecomposition(GN, GN, GRID3, NB, PAD, PAD)
    rank = SHARDS[shard]
    w = stage_windows(inp, decomp, rank)
    gx0, gy0 = decomp.offset(rank)
    dt = FRACS[stage] * DTF
    c = StageConstants(dt=dt, dtf=DTF, **CONSTS)
    got = _port(w, damp, c, order, dist=True, goff=(gx0, gy0), gnx=GN, gny=GN)
    j = jnp.asarray
    ref = fused_si_stage(
        j(w["u"]), j(w["v"]), j(w["s_now"]), j(w["s_int"]), tuple(map(j, w["q_now"])),
        tuple(map(j, w["q_int"])), j(w["su_now"]), j(w["sv_now"]), j(w["su_int"]),
        j(w["sv_int"]), j(w["mtg_now"]), j(w["hs"]), j(w["theta"])[None, :], j(w["gamma"]),
        j(w["s_ref"]), j(w["su_ref"]), j(w["sv_ref"]), tuple(map(j, w["q_refs"])),
        j(w["rmat"])[None, :],
        order=order, nb=NB, nr=NR, dt=dt, dtf=DTF, nq=3, do_damp=damp,
        dd=w["dd"] if damp else 1, interpret=True, dist=True,
        goff=jnp.asarray([gx0, gy0], jnp.int32), gnx=GN, gny=GN,
        yb=max(8, PAD + NR), epi_w=PAD + NR, **CONSTS,
    )
    whole = _port(inp, damp, c, order)
    ix, iy = GRID3.coords(rank)
    bx = decomp.bx
    own = (slice(PAD, PAD + bx), slice(PAD, PAD + bx))
    glob = (slice(ix * bx, (ix + 1) * bx), slice(iy * bx, (iy + 1) * bx))
    for k, (a, b, g) in enumerate(zip(got, ref, whole)):
        what = f"output {k}, {shard}, order {order}, stage {stage}"
        assert_scaled(a[own], np.asarray(b)[own], 1e-12, what)
        np.testing.assert_array_equal(a[own], g[glob], err_msg=what)


# ------------------------------------------------------------- the whole step

NSTEPS = 2
SIZE = dict(nx=48, ny=48, nz=8)
MOIST = {"relative_humidity": 1.2}  # clouds form within the two steps
PERIODIC = {"hb_type": "periodic", "hb_kwargs": {}}


def _jax_run(shape, physics: bool, overrides, halo):
    """The JAX ``DistributedModel`` (``pallas:interpret``, ring ``halo``) on
    a ``shape`` mesh of virtual CPU devices: NSTEPS steps, the gathered
    state."""
    from tasmania_tpu.framework.options import StorageOptions as JaxStorage

    jnl = importlib.import_module("drivers.namelist_sus")
    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    for key, value in {**SIZE, **overrides}.items():
        setattr(nl, key, value)
    nl.backend = "pallas:interpret"
    nl.so = JaxStorage(dtype=np.float64)
    from drivers.driver_namelist_sus import build_domain_and_state, build_model

    domain, state, pt = build_domain_and_state(nl)
    if physics:
        factory = lambda dom: build_model(nl, dom, pt)
    else:  # the JAX driver's run without --physics
        from tasmania_tpu.isentropic import IsentropicDynamicalCore

        def factory(dom):
            return IsentropicDynamicalCore(
                dom, moist=True, time_integration_scheme=nl.time_integration_scheme,
                horizontal_flux_scheme=nl.horizontal_flux_scheme,
                time_integration_properties={"pt": pt, "eps": nl.eps}, damp=nl.damp,
                damp_type=nl.damp_type, damp_depth=nl.damp_depth, damp_max=nl.damp_max,
                damp_at_every_stage=nl.damp_at_every_stage, smooth=False, backend=nl.backend,
                backend_options=nl.bo, storage_options=nl.so,
            ), None

    dt = nl.timestep.total_seconds()
    topo = nl.topo_kwargs["time"].total_seconds()
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    hs = domain.horizontal_boundary.get_physical_field(hs)  # the runner shards physical fields
    mesh = make_mesh(jax.devices()[: shape[0] * shape[1]], shape=shape)
    dm = JaxDistributedModel(domain, state, mesh, factory, dt, halo=halo)
    fields = dm.scatter_state(state)
    for i in range(NSTEPS):
        fields = dm.step(fields, dm.put_topography(min((i + 1) * dt / topo, 1.0) * hs))
    return {k: np.asarray(fa.data) for k, fa in dm.gather_state(fields).items()}


def _port_ranks(shape, physics: bool, overrides, workdir, halo):
    return shd.run(ranks=shape[0] * shape[1], comm="gloo", device="cpu", niter=NSTEPS,
                   physics=physics, f64=True, mesh=shape, warmup=False, verbose=False,
                   overrides=overrides, workdir=workdir, timeout_s=120.0, halo=halo, **SIZE)


def _check_ranks(res, shape):
    assert res["mesh"] == shape
    assert res["imported_by_rank"] == [[]] * (shape[0] * shape[1])


@pytest.fixture(scope="module")
def single_device():
    nl = shd.namelist("cpu", f64=True, niter=NSTEPS, **SIZE, **MOIST)
    return shd.single_device_run(nl, physics=True, warmup=False)["fields"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1), (1, 2), (1, 1)])
def test_decomposed_sus_step_matches(shape, single_device, tmp_path):
    res = _port_ranks(shape, True, MOIST, tmp_path, NB + 1)
    _check_ranks(res, shape)
    assert res["degenerate"] == (shape == (1, 1))
    if shape != (1, 1):
        assert res["pads"] == tuple(NB + 1 if n > 1 else 0 for n in shape)
    ref = _jax_run(shape, True, MOIST, NB + 1)
    assert float(single_device["mass_fraction_of_cloud_liquid_water_in_air"].max()) > 0.0
    assert set(res["fields"]) == set(single_device) == set(ref)
    for name, a in single_device.items():
        got = res["fields"][name]
        assert got.shape == a.shape, name  # every staggered face, gathered
        assert_scaled(got, a, 1e-13, f"{name} vs the single device")
        _assert_vs_jax(got, ref, name)


VECTORS = (("x_momentum_isentropic", "y_momentum_isentropic"),
           ("x_velocity_at_u_locations", "y_velocity_at_v_locations"))


def _assert_vs_jax(got, ref, name, tol=1e-12):
    """Within ``tol`` of the field's largest magnitude; the components of
    the momentum and of the velocity of their vector's (the JAX kernels sum
    the Montgomery scans as matrix products, whose last digits the pressure
    gradient carries into the momenta, and the y components are small
    beside the x ones)."""
    pair = next((p for p in VECTORS if name in p), (name,))
    scale = max(np.abs(ref[m]).max() for m in pair) or 1.0
    err = np.abs(got - ref[name]).max()
    assert err <= tol * scale, f"{name} vs the JAX runner: {err} > {tol} * {scale}"


@pytest.fixture(scope="module")
def periodic_one_rank(tmp_path_factory):
    res = _port_ranks((1, 1), False, PERIODIC, tmp_path_factory.mktemp("periodic"), NB)
    assert not res["degenerate"] and res["pads"] == (NB, NB)  # the ring wraps locally
    return res["fields"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_decomposed_periodic_dycore_matches(shape, periodic_one_rank, tmp_path):
    res = _port_ranks(shape, False, PERIODIC, tmp_path, NB)
    _check_ranks(res, shape)
    ref = _jax_run(shape, False, PERIODIC, NB)
    for name, a in periodic_one_rank.items():
        assert_scaled(res["fields"][name], a, 1e-13, f"{name} vs one rank")
        _assert_vs_jax(res["fields"][name], ref, name)
    s0 = shd.build_domain_and_state(shd.namelist("cpu", f64=True, **SIZE, **PERIODIC))[1]
    moved = res["fields"]["x_momentum_isentropic"] - s0["x_momentum_isentropic"].data.numpy()[
        NB:-NB, NB:-NB]
    assert np.abs(moved).max() > 0.0


IDENTITY = {"hb_type": "identity", "hb_kwargs": {}}


def test_decomposed_identity_dycore_matches(tmp_path):
    """The identity boundary (as ``test_distributed_framework.py::
    test_identity_bc_dry_dycore_bitwise``): the dycore alone on a 2x2 grid
    against the port's single device and the JAX runner."""
    res = _port_ranks((2, 2), False, IDENTITY, tmp_path, NB)
    _check_ranks(res, (2, 2))
    nl = shd.namelist("cpu", f64=True, niter=NSTEPS, **SIZE, **IDENTITY)
    single = shd.single_device_run(nl, physics=False, warmup=False)["fields"]
    ref = _jax_run((2, 2), False, IDENTITY, NB)
    for name, a in single.items():
        assert_scaled(res["fields"][name], a, 1e-13, f"{name} vs the single device")
        _assert_vs_jax(res["fields"][name], ref, name)


def test_decomposed_dirichlet_dycore_matches(tmp_path):
    """The Dirichlet boundary with a time-independent core that pins the
    frame to a perturbed start (as ``test_distributed_framework.py::
    test_dirichlet_core_distributed_bitwise``): the dycore alone on a 2x2
    grid against the port's single device and the JAX runner."""
    nl = shd.namelist("cpu", f64=True, niter=NSTEPS, **SIZE, **MOIST)
    state = shd.build_domain_and_state(nl)[1]
    rng = np.random.default_rng(3)
    values = {n: fa.data.numpy() * (1.0 + 1e-3 * rng.standard_normal(tuple(fa.data.shape)))
              for n, fa in state.items() if n != "time"}
    dirichlet = {"hb_type": "dirichlet", "hb_kwargs": {"core": ArrayCore(values)}, **MOIST}
    res = _port_ranks((2, 2), False, dirichlet, tmp_path, NB)
    _check_ranks(res, (2, 2))
    nl = shd.namelist("cpu", f64=True, niter=NSTEPS, **SIZE, **dirichlet)
    single = shd.single_device_run(nl, physics=False, warmup=False)["fields"]
    ref = _jax_run((2, 2), False, dirichlet, NB)
    for name, a in single.items():
        assert_scaled(res["fields"][name], a, 1e-13, f"{name} vs the single device")
        _assert_vs_jax(res["fields"][name], ref, name)
    qv = "mass_fraction_of_water_vapor_in_air"  # undamped: the frame is the core's
    np.testing.assert_array_equal(res["fields"][qv][:NB], values[qv][:NB])


# ------------------------------------------------------------------ refusals


def test_refuses_a_grid_one_cell_deep():
    """As ``test_distributed_framework.py::test_one_dimensional_grid_raises``:
    the decomposition refuses the block, and with nb = 0 the boundary."""
    domain = Domain((0.0, 1e5), 16, (0.0, 1.0), 1, FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
                    4, nb=NB, horizontal_boundary_type="identity", storage_options=CPU64)
    grid = RankGrid(4, 1)
    with pytest.raises(ValueError, match="smaller than halo width"):
        CartesianDecomposition(16, 1, grid, NB)
    with pytest.raises(ValueError, match="one cell deep"):
        DistributedBoundary(domain, CartesianDecomposition(16, 1, grid, 0),
                            Exchange(grid, 0, "gloo", False))


def test_refuses_a_time_dependent_dirichlet_core():
    """A core that returns a tensor (as the Zhao solution's) raises, as the
    JAX class raises for one that returns a traced array."""
    def tensor_core(time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
        return torch.ones(slice_x.stop - slice_x.start, slice_y.stop - slice_y.start, 1)

    domain = Domain((0.0, 1e5), 16, (0.0, 1e5), 16, FieldArray(np.array([400.0, 300.0]), "K", ("z",)),
                    4, nb=NB, horizontal_boundary_type="dirichlet",
                    horizontal_boundary_kwargs={"core": tensor_core}, storage_options=CPU64)
    grid = RankGrid(2, 2)
    hb = DistributedBoundary(domain, CartesianDecomposition(16, 16, grid, NB),
                             Exchange(grid, 0, "gloo", False))
    ref = {"air_isentropic_density": FieldArray(torch.ones(16, 16, 4, dtype=torch.float64),
                                                "kg m^-2 K^-1", ("x", "y", "z"))}
    with pytest.raises(NotImplementedError, match="time-dependent"):
        hb.set_reference_state(ref)


@pytest.mark.parametrize("nx,ny,grid,pad,match", [
    (47, 48, (2, 2), NB, "not divisible"),
    (48, 50, (2, 4), NB, "not divisible"),
    (8, 8, (4, 2), PAD, "smaller than halo"),
])
def test_refuses_a_bad_decomposition(nx, ny, grid, pad, match):
    with pytest.raises(ValueError, match=match):
        CartesianDecomposition(nx, ny, RankGrid(*grid), NB, pad, pad)


def test_refuses_a_bad_mesh():
    with pytest.raises(ValueError, match="mesh shape"):
        make_rank_grid(4, (3, 2))


def test_refuses_nccl_without_a_gpu_a_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 GPUs"):
        shd.run(ranks=4, comm="nccl", device="cuda", **SIZE, niter=1)
    with pytest.raises(ValueError, match="needs --device cuda"):
        launch.check_backend("nccl", "cpu", 1)


def test_a_failing_rank_fails_its_caller(tmp_path):
    """Ranks that raise (here on an nx the grid does not divide) end the
    run at once with the ranks' failure, well before the deadline."""
    import time

    spec = launch.RunSpec(target="tasmania_tpu_torch.drivers.driver_sharded:rank_run", world=2,
                          backend="gloo", device="cpu", mesh=(2, 1), timeout_s=60.0,
                          kwargs=dict(nx=47, ny=48, nz=8, niter=1, physics=False, f64=True))
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed"):
        launch.run_ranks(spec, tmp_path)
    assert time.monotonic() - t0 < 60.0


def test_refuses_the_fused_loop():
    with pytest.raises(ValueError, match="CUDA graph"):
        shd.main(["--fused-loop", "--device", "cpu", "--comm", "gloo"])
