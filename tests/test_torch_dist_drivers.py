"""The SUS driver's ``--spmd`` and the root drivers ``driver_profile``,
``driver_dist_bench`` and ``driver_weak_scaling`` of the port, on the CPU in
float64 (``tasmania_tpu_torch/drivers/``).

* ``--spmd`` on four gloo ranks (2x2) at ``tests/test_torch_distributed.py``'s
  size from relative humidity 1.2, a warm-up step and two steps, within
  1e-12 of the JAX step sharded over its 2x2 virtual mesh by the SPMD
  partitioner (the setup of ``tests/test_spmd_full_step.py``: the ``"jax"``
  backend, against which the port runs ``sedimentation_vt_mode="stage"``),
  the momenta and velocities held to their vector's largest magnitude, as
  ``tests/test_torch_distributed.py`` holds them; a NaN written into one
  rank's block stops every rank at the same checkpoint boundary; more than
  one rank refuses ``--fused-loop``.
* ``driver_profile``: each variant's warm-up step and one step at 17x17x8
  within 1e-12 of the JAX driver's ``build_model(skip=...)`` step with the
  same skip set (``physics_only`` without the dycore, ``no_damp`` without
  its damping); the launches each variant leaves (``expected_launches``);
  an unknown variant raises.
* ``driver_dist_bench --mesh 1,1``: the degenerate grid, bit for bit the
  single device.
* ``driver_weak_scaling`` on 1 and 4 gloo ranks: each rank's counted
  exchange bytes equal the ring's (``halo.ring_bytes``, itself checked by
  hand on a 3x3 grid); ``--analyze`` without ``--link-gbs`` projects
  nothing, and needs the single rank's run.
"""

from __future__ import annotations

import importlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tasmania_tpu.framework.field import FieldArray as JaxFieldArray
from tasmania_tpu.framework.options import StorageOptions as JaxStorageOptions
from tasmania_tpu.parallel import make_mesh
from tasmania_tpu_torch.drivers import driver_dist_bench as ddb
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers import driver_profile as dprof
from tasmania_tpu_torch.drivers import driver_weak_scaling as dws
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_to_numpy
from tasmania_tpu_torch.parallel import launch
from tasmania_tpu_torch.parallel.halo import Exchange, ring_bytes
from tasmania_tpu_torch.parallel.mesh import RankGrid
from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
SIZE = dict(nx=48, ny=48, nz=8)  # tests/test_torch_distributed.py's
NITER = 2
VECTORS = (("x_momentum_isentropic", "y_momentum_isentropic"),
           ("x_velocity_at_u_locations", "y_velocity_at_v_locations"))


def _assert_close(got, ref, tol, what):
    assert set(got) == set(ref), what
    for name in sorted(ref):
        assert got[name].shape == ref[name].shape, (what, name)
        pair = next((p for p in VECTORS if name in p), (name,))
        scale = max(np.abs(ref[m]).max() for m in pair) or 1.0
        err = np.abs(got[name] - ref[name]).max()
        assert err <= tol * scale, f"{what}, {name}: {err} > {tol} * {scale}"


def _jax_namelist(**values):
    jnl = importlib.import_module("drivers.namelist_sus")
    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    for key, value in values.items():
        setattr(nl, key, value)
    nl.so = JaxStorageOptions(dtype=np.float64)
    return nl


def _jax_run(nl, *, skip=(), no_dycore=False, mesh_shape=None):
    """The JAX driver's model (``build_model(skip=)``): the warm-up step at
    zero mountain height and ``nl.niter`` steps; with ``mesh_shape`` the
    fields sharded over a mesh of virtual CPU devices and the step jitted
    (``tests/test_spmd_full_step.py``)."""
    from drivers.driver_namelist_sus import build_domain_and_state, build_model

    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip=skip)
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)

    def step(fields, hs_now):
        st = {k: JaxFieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = JaxFieldArray(hs_now, "m", ("x", "y"))
        if not no_dycore:
            st = dycore(st, {}, dt_s)
        st = physics(st, dt_s)
        return {k: st[k].data for k in names}

    fields = {k: jnp.asarray(state[k].data) for k in names}
    put = jnp.asarray
    if mesh_shape is not None:
        mesh = make_mesh(jax.devices()[: mesh_shape[0] * mesh_shape[1]], shape=mesh_shape)

        def sharding(v):
            spec = [("x", "y")[a] if v.shape[a] % mesh_shape[a] == 0 else None
                    for a in range(min(v.ndim, 2))]
            return NamedSharding(mesh, P(*(spec + [None] * (v.ndim - len(spec)))))

        fields = {k: jax.device_put(v, sharding(v)) for k, v in fields.items()}
        put = lambda a: jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("x", "y")))
        step = jax.jit(step)
    for fact in [0.0] + [min((i + 1) * dt_s / topo_time, 1.0) for i in range(nl.niter)]:
        fields = step(fields, put(fact * hs))
    if mesh_shape is not None:
        assert len(fields["air_isentropic_density"].sharding.device_set) == 4
    return {k: np.asarray(v) for k, v in fields.items()}


# ----------------------------------------------------------------------- --spmd


def test_spmd_matches_the_jax_step_sharded_over_2x2(tmp_path):
    overrides = dict(SIZE, niter=NITER, relative_humidity=1.2, sedimentation_vt_mode="stage", so=CPU64)
    res = drv.run_spmd(overrides, ranks=4, comm="gloo", device="cpu", mesh=(2, 2), verbose=False,
                       timeout_s=120.0, workdir=tmp_path)
    assert res["imported_by_rank"] == [[]] * 4 and not res["degenerate"]
    assert res["pads"] == (4, 4)  # nb + 1: the fused stage's ring
    assert all(e["exchanges"] > 0 for e in res["exchange_by_rank"])
    ref = _jax_run(_jax_namelist(**SIZE, niter=NITER, relative_humidity=1.2), mesh_shape=(2, 2))
    assert ref["mass_fraction_of_cloud_liquid_water_in_air"].max() > 0.0
    _assert_close(res["fields"], ref, 1e-12, "--spmd on 2x2 vs the JAX step sharded over 2x2")


def test_nan_guard_stops_every_rank_at_the_same_boundary(tmp_path):
    """Rank 1 alone writes a NaN at step 3 (its 4th step call): every rank's
    guard trips at step 4, the next boundary, naming step 2; no step after
    it is saved."""
    ck = str(tmp_path / "ck")
    spec = launch.RunSpec(
        target="tests.torch_rank_jobs:guarded_spmd", world=4, backend="gloo", device="cpu",
        mesh=(2, 2), timeout_s=120.0,
        kwargs=dict(poison_rank=1, poison_call=4, checkpoint_dir=ck, checkpoint_every=2,
                    nan_guard=True, overrides=dict(SIZE, niter=6, so=CPU64)))
    results = launch.run_ranks(spec, tmp_path / "ranks")
    messages = {r["result"]["guard"] for r in results}
    assert len(messages) == 1, messages
    assert messages.pop() == ("non-finite state detected at step 4; last good checkpoint: step 2 "
                              "(restart with --resume)")
    assert {r["result"]["calls"] for r in results} == {5}  # warm-up + 4 steps on every rank
    assert [r["imported"] for r in results] == [[]] * 4
    assert CheckpointManager(ck).all_steps() == [2]


def test_more_than_one_rank_refuses_the_fused_loop():
    with pytest.raises(ValueError, match="CUDA graph"):
        drv.run_spmd(dict(SIZE, niter=1, so=CPU64), ranks=2, comm="gloo", device="cpu",
                     fused_loop=True)
    with pytest.raises(ValueError, match="CUDA graph"):
        drv.main(["--spmd", "--ranks", "2", "--comm", "gloo", "--device", "cpu", "--fused-loop"])


def test_spmd_flags_need_spmd(capsys):
    with pytest.raises(SystemExit):
        drv.main(["--ranks", "4", "--device", "cpu"])
    assert "go with --spmd" in capsys.readouterr().err


# -------------------------------------------------------------- driver_profile

PROFILE_SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}


@pytest.mark.parametrize("name", list(dprof.VARIANTS))
def test_profile_variant_matches_jax_build_model(name):
    """One step after the warm-up, the port's variant on the CPU against
    the JAX driver's model with the same skip set (the ``"jax"`` backend;
    the port with ``sedimentation_vt_mode="stage"``)."""
    skip, opts = dprof.variant(name)
    nl = load_namelist(**PROFILE_SIZE, niter=1, so=CPU64, sedimentation_vt_mode="stage")
    got = {k: a for k, (a, _) in state_to_numpy(dprof.run_variant(nl, name, fused_loop=False)["fields"]).items()}
    jnl = _jax_namelist(**PROFILE_SIZE, niter=1)
    if "damp" in opts:
        jnl.damp = opts["damp"]
    ref = _jax_run(jnl, skip=tuple(skip), no_dycore=bool(opts.get("no_dycore")))
    _assert_close(got, ref, 1e-12, f"variant {name}")


def test_profile_expected_launches():
    sus = dprof.expected_launches("full")
    assert sus == {"si_stage": 3, "fused_isentropic_diagnostics": 1, "fused_smoothing": 1,
                   "fused_smagorinsky_rk2": 1, "fused_kessler_satadj_rk2": 1,
                   "fused_vertical_advection_rk3ws": 1, "fused_sedimentation_rk3ws": 1}
    assert dprof.expected_launches("dycore_only") == {"si_stage": 3}
    assert dprof.expected_launches("physics_only") == {k: n for k, n in sus.items() if k != "si_stage"}
    assert dprof.expected_launches("no_smoothing") == {k: n for k, n in sus.items() if k != "fused_smoothing"}
    assert dprof.expected_launches("no_pointwise") == {
        k: n for k, n in sus.items() if k != "fused_kessler_satadj_rk2"}
    assert dprof.expected_launches("no_velocities") == dprof.expected_launches("no_damp") == sus


def test_profile_refuses_an_unknown_variant():
    with pytest.raises(ValueError, match="unknown variant 'no_such'"):
        dprof.variant("no_such")
    with pytest.raises(ValueError, match="unknown variant"):
        dprof.main(["--variants", "full,no_such", "--device", "cpu"])


# ----------------------------------------------------------- driver_dist_bench


def test_dist_bench_one_rank_is_the_single_device(capsys):
    res = ddb.main(["--mesh", "1,1", "--comm", "gloo", "--device", "cpu", "--nx", "17", "--nz", "8",
                    "--niter", "2"])
    assert res["degenerate"] and res["pads"] == [0, 0] and not res["graph"]
    assert res["bitwise"] and res["unequal"] == []
    for k, a in res["single_fields"].items():
        np.testing.assert_array_equal(res["fields"][k], a, err_msg=k)
    assert len(res["dist_ms_per_step_runs"]) == len(res["single_ms_per_step_runs"]) == ddb.MIN_PAIRS
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"degenerate": true' in line and '"ratio"' in line
    with pytest.raises(ValueError, match="at least 5"):
        ddb.bench(mesh=(1, 1), comm="gloo", device="cpu", nx=17, nz=8, niter=1, pairs=3)


# -------------------------------------------------------- driver_weak_scaling


def test_ring_bytes_by_hand():
    """The ring a 3x3 grid's ranks send, for blocks of 10x12 with pads
    (2, 3) and columns of 100 bytes: the interior rank sends to four
    neighbours, the corner to two (on a periodic domain to four)."""
    grid = RankGrid(3, 3)
    for rank, periodic, want in ((4, False, 2 * 2 * 12 + 2 * 3 * 10), (0, False, 2 * 12 + 3 * 10),
                                 (0, True, 2 * 2 * 12 + 2 * 3 * 10), (1, False, 2 * 12 + 2 * 3 * 10)):
        ex = Exchange(grid, rank, "gloo", periodic)
        assert ring_bytes(ex, (2, 3), (10, 12), 100) == 100 * want, (rank, periodic)
    # an axis of one rank sends nothing (a periodic one wraps locally)
    assert ring_bytes(Exchange(RankGrid(1, 1), 0, "gloo", True), (3, 3), (10, 10), 100) == 0


@pytest.fixture(scope="module")
def weak():
    return dws.weak_scaling([1, 4], block=16, nz=8, niter=2, comm="gloo", device="cpu",
                            verbose=False)


def test_weak_scaling_counts_the_ring(weak):
    one, four = weak["rows"]
    assert one["n"] == 1 and one["exchange_bytes_per_step"] == 0 and one["mesh"] == [1, 1]
    assert four["n"] == 4 and four["mesh"] == [2, 2] and four["pads"] == [4, 4]
    assert four["block_with_ring"] == [16 + 8, 16 + 8]
    for r in four["by_rank"]:
        assert r["exchange_bytes_per_step"] == r["ring_bytes_per_step"] > 0
        assert r["messages_per_step"] == 2 * four["exchanges_per_step"]  # one neighbour a decomposed axis
    assert four["imported_by_rank"] == [[]] * 4
    assert weak["rows"][0]["weak_scaling_efficiency"] == 1.0
    assert "not an interconnect" in weak["note"]


def test_weak_scaling_analysis_needs_a_link_rate_and_the_single_rank(weak):
    a = dws.analyze(weak["rows"], 16, 8, None)
    assert a["projection"].startswith("none") and not any(k.startswith("projected") for k in a)
    assert a["gps_single_rank_measured"] == weak["rows"][0]["gps"]
    assert a["exchange_bytes_per_step_per_rank"] == weak["rows"][1]["exchange_bytes_per_step"]
    assert a["flops"].startswith("not counted")
    b = dws.analyze(weak["rows"], 16, 8, 100.0)
    assert b["t_comm_s"] == a["exchange_bytes_per_step_per_rank"] / 100e9
    assert b["projected_efficiency_serial"] == a["t_compute_s"] / (a["t_compute_s"] + b["t_comm_s"])
    with pytest.raises(ValueError, match="include 1"):
        dws.analyze(weak["rows"][1:], 16, 8, 100.0)


@pytest.mark.parametrize("main, argv", [(drv.main, ["--spmd"]), (dprof.main, []), (ddb.main, []),
                                        (dws.main, [])], ids=["spmd", "profile", "dist_bench",
                                                              "weak_scaling"])
def test_entry_points_default_to_the_card(main, argv, capsys, monkeypatch):
    """Each new entry point runs on ``cuda`` unless told ``--device cpu``;
    without a GPU its parser exits saying so."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        main(argv)
    assert err.value.code == 2
    assert "no CUDA device is available" in capsys.readouterr().err
