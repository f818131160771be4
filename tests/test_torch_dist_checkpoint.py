"""Sharded checkpoints with elastic restore (``tasmania_tpu_torch/utils/
checkpoint.py`` with ``parallel/runner.py::ShardLayout``), on the CPU in
float64 at ``tests/test_torch_distributed.py``'s size, from relative
humidity 1.2 (clouds form).

The SUS driver's ``--spmd`` runs on four gloo ranks (2x2), a checkpoint a
step, the manager keeping three (the JAX class's counterpart holds a 4x2
checkpoint restored on 2x4, ``tests/test_checkpoint.py:56``):

* the step's rank files and metadata; rotation and ``latest_step`` count
  sharded steps; a step with a rank's file missing, or a temporary
  directory, is not a step;
* the restore onto the ranks of 1x1, 2x1, 1x2, 4x1 and 2x2, one layout at
  a time in this process: every owned block and every staggered face
  equals the one ``ShardLayout.scatter_state`` cuts from the gathered
  state, bit for bit; without a model the assembled global state is the
  gathered one (the JAX class's fallback for absent devices); a
  single-process checkpoint restores onto 2x2 and a sharded one onto one
  process; a restore asked for ``cuda`` raises without a GPU;
* resumed runs: on 2x2 from step 2 bit for bit the uninterrupted run; on
  4x1 within 1e-13 of it and within 1e-12 of the JAX ``DistributedModel``'s
  uninterrupted run on the 2x2 virtual CPU mesh (``pallas:interpret``, ring
  nb + 1, as ``tests/test_torch_distributed.py`` runs it).
"""

from __future__ import annotations

import importlib
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax

from tasmania_tpu.parallel import make_mesh
from tasmania_tpu.parallel.runner import DistributedModel as JaxDistributedModel
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.parallel.mesh import RankGrid
from tasmania_tpu_torch.parallel.runner import ShardLayout
from tasmania_tpu_torch.utils.checkpoint import RANK_FILE, CheckpointManager

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
NITER = 4
OVERRIDES = dict(nx=48, ny=48, nz=8, relative_humidity=1.2, niter=NITER, so=CPU64)
VECTORS = (("x_momentum_isentropic", "y_momentum_isentropic"),
           ("x_velocity_at_u_locations", "y_velocity_at_v_locations"))


def _scaled_error(got, ref, name):
    pair = next((p for p in VECTORS if name in p), (name,))
    scale = max(np.abs(ref[m]).max() for m in pair) or 1.0
    return np.abs(got[name] - ref[name]).max() / scale


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """The 2x2 run checkpointed every step, and its directory (kept
    unchanged: tests that write copy it)."""
    ck = str(tmp_path_factory.mktemp("ck") / "sharded")
    res = drv.run_spmd(OVERRIDES, ranks=4, comm="gloo", device="cpu", mesh=(2, 2), verbose=False,
                       checkpoint_dir=ck, checkpoint_every=1, timeout_s=120.0,
                       workdir=tmp_path_factory.mktemp("ranks"))
    assert res["imported_by_rank"] == [[]] * 4
    return res, ck


@pytest.fixture(scope="module")
def setup():
    nl = load_namelist(**OVERRIDES)
    domain, state, _ = drv.build_domain_and_state(nl)
    return nl, domain, state


def _copy(ck, tmp_path):
    dst = str(tmp_path / "ck")
    shutil.copytree(ck, dst)
    return dst


def test_sharded_steps_rotate_and_hold_every_rank(uninterrupted):
    res, ck = uninterrupted
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 3, 4] and mgr.latest_step == 4  # max_to_keep = 3
    meta = mgr.meta(4)
    assert meta["sharded"] and meta["grid"] == [2, 2] and meta["pads"] == [4, 4]
    assert sorted(os.listdir(os.path.join(ck, "4"))) == ["meta.json"] + [RANK_FILE.format(r) for r in range(4)]
    assert meta["fields"]["x_velocity_at_u_locations"]["shape"] == [49, 48, 8]
    # rank 3 (1, 1) owns the high corner: its u block and the last global face
    assert meta["regions"]["3"]["block:x_velocity_at_u_locations"] == [24, 48, 24, 48]
    assert meta["regions"]["3"]["face:x_velocity_at_u_locations"] == [48, 49, 24, 48]
    assert mgr.nbytes(4) > sum(np.prod(f["shape"]) * 8 for f in meta["fields"].values())


def test_a_step_missing_a_rank_file_is_not_a_step(uninterrupted, tmp_path):
    ck = _copy(uninterrupted[1], tmp_path)
    os.remove(os.path.join(ck, "3", RANK_FILE.format(2)))
    os.makedirs(os.path.join(ck, ".5.tmp-sharded"))  # a save cut before its rename
    with open(os.path.join(ck, ".5.tmp-sharded", RANK_FILE.format(0)), "wb") as f:
        f.write(b"partial")
    mgr = CheckpointManager(ck)
    assert mgr.all_steps() == [2, 4]
    with pytest.raises(FileNotFoundError):
        mgr.restore(3)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (4, 1), (2, 2)])
def test_restore_onto_another_grid_is_the_gathered_state(shape, uninterrupted, setup):
    res, ck = uninterrupted
    nl, domain, state = setup
    mgr = CheckpointManager(ck)
    gathered = {k: FieldArray(torch.as_tensor(a), state[k].units, state[k].dims)
                for k, a in res["fields"].items()}
    grid = RankGrid(*shape)
    for rank in range(grid.size):
        layout = ShardLayout(domain, grid, rank, halo=nl.nb + 1)
        layout.set_fields(state)
        blocks, faces = layout.split_windows(mgr.restore_windows(4, layout))
        want_blocks, want_faces = layout.scatter_state(gathered)
        assert set(blocks) == set(want_blocks) and set(faces) == set(want_faces)
        assert bool(faces) == (shape != (1, 1))  # the degenerate grid owns every face
        for k, b in want_blocks.items():
            assert torch.equal(blocks[k], b), (shape, rank, k)
        for k, f in want_faces.items():
            assert torch.equal(faces[k], f), (shape, rank, k)
        owned = mgr.restore(4, model=layout)
        assert all(torch.equal(owned[k].data, b) for k, b in want_blocks.items())


def test_restore_without_a_model_assembles_the_global_state(uninterrupted):
    res, ck = uninterrupted
    got = CheckpointManager(ck).restore(device="cpu")
    assert set(got) == set(res["fields"])
    for k, a in res["fields"].items():
        np.testing.assert_array_equal(got[k].data.numpy(), a, err_msg=k)


def test_single_process_checkpoint_onto_a_grid_and_back(uninterrupted, setup, tmp_path):
    nl, domain, state = setup
    ck = str(tmp_path / "single")
    one = drv.run(load_namelist(**OVERRIDES), verbose=False, checkpoint_dir=ck,
                  checkpoint_every=2)
    mgr = CheckpointManager(ck)
    assert not mgr.meta(4).get("sharded")
    for rank in range(4):
        layout = ShardLayout(domain, RankGrid(2, 2), rank, halo=nl.nb + 1)
        layout.set_fields(state)
        blocks, faces = layout.split_windows(mgr.restore_windows(4, layout))
        want_blocks, want_faces = layout.scatter_state(one["fields"])
        for k in want_blocks:
            assert torch.equal(blocks[k], want_blocks[k]), (rank, k)
        for k in want_faces:
            assert torch.equal(faces[k], want_faces[k]), (rank, k)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(4, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CheckpointManager(uninterrupted[1]).restore(4, device="cuda")


def _jax_uninterrupted():
    """The JAX ``DistributedModel`` on the 2x2 virtual mesh: the SUS
    driver's sequence (a warm-up step at zero mountain height, then NITER
    steps), the gathered state."""
    from tasmania_tpu.framework.options import StorageOptions as JaxStorage

    jnl = importlib.import_module("drivers.namelist_sus")
    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    for key in ("nx", "ny", "nz", "relative_humidity"):
        setattr(nl, key, OVERRIDES[key])
    nl.backend = "pallas:interpret"
    nl.so = JaxStorage(dtype=np.float64)
    from drivers.driver_namelist_sus import build_domain_and_state, build_model

    domain, state, pt = build_domain_and_state(nl)
    dt = nl.timestep.total_seconds()
    topo = nl.topo_kwargs["time"].total_seconds()
    hs = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    dm = JaxDistributedModel(domain, state, mesh, lambda dom: build_model(nl, dom, pt), dt,
                             halo=nl.nb + 1)
    fields = dm.scatter_state(state)
    for fact in [0.0] + [min((i + 1) * dt / topo, 1.0) for i in range(NITER)]:
        fields = dm.step(fields, dm.put_topography(fact * hs))
    return {k: np.asarray(fa.data) for k, fa in dm.gather_state(fields).items()}


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)])
def test_resume(mesh, uninterrupted, tmp_path):
    """From step 2: on the grid that wrote it bit for bit; on 4x1 within
    1e-13 of the uninterrupted run and 1e-12 of the JAX runner's."""
    full, ck = uninterrupted
    ck = _copy(ck, tmp_path)
    res = drv.run_spmd(OVERRIDES, ranks=4, comm="gloo", device="cpu", mesh=mesh, verbose=False,
                       checkpoint_dir=ck, resume=2, timeout_s=120.0, workdir=tmp_path / "ranks")
    assert res["start"] == 2 and res["imported_by_rank"] == [[]] * 4
    assert CheckpointManager(ck).meta(4)["grid"] == list(mesh)  # the resumed run's own step 4
    if mesh == (2, 2):
        for k, a in full["fields"].items():
            np.testing.assert_array_equal(res["fields"][k], a, err_msg=k)
        return
    ref = _jax_uninterrupted()
    assert full["fields"]["mass_fraction_of_cloud_liquid_water_in_air"].max() > 0.0
    for k in full["fields"]:
        assert _scaled_error(res["fields"], full["fields"], k) <= 1e-13, k
        assert _scaled_error(res["fields"], ref, k) <= 1e-12, k
