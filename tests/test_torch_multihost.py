"""The port's hybrid rank grid (``tasmania_tpu_torch/parallel/multihost.py::
make_hybrid_rank_grid``) against the JAX package's ``make_hybrid_mesh``
(``tasmania_tpu/parallel/multihost.py:70-161``), and the rank grid's explicit
order (``parallel/mesh.py::RankGrid``).

* The layout rule, pure arithmetic: for world sizes, nodes and node grids,
  the port's grid places each rank where the JAX function places the device
  of the same id, given stand-in devices whose ``process_index`` is their
  node (the JAX function's multi-process branches, with
  ``jax.process_count`` and ``jax.devices`` patched for the call); on one
  node it is ``make_rank_grid``'s grid; every assertion of the JAX
  function is a ``ValueError`` of the port's under the same arguments.
* A run: the SUS driver's ``--spmd`` on four gloo ranks told they are two
  nodes of two (``LOCAL_WORLD_SIZE=2``) with the nodes tiled 1x2, at
  ``tests/test_torch_distributed.py``'s size in float64, equal bit for bit
  to the plain 2x2 run (placement changes no arithmetic), each node's ranks
  one block of the grid, no JAX in any rank.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest
import torch

import jax

from tasmania_tpu.parallel.multihost import make_hybrid_mesh
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.parallel import make_hybrid_rank_grid
from tasmania_tpu_torch.parallel.mesh import RankGrid, make_rank_grid

CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
SIZE = dict(nx=48, ny=48, nz=8)  # tests/test_torch_distributed.py's
NSTEPS = 2


class _Device:
    """A stand-in device: its id and its process (node)."""

    def __init__(self, ident: int, process: int) -> None:
        self.id, self.process_index = ident, process


def _jax_layout(world, local_world, shape, node_grid):
    """The device ids of the JAX mesh, given ``local_world`` devices a
    process."""
    nodes = -(-world // local_world)
    devices = [_Device(i, i // local_world) for i in range(world)]
    with mock.patch.object(jax, "process_count", lambda: nodes), \
            mock.patch.object(jax, "devices", lambda: devices):
        if nodes == 1:
            return None
        mesh = make_hybrid_mesh(shape, process_grid=node_grid)
    return [[d.id for d in row] for row in np.asarray(mesh.devices)]


def _port_layout(grid: RankGrid):
    return [[grid.rank_of(i, j) for j in range(grid.py)] for i in range(grid.px)]


@pytest.mark.parametrize("world,local,shape,node_grid", [
    (4, 2, (2, 2), None),
    (4, 2, (2, 2), (2, 1)),
    (4, 2, (2, 2), (1, 2)),
    (8, 2, (4, 2), (2, 2)),
    (8, 4, (4, 2), None),
    (8, 4, (2, 4), (1, 2)),
    (8, 2, (8, 1), None),
    (16, 4, (4, 4), (2, 2)),
    (12, 6, (6, 2), None),
    (12, 2, (2, 6), (1, 6)),
])
def test_layout_matches_make_hybrid_mesh(world, local, shape, node_grid):
    grid = make_hybrid_rank_grid(shape, node_grid, world=world, local_world=local)
    assert grid.shape == shape
    assert _port_layout(grid) == _jax_layout(world, local, shape, node_grid)
    for r in range(world):  # coords and rank_of are inverse
        assert grid.rank_of(*grid.coords(r)) == r


@pytest.mark.parametrize("world,shape", [(1, None), (4, None), (4, (4, 1)), (6, (3, 2)), (8, (2, 4))])
def test_one_node_is_make_rank_grid(world, shape, monkeypatch):
    assert make_hybrid_rank_grid(shape, world=world, local_world=world) == make_rank_grid(world, shape)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setenv("WORLD_SIZE", str(world))
    assert make_hybrid_rank_grid(shape) == make_rank_grid(world, shape)  # one node without the variable


@pytest.mark.parametrize("world,local,shape,node_grid,match", [
    (4, 2, (4, 2), None, "mesh shape"),                        # :98
    (8, 2, (4, 2), (2, 1), "node grid 2x1 != 4"),               # :105
    (8, 2, (4, 2), (1, 4), "not divisible by node grid"),       # :106
    (6, 4, (6, 1), (2, 1), "node 0 has 4 ranks, need 3"),      # :115
    (4, 2, (1, 4), None, "must be divisible by the node count"),  # :124
    (6, 4, (2, 3), None, "node 0 has 4 ranks, need 3"),        # :157
])
def test_raises_where_make_hybrid_mesh_asserts(world, local, shape, node_grid, match):
    with pytest.raises(ValueError, match=match):
        make_hybrid_rank_grid(shape, node_grid, world=world, local_world=local)
    with pytest.raises(AssertionError):
        _jax_layout(world, local, shape, node_grid)


def test_rank_grid_order():
    grid = RankGrid(2, 2, (0, 2, 1, 3))
    assert [grid.coords(r) for r in range(4)] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert grid.rank_of(0, 1) == 2
    assert RankGrid(2, 2, (0, 1, 2, 3)) == RankGrid(2, 2)  # the identity is the default order
    with pytest.raises(ValueError, match="not a permutation"):
        RankGrid(2, 2, (0, 1, 1, 3))


@pytest.fixture(scope="module")
def plain_2x2(tmp_path_factory):
    return drv.run_spmd(dict(SIZE, niter=NSTEPS, relative_humidity=1.2, so=CPU64), ranks=4,
                        comm="gloo", device="cpu", mesh=(2, 2), verbose=False, timeout_s=120.0,
                        workdir=tmp_path_factory.mktemp("plain"))


def test_two_nodes_of_two_ranks_match_the_plain_grid(plain_2x2, tmp_path):
    res = drv.run_spmd(dict(SIZE, niter=NSTEPS, relative_humidity=1.2, so=CPU64), ranks=4,
                       comm="gloo", device="cpu", mesh=(2, 2), local_world=2, node_grid=(1, 2),
                       verbose=False, timeout_s=120.0, workdir=tmp_path)
    assert res["imported_by_rank"] == [[]] * 4 == plain_2x2["imported_by_rank"]
    # node 0 (ranks 0, 1) holds the column iy = 0, node 1 the column iy = 1
    assert res["coords_by_rank"] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert plain_2x2["coords_by_rank"] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert set(res["fields"]) == set(plain_2x2["fields"])
    for name, a in plain_2x2["fields"].items():
        np.testing.assert_array_equal(res["fields"][name], a, err_msg=name)
