"""Joining a process group that spans hosts (counterpart of
``tasmania_tpu/parallel/multihost.py::initialize_distributed``).

Under ``torchrun`` every process runs the same driver with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in its
environment; :func:`initialize_distributed` joins them into one group
(``init_method="env://"``) with a timeout, and each rank takes the card of
its local rank under NCCL.

:func:`make_hybrid_rank_grid` is the counterpart of the JAX module's
``make_hybrid_mesh`` (``tasmania_tpu/parallel/multihost.py:70-161``): a
rank grid in which the ranks of each node (``LOCAL_WORLD_SIZE`` of them,
numbered contiguously, as ``torchrun`` numbers them) own one contiguous
block, so that only the blocks' edges cross the network between nodes.
The layout is a permutation of the ranks, so ranks of one machine given
``LOCAL_WORLD_SIZE`` can stand for nodes and check it.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tasmania_tpu_torch.parallel.mesh import RankGrid, _factor_2d


def initialize_distributed(backend: str, timeout_s: float = 60.0) -> Tuple[int, int, int]:
    """Join the group that ``torchrun`` describes (idempotent); returns
    (rank, world size, local rank).  Raises without that environment."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost runs under torchrun: {', '.join(missing)} not set")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size(), local_rank


def _world_sizes(world: Optional[int], local_world: Optional[int]) -> Tuple[int, int]:
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if local_world is None:
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return world, local_world


def make_hybrid_rank_grid(shape: Optional[Tuple[int, int]] = None,
                          node_grid: Optional[Tuple[int, int]] = None, *,
                          world: Optional[int] = None,
                          local_world: Optional[int] = None) -> RankGrid:
    """A ``shape`` rank grid (default: the most-square one) whose nodes' ranks
    are contiguous blocks.  ``world`` (default: the process group's size, or
    ``WORLD_SIZE``) ranks run ``local_world`` (default ``LOCAL_WORLD_SIZE``,
    or all of them) a node, node p holding ranks ``p·local_world`` on.

    On one node this is ``make_rank_grid``'s grid.  On several, the nodes'
    blocks of ``(px / nodes, py)`` ranks are stacked along x (which, with
    ranks numbered node by node, is the row-major order again); with
    ``node_grid=(prx, pry)`` node p's block of ``(px / prx, py / pry)``
    ranks, row-major inside, sits at ``divmod(p, pry)`` of a 2-D tiling.
    Raises ``ValueError`` where the JAX function asserts: a shape that is
    not the world, a node grid that is not the node count or does not
    divide the shape, a node whose rank count is not its block's, an
    x-extent the node count does not divide."""
    world, local_world = _world_sizes(world, local_world)
    px, py = shape if shape is not None else _factor_2d(world)
    if px * py != world:
        raise ValueError(f"mesh shape {px}x{py} != {world} ranks")
    if local_world < 1:
        raise ValueError(f"LOCAL_WORLD_SIZE {local_world}: give a positive count")
    nodes = -(-world // local_world)
    ranks_of = [list(range(p * local_world, min((p + 1) * local_world, world))) for p in range(nodes)]
    if nodes == 1:
        return RankGrid(px, py)
    if node_grid is not None:
        prx, pry = node_grid
        if prx * pry != nodes:
            raise ValueError(f"node grid {prx}x{pry} != {nodes} nodes")
        if px % prx or py % pry:
            raise ValueError(f"mesh {px}x{py} not divisible by node grid {prx}x{pry}")
        bx, by = px // prx, py // pry
    else:
        if px % nodes:
            raise ValueError(f"mesh x-extent {px} must be divisible by the node count {nodes} "
                             "(nodes are stacked along the x axis)")
        prx, pry, bx, by = nodes, 1, px // nodes, py
    order = [0] * world
    for p, ranks in enumerate(ranks_of):
        if len(ranks) != bx * by:
            raise ValueError(f"node {p} has {len(ranks)} ranks, need {bx * by}")
        r, c = divmod(p, pry)
        for k, rank in enumerate(ranks):
            i, j = divmod(k, by)
            order[(r * bx + i) * py + c * by + j] = rank
    return RankGrid(px, py, tuple(order))
