"""Joining a process group that spans hosts (counterpart of
``tasmania_tpu/parallel/multihost.py::initialize_distributed``).

Under ``torchrun`` every process runs the same driver with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in its
environment; :func:`initialize_distributed` joins them into one group
(``init_method="env://"``) with a timeout, and each rank takes the card of
its local rank under NCCL.  The JAX module's ``make_hybrid_mesh`` (host
blocks contiguous in the mesh) waits for a multi-node machine.
"""

from __future__ import annotations

import datetime
import os
from typing import Tuple

import torch
import torch.distributed as dist


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
