"""Start the ranks of a decomposed run on this machine, and the entry point
each rank runs.

:func:`run_ranks` starts ``world`` processes of
``python -m tasmania_tpu_torch.parallel.launch SPEC RANK``; each joins one
``torch.distributed`` process group through a file in ``workdir`` (no TCP
port), calls the job ``target`` (``"module:function"``, a function of the
port) with a :class:`RankContext` and ``kwargs``, and saves what it returns
to ``workdir/result_<rank>.pt``.  The parent waits for all of them until a
deadline and kills them past it, so a rank that hangs fails its caller
instead of holding it.  Every rank reports whether ``jax`` or the JAX
package was imported in its process.

Under ``"gloo"`` the ranks may share one card (they exchange halos through
host memory); under ``"nccl"`` rank r takes card r, and more ranks than
cards raise before anything starts (NCCL refuses two ranks on one card).
The kernels are built once, in the parent, before the ranks start.

A spec may make ``local_world`` ranks a node: each rank then finds
``LOCAL_WORLD_SIZE`` and ``LOCAL_RANK`` in its environment, as ``torchrun``
sets them on a machine of several nodes, so ranks of one machine can stand
for nodes (``multihost.make_hybrid_rank_grid`` lays them out).
"""

from __future__ import annotations

import datetime
import importlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from tasmania_tpu_torch.parallel.halo import BACKENDS
from tasmania_tpu_torch.parallel.mesh import RankGrid, make_rank_grid


@dataclass
class RankContext:
    """What a rank's job is given: its rank, the rank grid, the process
    group's backend and the device of its tensors."""

    rank: int
    grid: RankGrid
    backend: str
    device: torch.device


@dataclass
class RunSpec:
    target: str
    world: int
    backend: str
    device: str
    mesh: Optional[Tuple[int, int]] = None
    kwargs: Dict[str, Any] = field(default_factory=dict)
    timeout_s: float = 60.0
    local_world: Optional[int] = None


def check_backend(backend: str, device: str, world: int) -> None:
    """Raise unless ``backend`` can serve ``world`` ranks on ``device``:
    NCCL needs a card a rank (and CUDA tensors), gloo carries host tensors
    and serves ranks on the CPU or sharing cards."""
    if backend not in BACKENDS:
        raise ValueError(f"comm backend {backend!r}: one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device is cuda but no CUDA device is available")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("--comm nccl sends CUDA tensors: it needs --device cuda")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"--comm nccl with {world} ranks needs {world} GPUs; this machine has "
                f"{torch.cuda.device_count()} (NCCL refuses two ranks on one GPU: use --comm gloo)"
            )


def rank_device(backend: str, device: str, local_rank: int) -> torch.device:
    """The device of a rank's tensors: under NCCL card ``local_rank``, under
    gloo the cards in turn (all ranks on one card of a one-card machine)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", local_rank)
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def init_group(backend: str, init_method: str, rank: int, world: int, timeout_s: float) -> None:
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def call_target(target: str, ctx: RankContext, kwargs: Dict[str, Any]):
    module, fn = target.split(":")
    return getattr(importlib.import_module(module), fn)(ctx, **kwargs)


def _rank_main(spec_path: str, rank: int) -> None:
    import torch.distributed as dist

    spec: RunSpec = torch.load(spec_path, weights_only=False)
    workdir = Path(spec_path).parent
    device = rank_device(spec.backend, spec.device, rank)
    if device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec.world))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_group(spec.backend, f"file://{workdir / 'rendezvous'}", rank, spec.world, spec.timeout_s)
    try:
        ctx = RankContext(rank, make_rank_grid(spec.world, spec.mesh), spec.backend, device)
        result = call_target(spec.target, ctx, spec.kwargs)
        imported = sorted(m for m in ("jax", "tasmania_tpu") if m in sys.modules)
        torch.save({"result": result, "imported": imported}, workdir / f"result_{rank}.pt")
        dist.barrier()  # every rank done before the group goes
    finally:
        dist.destroy_process_group()


def run_ranks(spec: RunSpec, workdir) -> List[Dict[str, Any]]:
    """Run ``spec`` on ``spec.world`` local ranks; returns each rank's
    ``{"result": ..., "imported": [...]}``.  Raises if a rank fails, or
    kills them all and raises ``TimeoutError`` past twice the group's
    timeout."""
    check_backend(spec.backend, spec.device, spec.world)
    make_rank_grid(spec.world, spec.mesh)  # raise on a bad mesh before starting
    if torch.device(spec.device).type == "cuda":
        from tasmania_tpu_torch.ops import _lib

        _lib.build()  # one build, not one a rank
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    for stale in [workdir / "rendezvous", *workdir.glob("result_*.pt")]:
        stale.unlink(missing_ok=True)
    spec_path = workdir / "spec.pt"
    torch.save(spec, spec_path)
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks are on this machine
    root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join([root] + [p for p in [env.get("PYTHONPATH")] if p])

    def rank_env(r: int) -> Dict[str, str]:
        if spec.local_world is None:
            return env
        return {**env, "LOCAL_WORLD_SIZE": str(spec.local_world),
                "LOCAL_RANK": str(r % spec.local_world)}

    procs = [
        subprocess.Popen([sys.executable, "-m", "tasmania_tpu_torch.parallel.launch",
                          str(spec_path), str(r)], env=rank_env(r))
        for r in range(spec.world)
    ]
    limit = time.monotonic() + 2 * spec.timeout_s
    try:
        # until all have finished, or one has failed (the others would wait
        # for it in their next exchange)
        while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
            if time.monotonic() > limit:
                raise TimeoutError(f"the {spec.world} ranks did not finish within the deadline")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError(f"ranks {failed} failed (exit codes "
                           f"{[procs[r].returncode for r in failed]})")
    return [torch.load(workdir / f"result_{r}.pt", weights_only=False) for r in range(spec.world)]


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
