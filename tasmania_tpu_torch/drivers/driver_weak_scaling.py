"""Weak scaling of the decomposed step: a fixed block a rank on a growing
grid of ranks (counterpart of ``drivers/driver_weak_scaling.py``).

Each rank count of ``--ranks`` (default ``1,4``) runs as its own job of
local ranks (``parallel/launch.py``) on the most-square grid: the flagship
namelist at ``px·block x py·block x nz``, the whole step through
``parallel/runner.py::DistributedModel`` (the dycore alone, or with
``--physics`` the SUS chain, as the JAX driver), one step to warm up, then
``--niter`` timed steps on a flat mountain.  ``--comm gloo`` (the default)
lets ranks share one card or run on the CPU (``--device cpu``); ``nccl``
takes one GPU a rank.  It prints each row as a JSON line, then the table
with ``weak_scaling_efficiency`` (gridpoints/s a rank over the first
row's).  Ranks that share one device measure the runner's and the halo
exchange's overhead, not an interconnect.

``--analyze`` adds a communication analysis from the largest rank count's
run: the bytes each rank's halo exchanges send a step, counted by the
exchange itself (``parallel/halo.py::ExchangeCounter``), beside the ring
those exchanges span (``halo.ring_bytes``), and the compute time of a
rank's block from the single rank's gridpoints/s measured in the same call
(so ``--ranks`` must include 1).  With ``--link-gbs`` (the link's rate a
direction, in GB/s; there is no default) it projects the weak-scaling
efficiency with the exchange overlapped with the step, t_comp / max(t_comp,
t_comm), and in series, t_comp / (t_comp + t_comm); without it, no
projection.  It counts no operations: the port has no compiled cost
analysis to read them from (the JAX driver reads XLA's).

Usage::

    python -m tasmania_tpu_torch.drivers.driver_weak_scaling [--block 32] [--nz 16]
        [--niter 10] [--ranks 1,4] [--physics] [--comm gloo|nccl] [--device cuda|cpu]
        [--halo N] [--analyze [--link-gbs G]]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import build_domain_and_state, synchronize
from tasmania_tpu_torch.drivers.driver_sharded import model_factory, namelist
from tasmania_tpu_torch.parallel.halo import ring_bytes
from tasmania_tpu_torch.parallel.launch import RankContext, RunSpec, check_backend, run_ranks
from tasmania_tpu_torch.parallel.mesh import make_rank_grid
from tasmania_tpu_torch.parallel.runner import DistributedModel

NOTE = ("ranks that share one device (or the host's cores) measure the runner's and the halo "
        "exchange's overhead at a fixed block a rank, not an interconnect")
NO_FLOPS = "not counted: the port has no compiled cost analysis to read operations from"


def rank_job(ctx: RankContext, *, block: int, nz: int, niter: int, physics: bool = False,
             halo: Optional[int] = None) -> Dict[str, Any]:
    """One rank's part of a row (a job of ``parallel.launch``): the warm-up
    step, then ``niter`` timed steps; the timing, and the exchanges' counts
    a step beside the ring's bytes."""
    px, py = ctx.grid.shape
    nl = namelist(ctx.device, nx=px * block, ny=py * block, nz=nz)
    domain, state, pt = build_domain_and_state(nl)
    dm = DistributedModel(domain, state, ctx.grid, ctx.rank, model_factory(nl, pt, physics),
                          nl.timestep.total_seconds(), backend=ctx.backend,
                          halo=nl.nb + 1 if halo is None else halo)
    fields = dm.scatter_state(state)
    hs = torch.zeros((dm.decomp.bx, dm.decomp.by) if not dm.degenerate else (nl.nx, nl.ny),
                     dtype=nl.so.dtype, device=ctx.device)
    fields = dm.step(fields, hs)
    synchronize(ctx.device)
    counter = dm.ex.counter
    counter.reset()
    t0 = time.perf_counter()
    for _ in range(niter):
        fields = dm.step(fields, hs)
    synchronize(ctx.device)
    wall = time.perf_counter() - t0
    blocks = sorted(counter.blocks)
    if len(blocks) > 1:
        raise AssertionError(f"rank {ctx.rank} exchanged blocks of shapes {blocks}")
    ring = ring_bytes(dm.ex, dm.pads, blocks[0], counter.column_bytes) if blocks else 0
    cells = nl.nx * nl.ny * nl.nz * niter
    return dict(
        rank=ctx.rank, n=ctx.grid.size, mesh=[px, py], nx=nl.nx, ny=nl.ny, nz=nl.nz, pads=list(dm.pads),
        wall=wall, gps=cells / wall, gps_per_rank=cells / wall / ctx.grid.size,
        exchanges_per_step=counter.exchanges / niter, messages_per_step=counter.messages / niter,
        exchange_bytes_per_step=counter.bytes_sent / niter, ring_bytes_per_step=ring / niter,
        block_with_ring=list(blocks[0]) if blocks else None,
    )


def run_row(n: int, *, block: int, nz: int, niter: int, physics: bool, comm: str, device: str,
            halo: Optional[int] = None, timeout_s: float = 600.0) -> Dict[str, Any]:
    """One row: ``n`` ranks as one job; rank 0's numbers with every rank's
    exchange bytes a step and ring bytes (``by_rank``)."""
    grid = make_rank_grid(n)
    spec = RunSpec(target="tasmania_tpu_torch.drivers.driver_weak_scaling:rank_job", world=n,
                   backend=comm, device=device, mesh=grid.shape, timeout_s=timeout_s,
                   kwargs=dict(block=block, nz=nz, niter=niter, physics=physics, halo=halo))
    with tempfile.TemporaryDirectory(prefix="tasmania_weak_") as tmp:
        results = run_ranks(spec, tmp)
    row = dict(results[0]["result"])
    row["by_rank"] = [{k: r["result"][k] for k in ("rank", "exchange_bytes_per_step",
                                                   "ring_bytes_per_step", "messages_per_step")}
                      for r in results]
    row["imported_by_rank"] = [r["imported"] for r in results]
    return row


def analyze(rows: List[Dict[str, Any]], block: int, nz: int,
            link_gbs: Optional[float]) -> Dict[str, Any]:
    """The communication analysis of the largest row against the single
    rank's measured gridpoints/s (module docstring)."""
    single = [r for r in rows if r["n"] == 1]
    if not single:
        raise ValueError("--analyze takes the compute time from the single rank's run: "
                         "include 1 in --ranks")
    big = max(rows, key=lambda r: r["n"])
    sent = max(r["exchange_bytes_per_step"] for r in big["by_rank"])
    t_comp = block * block * nz / single[0]["gps"]
    out = dict(
        n=big["n"], mesh=big["mesh"], block=block, nz=nz,
        exchanges_per_step=big["exchanges_per_step"], messages_per_step=big["messages_per_step"],
        exchange_bytes_per_step_per_rank=sent,
        ring_bytes_per_step_per_rank=max(r["ring_bytes_per_step"] for r in big["by_rank"]),
        gps_single_rank_measured=single[0]["gps"], t_compute_s=t_comp, flops=NO_FLOPS,
    )
    if link_gbs is None:
        out["projection"] = "none: give --link-gbs (the link's GB/s a direction) to project"
        return out
    t_comm = sent / (link_gbs * 1e9)
    out.update(
        link_gbs_assumed=link_gbs, t_comm_s=t_comm, comm_fraction=t_comm / (t_comp + t_comm),
        projected_efficiency_overlapped=t_comp / max(t_comp, t_comm),
        projected_efficiency_serial=t_comp / (t_comp + t_comm),
    )
    return out


def weak_scaling(ranks, *, block: int = 32, nz: int = 16, niter: int = 10, physics: bool = False,
                 comm: str = "gloo", device: str = "cuda",
                 halo: Optional[int] = None, analyze_comm: bool = False,
                 link_gbs: Optional[float] = None, verbose: bool = True) -> Dict[str, Any]:
    """The rows, the table and, with ``analyze_comm``, the analysis."""
    for n in ranks:
        check_backend(comm, device, n)
    rows = []
    for n in ranks:
        row = run_row(n, block=block, nz=nz, niter=niter, physics=physics, comm=comm,
                      device=device, halo=halo)
        rows.append(row)
        if verbose:
            print(json.dumps({k: v for k, v in row.items() if k not in ("by_rank", "imported_by_rank")}),
                  flush=True)
    base = rows[0]["gps_per_rank"]
    table = dict(block=block, nz=nz, physics=physics, comm=comm, device=str(device), note=NOTE,
                 rows=[dict(r, weak_scaling_efficiency=r["gps_per_rank"] / base) for r in rows])
    if analyze_comm:
        table["analysis"] = analyze(rows, block, nz, link_gbs)
    if verbose:
        print(json.dumps(table, indent=1))
    return table


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--block", type=int, default=32, help="a rank's block edge")
    parser.add_argument("--nz", type=int, default=16)
    parser.add_argument("--niter", type=int, default=10)
    parser.add_argument("--ranks", type=str, default="1,4")
    parser.add_argument("--physics", action="store_true")
    parser.add_argument("--comm", choices=("gloo", "nccl"), default="gloo")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--halo", type=int, default=None,
                        help="the ring's width on a decomposed axis (default nb + 1)")
    parser.add_argument("--analyze", action="store_true",
                        help="the exchange bytes a step against the single rank's compute time")
    parser.add_argument("--link-gbs", type=float, default=None,
                        help="with --analyze: the link's rate a direction, GB/s, to project the "
                             "efficiency (no default)")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    return weak_scaling([int(k) for k in cli.ranks.split(",")], block=cli.block, nz=cli.nz,
                        niter=cli.niter, physics=cli.physics, comm=cli.comm, device=cli.device,
                        halo=cli.halo, analyze_comm=cli.analyze, link_gbs=cli.link_gbs)


if __name__ == "__main__":
    main()
