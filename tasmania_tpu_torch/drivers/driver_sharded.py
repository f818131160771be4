"""The domain-decomposed isentropic run, BASELINE config 5 (counterpart of
``drivers/driver_sharded.py``).

The framework's model (the isentropic dycore with rk3ws_si and fifth-order
fluxes, and with ``--physics`` the whole moist SUS chain) runs on a 2-D
grid of ranks, each stepping its block of the domain with halo exchange
over ``torch.distributed`` (``parallel/runner.py``).  The namelist is the
flagship's (``namelist_sus.py``) at ``--nx``, ``--ny``, ``--nz``; nx and ny
are trimmed to multiples of the rank grid's extents, as the JAX driver
trims them.  The sequence is the JAX driver's: one warm-up step at zero
mountain height, whose result is discarded, then ``--niter`` steps from
the initial state with the mountain growing; it prints the mesh, the grid,
``Validation: umax`` (the largest cell-anchored u) and the gridpoints/s.

Ranks: ``--ranks N`` starts N local ranks (the JAX driver's ``--virtual
N``); ``--comm nccl`` (the default) takes one GPU a rank and raises with
more ranks than GPUs, ``--comm gloo`` exchanges through host memory, so
several ranks can share one card or run on the CPU.  ``--multihost`` runs
this process as one rank of a ``torchrun`` group.  The step is eager:
``--fused-loop`` raises, since a gloo exchange cannot be captured in a CUDA
graph.  The fields are float32, float64 with ``--f64``.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_sharded [--nx 256] [--ny N]
        [--nz 64] [--niter 50] [--physics] [--f64] [--device cuda|cpu]
        [--ranks N] [--comm nccl|gloo] [--multihost]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple

import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import (
    build_domain_and_state,
    build_model,
    make_dycore,
    steady_topography,
    synchronize,
)
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.parallel.launch import RankContext, RunSpec, check_backend, run_ranks
from tasmania_tpu_torch.parallel.mesh import RankGrid, make_rank_grid
from tasmania_tpu_torch.parallel.runner import DistributedModel


def trimmed_extents(nx: int, ny: Optional[int], grid: RankGrid) -> Tuple[int, int]:
    """nx and ny cut to multiples of the rank grid's extents
    (``driver_sharded.py:75-76`` of the JAX package)."""
    ny = ny or nx
    return nx - nx % grid.px or grid.px * 8, ny - ny % grid.py or grid.py * 8


def namelist(device, *, f64: bool = False, **overrides):
    """The flagship namelist on ``device`` with ``overrides``."""
    so = replace(load_namelist().so, device=torch.device(device),
                 dtype=torch.float64 if f64 else torch.float32)
    return load_namelist(so=so, **overrides)


def model_factory(nl, pt, physics: bool):
    """The components on a domain: dycore and SUS chain, or the dycore
    alone (the JAX driver's run without ``--physics``)."""
    if physics:
        return lambda dom: build_model(nl, dom, pt)
    return lambda dom: (make_dycore(nl, dom, pt), None)


def rank_run(ctx: RankContext, *, nx: int, ny: int, nz: int, niter: int, physics: bool,
             f64: bool = False, halo: Optional[int] = None, warmup: bool = True,
             overrides: Optional[Dict[str, Any]] = None, verbose: bool = False) -> Dict[str, Any]:
    """One rank's part of the decomposed run (a job of ``parallel.launch``):
    the warm-up step (if ``warmup``), then ``niter`` steps.  Rank 0 returns
    the gathered global fields (numpy), the validation value and the timing;
    every rank returns its kernel launches in the first step and in the
    whole run (counted from zero just before it)."""
    nl = namelist(ctx.device, f64=f64, nx=nx, ny=ny, nz=nz, niter=niter, **(overrides or {}))
    domain, state, pt = build_domain_and_state(nl)
    dt = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    dm = DistributedModel(domain, state, ctx.grid, ctx.rank, model_factory(nl, pt, physics), dt,
                          backend=ctx.backend, halo=nl.nb + 1 if halo is None else halo)
    fields = dm.scatter_state(state)
    hs_steady = dm.put_topography(steady_topography(domain, nl))
    if ctx.rank == 0 and verbose:
        print(f"mesh {ctx.grid.px}x{ctx.grid.py}, grid {nx}x{ny}x{nz}, halo {dm.pads}, "
              f"comm {ctx.backend}, device {ctx.device}", flush=True)
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    if warmup:
        dm.step(fields, 0.0 * hs_steady)  # the JAX driver discards the warm-up's result
    else:
        fields = dm.step(fields, min(dt / topo_time, 1.0) * hs_steady)
    synchronize(ctx.device)
    per_step = dict(_lib.launch_counts)
    warm_s = time.perf_counter() - t0
    if ctx.rank == 0 and verbose:
        print(f"warmup step: {warm_s:.3f} s", flush=True)
    first = 0 if warmup else 1
    t0 = time.perf_counter()
    for i in range(first, niter):
        fields = dm.step(fields, min((i + 1) * dt / topo_time, 1.0) * hs_steady)
    synchronize(ctx.device)
    elapsed = time.perf_counter() - t0
    launches = dict(_lib.launch_counts)
    full = dm.gather_state(fields)
    out = {"launches_per_step": per_step, "launches": launches, "degenerate": dm.degenerate,
           "pads": dm.pads}
    if full is None:
        return out
    full = {k: fa.data.numpy() for k, fa in full.items()}
    steps = niter - first
    out.update(
        fields=full, umax=float(full["x_velocity_at_u_locations"][:-1].max()),
        elapsed=elapsed, ms_per_step=1e3 * elapsed / max(steps, 1),
        gps=nx * ny * nz * steps / elapsed if steps else 0.0,
    )
    return out


def single_device_run(nl, *, physics: bool = True, warmup: bool = True) -> Dict[str, Any]:
    """The same sequence on one device without decomposition (the port's
    single-device step); returns the final fields (numpy) and the timing."""
    domain, state, pt = build_domain_and_state(nl)
    dycore, chain = model_factory(nl, pt, physics)(domain)
    dt = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    names = sorted(k for k in state if k != "time")
    hs_steady = steady_topography(domain, nl)

    def step(fields, hs):
        st = dict(fields)
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = dycore(st, {}, dt)
        st = st if chain is None else chain(st, dt)
        return {k: st[k] for k in names}

    fields = {k: state[k] for k in names}
    if warmup:
        step(fields, 0.0 * hs_steady)
    first = 0 if warmup else 1
    if not warmup:
        fields = step(fields, min(dt / topo_time, 1.0) * hs_steady)
    synchronize(nl.so.device)
    t0 = time.perf_counter()
    for i in range(first, nl.niter):
        fields = step(fields, min((i + 1) * dt / topo_time, 1.0) * hs_steady)
    synchronize(nl.so.device)
    elapsed = time.perf_counter() - t0
    return {"fields": {k: fa.data.cpu().numpy() for k, fa in fields.items()},
            "ms_per_step": 1e3 * elapsed / max(nl.niter - first, 1)}


def run(*, ranks: int, comm: str, device: str, nx: int = 256, ny: Optional[int] = None,
        nz: int = 64, niter: int = 50, physics: bool = False, f64: bool = False,
        mesh: Optional[Tuple[int, int]] = None, workdir=None, timeout_s: float = 600.0,
        verbose: bool = True, **job) -> Dict[str, Any]:
    """Start ``ranks`` local ranks of the decomposed run; returns rank 0's
    result with every rank's launches and imported modules."""
    check_backend(comm, device, ranks)
    grid = make_rank_grid(ranks, mesh)
    nx, ny = trimmed_extents(nx, ny, grid)
    spec = RunSpec(
        target="tasmania_tpu_torch.drivers.driver_sharded:rank_run", world=ranks, backend=comm,
        device=device, mesh=grid.shape, timeout_s=timeout_s,
        kwargs=dict(nx=nx, ny=ny, nz=nz, niter=niter, physics=physics, f64=f64, verbose=verbose,
                    **job),
    )
    with tempfile.TemporaryDirectory(prefix="tasmania_ranks_") as tmp:
        results = run_ranks(spec, workdir or tmp)
    out = dict(results[0]["result"])
    out.update(mesh=grid.shape, grid=(nx, ny, nz),
               launches_per_step_by_rank=[r["result"]["launches_per_step"] for r in results],
               launches_by_rank=[r["result"]["launches"] for r in results],
               imported_by_rank=[r["imported"] for r in results])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nx", type=int, default=256)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=64)
    parser.add_argument("--niter", type=int, default=50)
    parser.add_argument("--physics", action="store_true",
                        help="run the whole moist SUS physics chain decomposed")
    parser.add_argument("--f64", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--ranks", type=int, default=1, help="N local ranks")
    parser.add_argument("--comm", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--multihost", action="store_true",
                        help="run as one rank of a torchrun group")
    parser.add_argument("--fused-loop", action="store_true")
    cli = parser.parse_args(argv)
    if cli.fused_loop:
        raise ValueError("--fused-loop is not available decomposed: a gloo halo exchange cannot be "
                         "captured in a CUDA graph")
    if cli.multihost:
        from tasmania_tpu_torch.parallel.launch import rank_device
        from tasmania_tpu_torch.parallel.multihost import initialize_distributed

        rank, world, local = initialize_distributed(cli.comm)
        grid = make_rank_grid(world)
        nx, ny = trimmed_extents(cli.nx, cli.ny, grid)
        ctx = RankContext(rank, grid, cli.comm, rank_device(cli.comm, cli.device, local))
        res = rank_run(ctx, nx=nx, ny=ny, nz=cli.nz, niter=cli.niter, physics=cli.physics,
                       f64=cli.f64, verbose=True)
        res.update(mesh=grid.shape, grid=(nx, ny, cli.nz))
        if rank != 0:
            return res
    else:
        res = run(ranks=cli.ranks, comm=cli.comm, device=cli.device, nx=cli.nx, ny=cli.ny,
                  nz=cli.nz, niter=cli.niter, physics=cli.physics, f64=cli.f64)
    print(f"Validation: umax = {res['umax']:.5f}")
    print(f"Compute time: {res['elapsed']:.3f} s; throughput: {res['gps']:.3e} gridpoints/s")
    return res


if __name__ == "__main__":
    main()
