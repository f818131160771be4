"""The flagship through the decomposed runner, beside the single device
(counterpart of ``drivers/driver_dist_bench.py``).

Times the flagship's SUS step through ``parallel/runner.py::DistributedModel``
on a ``--mesh px,py`` grid of ranks.  On a 1x1 mesh the runner binds the
components to the global domain (the degenerate grid: the single-device
program), so its step must match the single device's; the JAX driver's bar
is 2% (``drivers/driver_dist_bench.py:6-9``).  There the step runs on this
process as one CUDA graph (on a CPU device, eagerly), beside the
single-device step of the same namelist run the same way: one warm-up step
at zero mountain height, ``--niter`` steps whose fields the two must agree
on bit for bit, then the two timed in alternating pairs of ``--niter``
steps (``--pairs``, at least 5, the first pair being the compared one).  It
prints one JSON line: the mesh, ``degenerate``, the pads, the runner's
ms/step (the median of its runs), gridpoints/s and umax, the single
device's ms/step (the median of its runs) and the ratio of the two.

On a larger mesh the step runs eagerly on local ranks (``--comm``: ``nccl``
takes one GPU a rank, ``gloo`` lets ranks share one or run on the CPU;
``driver_sharded.py``'s ranks) and the JSON line holds the mesh,
``degenerate``, the pads, ms/step, gridpoints/s and umax.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_dist_bench [--mesh 1,1] [--comm nccl|gloo]
        [--niter 100] [--nx N] [--ny N] [--nz N] [--halo N] [--pairs 5] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import (
    build_domain_and_state,
    build_model,
    check_device,
    fields_step,
    graph_mode,
    steady_topography,
    synchronize,
    warm_up,
)
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.parallel.launch import check_backend
from tasmania_tpu_torch.parallel.mesh import RankGrid
from tasmania_tpu_torch.parallel.runner import DistributedModel
from tasmania_tpu_torch.utils.jitx import StepBody

MIN_PAIRS = 5


def stepper(step, fields, hs_steady: torch.Tensor, facts, *, graph: Optional[bool] = None):
    """After :func:`warm_up`'s step at zero mountain height: a function that
    advances ``n`` steps with the mountain at ``facts[i]`` of ``hs_steady``
    (the last fact once past them) and returns their seconds, the
    :class:`StepBody` whose ``fields()`` are the last step's, and the kernel
    launches of one step (the warm-up's, or the captured step's).  Where
    ``graph`` resolves to the graph (``driver_namelist_sus.graph_mode``: by
    default on a CUDA device) the steps are replays of the warm-up's CUDA
    graph, else the body called eagerly, every field copied back."""
    device = hs_steady.device
    fields, captured, per_step, _ = warm_up(step, fields, hs_steady * 0.0, hs_steady, facts, device,
                                            fused_loop=graph, verbose=False)
    body = captured.body if captured is not None else StepBody(step, fields, set(fields), hs_steady, facts)

    def advance(n: int) -> float:
        synchronize(device)
        t0 = time.perf_counter()
        if captured is not None:
            captured.replay(n)
        else:
            for _ in range(n):
                body()
        synchronize(device)
        return time.perf_counter() - t0

    return advance, body, per_step


def bench_degenerate(nl, *, comm: str = "nccl", halo: Optional[int] = None,
                     pairs: int = MIN_PAIRS) -> Dict[str, Any]:
    """The 1x1 mesh on this process beside the single device (module
    docstring); also returns both runs' fields after the compared steps
    (``fields``, ``single_fields``: numpy) and each run's ms/step."""
    if pairs < MIN_PAIRS:
        raise ValueError(f"{pairs} pairs: the single device's step is the median of at least "
                         f"{MIN_PAIRS}")
    check_device(nl.so.device)
    graph = graph_mode(nl.so.device)
    domain, state, pt = build_domain_and_state(nl)
    dt_s = nl.timestep.total_seconds()
    dm = DistributedModel(domain, state, RankGrid(1, 1), 0, lambda dom: build_model(nl, dom, pt),
                          dt_s, backend=comm, halo=nl.nb + 1 if halo is None else halo)
    if not dm.degenerate:
        raise ValueError(f"the 1x1 mesh takes the degenerate route only on a non-periodic domain "
                         f"(pads {dm.pads})")
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    topo_time = nl.topo_kwargs["time"].total_seconds()
    facts = [min((i + 1) * dt_s / topo_time, 1.0) for i in range(nl.niter)]
    hs = steady_topography(domain, nl)
    dist_fields = {n: FieldArray(b, dm.units[n], dm.dims[n]) for n, b in dm.scatter_state(state).items()}
    loops = {
        "dist": stepper(dm.step_state, dist_fields, dm.put_topography(hs), facts, graph=graph),
        "single": stepper(fields_step(lambda st, dt: physics(dycore(st, {}, dt), dt), names, dt_s),
                          {k: state[k] for k in names}, hs, facts, graph=graph),
    }
    times: Dict[str, List[float]] = {"dist": [], "single": []}
    compared = {}
    for i in range(pairs):
        for which in (("dist", "single") if i % 2 == 0 else ("single", "dist")):
            times[which].append(1e3 * loops[which][0](nl.niter) / nl.niter)
        if i == 0:
            compared = {w: {k: fa.data.cpu().numpy() for k, fa in body.fields().items()}
                        for w, (_, body, _) in loops.items()}
    unequal = sorted(k for k, a in compared["single"].items()
                     if not np.array_equal(compared["dist"][k], a))
    med = {w: float(np.median(t)) for w, t in times.items()}
    u = compared["dist"]["x_velocity_at_u_locations"]
    return dict(
        mesh=[1, 1], comm=comm, degenerate=dm.degenerate, pads=list(dm.pads),
        graph=graph, ms_per_step=med["dist"], gps=nl.nx * nl.ny * nl.nz / med["dist"] * 1e3,
        umax=float(u[:, :-1].max()), single_device_ms_per_step=med["single"],
        ratio=med["dist"] / med["single"], pairs=pairs, niter=nl.niter,
        dist_ms_per_step_runs=times["dist"], single_ms_per_step_runs=times["single"],
        bitwise=not unequal, unequal=unequal,
        fields=compared["dist"], single_fields=compared["single"],
    )


def bench(*, mesh: Tuple[int, int] = (1, 1), comm: str = "nccl", device: str = "cuda",
          nx: Optional[int] = None, ny: Optional[int] = None, nz: Optional[int] = None,
          niter: int = 100, halo: Optional[int] = None, pairs: int = MIN_PAIRS,
          timeout_s: float = 600.0) -> Dict[str, Any]:
    """The bench's result (module docstring); on 1x1 with the fields."""
    size = {k: v for k, v in (("nx", nx), ("ny", ny or nx), ("nz", nz)) if v}
    check_backend(comm, device, mesh[0] * mesh[1])
    if tuple(mesh) == (1, 1):
        defaults = load_namelist()
        so = type(defaults.so)(dtype=defaults.so.dtype, device=torch.device(device))
        return bench_degenerate(load_namelist(niter=niter, so=so, **size), comm=comm, halo=halo,
                                pairs=pairs)
    from tasmania_tpu_torch.drivers import driver_sharded as shd

    nl = load_namelist(**size)
    res = shd.run(ranks=mesh[0] * mesh[1], comm=comm, device=device, mesh=tuple(mesh), nx=nl.nx,
                  ny=nl.ny, nz=nl.nz, niter=niter, physics=True, halo=nl.nb + 1 if halo is None else halo,
                  timeout_s=timeout_s, verbose=False)
    return dict(mesh=list(res["mesh"]), comm=comm, degenerate=res["degenerate"], pads=list(res["pads"]),
                graph=False, elapsed=res["elapsed"], ms_per_step=res["ms_per_step"], gps=res["gps"],
                umax=res["umax"], grid=list(res["grid"]), fields=res["fields"])


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mesh", type=str, default="1,1")
    parser.add_argument("--comm", choices=("nccl", "gloo"), default="nccl")
    parser.add_argument("--niter", type=int, default=100)
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--halo", type=int, default=None,
                        help="the ring's width on a decomposed axis (default nb + 1, which the "
                             "fused stage needs)")
    parser.add_argument("--pairs", type=int, default=MIN_PAIRS)
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    px, py = (int(k) for k in cli.mesh.split(","))
    res = bench(mesh=(px, py), comm=cli.comm, device=cli.device, nx=cli.nx, ny=cli.ny, nz=cli.nz,
                niter=cli.niter, halo=cli.halo, pairs=cli.pairs)
    print(json.dumps({k: v for k, v in res.items() if k not in ("fields", "single_fields")}))
    return res


if __name__ == "__main__":
    main()
