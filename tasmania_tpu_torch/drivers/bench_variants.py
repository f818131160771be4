"""The six couplings at the flagship, side by side (counterpart of
``drivers/bench_variants.py``): ms a step, gridpoints/s, umax and vmax of
fc, lfc, ps, sts, sus and ssus.

Each coupling's model is built with ``driver_isentropic_moist.build_variant``
from its namelist (``namelist_<coupling>.py``), takes the drivers' warm-up
step at zero mountain height and, on a CUDA device, one CUDA graph of its
step (``driver_dist_bench.stepper``; on the CPU the step runs eagerly).
Then ``MIN_PAIRS`` rounds: each round advances every coupling by
``--nt`` steps once, timed on the host clock between two synchronisations,
in an order rotated by one from round to round.  A coupling's ms a step is
the median of its rounds, printed with their range; gridpoints/s is nx·ny·nz
over it.  umax (``u[:, :-1]``) and vmax (``v[:-1, :]``) are read after the
first round, from the fields of the warm-up step and ``--nt`` steps from the
initial state: ``driver_isentropic_moist.run`` at ``niter = nt``.  Each row
also holds the seconds of the build, the warm-up and the capture (the JAX
tool's ``compile_warm_s``) and the kernel launches of one step (the
captured step's).  The JAX tool's slope timing, t(2n) - t(n), cancels a
remote call's fixed cost, which a local card does not have.

Usage::

    python -m tasmania_tpu_torch.drivers.bench_variants [--nt 50] [--variants fc,lfc,...]
        [--nx N] [--ny N] [--nz N] [--out PATH] [--device cuda|cpu]

``--out`` writes the table as JSON to PATH.  The device defaults to
``cuda``; without a GPU the tool exits unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Sequence

import torch

from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers.driver_dist_bench import MIN_PAIRS, stepper
from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device, fields_step, graph_mode

VARIANTS = moist.COUPLINGS


def prepare(coupling: str, nt: int, device, **size) -> Dict[str, Any]:
    """The coupling's namelist on ``device`` (``niter = nt``, ``size`` its
    nx, ny, nz overrides), its model past the warm-up step (and the
    capture, on a CUDA device): ``stepper``'s ``advance``, ``body`` and
    launches a step, and the seconds all this took."""
    t0 = time.perf_counter()
    so = replace(moist.load_namelist(coupling).so, device=torch.device(device))
    nl = moist.load_namelist(coupling, niter=nt, so=so, **size)
    _, state, dycore, step_impl = moist.build_variant(nl, coupling)
    names = sorted(k for k in state if k != "time")
    dt_s = nl.timestep.total_seconds()
    topo_s = nl.topo_kwargs["time"].total_seconds()
    facts = [min((i + 1) * dt_s / topo_s, 1.0) for i in range(nt)]
    advance, body, per_step = stepper(fields_step(step_impl, names, dt_s), {k: state[k] for k in names},
                                      dycore.topography_steady, facts)
    return dict(nl=nl, advance=advance, body=body, launches_per_step=per_step,
                build_capture_s=time.perf_counter() - t0)


def bench_variants(variants: Sequence[str] = VARIANTS, nt: int = 50, *, device="cuda",
                   verbose: bool = True, **size) -> Dict[str, Any]:
    """The table (module docstring): ``{"rows": {coupling: row}, "fields":
    {coupling: the fields after the first round}}``."""
    for c in variants:
        if c not in VARIANTS:
            raise ValueError(f"unknown coupling {c!r} (have {VARIANTS})")
    check_device(device)
    models = {c: prepare(c, nt, device, **size) for c in variants}
    runs: Dict[str, list] = {c: [] for c in variants}
    fields = {}
    for r in range(MIN_PAIRS):
        k = r % len(variants)
        for c in (*variants[k:], *variants[:k]):
            runs[c].append(1e3 * models[c]["advance"](nt) / nt)
            if r == 0:
                fields[c] = models[c]["body"].fields()
    rows = {}
    for c in variants:
        nl, ms = models[c]["nl"], sorted(runs[c])[len(runs[c]) // 2]
        u = fields[c]["x_velocity_at_u_locations"].data
        v = fields[c]["y_velocity_at_v_locations"].data
        rows[c] = dict(
            ms_per_step=ms, ms_per_step_runs=runs[c], ms_per_step_range=[min(runs[c]), max(runs[c])],
            gridpoints_per_s=nl.nx * nl.ny * nl.nz / (ms * 1e-3),
            umax=float(u[:, :-1].max()), vmax=float(v[:-1, :].max()),
            build_capture_s=models[c]["build_capture_s"],
            launches_per_step=models[c]["launches_per_step"],
            graph=graph_mode(device), nt=nt, grid=[nl.nx, nl.ny, nl.nz],
        )
        if verbose:
            print(json.dumps({c: rows[c]}), flush=True)
    return {"rows": rows, "fields": fields}


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nt", type=int, default=50)
    parser.add_argument("--variants", type=str, default=",".join(VARIANTS))
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--out", type=str, default=None, metavar="PATH",
                        help="write the table as JSON to PATH")
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    size = {k: v for k, v in (("nx", cli.nx), ("ny", cli.ny or cli.nx), ("nz", cli.nz)) if v}
    graph = graph_mode(cli.device)
    where = torch.cuda.get_device_name(0) if graph else "cpu"
    print(f"coupling-variant bench on {where}", flush=True)
    res = bench_variants([v for v in cli.variants.split(",") if v], cli.nt, device=cli.device, **size)
    if cli.out:
        Path(cli.out).write_text(json.dumps({
            "method": f"median of {MIN_PAIRS} rounds of {cli.nt} steps a coupling, rotated order, "
                      f"{'CUDA graph replays' if graph else 'eager steps'}",
            "device": where, "variants": res["rows"]}, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()
