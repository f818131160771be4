"""Leave-one-out profiler of the flagship SUS step (counterpart of
``drivers/driver_profile.py``).

Times the flagship's step with single physics processes, the whole physics
chain or the dycore left out (``build_model(skip=)``, or the step without
its dycore), and the step without the dycore's damping, to attribute the
cost of a step.  Each variant runs the SUS driver's sequence (one warm-up
step at zero mountain height, then ``--niter`` steps) in the driver's
default mode: on a CUDA device its timed steps are replays of one CUDA
graph of the step (the JAX driver times one jitted ``fori_loop``); on the
CPU the steps are eager.
It prints one line a variant, ``variant  ms/step  (full - this)``.

The JAX driver's three variants driven by environment variables
(``TASMANIA_DERIVE_UV``, ``TASMANIA_FUSE_STAGE``, ``TASMANIA_SKIP_XBAND``)
are TPU probes and have no counterpart here.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_profile [--variants full,no_smoothing,...]
        [--niter 100] [--nx N] [--ny N] [--nz N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, FrozenSet, Mapping, Optional, Tuple

import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import (
    PROCESSES,
    build_domain_and_state,
    build_model,
    check_device,
    run_steps,
)
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

# name -> (the processes left out, options: "no_dycore" steps the physics
# alone, "damp" sets the namelist's damping)
VARIANTS: Dict[str, Tuple[FrozenSet[str], Dict[str, Any]]] = {
    "full": (frozenset(), {}),
    "dycore_only": (frozenset(PROCESSES), {}),
    "physics_only": (frozenset(), {"no_dycore": True}),
    "no_vertical_advection": (frozenset({"vertical_advection"}), {}),
    "no_smoothing": (frozenset({"smoothing"}), {}),
    "no_diagnostics": (frozenset({"diagnostics"}), {}),
    "no_sedimentation": (frozenset({"sedimentation"}), {}),
    "no_smagorinsky": (frozenset({"smagorinsky"}), {}),
    "no_velocities": (frozenset({"velocities"}), {}),
    "no_pointwise": (frozenset({"kessler", "satadj", "precipitation", "coriolis"}), {}),
    "no_damp": (frozenset(), {"damp": False}),
}

# the kernels each part of the flagship's step launches a step: the dycore's
# three RK3WS stages (the damping is inside the stage kernel), one kernel
# for each process that has one, and Kessler with saturation adjustment as
# one pair when both run; velocities, Coriolis and precipitation are plain
# PyTorch
DYCORE_KERNELS = {"si_stage": 3}
PROCESS_KERNELS = {
    "diagnostics": {"fused_isentropic_diagnostics": 1},
    "smoothing": {"fused_smoothing": 1},
    "smagorinsky": {"fused_smagorinsky_rk2": 1},
    "vertical_advection": {"fused_vertical_advection_rk3ws": 1},
    "sedimentation": {"fused_sedimentation_rk3ws": 1},
}
PAIR = ("kessler", "satadj")
PAIR_KERNELS = {"fused_kessler_satadj_rk2": 1}


def variant(name: str) -> Tuple[FrozenSet[str], Dict[str, Any]]:
    """The skip set and options of a variant; ``ValueError`` for an unknown
    name."""
    if name not in VARIANTS:
        raise ValueError(f"unknown variant {name!r}: one of {', '.join(VARIANTS)}")
    return VARIANTS[name]


def expected_launches(name: str) -> Dict[str, int]:
    """The kernel launches of one step of variant ``name`` on the card:
    the flagship's (``chip_smoke.LAUNCHES_PER_STEP["sus"]``) less those of
    the parts it leaves out."""
    skip, opts = variant(name)
    out: Dict[str, int] = {}
    parts = [] if opts.get("no_dycore") else [DYCORE_KERNELS]
    parts += [k for p, k in PROCESS_KERNELS.items() if p not in skip]
    if not set(PAIR) & skip:
        parts.append(PAIR_KERNELS)
    elif not set(PAIR) <= skip:
        raise ValueError(f"variant {name!r} leaves out one of {PAIR} alone")
    for kernels in parts:
        for k, n in kernels.items():
            out[k] = out.get(k, 0) + n
    return out


def variant_model(nl, name: str):
    """The namelist, initial state and step of variant ``name``:
    ``(nl, state, step_impl, hs_steady)``."""
    skip, opts = variant(name)
    if "damp" in opts:
        nl = load_namelist(**{**vars(nl), "damp": opts["damp"]})
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip)
    if opts.get("no_dycore"):
        def step_impl(st, dt):
            return physics(st, dt)
    else:
        def step_impl(st, dt):
            return physics(dycore(st, {}, dt), dt)
    return nl, state, step_impl, dycore.topography_steady


def run_variant(nl, name: str, *, fused_loop: Optional[bool] = None) -> Dict[str, Any]:
    """Variant ``name`` through the SUS driver's sequence (``run_steps``, in
    the mode ``fused_loop`` resolves to: by default the graph on a CUDA
    device): its result, the fields, ms/step and the launches of one step."""
    nl, state, step_impl, hs_steady = variant_model(nl, name)
    return run_steps(nl, state, step_impl, hs_steady, verbose=False, fused_loop=fused_loop)


def profile(nl, names, *, verbose: bool = True) -> Dict[str, Dict[str, Any]]:
    """Each variant of ``names`` in turn on ``nl``'s device (a CUDA graph
    of the step on the card, eager on the CPU); prints its line."""
    check_device(nl.so.device)
    for name in names:
        variant(name)
    results: Dict[str, Dict[str, Any]] = {}
    for name in names:
        res = run_variant(nl, name)
        results[name] = res
        if verbose:
            base = results.get("full")
            delta = (f"  (full - this = {base['ms_per_step'] - res['ms_per_step']:+.3f} ms)"
                     if base is not None and name != "full" else "")
            print(f"{name:24s} {res['ms_per_step']:8.3f} ms/step{delta}", flush=True)
    return results


def main(argv=None) -> Mapping[str, Dict[str, Any]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", type=str, default=",".join(VARIANTS))
    parser.add_argument("--niter", type=int, default=100)
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    names = [n for n in cli.variants.split(",") if n]
    for name in names:
        variant(name)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    defaults = load_namelist()
    overrides = {"niter": cli.niter,
                 "so": type(defaults.so)(dtype=defaults.so.dtype, device=torch.device(cli.device))}
    if cli.nx:
        overrides.update(nx=cli.nx, ny=cli.ny or cli.nx)
    elif cli.ny:
        overrides["ny"] = cli.ny
    if cli.nz:
        overrides["nz"] = cli.nz
    return profile(load_namelist(**overrides), names)


if __name__ == "__main__":
    main()
