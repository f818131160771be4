"""Moist isentropic benchmark driver under all six physics-dynamics couplings
(counterpart of ``drivers/driver_isentropic_moist.py``).

The model and namelist are the SUS flagship's (``namelist_<coupling>.py``
re-export ``namelist_sus.py``); the coupling differs:

* ``fc``   -- full concurrent coupling: the physics chain [Smagorinsky,
  Kessler, saturation adjustment, θ-tendency to diagnostic, vertical
  advection, fall velocity, sedimentation] is the dycore's fast tendency
  component, evaluated on each stage's input state, and the isentropic
  diagnostics its fast diagnostic component; after the step the slow
  diagnostics [fall velocity, precipitation, smoothing, velocities];
* ``lfc``  -- lazy fc: the chain's tendencies evaluated once per step, before
  the dycore, and passed to it as its tendencies;
* ``ps``   -- parallel splitting of the SUS process list against the dycore's
  output;
* ``sts``  -- sequential-tendency splitting: the processes' tendencies are
  evaluated on the current state and applied to the dycore's output;
* ``sus``  -- sequential-update splitting (``driver_namelist_sus``);
* ``ssus`` -- symmetrized SUS: the first half of the process list before the
  dycore, the second half after it.

With the namelist's ``coriolis_parameter`` set (``--coriolis F``) the
Coriolis process comes first in fc's and lfc's chain, and after the
diagnostics in the process list of the others (so ssus's halves move with
it, as in the JAX driver).  Only sus takes ``implicit_vertical_advection``;
the other couplings advect explicitly whatever it says, as the JAX driver
does.

With tendencies (fc, lfc) the dycore's stages take the two-kernel path
(``ops/advection_step``); the others take the whole-stage kernel.  The
namelist's ``process_merges`` (``--merge NAME``) apply to the sequential-update
splittings of sus and ssus; the other couplings raise ``ValueError`` if any
is set.  The step sequence is the JAX driver's: one warm-up step at zero
mountain height, then ``niter`` timed steps with the growing mountain.
On a CUDA device the timed steps are replays of one CUDA graph of the
coupling's step, the counterpart of the JAX driver's per-step ``jax.jit``
(``driver_namelist_sus.run_steps``); on the CPU, or with
``fused_loop=False`` from Python, they are eager.  ``--fused-loop`` asks
for the graph and raises without a CUDA device.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_isentropic_moist --coupling fc
        [--nx N] [--ny N] [--nz N] [--niter N] [--device cuda|cpu] [--merge NAME]
        [--coriolis F] [--implicit-vadv] [--fused-loop]

The namelist's device is ``cuda``; without a GPU, ``run`` raises unless the
namelist names the CPU (``--device cpu`` on the command line).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Optional

from tasmania_tpu_torch.drivers.driver_namelist_sus import (
    build_components,
    build_domain_and_state,
    build_model,
    check_device,
    cli_mode,
    make_dycore,
    namelist_from,
    physics_options,
    run_steps,
    size_parser,
)
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.dict_operator import update
from tasmania_tpu_torch.framework.splitting import (
    ParallelSplitting,
    SequentialTendencySplitting,
    SequentialUpdateSplitting,
)

COUPLINGS = ("fc", "lfc", "ps", "sts", "sus", "ssus")


def build_variant(nl, coupling: str):
    """``(domain, initial state, dycore, step)`` of the coupling, as
    ``drivers/driver_isentropic_moist.py:108-279`` builds it; ``step(state,
    dt)`` is one timestep."""
    if coupling not in COUPLINGS:
        raise ValueError(f"unknown coupling {coupling!r} (have {COUPLINGS})")
    if nl.process_merges and coupling not in ("sus", "ssus"):
        raise ValueError(f"process_merges {tuple(nl.process_merges)}: the {coupling} coupling "
                         "runs no sequential-update splitting to merge processes in")
    domain, state, pt = build_domain_and_state(nl)
    if coupling == "sus":
        dycore, physics = build_model(nl, domain, pt)
        return domain, state, dycore, lambda st, dt: physics(dycore(st, {}, dt), dt)
    c = build_components(nl, domain, pt)

    if coupling in ("fc", "lfc"):
        chain = [c["turb"], c["ke"], c["sa"], c["t2d"], c["vf"], c["rfv"], c["sd"]]
        chain = ConcurrentCoupling(*([c["cf"]] if "cf" in c else []), *chain)
        slow_diagnostics = ConcurrentCoupling(c["rfv"], c["ap"], c["hs"], c["vc"])
        if coupling == "fc":
            dycore = make_dycore(nl, domain, pt, fast_tendency_component=chain,
                                 fast_diagnostic_component=c["dv"])

            def step(st, dt):
                st = dycore(st, {}, dt)
                return update(st, slow_diagnostics(st, dt)[1])

        else:
            dycore = make_dycore(nl, domain, pt)

            def step(st, dt):
                tendencies, diagnostics = chain(st, dt)
                st = dycore(update(st, diagnostics), tendencies, dt)
                st = update(st, c["dv"](st))
                return update(st, slow_diagnostics(st, dt)[1])

        return domain, state, dycore, step

    options = physics_options(nl, c)
    dycore = make_dycore(nl, domain, pt)
    if coupling == "ssus":
        half = len(options) // 2
        before = SequentialUpdateSplitting(*options[:half], merges=nl.process_merges)
        after = SequentialUpdateSplitting(*options[half:], merges=nl.process_merges)
        return domain, state, dycore, lambda st, dt: after(dycore(before(st, dt), {}, dt), dt)

    if coupling == "ps":
        physics = ParallelSplitting(*options)
    else:
        physics = SequentialTendencySplitting(*options)

    def step(st, dt):
        cur, prv = physics(st, dycore(st, {}, dt), dt)
        return update(cur, prv)

    return domain, state, dycore, step


def run(nl, coupling: str, *, verbose: bool = True, fused_loop: Optional[bool] = None) -> Dict[str, Any]:
    """Build the coupling's model, run the warm-up step and ``nl.niter``
    timed steps on the namelist's device (on a CUDA device as replays of a
    CUDA graph of the step unless ``fused_loop`` is False:
    ``driver_namelist_sus.graph_mode``); the result of
    ``driver_namelist_sus.run`` (validation numbers, timing, final fields,
    launches a step)."""
    check_device(nl.so.device, fused_loop=fused_loop)
    _, state, dycore, step = build_variant(nl, coupling)
    return run_steps(nl, state, step, dycore.topography_steady, verbose=verbose,
                     fused_loop=fused_loop)


def load_namelist(coupling: str, **overrides):
    """The coupling's namelist (``namelist_<coupling>.py``) with overrides."""
    module = importlib.import_module(f"tasmania_tpu_torch.drivers.namelist_{coupling}")
    return module.load_namelist(**overrides)


def main(argv=None):
    parser = size_parser(__doc__.split("\n\n")[0])
    parser.add_argument("--coupling", choices=COUPLINGS, default="sus")
    cli = parser.parse_args(argv)
    nl = namelist_from(parser, cli, lambda **kw: load_namelist(cli.coupling, **kw))
    res = run(nl, cli.coupling, fused_loop=cli_mode(cli))
    print("Simulation successfully completed.")
    return res


if __name__ == "__main__":
    main()
