"""Rank jobs that the port's distribution tests start through
``tasmania_tpu_torch.parallel.launch`` (a module the ranks import, so it
imports neither JAX nor the JAX package)."""

from __future__ import annotations


def guarded_spmd(ctx, *, poison_rank: int, poison_call: int, **job):
    """``driver_namelist_sus.spmd_rank_run`` with a NaN written into one
    field of rank ``poison_rank``'s block at its ``poison_call``-th step
    call (the warm-up step is call 1); returns the NaN guard's message
    instead of raising it."""
    from tasmania_tpu_torch.drivers.driver_namelist_sus import spmd_rank_run
    from tasmania_tpu_torch.parallel.runner import DistributedModel

    calls = []
    step_state = DistributedModel.step_state

    def poisoned(self, fields, hs):
        out = step_state(self, fields, hs)
        calls.append(1)
        if ctx.rank == poison_rank and len(calls) == poison_call:
            out["air_isentropic_density"].data[1, 2, 0] = float("nan")
        return out

    DistributedModel.step_state = poisoned  # this rank's process only
    try:
        spmd_rank_run(ctx, **job)
    except RuntimeError as err:
        return {"guard": str(err), "calls": len(calls)}
    finally:
        DistributedModel.step_state = step_state
    return {"guard": None, "calls": len(calls)}
