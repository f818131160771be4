"""Sequential-update splitting (counterpart of
``tasmania_tpu/framework/splitting.py:101 SequentialUpdateSplitting``).

Each process updates the state in turn.  A process is given as
``TimeIntegrationOptions``: a diagnostic component, or a component without a
scheme, feeds the state its diagnostics; a component with a scheme is wrapped
in that stepper (``framework/steppers.py``), run ``substeps`` times.

Process-pair fusers let a component module run two ADJACENT processes (both
steppers with one substep) as one operation, A then B, for example the
Kessler + saturation-adjustment kernel.  Results agree with the two separate
processes bitwise where the operation order allows it, and within a stated
tolerance otherwise (the tests hold each pair to its own).
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

from torch import nn

from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.core_components import DiagnosticComponent, TendencyComponent
from tasmania_tpu_torch.framework.field import ensure_timedelta_seconds
from tasmania_tpu_torch.framework.options import TimeIntegrationOptions
from tasmania_tpu_torch.framework.steppers import TendencyStepper

# (matcher(stepper_a, stepper_b) -> bool, fuser(stepper_a, stepper_b, state, dt)
#  -> (diagnostics, stepped))
_PROCESS_PAIR_FUSERS: List[Tuple[Callable, Callable]] = []


def register_process_pair_fuser(matcher, fuser) -> None:
    _PROCESS_PAIR_FUSERS.append((matcher, fuser))


def _pair_plan(processes) -> List[Tuple[Any, ...]]:
    """``("one", process, substeps)`` and ``("pair", A, B, fuser)`` entries."""
    plan: List[Tuple[Any, ...]] = []
    i = 0
    while i < len(processes):
        fused = None
        if i + 1 < len(processes) and processes[i][1] == 1 and processes[i + 1][1] == 1:
            for matcher, fuser in _PROCESS_PAIR_FUSERS:
                if matcher(processes[i][0], processes[i + 1][0]):
                    fused = ("pair", processes[i][0], processes[i + 1][0], fuser)
                    break
        if fused is not None:
            plan.append(fused)
            i += 2
        else:
            plan.append(("one",) + tuple(processes[i]))
            i += 1
    return plan


def _build_processes(options: Sequence[TimeIntegrationOptions]) -> List[Tuple[Any, int]]:
    out = []
    for opt in options:
        if not isinstance(opt, TimeIntegrationOptions):
            raise TypeError(f"a process is given as TimeIntegrationOptions, got {type(opt).__name__}")
        if isinstance(opt.component, DiagnosticComponent) or opt.scheme is None:
            out.append((opt.component, 1))
        else:
            stepper = TendencyStepper.factory(
                opt.scheme, opt.component,
                enforce_horizontal_boundary=opt.enforce_horizontal_boundary,
            )
            out.append((stepper, opt.substeps))
    return out


class SequentialUpdateSplitting(nn.Module):
    """Processes applied one after another, each on the state the previous
    one left."""

    def __init__(self, *options: TimeIntegrationOptions) -> None:
        super().__init__()
        self._processes = _build_processes(options)
        self.processes = nn.ModuleList(p for p, _ in self._processes)

    @property
    def components(self):
        return tuple(self.processes)

    def forward(self, state: Mapping[str, Any], timestep) -> Dict[str, Any]:
        td = timedelta(seconds=ensure_timedelta_seconds(timestep))
        out = dict(state)

        def update(new):
            out.update({k: v for k, v in new.items() if k != "time"})

        for entry in _pair_plan(self._processes):
            if entry[0] == "pair":
                _, a, b, fuser = entry
                diagnostics, stepped = fuser(a, b, out, td)
                update(diagnostics)
                update(stepped)
                continue
            _, proc, substeps = entry
            if isinstance(proc, DiagnosticComponent):
                update(proc(out))
            elif isinstance(proc, (ConcurrentCoupling, TendencyComponent)):
                # a tendency process without a scheme: only its diagnostics
                # feed the state (the chain's fall velocity + precipitation)
                update(proc(out, td)[1])
            else:
                for _ in range(substeps):
                    diagnostics, stepped = proc(out, td / substeps)
                    update(diagnostics)
                    update(stepped)
        if "time" in state:
            out["time"] = state["time"] + td
        return out
