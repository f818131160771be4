"""Physics-dynamics splittings: sequential-update, parallel and
sequential-tendency (counterpart of ``tasmania_tpu/framework/splitting.py``).

A process is given as ``TimeIntegrationOptions``: a diagnostic component, or
a component without a scheme, gives diagnostics; a component with a scheme
is wrapped in that stepper (``framework/steppers.py``).

* ``SequentialUpdateSplitting``: each process updates the state in turn,
  its stepper run ``substeps`` times.
* ``ParallelSplitting``: every process steps from the same current state,
  and each one's increment is added to the provisional state.
* ``SequentialTendencySplitting``: each process evaluates its tendencies on
  the current state and applies them to the provisional state.

Process-pair fusers let a component module run two ADJACENT processes (each
with one substep) as one operation, A then B, for example the Kessler +
saturation-adjustment kernel.  Results agree with the two separate processes
bitwise where the operation order allows it, and within a stated tolerance
otherwise (the tests hold each pair to its own).  A fuser registered without
a name is always planned; a named one (a "merge": ``"smooth_smag"``,
``"vadv_sed"``) only when the caller names it in
``SequentialUpdateSplitting(..., merges=...)``, the one place that choice is
made.
"""

from __future__ import annotations

from datetime import timedelta
from typing import AbstractSet, Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from torch import nn

from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.core_components import (
    DiagnosticComponent,
    TendencyComponent,
    component_label,
)
from tasmania_tpu_torch.framework.dict_operator import addsub, update
from tasmania_tpu_torch.framework.field import ensure_timedelta_seconds
from tasmania_tpu_torch.framework.options import TimeIntegrationOptions
from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper, TendencyStepper
from tasmania_tpu_torch.utils.timer import Timer

# (matcher(process_a, process_b) -> bool, fuser(process_a, process_b, state,
#  dt) -> (diagnostics, stepped), merge name or None for an always-on pair)
_PROCESS_PAIR_FUSERS: List[Tuple[Callable, Callable, Optional[str]]] = []


def register_process_pair_fuser(matcher, fuser, name: Optional[str] = None) -> None:
    _PROCESS_PAIR_FUSERS.append((matcher, fuser, name))


def merge_names() -> Tuple[str, ...]:
    """The names of the registered optional merges."""
    return tuple(name for _, _, name in _PROCESS_PAIR_FUSERS if name is not None)


def _pair_plan(processes, merges: AbstractSet[str] = frozenset()) -> List[Tuple[Any, ...]]:
    """``("one", process, substeps)`` and ``("pair", A, B, fuser)`` entries;
    named fusers take part only if ``merges`` holds their name."""
    plan: List[Tuple[Any, ...]] = []
    i = 0
    while i < len(processes):
        fused = None
        if i + 1 < len(processes) and processes[i][1] == 1 and processes[i + 1][1] == 1:
            for matcher, fuser, name in _PROCESS_PAIR_FUSERS:
                if name is not None and name not in merges:
                    continue
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


def _components(process) -> List[Any]:
    """A process's components: a stepper's coupling's, else the process."""
    coupling = getattr(process, "coupling", None)
    return list(coupling.components) if coupling is not None else [process]


def _build_processes(options: Sequence[TimeIntegrationOptions], family=TendencyStepper) -> List[Tuple[Any, int]]:
    """``(process, substeps)``: the component itself where it has no scheme,
    else the stepper of ``family`` for its scheme."""
    out = []
    for opt in options:
        if not isinstance(opt, TimeIntegrationOptions):
            raise TypeError(f"a process is given as TimeIntegrationOptions, got {type(opt).__name__}")
        if isinstance(opt.component, DiagnosticComponent) or opt.scheme is None:
            out.append((opt.component, 1))
        else:
            stepper = family.factory(
                opt.scheme, opt.component,
                enforce_horizontal_boundary=opt.enforce_horizontal_boundary,
                backend=opt.backend, backend_options=opt.backend_options,
                storage_options=opt.storage_options, **opt.kwargs,
            )
            out.append((stepper, opt.substeps))
    return out


class _Splitting(nn.Module):
    def __init__(self, *options: TimeIntegrationOptions, family=TendencyStepper) -> None:
        super().__init__()
        self._processes = _build_processes(options, family)
        self.processes = nn.ModuleList(p for p, _ in self._processes)

    @property
    def components(self):
        return tuple(self.processes)


class SequentialUpdateSplitting(_Splitting):
    """Processes applied one after another, each on the state the previous
    one left.  ``merges`` names the optional process-pair merges to plan
    (:func:`merge_names`); an unknown name raises ``ValueError``."""

    def __init__(self, *options: TimeIntegrationOptions, merges: Sequence[str] = ()) -> None:
        super().__init__(*options)
        unknown = set(merges) - set(merge_names())
        if unknown:
            raise ValueError(f"unknown process merges {sorted(unknown)} (have {sorted(merge_names())})")
        self.merges = frozenset(merges)

    def forward(self, state: Mapping[str, Any], timestep) -> Dict[str, Any]:
        td = timedelta(seconds=ensure_timedelta_seconds(timestep))
        out = dict(state)
        for entry in _pair_plan(self._processes, self.merges):
            if entry[0] == "pair":
                _, a, b, fuser = entry
                with Timer.timing(component_label(_components(a) + _components(b))):
                    diagnostics, stepped = fuser(a, b, out, td)
                out = update(update(out, diagnostics), stepped)
                continue
            _, proc, substeps = entry
            if isinstance(proc, DiagnosticComponent):
                out = update(out, proc(out))
            elif isinstance(proc, (ConcurrentCoupling, TendencyComponent)):
                # a tendency process without a scheme: only its diagnostics
                # feed the state (the chain's fall velocity + precipitation)
                out = update(out, proc(out, td)[1])
            else:
                for _ in range(substeps):
                    diagnostics, stepped = proc(out, td / substeps)
                    out = update(update(out, diagnostics), stepped)
        if "time" in state:
            out["time"] = state["time"] + td
        return out


class ParallelSplitting(_Splitting):
    """Every process steps from the same current state, and its increment
    (stepped minus current, on its output variables) is added to the
    provisional state.  ``__call__(state, state_prv, timestep)`` returns
    ``(current state with the processes' diagnostics, new provisional
    state)``; diagnostic components update the current state.

    A process without a scheme is called as a stepper is, as the JAX package
    does: a coupling's ``(tendencies, diagnostics)`` then take the places of
    ``(diagnostics, stepped)``, and as a coupling has no output variables
    nothing is added.  So the diagnostics of the moist chain's
    ``[fall velocity, precipitation]`` reach neither state."""

    def __init__(self, *options: TimeIntegrationOptions) -> None:
        super().__init__(*options)
        self.provisional_output_properties: Dict[str, Any] = {}
        for proc, _ in self._processes:
            for name, props in getattr(proc, "output_properties", {}).items():
                self.provisional_output_properties[name] = dict(props)

    def forward(self, state: Mapping[str, Any], state_prv: Mapping[str, Any], timestep):
        td = timedelta(seconds=ensure_timedelta_seconds(timestep))
        cur, prv = dict(state), dict(state_prv)
        for proc, substeps in self._processes:
            if isinstance(proc, DiagnosticComponent):
                cur = update(cur, proc(cur))
                continue
            sub_td = td / substeps
            diagnostics, stepped = proc(cur, sub_td)
            for _ in range(1, substeps):
                _, stepped = proc(update(cur, stepped), sub_td)
            own = getattr(proc, "output_properties", {})
            props = {k: v for k, v in self.provisional_output_properties.items() if k in own}
            prv = update(prv, addsub(prv, stepped, cur, props))
            cur = update(cur, diagnostics)
        if "time" in state:
            prv["time"] = state["time"] + td
        return cur, prv


class SequentialTendencySplitting(_Splitting):
    """Each process evaluates its tendencies on the current state and applies
    them to the provisional state, through the sequential-tendency steppers
    (a process's stepper runs once, with the timestep over ``substeps``, as
    in the JAX package).  Diagnostic components, and components without a
    scheme, update the provisional state.  ``__call__(state, state_prv,
    timestep)`` returns ``(current state with the steppers' diagnostics, new
    provisional state)``."""

    def __init__(self, *options: TimeIntegrationOptions) -> None:
        super().__init__(*options, family=SequentialTendencyStepper)

    def forward(self, state: Mapping[str, Any], state_prv: Mapping[str, Any], timestep):
        td = timedelta(seconds=ensure_timedelta_seconds(timestep))
        cur, prv = dict(state), dict(state_prv)
        for proc, substeps in self._processes:
            if isinstance(proc, DiagnosticComponent):
                prv = update(prv, proc(prv))
            elif isinstance(proc, (ConcurrentCoupling, TendencyComponent)):
                prv = update(prv, proc(prv, td)[1])
            else:
                diagnostics, stepped = proc(cur, prv, td / substeps)
                cur = update(cur, diagnostics)
                prv = update(prv, stepped)
        if "time" in state:
            cur["time"] = state["time"]
            prv["time"] = state["time"] + td
        return cur, prv
