"""Concurrent coupling: several components as one tendency evaluation
(counterpart of ``tasmania_tpu/framework/concurrent_coupling.py``, the
``"serial"`` execution policy).

Components run in order; each one's diagnostics enter the state the next one
sees, and tendencies of the same variable are summed.  Promoters move the
θ-tendency between the tendency and the diagnostic namespaces.

The chain-fuser registry lets a component module offer one operation for a
whole multi-stage step of a recognised component chain (for example the
sedimentation kernel for ``[KesslerFallVelocity, KesslerSedimentation]``
under RK3WS): ``fused_rk_step`` returns the first fuser's result, or ``None``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from torch import nn

from tasmania_tpu_torch.framework.core_components import DiagnosticComponent, merge_tendencies
from tasmania_tpu_torch.framework.promoter import FromDiagnosticToTendency, FromTendencyToDiagnostic
from tasmania_tpu_torch.utils.units import units_are_compatible

PropertyDict = Dict[str, Dict[str, Any]]

# (matcher(components, scheme) -> bool, fuser(components, state, dt, output_properties))
_CHAIN_FUSERS: List[Tuple[Callable, Callable]] = []


def register_chain_fuser(matcher, fuser) -> None:
    _CHAIN_FUSERS.append((matcher, fuser))


def _props(component, attr: str) -> Mapping[str, Any]:
    return getattr(component, attr, {}) or {}


class ConcurrentCoupling(nn.Module):
    """Explicit concurrent coupling of diagnostic, tendency and promoter
    components (Staniforth et al. 2002), evaluated serially."""

    def __init__(self, *components) -> None:
        super().__init__()
        self.components = nn.ModuleList(components)
        self.input_properties = self._input_properties()
        self.tendency_properties = self._tendency_properties()
        self.diagnostic_properties: PropertyDict = {}
        for c in components:
            self.diagnostic_properties.update({k: dict(v) for k, v in _props(c, "diagnostic_properties").items()})
        # the first producer of a tendency overwrites a stale entry
        self.overwrite_tendencies = []
        seen: set = set()
        for c in components:
            flags = {}
            for name in _props(c, "tendency_properties"):
                flags[name] = name not in seen
                seen.add(name)
            self.overwrite_tendencies.append(flags)
        self.horizontal_boundary = next(
            (c.horizontal_boundary for c in components if getattr(c, "horizontal_boundary", None) is not None),
            None,
        )

    def _input_properties(self) -> PropertyDict:
        """Inputs of every component that no earlier one produces."""
        inputs: PropertyDict = {}
        available: set = set()
        for c in self.components:
            own = {} if isinstance(c, FromTendencyToDiagnostic) else _props(c, "input_properties")
            for name, props in own.items():
                if name not in available and name not in inputs:
                    inputs[name] = dict(props)
                elif name in inputs and not units_are_compatible(
                    inputs[name].get("units", "1"), props.get("units", "1")
                ):
                    raise ValueError(f"incompatible units for input {name!r}")
            available |= set(_props(c, "diagnostic_properties"))
        return inputs

    def _tendency_properties(self) -> PropertyDict:
        tends: PropertyDict = {}
        for c in self.components:
            for name, props in _props(c, "tendency_properties").items():
                if name not in tends:
                    tends[name] = {k: v for k, v in props.items() if k != "tendency_name"}
                elif not units_are_compatible(tends[name].get("units", "1"), props.get("units", "1")):
                    raise ValueError(f"incompatible units for tendency {name!r}")
        return tends

    def fused_rk_step(self, scheme: str, state, dt: float, output_properties):
        """The whole step of a recognised chain in one operation, else None."""
        comps = tuple(self.components)
        for matcher, fuser in _CHAIN_FUSERS:
            if matcher(comps, scheme):
                return fuser(comps, state, dt, output_properties)
        return None

    def forward(
        self,
        state: Mapping[str, Any],
        timestep=None,
        *,
        out_tendencies: Optional[Mapping[str, Any]] = None,
        overwrite_tendencies: Optional[Mapping[str, bool]] = None,
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Returns ``(tendencies, diagnostics)``."""
        tendencies: Dict[str, Any] = dict(out_tendencies or {})
        diagnostics: Dict[str, Any] = {}
        overwrite_tendencies = overwrite_tendencies or {}
        aux = dict(state)
        for component, own in zip(self.components, self.overwrite_tendencies):
            if isinstance(component, DiagnosticComponent):
                new = component(aux)
                diagnostics.update(new)
                aux.update(new)
            elif isinstance(component, FromTendencyToDiagnostic):
                new = component(tendencies)
                diagnostics.update(new)
                aux.update(new)
            elif isinstance(component, FromDiagnosticToTendency):
                tendencies = merge_tendencies(tendencies, component(aux))
            else:
                ot = {n: flag and overwrite_tendencies.get(n, True) for n, flag in own.items()}
                tendencies, new = component(
                    aux, timestep, out_tendencies=tendencies, overwrite_tendencies=ot
                )
                diagnostics.update(new)
                aux.update({k: new[k] for k in _props(component, "diagnostic_properties") if k in new})
        return tendencies, diagnostics
