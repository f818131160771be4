"""Chains of diagnostic components (counterpart of
``tasmania_tpu/framework/composite.py``): ``DiagnosticComponentComposite``
under the ``"serial"`` policy (each component's diagnostics enter the state
the next one sees) or ``"as_parallel"`` (every component sees the input
state); an unknown policy is ``"serial"``."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from torch import nn

from tasmania_tpu_torch.utils.exceptions import PropertyError
from tasmania_tpu_torch.utils.units import units_are_compatible

POLICIES = ("serial", "as_parallel")


class DiagnosticComponentComposite(nn.Module):
    def __init__(self, *components, execution_policy: str = "serial") -> None:
        super().__init__()
        self.components = nn.ModuleList(components)
        self.execution_policy = execution_policy if execution_policy in POLICIES else "serial"
        self.input_properties: Dict[str, Any] = {}
        self.diagnostic_properties: Dict[str, Any] = {}
        available: set = set()
        for c in components:
            for name, props in (getattr(c, "input_properties", {}) or {}).items():
                if name not in available and name not in self.input_properties:
                    self.input_properties[name] = dict(props)
                elif name in self.input_properties and not units_are_compatible(
                    self.input_properties[name].get("units", "1"), props.get("units", "1")
                ):
                    raise PropertyError(f"incompatible units for input {name!r}")
            diagnostics = getattr(c, "diagnostic_properties", {}) or {}
            self.diagnostic_properties.update({k: dict(v) for k, v in diagnostics.items()})
            if self.execution_policy == "serial":
                available |= set(diagnostics)

    def forward(self, state: Mapping[str, Any], *, out: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
        diagnostics: Dict[str, Any] = dict(out or {})
        serial = self.execution_policy == "serial"
        aux = dict(state)
        for c in self.components:
            new = c(aux if serial else state)
            diagnostics.update(new)
            if serial:
                aux.update(new)
        if "time" in state:
            diagnostics["time"] = state["time"]
        return diagnostics
