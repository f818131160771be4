"""Promoters: move a field between the tendency and the diagnostic namespaces
(counterpart of ``tasmania_tpu/framework/promoter.py``).

Used in the moist chain to hand the θ-tendency of Kessler microphysics to
saturation adjustment and vertical advection.  Both kinds only rename (and
convert units); they hold no state.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping

from torch import nn

from tasmania_tpu_torch.framework.field import FieldArray

PropertyDict = Mapping[str, Mapping[str, Any]]


class FromDiagnosticToTendency(nn.Module, abc.ABC):
    """Lift state diagnostics into the tendency namespace."""

    def __init__(self, domain, grid_type: str = "numerical", **kwargs) -> None:
        super().__init__()
        self.horizontal_boundary = domain.horizontal_boundary

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        """``{diagnostic_name: {dims, units, tendency_name}}``"""

    @property
    def tendency_properties(self) -> PropertyDict:
        return {
            props.get("tendency_name", name): {
                k: v for k, v in props.items() if k != "tendency_name"
            }
            for name, props in self.input_properties.items()
        }

    def forward(self, state: Mapping[str, Any]) -> Dict[str, FieldArray]:
        out: Dict[str, FieldArray] = {}
        for name, props in self.input_properties.items():
            out[props.get("tendency_name", name)] = state[name].to_units(props["units"])
        return out


class FromTendencyToDiagnostic(nn.Module, abc.ABC):
    """Expose computed tendencies as state diagnostics."""

    def __init__(self, domain, grid_type: str = "numerical", **kwargs) -> None:
        super().__init__()
        self.horizontal_boundary = domain.horizontal_boundary

    @property
    @abc.abstractmethod
    def input_tendency_properties(self) -> PropertyDict:
        """``{tendency_name: {dims, units, diagnostic_name}}``"""

    @property
    def diagnostic_properties(self) -> PropertyDict:
        return {
            props.get("diagnostic_name", f"tendency_of_{name}"): {
                k: v for k, v in props.items() if k != "diagnostic_name"
            }
            for name, props in self.input_tendency_properties.items()
        }

    def forward(self, tendencies: Mapping[str, Any]) -> Dict[str, FieldArray]:
        out: Dict[str, FieldArray] = {}
        for name, props in self.input_tendency_properties.items():
            diag = props.get("diagnostic_name", f"tendency_of_{name}")
            out[diag] = tendencies[name].to_units(props["units"])
        return out
