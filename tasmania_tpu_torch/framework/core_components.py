"""Diagnostic components (counterpart of
``tasmania_tpu/framework/core_components.py``, the diagnostic kind only).

A component is an ``nn.Module``: ``array_call`` maps raw tensors to raw
tensors, and ``forward`` converts units at the boundary and wraps the results
into ``FieldArray``s.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional

from torch import nn

from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict, wrap_outputs
from tasmania_tpu_torch.framework.options import StorageOptions

PropertyDict = Mapping[str, Mapping[str, Any]]


class DiagnosticComponent(nn.Module, abc.ABC):
    """Computes diagnostics from the state."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__()
        if grid_type not in ("numerical", "physical"):
            raise ValueError(f"grid_type must be 'numerical' or 'physical', got {grid_type!r}")
        self.grid = domain.numerical_grid if grid_type == "numerical" else domain.physical_grid
        self.horizontal_boundary = domain.horizontal_boundary
        self.storage_options = storage_options or StorageOptions()

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def diagnostic_properties(self) -> PropertyDict:
        ...

    @abc.abstractmethod
    def array_call(self, state: Mapping[str, Any]) -> Dict[str, Any]:
        """Raw tensors in (declared units) -> raw diagnostics out."""

    def forward(self, state: Mapping[str, Any]) -> Dict[str, FieldArray]:
        raw = get_array_dict(state, self.input_properties)
        return wrap_outputs(self.array_call(raw), self.diagnostic_properties)
