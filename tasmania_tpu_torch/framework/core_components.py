"""Diagnostic and tendency components (counterpart of
``tasmania_tpu/framework/core_components.py``).

A component is an ``nn.Module``: ``array_call`` maps raw tensors to raw
tensors, and ``forward`` converts units at the boundary and wraps the results
into ``FieldArray``s.  A tendency component's ``array_call`` returns
``(tendencies, diagnostics)``; an implicit one also takes the timestep.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple

from torch import nn

from tasmania_tpu_torch.framework.field import (
    FieldArray,
    ensure_timedelta_seconds,
    get_array_dict,
    wrap_outputs,
)
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.constants import get_physical_constants

PropertyDict = Mapping[str, Mapping[str, Any]]


def merge_tendencies(
    out_tendencies: Optional[Mapping[str, FieldArray]],
    new: Mapping[str, FieldArray],
    overwrite: Optional[Mapping[str, bool]] = None,
) -> Dict[str, FieldArray]:
    """Add ``new`` to the tendencies already in ``out_tendencies``, except
    where the per-variable ``overwrite`` flag is set."""
    merged: Dict[str, FieldArray] = dict(out_tendencies or {})
    overwrite = overwrite or {}
    for name, fa in new.items():
        if name == "time":
            continue
        if name in merged and not overwrite.get(name, False):
            prev = merged[name]
            merged[name] = prev.with_data(prev.data + fa.to_units(prev.units).data)
        else:
            merged[name] = fa
    return merged


class _Component(nn.Module, abc.ABC):
    """Domain binding, storage options and physical constants."""

    #: ``{name: (value, units)}``, overridable through ``physical_constants``
    default_physical_constants: Dict[str, Any] = {}

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        physical_constants: Optional[Mapping[str, Any]] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__()
        if grid_type not in ("numerical", "physical"):
            raise ValueError(f"grid_type must be 'numerical' or 'physical', got {grid_type!r}")
        self.grid = domain.numerical_grid if grid_type == "numerical" else domain.physical_grid
        self.horizontal_boundary = domain.horizontal_boundary
        self.storage_options = storage_options or StorageOptions()
        self.rpc = get_physical_constants(self.default_physical_constants, physical_constants)

    @property
    @abc.abstractmethod
    def input_properties(self) -> PropertyDict:
        ...


class DiagnosticComponent(_Component):
    """Computes diagnostics from the state."""

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


class TendencyComponent(_Component):
    """Computes tendencies (and diagnostics) from the state."""

    @property
    @abc.abstractmethod
    def tendency_properties(self) -> PropertyDict:
        ...

    @property
    def diagnostic_properties(self) -> PropertyDict:
        return {}

    @abc.abstractmethod
    def array_call(self, state: Mapping[str, Any]) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state -> (raw tendencies, raw diagnostics)."""

    def _raw_call(self, raw, timestep):
        return self.array_call(raw)

    def forward(
        self,
        state: Mapping[str, Any],
        timestep=None,
        *,
        out_tendencies: Optional[Mapping[str, FieldArray]] = None,
        overwrite_tendencies: Optional[Mapping[str, bool]] = None,
    ) -> Tuple[Dict[str, FieldArray], Dict[str, FieldArray]]:
        raw = get_array_dict(state, self.input_properties)
        raw_tends, raw_diags = self._raw_call(raw, timestep)
        tends = wrap_outputs(raw_tends, self.tendency_properties)
        diags = wrap_outputs(raw_diags, self.diagnostic_properties)
        return merge_tendencies(out_tendencies, tends, overwrite_tendencies), diags


class ImplicitTendencyComponent(TendencyComponent):
    """A tendency component whose tendencies depend on the timestep."""

    @abc.abstractmethod
    def array_call(
        self, state: Mapping[str, Any], timestep: float
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state + dt (seconds) -> (raw tendencies, raw diagnostics)."""

    def _raw_call(self, raw, timestep):
        dt = ensure_timedelta_seconds(timestep) if timestep is not None else 0.0
        return self.array_call(raw, dt)
