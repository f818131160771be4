"""Diagnostic, tendency and stepper components (counterpart of
``tasmania_tpu/framework/core_components.py``).

A component is an ``nn.Module`` and a ``StencilFactory``: ``array_call``
maps raw tensors to raw tensors, and ``forward`` converts units at the
boundary and wraps the results into ``FieldArray``s.  A tendency
component's ``array_call`` returns ``(tendencies, diagnostics)``; an
implicit one also takes the timestep; a ``Stepper``'s takes the timestep
and returns ``(diagnostics, new state)``.  Every base takes the JAX
package's ``backend`` and ``backend_options`` keywords, which name the
stencils a component compiles and choose no kernel (``framework/stencil.py``).
"""

from __future__ import annotations

import abc
from datetime import timedelta
from typing import Any, Dict, Mapping, Optional, Tuple

from torch import nn

from tasmania_tpu_torch.framework.field import (
    FieldArray,
    ensure_timedelta_seconds,
    get_array_dict,
    wrap_outputs,
)
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.utils.constants import get_physical_constants
from tasmania_tpu_torch.utils.timer import Timer

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


def component_label(components) -> str:
    """The ``Timer`` label of one operation that runs ``components`` at
    once (a fused step, a process pair): their class names joined by "+",
    promoters left out."""
    return "+".join(type(c).__name__ for c in components if isinstance(c, _Component))


class _Component(nn.Module, StencilFactory, abc.ABC):
    """Domain binding, backend and storage options and physical constants."""

    #: ``{name: (value, units)}``, overridable through ``physical_constants``
    default_physical_constants: Dict[str, Any] = {}

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        *,
        physical_constants: Optional[Mapping[str, Any]] = None,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        if grid_type not in ("numerical", "physical"):
            raise ValueError(f"grid_type must be 'numerical' or 'physical', got {grid_type!r}")
        self.grid = domain.numerical_grid if grid_type == "numerical" else domain.physical_grid
        self.horizontal_boundary = domain.horizontal_boundary
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
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_diags = self.array_call(raw)
        return wrap_outputs(raw_diags, self.diagnostic_properties)


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
        with Timer.timing(type(self).__name__):
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


class Stepper(_Component):
    """Steps a subset of the state over a timestep directly."""

    @property
    @abc.abstractmethod
    def output_properties(self) -> PropertyDict:
        ...

    @property
    def diagnostic_properties(self) -> PropertyDict:
        return {}

    @abc.abstractmethod
    def array_call(
        self, state: Mapping[str, Any], timestep: float
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Raw state + dt (seconds) -> (raw diagnostics, raw new state)."""

    def forward(self, state: Mapping[str, Any], timestep) -> Tuple[Dict[str, FieldArray], Dict[str, FieldArray]]:
        dt = ensure_timedelta_seconds(timestep)
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            raw_diags, raw_out = self.array_call(raw, dt)
        diags = wrap_outputs(raw_diags, self.diagnostic_properties)
        out = wrap_outputs(raw_out, self.output_properties)
        if "time" in state:
            out["time"] = state["time"] + timedelta(seconds=dt)
        return diags, out
