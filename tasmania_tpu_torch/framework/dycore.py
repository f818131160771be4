"""Multi-stage dynamical-core driver (counterpart of
``tasmania_tpu/framework/dycore.py:174-271``): the stage loop with unit
conversion at the boundary, tendencies and the fast components.

Per stage, as in the JAX package's ``_stage_call``:

1. the slow tendencies (the ``tendencies`` argument) are merged with the
   tendencies the fast diagnostic component gave after the previous stage;
2. the fast tendency component runs on the stage's input state, adding its
   tendencies to those (``out_tendencies``), and its diagnostics update that
   state;
3. the stage steps the state with the tendencies it declares in
   ``stage_tendency_properties``;
4. with ``substeps`` > 0 and a non-empty ``substep_output_properties``, the
   variables that property names are stepped again from the stage's input
   in ``int(substep_fractions[stage] * substeps)`` substeps of ``dt /
   substeps`` (``substep_array_call``), the superfast tendency component
   run before and the superfast diagnostic component after each substep;
5. the fast diagnostic component runs on the stage's output; its
   diagnostics update it, and its tendencies go to the next stage.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional, Tuple

from torch import nn

from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.core_components import merge_tendencies
from tasmania_tpu_torch.framework.dict_operator import update
from tasmania_tpu_torch.framework.field import (
    FieldArray,
    add_seconds,
    ensure_timedelta_seconds,
    get_array_dict,
    wrap_outputs,
)
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.utils.timer import Timer

PropertyDict = Mapping[str, Mapping[str, Any]]


def _coupling(component):
    if component is None or isinstance(component, ConcurrentCoupling):
        return component
    return ConcurrentCoupling(component)


class DynamicalCore(nn.Module, StencilFactory, abc.ABC):
    def __init__(self, fast_tendency_component=None, fast_diagnostic_component=None, substeps: int = 0,
                 superfast_tendency_component=None, superfast_diagnostic_component=None, *,
                 backend: str = DEFAULT_BACKEND, backend_options: Optional[BackendOptions] = None,
                 storage_options: Optional[StorageOptions] = None) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self.fast_tendency_component = _coupling(fast_tendency_component)
        self.fast_diagnostic_component = _coupling(fast_diagnostic_component)
        self.substeps = int(substeps)
        self.superfast_tendency_component = _coupling(superfast_tendency_component)
        self.superfast_diagnostic_component = _coupling(superfast_diagnostic_component)

    @property
    @abc.abstractmethod
    def stage_input_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stage_tendency_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stage_output_properties(self) -> PropertyDict:
        ...

    @property
    @abc.abstractmethod
    def stages(self) -> int:
        ...

    @abc.abstractmethod
    def stage_array_call(
        self, stage: int, raw_state: Mapping[str, Any], raw_tendencies: Mapping[str, Any], timestep: float
    ) -> Dict[str, Any]:
        """Raw stage step: tensors in declared units -> stepped tensors."""

    # -- the substep interface: empty properties (the default) substep nothing
    @property
    def substep_input_properties(self) -> PropertyDict:
        """The variables a substep reads."""
        return {}

    @property
    def substep_tendency_properties(self) -> PropertyDict:
        """The tendencies a substep may take."""
        return {}

    @property
    def substep_output_properties(self) -> PropertyDict:
        """The variables the substeps step again; empty: no substepping."""
        return {}

    @property
    def substep_fractions(self):
        """Each stage's share of ``substeps``."""
        return tuple(1.0 for _ in range(self.stages))

    def substep_array_call(
        self, stage: int, substep: int, raw_state: Mapping[str, Any], raw_stage_state: Mapping[str, Any],
        raw_substep_state: Mapping[str, Any], raw_tendencies: Mapping[str, Any], timestep: float,
    ) -> Dict[str, Any]:
        """One substep: ``raw_state`` is the timestep's start, ``raw_stage_state``
        the output of ``stage_array_call``, ``raw_substep_state`` the latest
        substepped values; ``timestep`` is the whole dt (a substep's is
        ``timestep / self.substeps``)."""
        raise NotImplementedError(
            "substeps > 0 with non-empty substep_output_properties requires "
            "the subclass to implement substep_array_call"
        )

    @property
    def input_properties(self) -> PropertyDict:
        """The stage's inputs, then the fast and superfast tendency
        components' and the substeps' that the stage does not read."""
        props = {k: dict(p) for k, p in self.stage_input_properties.items()}
        for comp in (self.fast_tendency_component, self.superfast_tendency_component):
            if comp is not None:
                for name, p in comp.input_properties.items():
                    props.setdefault(name, dict(p))
        for name, p in self.substep_input_properties.items():
            props.setdefault(name, dict(p))
        return props

    def forward(self, state: Mapping[str, Any], tendencies: Mapping[str, Any], timestep) -> Dict[str, Any]:
        """Advance ``state`` one timestep under the slow ``tendencies``."""
        dt = ensure_timedelta_seconds(timestep)
        tmp_state = dict(state)
        fdc_tendencies: Dict[str, Any] = {}
        for stage in range(self.stages):
            tmp_state, fdc_tendencies = self._stage_call(stage, dt, state, tendencies, tmp_state, fdc_tendencies)
        if "time" in state:
            tmp_state["time"] = add_seconds(state["time"], dt)
        return tmp_state

    def _stage_call(
        self, stage: int, dt: float, state: Mapping[str, Any], slow_tendencies: Mapping[str, Any],
        tmp_state: Dict[str, Any], fdc_tendencies: Mapping[str, Any],
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        tends = merge_tendencies({k: v for k, v in slow_tendencies.items() if k != "time"}, fdc_tendencies)
        if self.fast_tendency_component is not None:
            with Timer.timing("call_fast_tendency_component"):
                tends, diagnostics = self.fast_tendency_component(tmp_state, dt, out_tendencies=tends)
                tmp_state = update(tmp_state, diagnostics)

        raw = get_array_dict(tmp_state, self.stage_input_properties)
        if "time" in tmp_state:
            raw["time"] = tmp_state["time"]
        th = tmp_state.get("topography_height")
        if th is not None:
            raw["topography_height"] = th.to_units("m").data if isinstance(th, FieldArray) else th
        raw_tends = get_array_dict(
            tends, {k: p for k, p in self.stage_tendency_properties.items() if k in tends}
        )
        with Timer.timing("stage"):
            raw_out = self.stage_array_call(stage, raw, raw_tends, dt)
        stage_state = update(tmp_state, wrap_outputs(raw_out, self.stage_output_properties))
        if "time" in raw_out:  # the stage's own time stamp
            stage_state["time"] = raw_out["time"]
        if self.substeps > 0 and self.substep_output_properties:
            with Timer.timing("substeps"):
                stage_state = self._substep_loop(stage, dt, state, raw_out, tmp_state, stage_state)

        new_fdc_tendencies: Dict[str, Any] = {}
        if self.fast_diagnostic_component is not None:
            with Timer.timing("call_fast_diagnostic_component"):
                new_fdc_tendencies, diagnostics = self.fast_diagnostic_component(stage_state, dt)
                stage_state = update(stage_state, diagnostics)
        return stage_state, new_fdc_tendencies

    def _substep_loop(
        self, stage: int, dt: float, state: Mapping[str, Any], raw_stage_state: Mapping[str, Any],
        stage_input_state: Mapping[str, Any], stage_state: Dict[str, Any],
    ) -> Dict[str, Any]:
        """Step the ``substep_output_properties`` variables again from their
        values at the stage's input, in ``int(fraction * substeps)`` substeps
        of ``dt / substeps`` (none where that truncates to 0: they keep the
        stage's input), with the superfast components around each."""
        frac = 1.0 if self.stages == 1 else self.substep_fractions[stage]
        n = int(frac * self.substeps)
        inputs = self.substep_input_properties
        tendency_props = self.substep_tendency_properties
        raw_state = get_array_dict({k: v for k, v in state.items() if k in inputs},
                                   {k: p for k, p in inputs.items() if k in state})
        out_state: Dict[str, Any] = dict(stage_state)
        for name in self.substep_output_properties:
            if name in stage_input_state:
                out_state[name] = stage_input_state[name]
        stc, sdc = self.superfast_tendency_component, self.superfast_diagnostic_component
        sub_dt = dt / self.substeps
        for substep in range(n):
            tends: Mapping[str, Any] = {}
            if stc is not None:
                tends, diagnostics = stc(out_state, sub_dt)
                out_state = update(out_state, diagnostics)
            raw_substep_state = get_array_dict(out_state, inputs)
            raw_tends = get_array_dict({k: v for k, v in tends.items() if k in tendency_props},
                                       {k: p for k, p in tendency_props.items() if k in tends})
            raw_out = self.substep_array_call(
                stage, substep, raw_state, raw_stage_state, raw_substep_state, raw_tends, dt
            )
            out_state = update(out_state, wrap_outputs(raw_out, self.substep_output_properties))
            if sdc is not None:
                _, diagnostics = sdc(out_state, sub_dt)
                out_state = update(out_state, diagnostics)
        for name in self.substep_output_properties:
            if name in out_state:
                stage_state[name] = out_state[name]
        return stage_state
