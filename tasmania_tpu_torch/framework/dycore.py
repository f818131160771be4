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
4. the fast diagnostic component runs on the stage's output; its
   diagnostics update it, and its tendencies go to the next stage.

Substepping and the superfast components are not ported: the constructors
take no such argument.
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Tuple

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

PropertyDict = Mapping[str, Mapping[str, Any]]


def _coupling(component):
    if component is None or isinstance(component, ConcurrentCoupling):
        return component
    return ConcurrentCoupling(component)


class DynamicalCore(nn.Module, abc.ABC):
    def __init__(self, fast_tendency_component=None, fast_diagnostic_component=None) -> None:
        super().__init__()
        self.fast_tendency_component = _coupling(fast_tendency_component)
        self.fast_diagnostic_component = _coupling(fast_diagnostic_component)

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

    def forward(self, state: Mapping[str, Any], tendencies: Mapping[str, Any], timestep) -> Dict[str, Any]:
        """Advance ``state`` one timestep under the slow ``tendencies``."""
        dt = ensure_timedelta_seconds(timestep)
        tmp_state = dict(state)
        fdc_tendencies: Dict[str, Any] = {}
        for stage in range(self.stages):
            tmp_state, fdc_tendencies = self._stage_call(stage, dt, tendencies, tmp_state, fdc_tendencies)
        if "time" in state:
            tmp_state["time"] = add_seconds(state["time"], dt)
        return tmp_state

    def _stage_call(
        self, stage: int, dt: float, slow_tendencies: Mapping[str, Any], tmp_state: Dict[str, Any],
        fdc_tendencies: Mapping[str, Any],
    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        tends = merge_tendencies({k: v for k, v in slow_tendencies.items() if k != "time"}, fdc_tendencies)
        if self.fast_tendency_component is not None:
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
        raw_out = self.stage_array_call(stage, raw, raw_tends, dt)
        stage_state = update(tmp_state, wrap_outputs(raw_out, self.stage_output_properties))
        if "time" in raw_out:  # the stage's own time stamp
            stage_state["time"] = raw_out["time"]

        new_fdc_tendencies: Dict[str, Any] = {}
        if self.fast_diagnostic_component is not None:
            new_fdc_tendencies, diagnostics = self.fast_diagnostic_component(stage_state, dt)
            stage_state = update(stage_state, diagnostics)
        return stage_state, new_fdc_tendencies
