"""Multi-stage dynamical-core driver (counterpart of
``tasmania_tpu/framework/dycore.py:174-271``): the stage loop with unit
conversion at the boundary.  No fast or superfast components and no
substepping are ported."""

from __future__ import annotations

import abc
from datetime import timedelta
from typing import Any, Dict, Mapping

from torch import nn

from tasmania_tpu_torch.framework.field import (
    FieldArray,
    ensure_timedelta_seconds,
    get_array_dict,
    wrap_outputs,
)

PropertyDict = Mapping[str, Mapping[str, Any]]


class DynamicalCore(nn.Module, abc.ABC):
    @property
    @abc.abstractmethod
    def stage_input_properties(self) -> PropertyDict:
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
    def stage_array_call(self, stage: int, raw_state: Mapping[str, Any], timestep: float) -> Dict[str, Any]:
        """Raw stage step: tensors in declared units -> stepped tensors."""

    def forward(self, state: Mapping[str, Any], tendencies: Mapping[str, Any], timestep) -> Dict[str, Any]:
        """Advance ``state`` one timestep; dycore tendencies are not ported."""
        if any(k != "time" for k in tendencies):
            raise NotImplementedError("dynamical-core tendencies are not ported")
        dt = ensure_timedelta_seconds(timestep)
        tmp_state = dict(state)
        for stage in range(self.stages):
            raw = get_array_dict(tmp_state, self.stage_input_properties)
            th = tmp_state.get("topography_height")
            if th is not None:
                raw["topography_height"] = th.to_units("m").data if isinstance(th, FieldArray) else th
            raw_out = self.stage_array_call(stage, raw, dt)
            tmp_state.update(wrap_outputs(raw_out, self.stage_output_properties))
        if "time" in state:
            tmp_state["time"] = state["time"] + timedelta(seconds=dt)
        return tmp_state
