"""The Burgers dynamical core (counterpart of
``tasmania_tpu/burgers/dynamics/dycore.py``): the prognostics are the two
velocity components on a grid one level deep (``nz == 1``); each stage runs
the stepper, then enforces the lateral boundary at the stage's time."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from tasmania_tpu_torch.burgers.dynamics.stepper import BurgersStepper
from tasmania_tpu_torch.framework.dycore import DynamicalCore
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND

DIMS = ("x", "y", "z")
#: the reference's flux names, mapped to the advection's
FLUX_ALIASES = {"upwind": "first_order", "centered": "second_order"}


class BurgersDynamicalCore(DynamicalCore):
    def __init__(self, domain, fast_tendency_component=None,
                 time_integration_scheme: str = "forward_euler", flux_scheme: str = "upwind", *,
                 backend: str = DEFAULT_BACKEND, backend_options: Optional[BackendOptions] = None,
                 storage_options: Optional[StorageOptions] = None) -> None:
        super().__init__(fast_tendency_component, None, backend=backend,
                         backend_options=backend_options, storage_options=storage_options)
        self.grid = domain.numerical_grid
        if self.grid.nz != 1:
            raise ValueError(f"the Burgers model needs nz == 1, not {self.grid.nz}")
        self.horizontal_boundary = domain.horizontal_boundary
        self.stepper = BurgersStepper.factory(
            time_integration_scheme, self.grid.grid_xy, self.horizontal_boundary.nb,
            FLUX_ALIASES.get(flux_scheme, flux_scheme), backend=backend,
            backend_options=backend_options, storage_options=self.storage_options,
        )

    @property
    def stage_input_properties(self):
        return {"x_velocity": {"dims": DIMS, "units": "m s^-1"},
                "y_velocity": {"dims": DIMS, "units": "m s^-1"}}

    @property
    def stage_tendency_properties(self):
        return {"x_velocity": {"dims": DIMS, "units": "m s^-2"},
                "y_velocity": {"dims": DIMS, "units": "m s^-2"}}

    @property
    def stage_output_properties(self):
        return self.stage_input_properties

    @property
    def stages(self) -> int:
        return self.stepper.stages

    def stage_array_call(self, stage: int, raw_state: Mapping[str, Any],
                         raw_tendencies: Mapping[str, Any], timestep: float) -> Dict[str, Any]:
        out = self.stepper(stage, raw_state, raw_tendencies, timestep)
        return self.horizontal_boundary.enforce_raw(out, self.stage_output_properties)
