"""Diagnostic components exposing the isentropic-core diagnostics to the
physics chain (counterpart of ``tasmania_tpu/isentropic/physics/diagnostics.py``)."""

from __future__ import annotations

import numpy as np

from tasmania_tpu_torch.dwarfs.diagnostics import get_velocity_components
from tasmania_tpu_torch.framework.core_components import DiagnosticComponent
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.isentropic.dynamics.diagnostics import (
    IsentropicDiagnostics as DynamicsDiagnostics,
)

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")
DIMS_U = ("x_at_u_locations", "y", "z")
DIMS_V = ("x", "y_at_v_locations", "z")


class IsentropicDiagnostics(DiagnosticComponent):
    """p / exn / mtg / h (+ ρ, T when moist) from the isentropic density."""

    def __init__(self, domain, grid_type: str = "numerical", moist: bool = False,
                 pt=None, physical_constants=None, **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.moist = moist
        if isinstance(pt, FieldArray):
            self.pt = float(np.asarray(pt.to_units("Pa").data))
        else:
            self.pt = float(pt if pt is not None else 0.0)
        self.core = DynamicsDiagnostics(
            self.grid, physical_constants, storage_options=self.storage_options
        )

    @property
    def input_properties(self):
        props = {"air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"}}
        # a growing mountain enters through the state, as in the dycore
        if self.grid.topography.time.total_seconds() > 0.0:
            props["topography_height"] = {"dims": ("x", "y"), "units": "m"}
        return props

    @property
    def diagnostic_properties(self):
        props = {
            "air_pressure_on_interface_levels": {"dims": DIMS_Z, "units": "Pa"},
            "exner_function_on_interface_levels": {"dims": DIMS_Z, "units": "J K^-1 kg^-1"},
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
        }
        if self.moist:
            props["air_density"] = {"dims": DIMS, "units": "kg m^-3"}
            props["air_temperature"] = {"dims": DIMS, "units": "K"}
        return props

    def array_call(self, state):
        res = self.core.get_diagnostic_variables(
            state["air_isentropic_density"], self.pt,
            hs=state.get("topography_height"), moist=self.moist,
        )
        return dict(zip(self.diagnostic_properties, res))


class IsentropicVelocityComponents(DiagnosticComponent):
    """Staggered velocities from the momenta, with the outermost layers from
    the lateral boundary."""

    def __init__(self, domain, **kwargs) -> None:
        super().__init__(domain, "numerical", **kwargs)

    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {
            "x_velocity_at_u_locations": {"dims": DIMS_U, "units": "m s^-1"},
            "y_velocity_at_v_locations": {"dims": DIMS_V, "units": "m s^-1"},
        }

    def array_call(self, state):
        hb = self.horizontal_boundary
        u, v = get_velocity_components(
            state["air_isentropic_density"],
            state["x_momentum_isentropic"],
            state["y_momentum_isentropic"],
        )
        return {
            "x_velocity_at_u_locations": hb.set_outermost_layers_x(
                u, "x_velocity_at_u_locations", "m s^-1"
            ),
            "y_velocity_at_v_locations": hb.set_outermost_layers_y(
                v, "y_velocity_at_v_locations", "m s^-1"
            ),
        }
