"""Dry and moist static energy diagnostics (counterpart of
``tasmania_tpu/physics/static_energy.py``), plain PyTorch as there."""

from __future__ import annotations

from tasmania_tpu_torch.framework.core_components import DiagnosticComponent

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


class DryStaticEnergy(DiagnosticComponent):
    """dse = cp·T + g·h, h the mean of its interface values when given on
    the interfaces; returned under the JAX package's name,
    ``montgomery_potential``."""

    default_physical_constants = {
        "gravitational_acceleration": (9.80665, "m s^-2"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    def __init__(self, domain, grid_type: str = "numerical", height_on_interface_levels: bool = True,
                 **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.stgz = height_on_interface_levels

    @property
    def input_properties(self):
        props = {"air_temperature": {"dims": DIMS, "units": "K"}}
        if self.stgz:
            props["height_on_interface_levels"] = {"dims": DIMS_Z, "units": "m"}
        else:
            props["height"] = {"dims": DIMS, "units": "m"}
        return props

    @property
    def diagnostic_properties(self):
        return {"montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"}}

    def array_call(self, state):
        g = self.rpc["gravitational_acceleration"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        if self.stgz:
            h_if = state["height_on_interface_levels"]
            h = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        else:
            h = state["height"]
        return {"montgomery_potential": cp * state["air_temperature"] + g * h}


class MoistStaticEnergy(DiagnosticComponent):
    """mse = dse + Lv·qv, the dry static energy read from
    ``montgomery_potential``."""

    default_physical_constants = {
        "latent_heat_of_vaporization_of_water": (2.5e6, "J kg^-1"),
    }

    @property
    def input_properties(self):
        return {
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "mass_fraction_of_water_vapor_in_air": {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {"moist_static_energy": {"dims": DIMS, "units": "m^2 s^-2"}}

    def array_call(self, state):
        lhv = self.rpc["latent_heat_of_vaporization_of_water"]
        return {"moist_static_energy": state["montgomery_potential"]
                + lhv * state["mass_fraction_of_water_vapor_in_air"]}
