"""Clipping, precipitation and sedimentation fluxes (counterpart of
``tasmania_tpu/physics/microphysics/utils.py``: ``Clipping``,
``Precipitation`` and the first- and second-order upwind
``SedimentationFlux``)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tasmania_tpu_torch.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
)
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


class Clipping(DiagnosticComponent):
    """The water species clipped to q >= 0."""

    def __init__(self, domain, grid_type: str = "numerical",
                 water_species_names: Optional[Sequence[str]] = None, **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.names = tuple(water_species_names or (mfwv, mfcw, mfpw))

    @property
    def input_properties(self):
        return {name: {"dims": DIMS, "units": "g g^-1"} for name in self.names}

    @property
    def diagnostic_properties(self):
        return self.input_properties

    def array_call(self, state):
        return {name: torch.where(state[name] > 0.0, state[name], torch.zeros_like(state[name]))
                for name in self.names}


class Precipitation(ImplicitTendencyComponent):
    """Surface precipitation rate and accumulated precipitation from the
    sedimentation flux at the surface, the last main level; both (nx, ny, 1)."""

    default_physical_constants = {"density_of_liquid_water": (1000.0, "kg m^-3")}

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
            "raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"},
            "accumulated_precipitation": {"dims": DIMS, "units": "mm"},
        }

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        return {
            "precipitation": {"dims": DIMS, "units": "mm hr^-1"},
            "accumulated_precipitation": {"dims": DIMS, "units": "mm"},
        }

    def array_call(self, state, timestep: float):
        rhow = self.rpc["density_of_liquid_water"]
        rho_s = state["air_density"][:, :, -1:]
        qr_s = state[mfpw][:, :, -1:]
        vt_s = state["raindrop_fall_velocity"][:, :, -1:]
        prec = 3.6e6 * rho_s * qr_s * vt_s / rhow  # [mm hr^-1]
        acc = state["accumulated_precipitation"] + timestep * prec / 3.6e3
        return {}, {"precipitation": prec, "accumulated_precipitation": acc}


class SedimentationFlux:
    """The vertical derivative of the sedimentation flux, on levels [nb, nz).
    Factory base: ``SedimentationFlux.factory("first_order_upwind")``."""

    registry = {}
    nb = 1

    @staticmethod
    def factory(flux_type: str, backend: str = DEFAULT_BACKEND) -> "SedimentationFlux":
        return factorize(flux_type, SedimentationFlux, ())

    def __call__(self, rho, h, q, vt):
        raise NotImplementedError


@factor_register("first_order_upwind")
class FirstOrderUpwind(SedimentationFlux):
    nb = 1

    def __call__(self, rho, h, q, vt):
        return (
            rho[:, :, :-1] * q[:, :, :-1] * vt[:, :, :-1] - rho[:, :, 1:] * q[:, :, 1:] * vt[:, :, 1:]
        ) / (h[:, :, :-1] - h[:, :, 1:])


@factor_register("second_order_upwind")
class SecondOrderUpwind(SedimentationFlux):
    nb = 2

    def __call__(self, rho, h, q, vt):
        a = (2.0 * h[:, :, 2:] - h[:, :, 1:-1] - h[:, :, :-2]) / (
            (h[:, :, 1:-1] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 2:])
        )
        b = (h[:, :, :-2] - h[:, :, 2:]) / (
            (h[:, :, 1:-1] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 1:-1])
        )
        c = (h[:, :, 2:] - h[:, :, 1:-1]) / (
            (h[:, :, :-2] - h[:, :, 2:]) * (h[:, :, :-2] - h[:, :, 1:-1])
        )
        return (
            a * rho[:, :, 2:] * q[:, :, 2:] * vt[:, :, 2:]
            + b * rho[:, :, 1:-1] * q[:, :, 1:-1] * vt[:, :, 1:-1]
            + c * rho[:, :, :-2] * q[:, :, :-2] * vt[:, :, :-2]
        )

