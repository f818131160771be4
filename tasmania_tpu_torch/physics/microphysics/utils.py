"""Precipitation and sedimentation fluxes (counterpart of
``tasmania_tpu/physics/microphysics/utils.py``, ``Precipitation`` and the
first- and second-order upwind ``SedimentationFlux``)."""

from __future__ import annotations

from tasmania_tpu_torch.framework.core_components import ImplicitTendencyComponent

mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


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
    """The vertical derivative of the sedimentation flux, on levels [nb, nz)."""

    nb = 1

    @staticmethod
    def factory(flux_type: str) -> "SedimentationFlux":
        if flux_type not in _FLUXES:
            raise ValueError(f"unknown sedimentation flux {flux_type!r} (have {sorted(_FLUXES)})")
        return _FLUXES[flux_type]()

    def __call__(self, rho, h, q, vt):
        raise NotImplementedError


class FirstOrderUpwind(SedimentationFlux):
    nb = 1

    def __call__(self, rho, h, q, vt):
        return (
            rho[:, :, :-1] * q[:, :, :-1] * vt[:, :, :-1] - rho[:, :, 1:] * q[:, :, 1:] * vt[:, :, 1:]
        ) / (h[:, :, :-1] - h[:, :, 1:])


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


_FLUXES = {"first_order_upwind": FirstOrderUpwind, "second_order_upwind": SecondOrderUpwind}
