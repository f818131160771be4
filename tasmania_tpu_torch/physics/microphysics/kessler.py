"""Kessler warm-rain microphysics (counterpart of
``tasmania_tpu/physics/microphysics/kessler.py``):

* ``KesslerMicrophysics``: autoconversion, accretion and rain evaporation,
  with its θ-tendency;
* ``KesslerSaturationAdjustmentPrognostic``: relaxed adjustment at
  ``saturation_rate``;
* ``KesslerSaturationAdjustmentDiagnostic``: the adjustment in one go, the
  adjusted state as diagnostics (stepped by ``"rk2sa"``);
* ``KesslerFallVelocity``: raindrop fall speed;
* ``KesslerSedimentation``: the qr tendency of the sedimentation flux.

Under RK3WS the chain ``[KesslerFallVelocity, KesslerSedimentation]`` runs as
one operation (``ops/sedimentation_step``; the kernel on the card), with the
fall velocity evaluated at every stage (``vt_mode="stage"``) or at stage 1
only (``"step"``).  With the merge ``"vadv_sed"`` (``SequentialUpdateSplitting(...,
merges=...)``) the vertical advection before it and its RK3WS step run as
one operation, ``fused_vadv_sedimentation_rk3ws``.
"""

from __future__ import annotations

import numpy as np
import torch

from tasmania_tpu_torch.framework.concurrent_coupling import register_chain_fuser
from tasmania_tpu_torch.framework.core_components import (
    DiagnosticComponent,
    ImplicitTendencyComponent,
    TendencyComponent,
)
from tasmania_tpu_torch.framework.field import FieldArray, ensure_timedelta_seconds, get_array_dict
from tasmania_tpu_torch.framework.splitting import register_process_pair_fuser
from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
from tasmania_tpu_torch.ops.kessler_step import tetens
from tasmania_tpu_torch.ops.sedimentation_step import VT_MODES, fused_sedimentation_rk3ws
from tasmania_tpu_torch.ops.vertical_advection_step import fused_vadv_sedimentation_rk3ws
from tasmania_tpu_torch.physics.microphysics.utils import SedimentationFlux
from tasmania_tpu_torch.utils.units import conversion_factor

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")


def coefficient(value, units: str, default: float) -> float:
    """A namelist coefficient (a ``FieldArray``, a number or None) in ``units``."""
    if isinstance(value, FieldArray):
        return float(np.asarray(value.data)) * conversion_factor(value.units, units)
    return float(value) if value is not None else default


class _KesslerBase(TendencyComponent):
    """Pressure and Exner function on the main levels are the means of their
    interface values."""

    default_physical_constants = {
        "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
        "gas_constant_of_water_vapor": (461.52, "J K^-1 kg^-1"),
        "latent_heat_of_vaporization_of_water": (2.5e6, "J kg^-1"),
        "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
    }

    @staticmethod
    def p_exn(state):
        p_if = state["air_pressure_on_interface_levels"]
        exn_if = state["exner_function_on_interface_levels"]
        return 0.5 * (p_if[:, :, :-1] + p_if[:, :, 1:]), 0.5 * (exn_if[:, :, :-1] + exn_if[:, :, 1:])

    @staticmethod
    def with_pressure(props):
        props["air_pressure_on_interface_levels"] = {"dims": DIMS_Z, "units": "Pa"}
        props["exner_function_on_interface_levels"] = {"dims": DIMS_Z, "units": "J K^-1 kg^-1"}
        return props

    def saturation_mixing_ratio(self, t, p):
        beta = self.rpc["gas_constant_of_dry_air"] / self.rpc["gas_constant_of_water_vapor"]
        return beta * tetens(t) / p


class KesslerMicrophysics(_KesslerBase):
    """Autoconversion, accretion and rain evaporation, with the θ-tendency
    of the evaporation as a tendency."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        autoconversion_threshold=None,
        autoconversion_rate=None,
        collection_rate=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.a = coefficient(autoconversion_threshold, "g g^-1", 0.001)
        self.k1 = coefficient(autoconversion_rate, "s^-1", 0.001)
        self.k2 = coefficient(collection_rate, "s^-1", 2.2)

    @property
    def input_properties(self):
        return self.with_pressure({
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        })

    @property
    def tendency_properties(self):
        return {
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfwv: {"dims": DIMS, "units": "g g^-1 s^-1"},
            "air_potential_temperature": {"dims": DIMS, "units": "K s^-1"},
        }

    def array_call(self, state):
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        rho, t = state["air_density"], state["air_temperature"]
        qv, qc, qr = state[mfwv], state[mfcw], state[mfpw]
        p, exn = self.p_exn(state)
        qvs = self.saturation_mixing_ratio(t, p)
        zero = torch.zeros((), dtype=qc.dtype, device=qc.device)
        ar = self.k1 * torch.where(qc > self.a, qc - self.a, zero)
        cr = self.k2 * qc * torch.where(qr > 0.0, qr**0.875, zero)
        er = torch.where(qr > 0.0, 0.0484794 * (qvs - qv) * (rho * qr) ** (13.0 / 20.0), zero)
        return {
            mfcw: -(ar + cr),
            mfpw: ar + cr - er,
            mfwv: er,
            "air_potential_temperature": -lhvw / exn * er,
        }, {}


class KesslerSaturationAdjustmentPrognostic(_KesslerBase):
    """Relaxed saturation adjustment with rate ``saturation_rate``."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        saturation_rate=None,
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.sr = coefficient(saturation_rate, "s^-1", 0.5)

    @property
    def input_properties(self):
        return self.with_pressure({
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
        })

    @property
    def tendency_properties(self):
        return {
            mfwv: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            "air_potential_temperature": {"dims": DIMS, "units": "K s^-1"},
        }

    def array_call(self, state):
        rv = self.rpc["gas_constant_of_water_vapor"]
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        t, qv, qc = state["air_temperature"], state[mfwv], state[mfcw]
        p, exn = self.p_exn(state)
        qvs = self.saturation_mixing_ratio(t, p)
        sat = (qvs - qv) / (1.0 + qvs * lhvw**2 / (cp * rv * t**2))
        dq = torch.where(sat <= qc, sat, qc)
        return {
            mfwv: self.sr * dq,
            mfcw: -self.sr * dq,
            "air_potential_temperature": -self.sr * (lhvw / exn) * dq,
        }, {}


class KesslerSaturationAdjustmentDiagnostic(_KesslerBase):
    """Saturation adjustment in one go: the adjusted qv, qc and temperature
    as diagnostics, the θ-tendency of the latent heat over the timestep as a
    tendency (1 s when called without one, as in the JAX package).  Its
    stepper is ``"rk2sa"``, which returns the adjusted state of its second
    stage."""

    @property
    def input_properties(self):
        return self.with_pressure({
            "air_temperature": {"dims": DIMS, "units": "K"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
        })

    @property
    def tendency_properties(self):
        return {"air_potential_temperature": {"dims": DIMS, "units": "K s^-1"}}

    @property
    def diagnostic_properties(self):
        return {
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            "air_temperature": {"dims": DIMS, "units": "K"},
        }

    def _raw_call(self, raw, timestep):
        return self.array_call(raw, ensure_timedelta_seconds(timestep) if timestep is not None else 1.0)

    def array_call(self, state, timestep: float):
        rv = self.rpc["gas_constant_of_water_vapor"]
        lhvw = self.rpc["latent_heat_of_vaporization_of_water"]
        cp = self.rpc["specific_heat_of_dry_air_at_constant_pressure"]
        t, qv, qc = state["air_temperature"], state[mfwv], state[mfcw]
        p, exn = self.p_exn(state)
        qvs = self.saturation_mixing_ratio(t, p)
        sat = (qvs - qv) / (1.0 + qvs * lhvw**2 / (cp * rv * t**2))
        dq = torch.where(sat <= qc, sat, qc)
        return {"air_potential_temperature": (lhvw / exn) * (-dq / timestep)}, {
            mfwv: qv + dq,
            mfcw: qc - dq,
            "air_temperature": t - dq * lhvw / cp,
        }


class KesslerFallVelocity(DiagnosticComponent):
    """vt = 36.34·(1e-3·ρ·max(qr, 0))^0.1346·(ρ_s/ρ)^0.5, ρ_s the surface
    (last-level) density."""

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def diagnostic_properties(self):
        return {"raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"}}

    def array_call(self, state):
        rho, qr = state["air_density"], state[mfpw]
        zero = torch.zeros((), dtype=qr.dtype, device=qr.device)
        vt = (
            36.34
            * (1.0e-3 * rho * torch.where(qr > 0.0, qr, zero)) ** 0.1346
            * (rho[:, :, -1:] / rho) ** 0.5
        )
        return {"raindrop_fall_velocity": vt}


class KesslerSedimentation(ImplicitTendencyComponent):
    """The qr tendency of the sedimentation flux.  ``vt_mode`` steers the
    fused RK3WS chain only."""

    def __init__(
        self,
        domain,
        grid_type: str = "numerical",
        sedimentation_flux_scheme: str = "first_order_upwind",
        vt_mode: str = "stage",
        **kwargs,
    ) -> None:
        super().__init__(domain, grid_type, **kwargs)
        if vt_mode not in VT_MODES:
            raise ValueError(f"vt_mode must be one of {VT_MODES}, got {vt_mode!r}")
        self.sflux = SedimentationFlux.factory(sedimentation_flux_scheme, self.backend)
        self.vt_mode = vt_mode

    @property
    def input_properties(self):
        return {
            "air_density": {"dims": DIMS, "units": "kg m^-3"},
            "height_on_interface_levels": {"dims": DIMS_Z, "units": "m"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
            "raindrop_fall_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def tendency_properties(self):
        return {mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"}}

    def array_call(self, state, timestep: float):
        rho = state["air_density"]
        h_if = state["height_on_interface_levels"]
        h = 0.5 * (h_if[:, :, :-1] + h_if[:, :, 1:])
        qr = state[mfpw]
        nb = self.sflux.nb
        dfdz = self.sflux(rho, h, qr, state["raindrop_fall_velocity"])
        tnd = torch.zeros_like(qr)
        tnd[:, :, nb:] = dfdz / rho[:, :, nb:]
        return {mfpw: tnd}, {}


def _sedimentation_chain_matches(components, scheme) -> bool:
    return (
        scheme == "rk3ws"
        and len(components) == 2
        and isinstance(components[0], KesslerFallVelocity)
        and isinstance(components[1], KesslerSedimentation)
    )


def _sedimentation_chain_fuser(components, state, dt, output_properties):
    """The whole RK3WS step of fall velocity + sedimentation in one operation."""
    fv, sed = components
    props = dict(fv.input_properties)
    props.update(sed.input_properties)
    props.pop("raindrop_fall_velocity")  # made inside the step
    raw = get_array_dict(state, props)
    qr, vt1 = fused_sedimentation_rk3ws(
        raw["air_density"], raw["height_on_interface_levels"], raw[mfpw],
        order=sed.sflux.nb, dt=float(dt), vt_mode=sed.vt_mode,
    )
    return (
        {"raindrop_fall_velocity": FieldArray(vt1, "m s^-1", DIMS)},
        {mfpw: FieldArray(qr, output_properties[mfpw]["units"], DIMS)},
    )


register_chain_fuser(_sedimentation_chain_matches, _sedimentation_chain_fuser)


# the SUS process pair [IsentropicVerticalAdvection(rk3ws) -> [fall velocity,
# sedimentation](rk3ws)] as one operation, the merge "vadv_sed" (counterpart of
# tasmania_tpu/physics/microphysics/kessler.py:458-550)


def _vadv_sed_pair_matches(stepper_a, stepper_b) -> bool:
    if getattr(stepper_a, "name", "") != "rk3ws" or getattr(stepper_b, "name", "") != "rk3ws":
        return False
    if stepper_a.enforce_hb or stepper_b.enforce_hb:
        return False
    comps_a = stepper_a.coupling.components
    return (
        len(comps_a) == 1
        and isinstance(comps_a[0], IsentropicVerticalAdvection)
        and _sedimentation_chain_matches(tuple(stepper_b.coupling.components), "rk3ws")
    )


def _vadv_sed_pair_fuser(stepper_a, stepper_b, state, td):
    """Advect the six fields and sediment the advected rain in one operation
    (``fused_vadv_sedimentation_rk3ws``), with the density and interface
    heights of the state before the pair, which the pair does not change."""
    va = stepper_a.coupling.components[0]
    _, sed = stepper_b.coupling.components
    raw = get_array_dict(state, va.input_properties)
    raw_b = get_array_dict(state, {k: sed.input_properties[k]
                                   for k in ("air_density", "height_on_interface_levels")})
    names = va.fields
    outs = fused_vadv_sedimentation_rk3ws(
        raw["tendency_of_air_potential_temperature"], *(raw[n] for n in names),
        raw_b["air_density"], raw_b["height_on_interface_levels"],
        vorder=va.vflux.order, sorder=sed.sflux.nb, dt=td.total_seconds(), dz=va.dz,
        vt_mode=sed.vt_mode,
    )
    units = {**stepper_a.output_properties, mfpw: stepper_b.output_properties[mfpw]}
    stepped = {n: FieldArray(a, units[n]["units"], DIMS) for n, a in zip(names, outs)}
    return {"raindrop_fall_velocity": FieldArray(outs[6], "m s^-1", DIMS)}, stepped


register_process_pair_fuser(_vadv_sed_pair_matches, _vadv_sed_pair_fuser, "vadv_sed")
