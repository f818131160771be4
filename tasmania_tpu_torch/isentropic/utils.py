"""θ-tendency promoters of the isentropic model, the Kessler and
saturation-adjustment chain fusers and their process-pair fuser (counterpart
of ``tasmania_tpu/isentropic/utils.py``).

In the moist chain, Kessler microphysics runs as ``[KesslerMicrophysics,
θ-to-diagnostic]`` under RK2 and saturation adjustment as ``[θ-to-tendency,
KesslerSaturationAdjustmentPrognostic, θ-to-diagnostic]`` under RK2.  Each
chain's RK2 step is one operation, ``ops/kessler_step.fused_kessler_rk2`` or
``fused_satadj_rk2`` (kernels on the card).  When a sequential splitting has
the two processes adjacent, it runs both as one operation first,
``fused_kessler_satadj_rk2``: the intermediate species and the Kessler
θ-tendency never reach device memory.
"""

from __future__ import annotations

import dataclasses

from tasmania_tpu_torch.framework.concurrent_coupling import register_chain_fuser
from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict
from tasmania_tpu_torch.framework.promoter import FromDiagnosticToTendency, FromTendencyToDiagnostic
from tasmania_tpu_torch.framework.splitting import register_process_pair_fuser
from tasmania_tpu_torch.ops.kessler_step import (
    KesslerConstants,
    fused_kessler_rk2,
    fused_kessler_satadj_rk2,
    fused_satadj_rk2,
)
from tasmania_tpu_torch.physics.microphysics.kessler import (
    KesslerMicrophysics,
    KesslerSaturationAdjustmentPrognostic,
)

DIMS = ("x", "y", "z")
mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"
TTD = "tendency_of_air_potential_temperature"


class AirPotentialTemperatureToDiagnostic(FromTendencyToDiagnostic):
    """The θ-tendency as the state diagnostic ``tendency_of_air_potential_temperature``."""

    @property
    def input_tendency_properties(self):
        return {"air_potential_temperature": {"dims": DIMS, "units": "K s^-1", "diagnostic_name": TTD}}


class AirPotentialTemperatureToTendency(FromDiagnosticToTendency):
    """The diagnostic ``tendency_of_air_potential_temperature`` back as a
    tendency of ``air_potential_temperature``."""

    @property
    def input_properties(self):
        return {TTD: {"dims": DIMS, "units": "K s^-1", "tendency_name": "air_potential_temperature"}}


def _kessler_chain_matches(components, scheme) -> bool:
    return (
        scheme == "rk2"
        and len(components) == 2
        and isinstance(components[0], KesslerMicrophysics)
        and isinstance(components[1], AirPotentialTemperatureToDiagnostic)
    )


def _satadj_chain_matches(components, scheme) -> bool:
    return (
        scheme == "rk2"
        and len(components) == 3
        and isinstance(components[0], AirPotentialTemperatureToTendency)
        and isinstance(components[1], KesslerSaturationAdjustmentPrognostic)
        and isinstance(components[2], AirPotentialTemperatureToDiagnostic)
    )


def _constants(component, dt: float, **coefficients) -> KesslerConstants:
    rv = component.rpc["gas_constant_of_water_vapor"]
    return KesslerConstants(
        beta=component.rpc["gas_constant_of_dry_air"] / rv,
        lhvw=component.rpc["latent_heat_of_vaporization_of_water"],
        cp=component.rpc["specific_heat_of_dry_air_at_constant_pressure"], rv=rv, dt=dt,
        **coefficients,
    )


def _kessler_chain_fuser(components, state, dt, output_properties):
    """The chain's RK2 step in one operation: (diagnostics, stepped)."""
    ke = components[0]
    raw = get_array_dict(state, ke.input_properties)
    qv, qc, qr, th = fused_kessler_rk2(
        raw["air_density"], raw["air_temperature"], raw["air_pressure_on_interface_levels"],
        raw["exner_function_on_interface_levels"], raw[mfwv], raw[mfcw], raw[mfpw],
        _constants(ke, float(dt), a=ke.a, k1=ke.k1, k2=ke.k2),
    )
    stepped = {n: FieldArray(a, output_properties[n]["units"], DIMS)
               for n, a in ((mfwv, qv), (mfcw, qc), (mfpw, qr))}
    return {TTD: FieldArray(th, "K s^-1", DIMS)}, stepped


def _satadj_chain_fuser(components, state, dt, output_properties):
    """The chain's RK2 step in one operation: (diagnostics, stepped)."""
    sa = components[1]
    props = dict(sa.input_properties)
    props[TTD] = {"dims": DIMS, "units": "K s^-1"}
    raw = get_array_dict(state, props)
    qv, qc, th = fused_satadj_rk2(
        raw["air_temperature"], raw["air_pressure_on_interface_levels"],
        raw["exner_function_on_interface_levels"], raw[mfwv], raw[mfcw], raw[TTD],
        _constants(sa, float(dt), sr=sa.sr),
    )
    stepped = {n: FieldArray(a, output_properties[n]["units"], DIMS) for n, a in ((mfwv, qv), (mfcw, qc))}
    return {TTD: FieldArray(th, "K s^-1", DIMS)}, stepped


def _kessler_satadj_pair_matches(stepper_a, stepper_b) -> bool:
    return (
        getattr(stepper_a, "name", "") == "rk2"
        and getattr(stepper_b, "name", "") == "rk2"
        and not stepper_a.enforce_hb
        and not stepper_b.enforce_hb
        and _kessler_chain_matches(tuple(stepper_a.coupling.components), "rk2")
        and _satadj_chain_matches(tuple(stepper_b.coupling.components), "rk2")
    )


def _kessler_satadj_pair_fuser(stepper_a, stepper_b, state, td):
    """Both RK2 processes in one operation: (diagnostics, stepped)."""
    ke = stepper_a.coupling.components[0]
    sa = stepper_b.coupling.components[1]
    raw = get_array_dict(state, ke.input_properties)
    c = dataclasses.replace(
        _constants(ke, td.total_seconds(), a=ke.a, k1=ke.k1, k2=ke.k2, sr=sa.sr),
        cp=sa.rpc["specific_heat_of_dry_air_at_constant_pressure"],
    )
    qv, qc, qr, th = fused_kessler_satadj_rk2(
        raw["air_density"], raw["air_temperature"], raw["air_pressure_on_interface_levels"],
        raw["exner_function_on_interface_levels"], raw[mfwv], raw[mfcw], raw[mfpw], c,
    )
    units = stepper_a.output_properties
    stepped = {n: FieldArray(a, units[n]["units"], DIMS) for n, a in ((mfwv, qv), (mfcw, qc), (mfpw, qr))}
    return {TTD: FieldArray(th, "K s^-1", DIMS)}, stepped


register_chain_fuser(_kessler_chain_matches, _kessler_chain_fuser)
register_chain_fuser(_satadj_chain_matches, _satadj_chain_fuser)
register_process_pair_fuser(_kessler_satadj_pair_matches, _kessler_satadj_pair_fuser)
