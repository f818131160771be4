"""Balanced initial states of the isentropic model (counterpart of
``tasmania_tpu/isentropic/state.py``): from a uniform Brunt-Väisälä
frequency, or from a uniform temperature with an optional warm bubble.

The state is built host-side in numpy with the reference's exact
recurrences, then placed on the storage device as tensors."""

from __future__ import annotations

from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.interop import state_from_numpy
from tasmania_tpu_torch.utils.constants import get_physical_constants
from tasmania_tpu_torch.utils.meteo import convert_relative_humidity_to_water_vapor

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

_DEFAULTS = {
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
    "reference_air_pressure": (1.0e5, "Pa"),
    "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
}

def _scalar(value, units: str) -> float:
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units(units).data))
    return float(value)


def get_isentropic_state_from_brunt_vaisala_frequency(
    grid,
    time: datetime,
    x_velocity,
    y_velocity,
    brunt_vaisala,
    moist: bool = False,
    precipitation: bool = False,
    relative_humidity: float = 0.5,
    physical_constants=None,
    *,
    storage_options: Optional[StorageOptions] = None,
) -> Dict[str, Any]:
    """Balanced state from uniform (u, v, N)."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    so = storage_options or StorageOptions()
    dtype = so.np_dtype
    dz = float(np.asarray(grid.dz.to_units("K").data))
    hs = np.asarray(grid.topography.profile.to_units("m").data)
    bv = _scalar(brunt_vaisala, "s^-1")
    uval = _scalar(x_velocity, "m s^-1")
    vval = _scalar(y_velocity, "m s^-1")

    pcs = get_physical_constants(_DEFAULTS, physical_constants)
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    pref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    theta1d = np.asarray(grid.z.to_units("K").data)[np.newaxis, np.newaxis, :]
    theta_s = float(np.asarray(grid.z_on_interface_levels.to_units("K").data)[-1])

    u = np.full((nx + 1, ny, nz), uval, dtype=dtype)
    v = np.full((nx, ny + 1, nz), vval, dtype=dtype)

    # height of interface levels: h[nz] = hs; h[k] = h[k+1] + g dz/(N² θ[k])
    dh = g * dz / ((bv**2) * theta1d[0, 0, :])
    h = np.empty((nx, ny, nz + 1), dtype=dtype)
    h[:, :, nz] = hs
    h[:, :, :nz] = hs[:, :, np.newaxis] + np.cumsum(dh[::-1])[::-1][np.newaxis, np.newaxis, :]

    # Exner on interface levels: exn[nz] = cp; exn[k] = exn[k+1] - dz g²/(N² θ[k]²)
    dexn = dz * (g**2) / ((bv**2) * theta1d[0, 0, :] ** 2)
    exn = np.empty((nx, ny, nz + 1), dtype=dtype)
    exn[:, :, nz] = cp
    exn[:, :, :nz] = (cp - np.cumsum(dexn[::-1])[::-1])[np.newaxis, np.newaxis, :]

    p = pref * (exn / cp) ** (cp / Rd)
    mtg_s = g * h[:, :, nz] + theta_s * exn[:, :, nz]
    mtg = np.empty((nx, ny, nz), dtype=dtype)
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]

    s = -(p[:, :, :nz] - p[:, :, 1 : nz + 1]) / (g * dz)
    su = 0.5 * s * (u[:nx] + u[1 : nx + 1])
    sv = 0.5 * s * (v[:, :ny] + v[:, 1 : ny + 1])

    arrays = {
        "air_isentropic_density": (s, "kg m^-2 K^-1"),
        "air_pressure_on_interface_levels": (p, "Pa"),
        "exner_function_on_interface_levels": (exn, "J K^-1 kg^-1"),
        "height_on_interface_levels": (h, "m"),
        "montgomery_potential": (mtg, "m^2 s^-2"),
        "x_momentum_isentropic": (su, "kg m^-1 K^-1 s^-1"),
        "x_velocity_at_u_locations": (u, "m s^-1"),
        "y_momentum_isentropic": (sv, "kg m^-1 K^-1 s^-1"),
        "y_velocity_at_v_locations": (v, "m s^-1"),
    }
    if moist:
        rho = s * dz / (h[:, :, :nz] - h[:, :, 1 : nz + 1])
        temp = 0.5 * (exn[:, :, :nz] + exn[:, :, 1 : nz + 1]) * theta1d / cp
        arrays["air_density"] = (rho, "kg m^-3")
        arrays["air_temperature"] = (temp, "K")
        p_unstg = 0.5 * (p[:, :, :nz] + p[:, :, 1 : nz + 1])
        qv = convert_relative_humidity_to_water_vapor(
            "tetens", p_unstg, np.asarray(temp), np.full_like(s, relative_humidity)
        )
        arrays[mfwv] = (qv.astype(dtype), "g g^-1")
        arrays[mfcw] = (np.zeros_like(s), "g g^-1")
        arrays[mfpw] = (np.zeros_like(s), "g g^-1")
        if precipitation:
            arrays["precipitation"] = (np.zeros((nx, ny, 1), dtype=dtype), "mm hr^-1")
            arrays["accumulated_precipitation"] = (np.zeros((nx, ny, 1), dtype=dtype), "mm")

    state = state_from_numpy(arrays, device=so.device, dtype=so.dtype)
    state["time"] = time
    return state


def get_isentropic_state_from_temperature(
    grid,
    time: datetime,
    x_velocity,
    y_velocity,
    background_temperature,
    bubble_center_x=None,
    bubble_center_y=None,
    bubble_center_height=None,
    bubble_radius=None,
    bubble_maximum_perturbation=None,
    moist: bool = False,
    precipitation: bool = False,
    relative_humidity: float = 0.5,
    physical_constants=None,
    *,
    storage_options: Optional[StorageOptions] = None,
) -> Dict[str, Any]:
    """Balanced state from a uniform background temperature, optionally with
    a warm bubble: exn = cp·T/θ on each isentrope, the heights by hydrostatic
    integration from the ground, the rest as the N²-based factory."""
    nx, ny, nz = grid.nx, grid.ny, grid.nz
    so = storage_options or StorageOptions()
    dtype = so.np_dtype
    dz = float(np.asarray(grid.dz.to_units("K").data))
    hs = np.asarray(grid.topography.profile.to_units("m").data)
    uval = _scalar(x_velocity, "m s^-1")
    vval = _scalar(y_velocity, "m s^-1")
    temp0 = _scalar(background_temperature, "K")

    pcs = get_physical_constants(_DEFAULTS, physical_constants)
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    pref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    theta_hl = np.asarray(grid.z_on_interface_levels.to_units("K").data)  # (nz+1,)
    theta_s = float(theta_hl[-1])

    # the temperature: the uniform background plus the optional bubble
    t_hl = np.full((nx, ny, nz + 1), temp0, dtype=dtype)
    if bubble_maximum_perturbation is not None:
        cx = _scalar(bubble_center_x, "m") if bubble_center_x is not None else 0.0
        cy = _scalar(bubble_center_y, "m") if bubble_center_y is not None else 0.0
        ch = _scalar(bubble_center_height, "m") if bubble_center_height is not None else 0.0
        r = _scalar(bubble_radius, "m") if bubble_radius is not None else 1.0
        dt_max = _scalar(bubble_maximum_perturbation, "K")
        xv = np.asarray(grid.x.to_units("m").data)[:, None, None]
        yv = np.asarray(grid.y.to_units("m").data)[None, :, None]
        # the isothermal profile's heights
        zv = (-Rd * temp0 / g * np.log(theta_hl / theta_s))[None, None, :]
        dist = np.sqrt(((xv - cx) / r) ** 2 + ((yv - cy) / r) ** 2 + ((zv - ch) / r) ** 2)
        t_hl = t_hl + dt_max * np.where(dist < 1.0, np.cos(0.5 * np.pi * dist) ** 2, 0.0)

    exn = cp * t_hl / theta_hl[np.newaxis, np.newaxis, :]
    p = pref * (exn / cp) ** (cp / Rd)

    # the heights by hydrostatic integration from the ground
    h = np.empty((nx, ny, nz + 1), dtype=dtype)
    h[:, :, nz] = hs
    for k in range(nz - 1, -1, -1):
        h[:, :, k] = h[:, :, k + 1] - Rd * (
            theta_hl[k] * exn[:, :, k] + theta_hl[k + 1] * exn[:, :, k + 1]
        ) * (p[:, :, k] - p[:, :, k + 1]) / (cp * g * (p[:, :, k] + p[:, :, k + 1]))

    mtg_s = g * h[:, :, nz] + theta_s * exn[:, :, nz]
    mtg = np.empty((nx, ny, nz), dtype=dtype)
    mtg[:, :, nz - 1] = mtg_s + 0.5 * dz * exn[:, :, nz]
    for k in range(nz - 2, -1, -1):
        mtg[:, :, k] = mtg[:, :, k + 1] + dz * exn[:, :, k + 1]

    s = -(p[:, :, :nz] - p[:, :, 1 : nz + 1]) / (g * dz)
    u = np.full((nx + 1, ny, nz), uval, dtype=dtype)
    v = np.full((nx, ny + 1, nz), vval, dtype=dtype)
    su = 0.5 * s * (u[:nx] + u[1 : nx + 1])
    sv = 0.5 * s * (v[:, :ny] + v[:, 1 : ny + 1])

    arrays = {
        "air_isentropic_density": (s, "kg m^-2 K^-1"),
        "air_pressure_on_interface_levels": (p.astype(dtype), "Pa"),
        "exner_function_on_interface_levels": (exn.astype(dtype), "J K^-1 kg^-1"),
        "height_on_interface_levels": (h, "m"),
        "montgomery_potential": (mtg, "m^2 s^-2"),
        "x_momentum_isentropic": (su, "kg m^-1 K^-1 s^-1"),
        "x_velocity_at_u_locations": (u, "m s^-1"),
        "y_momentum_isentropic": (sv, "kg m^-1 K^-1 s^-1"),
        "y_velocity_at_v_locations": (v, "m s^-1"),
    }
    if moist:
        temp = 0.5 * (t_hl[:, :, :nz] + t_hl[:, :, 1 : nz + 1])
        arrays["air_density"] = (s * dz / (h[:, :, :nz] - h[:, :, 1 : nz + 1]), "kg m^-3")
        arrays["air_temperature"] = (temp, "K")
        p_unstg = 0.5 * (p[:, :, :nz] + p[:, :, 1 : nz + 1])
        qv = convert_relative_humidity_to_water_vapor(
            "tetens", p_unstg, temp, np.full_like(s, relative_humidity)
        )
        arrays[mfwv] = (qv.astype(dtype), "g g^-1")
        arrays[mfcw] = (np.zeros_like(s), "g g^-1")
        arrays[mfpw] = (np.zeros_like(s), "g g^-1")
        if precipitation:
            arrays["precipitation"] = (np.zeros((nx, ny, 1), dtype=dtype), "mm hr^-1")
            arrays["accumulated_precipitation"] = (np.zeros((nx, ny, 1), dtype=dtype), "mm")

    state = state_from_numpy(arrays, device=so.device, dtype=so.dtype)
    state["time"] = time
    return state
