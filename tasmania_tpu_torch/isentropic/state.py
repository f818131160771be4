"""Balanced initial state of the isentropic model (counterpart of
``tasmania_tpu/isentropic/state.py``).

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
