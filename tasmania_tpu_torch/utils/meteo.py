"""Meteorological formulas (counterpart of ``tasmania_tpu/utils/meteo.py``):
Tetens saturation vapor pressure, the RH -> water-vapor conversion of the
initial state, and the isothermal analytic mountain-wave solution the
mountain-wave driver validates against.  Host-side numpy, like the
initial-state construction and the validation that call them."""

from __future__ import annotations

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.utils.constants import get_physical_constants


def tetens_formula(t):
    """Saturation vapor pressure over water [Pa]."""
    pw, aw, tr, bw = 610.78, 17.27, 273.16, 35.86
    return pw * np.exp(aw * (t - tr) / (t - bw))


def convert_relative_humidity_to_water_vapor(method: str, p, t, rh):
    """RH -> qv [g g^-1] on raw arrays in (Pa, K, 1)."""
    if method != "tetens":
        raise NotImplementedError(f"saturation formula {method!r} is not ported")
    p_sat = tetens_formula(t)
    pw = rh * p_sat
    B = 0.62198
    return np.where(p_sat >= 0.616 * p, 0.0, B * pw / (p - pw))


def get_isothermal_isentropic_analytical_solution(
    grid,
    x_velocity_initial,
    temperature,
    mountain_height,
    mountain_width,
    x_staggered: bool = True,
    z_staggered: bool = False,
    physical_constants=None,
):
    """Steady hydrostatic isothermal flow over a Witch-of-Agnesi mountain
    (Durran 1981), on a grid with ``ny == 1``.  The scalar arguments are
    ``FieldArray``s or floats in SI units; returns numpy (u, w) of shape
    (mi, 1, mk), on the u-points in x if ``x_staggered`` and on the
    interface levels in θ if ``z_staggered``."""
    if grid.ny != 1:
        raise ValueError("the analytic solution needs a grid with ny == 1")

    def val(x, units):
        if isinstance(x, FieldArray):
            return float(np.asarray(x.to_units(units).data))
        return float(x)

    u_bar = val(x_velocity_initial, "m s^-1")
    T = val(temperature, "K")
    h = val(mountain_height, "m")
    a = val(mountain_width, grid.x.units)

    pcs = get_physical_constants(
        {
            "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
            "gravitational_acceleration": (9.80665, "m s^-2"),
            "reference_air_pressure": (1e5, "Pa"),
            "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
        },
        physical_constants,
    )
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    p_ref = pcs["reference_air_pressure"]
    cp = pcs["specific_heat_of_dry_air_at_constant_pressure"]

    # Scorer parameter
    scpam = np.sqrt((g**2) / (cp * T * (u_bar**2)) - (g**2) / (4.0 * (Rd**2) * (T**2)))

    xv = np.asarray((grid.x_at_u_locations if x_staggered else grid.x).data)
    zv = np.asarray((grid.z_on_interface_levels if z_staggered else grid.z).to_units("K").data)
    x, theta = np.meshgrid(xv, zv, indexing="ij")

    zs = h * (a**2) / ((x**2) + (a**2))
    theta_s = float(np.asarray(grid.z_on_interface_levels.to_units("K").data)[-1])
    z = zs + cp * T / g * np.log(theta / theta_s)
    dz_dx = -2.0 * h * (a**2) * x / (((x**2) + (a**2)) ** 2)
    dz_dtheta = cp * T / (g * theta)

    p_bar = p_ref * (T / theta) ** (cp / Rd)
    rho_ref = p_ref / (Rd * T)
    rho_bar = p_bar / (Rd * T)
    drho_bar_dtheta = -cp * p_ref / ((Rd**2) * (T**2)) * ((T / theta) ** (cp / Rd + 1.0))

    d = (
        ((rho_bar / rho_ref) ** (-0.5))
        * h
        * a
        * (a * np.cos(scpam * z) - x * np.sin(scpam * z))
        / ((x**2) + (a**2))
    )
    dd_dx = (
        -((rho_bar / rho_ref) ** (-0.5))
        * h
        * a
        / (((x**2) + (a**2)) ** 2)
        * (
            ((a * np.sin(scpam * z) + x * np.cos(scpam * z)) * scpam * dz_dx + np.sin(scpam * z))
            * ((x**2) + (a**2))
            + 2.0 * x * (a * np.cos(scpam * z) - x * np.sin(scpam * z))
        )
    )
    dd_dtheta = 0.5 * cp / (Rd * T) * ((theta / T) ** (0.5 * cp / Rd - 1.0)) * h * a * (
        a * np.cos(scpam * z) - x * np.sin(scpam * z)
    ) / ((x**2) + (a**2)) - ((theta / T) ** (0.5 * cp / Rd)) * h * a * (
        a * np.sin(scpam * z) + x * np.cos(scpam * z)
    ) * scpam * dz_dtheta / ((x**2) + (a**2))
    dd_dz = dd_dtheta / dz_dtheta

    u = u_bar * (1.0 - drho_bar_dtheta * d / (dz_dtheta * rho_bar) - dd_dz)
    w = u_bar * dd_dx
    return u[:, np.newaxis, :], w[:, np.newaxis, :]
