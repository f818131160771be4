"""Meteorological formulas the slice needs (counterpart of
``tasmania_tpu/utils/meteo.py``): Tetens saturation vapor pressure and the
RH -> water-vapor conversion of the initial state.  Host-side numpy, like the
initial-state construction that calls it."""

from __future__ import annotations

import numpy as np


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
