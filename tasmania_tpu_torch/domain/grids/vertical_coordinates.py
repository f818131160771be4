"""Terrain-following vertical-coordinate grids with their metric terms
(counterpart of ``tasmania_tpu/domain/grids/vertical_coordinates.py``):

* ``Sigma3d``: the pressure-based hybrid σ = p/p_SL coordinate; geometric
  height and reference pressure from a logarithmic reference profile;
* ``GalChen3d``: the height-based Gal-Chen and Somerville coordinate, the
  terrain decaying linearly below z_F;
* ``SLEVE3d``: the height-based SLEVE coordinate (Schär et al. 2002), the
  terrain split into a smooth and a residual part with their own sinh decay
  scales.

The metric terms are computed on the host with numpy, as in the JAX package,
and kept as tensors of the storage options' type on their device (height,
reference pressure, on the levels and their interfaces);
``update_topography`` recomputes them.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tasmania_tpu_torch.domain.grid import PhysicalGrid
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.constants import get_physical_constants

_D_CONSTANTS = {
    "air_pressure_at_sea_level": (1e5, "Pa"),
    "air_temperature_at_sea_level": (288.15, "K"),
    "beta": (42.0, "K Pa^-1"),
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
}
DIMS3 = ("x", "y", "z")
DIMS3_HL = ("x", "y", "z_on_interface_levels")


def _ref_pressure_from_height(z_hl, pcs):
    """The reference pressure at geometric height ``z_hl`` of the
    logarithmic profile."""
    p_sl = pcs["air_pressure_at_sea_level"]
    T_sl = pcs["air_temperature_at_sea_level"]
    beta = pcs["beta"]
    Rd = pcs["gas_constant_of_dry_air"]
    g = pcs["gravitational_acceleration"]
    if beta == 0.0:
        return p_sl * np.exp(-g * z_hl / (Rd * T_sl))
    return p_sl * np.exp(
        -T_sl / beta * (1.0 - np.sqrt(1.0 - 2.0 * beta * g * z_hl / (Rd * T_sl**2)))
    )


class _MetricGrid(PhysicalGrid):
    """The physical constants, and the metric terms refreshed with the
    topography."""

    def __init__(self, *args, physical_constants=None, storage_options: Optional[StorageOptions] = None,
                 **kwargs):
        self.storage_options = storage_options or StorageOptions()
        super().__init__(*args, storage_options=self.storage_options, **kwargs)
        self._physical_constants = get_physical_constants(_D_CONSTANTS, physical_constants)
        self.height = None
        self.height_on_interface_levels = None
        self.reference_pressure = None
        self.reference_pressure_on_interface_levels = None
        self._update_metric_terms()

    @property
    def topography_height(self) -> np.ndarray:
        return np.asarray(self.topography.profile.to_units("m").data)

    def update_topography(self, time) -> None:
        super().update_topography(time)
        self._update_metric_terms()

    def _field(self, values: np.ndarray, units: str, dims) -> FieldArray:
        so = self.storage_options
        return FieldArray(torch.as_tensor(values, dtype=so.dtype, device=so.device), units, dims)

    def _wrap(self, z_hl: np.ndarray, p0_hl: np.ndarray) -> None:
        """Keep the heights and reference pressures at the interfaces and
        their means on the levels."""
        self.height_on_interface_levels = self._field(z_hl, "m", DIMS3_HL)
        self.height = self._field(0.5 * (z_hl[:, :, :-1] + z_hl[:, :, 1:]), "m", DIMS3)
        self.reference_pressure_on_interface_levels = self._field(p0_hl, "Pa", DIMS3_HL)
        self.reference_pressure = self._field(0.5 * (p0_hl[:, :, :-1] + p0_hl[:, :, 1:]), "Pa", DIMS3)

    def _levels(self):
        """The surface height on every interface, the interfaces' coordinate
        (1, 1, nz + 1) and z_F."""
        hs = np.repeat(self.topography_height[:, :, None], self.nz + 1, axis=2)
        zv = np.asarray(self.z_on_interface_levels.data)[None, None, :]
        return hs, zv, float(np.asarray(self.z_interface.data))

    def _update_metric_terms(self) -> None:
        raise NotImplementedError


class Sigma3d(_MetricGrid):
    """The σ = p/p_SL pressure-based coordinate."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # σ must be positive, 1 at the surface, decreasing with height
        zv = np.asarray(self.z_on_interface_levels.data)
        assert zv[0] < zv[-1] and zv[0] >= 0.0 and abs(zv[-1] - 1.0) < 1e-12, (
            "sigma coordinate must increase from top to 1 at the surface"
        )

    def _update_metric_terms(self) -> None:
        """The hybrid σ's reference pressure at the interfaces, then the
        geometric height from the logarithmic profile."""
        pcs = self._physical_constants
        p_sl = pcs["air_pressure_at_sea_level"]
        T_sl = pcs["air_temperature_at_sea_level"]
        beta = pcs["beta"]
        Rd = pcs["gas_constant_of_dry_air"]
        g = pcs["gravitational_acceleration"]
        hs, zv, zf = self._levels()
        zt = zv[0, 0, 0]

        # the reference pressure at the terrain surface
        if beta == 0.0:
            p0_s = p_sl * np.exp(-g * hs / (Rd * T_sl))
        else:
            p0_s = p_sl * np.exp(
                -T_sl / beta * (1.0 - np.sqrt(1.0 - 2.0 * beta * g * hs / (Rd * T_sl**2)))
            )

        # the hybrid blend: flat above z_F, terrain-following below
        flat = (zt <= zv) & (zv <= zf)
        tf = (zf < zv) & (zv <= 1.0)
        a = p_sl * zv * flat + p_sl * zf * (1.0 - zv) / (1.0 - zf) * tf
        a = np.broadcast_to(a, (self.nx, self.ny, self.nz + 1)).copy()
        b = np.broadcast_to((zv - zf) / (1.0 - zf) * tf, a.shape)
        p0_hl = a + b * p0_s

        if beta == 0.0:
            z_hl = Rd * T_sl / g * np.log(p_sl / p0_hl)
        else:
            z_hl = Rd / g * np.log(p_sl / p0_hl) * (T_sl - 0.5 * beta * np.log(p_sl / p0_hl))
        self._wrap(z_hl, p0_hl)


class GalChen3d(_MetricGrid):
    """The Gal-Chen and Somerville height-based coordinate, the terrain
    decaying linearly below z_F."""

    def _update_metric_terms(self) -> None:
        hs, zv, zf = self._levels()
        a = np.broadcast_to(zv, (self.nx, self.ny, self.nz + 1))
        b = np.broadcast_to((zf - zv) / zf * ((0.0 <= zv) & (zv < zf)), a.shape)
        z_hl = np.asarray(a + b * hs)
        self._wrap(z_hl, _ref_pressure_from_height(z_hl, self._physical_constants))


class SLEVE3d(_MetricGrid):
    """The SLEVE coordinate: a smooth and a residual terrain, each with its
    own sinh decay scale (``s1``, ``s2``)."""

    def __init__(self, *args, niter: int = 10, s1: float = 8e3, s2: float = 5e3, **kwargs):
        self._niter = niter
        self._s1 = s1
        self._s2 = s2
        super().__init__(*args, **kwargs)

    def _update_metric_terms(self) -> None:
        hs, zv, zf = self._levels()
        s1, s2 = self._s1, self._s2

        # the smooth terrain: a 9-point low-pass filter, niter times
        h1 = hs.copy()
        for _ in range(self._niter):
            if h1.shape[0] > 2 and h1.shape[1] > 2:
                h1[1:-1, 1:-1] = (
                    h1[:-2, :-2] + h1[1:-1, :-2] + h1[2:, :-2]
                    + h1[:-2, 1:-1] + h1[1:-1, 1:-1] + h1[2:, 1:-1]
                    + h1[:-2, 2:] + h1[1:-1, 2:] + h1[2:, 2:]
                ) / 9.0
        h2 = hs - h1

        below = zv < zf
        b1 = np.sinh((zf - zv) / s1) / math.sinh(zf / s1) * below
        b2 = np.sinh((zf - zv) / s2) / math.sinh(zf / s2) * below
        a = np.broadcast_to(zv, (self.nx, self.ny, self.nz + 1))
        z_hl = np.asarray(a + np.broadcast_to(b1, a.shape) * h1 + np.broadcast_to(b2, a.shape) * h2)
        self._wrap(z_hl, _ref_pressure_from_height(z_hl, self._physical_constants))
