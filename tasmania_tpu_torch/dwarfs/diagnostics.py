"""Velocity/momenta and water-constituent diagnostics (counterpart of
``tasmania_tpu/dwarfs/diagnostics.py``): ``HorizontalVelocity`` (momenta
from velocities on the C-staggered grid and back) and ``WaterConstituent``
(s·q and q = sq/s, optionally clipped at zero).  The isentropic diagnostics
and the dycore call :func:`get_velocity_components` directly; the stage
operation (``ops/si_stage.py``) converts between water densities and mass
fractions inside its kernel."""

from __future__ import annotations

from typing import Optional

import torch

from tasmania_tpu_torch.framework.options import StorageOptions


def get_velocity_components(d, du, dv):
    """(u, v) on the C-staggered grid from the isentropic density ``d`` and
    the momenta: u (nx+1, ny, nz), v (nx, ny+1, nz).  The outermost staggered
    layers are zero; callers set them from the lateral boundary."""
    u_in = (du[:-1] + du[1:]) / (d[:-1] + d[1:])
    v_in = (dv[:, :-1] + dv[:, 1:]) / (d[:, :-1] + d[:, 1:])
    zu = torch.zeros_like(u_in[:1])
    zv = torch.zeros_like(v_in[:, :1])
    return torch.cat([zu, u_in, zu], dim=0), torch.cat([zv, v_in, zv], dim=1)


class HorizontalVelocity:
    """Momenta from velocities and back, with staggered averaging where
    ``staggering`` (velocities on the cell faces), pointwise otherwise."""

    def __init__(self, grid, staggering: bool = True, *,
                 storage_options: Optional[StorageOptions] = None) -> None:
        self.grid = grid
        self.staggering = staggering
        self.storage_options = storage_options or StorageOptions()

    def get_momenta(self, d, u, v):
        """(d·ū, d·v̄), the face velocities averaged to the cells."""
        if self.staggering:
            return 0.5 * d * (u[:-1] + u[1:]), 0.5 * d * (v[:, :-1] + v[:, 1:])
        return d * u, d * v

    def get_velocity_components(self, d, du, dv):
        """(u, v) from the momenta; staggered, the outermost faces are zero
        (:func:`get_velocity_components`)."""
        if self.staggering:
            return get_velocity_components(d, du, dv)
        return du / d, dv / d


class WaterConstituent:
    """sq = s·q and q = sq/s, each clipped at zero where ``clipping``."""

    def __init__(self, grid, clipping: bool = False, *,
                 storage_options: Optional[StorageOptions] = None) -> None:
        self.grid = grid
        self.clipping = clipping
        self.storage_options = storage_options or StorageOptions()

    def _clip(self, x):
        return torch.where(x > 0.0, x, torch.zeros_like(x)) if self.clipping else x

    def get_density_of_water_constituent(self, d, q):
        return self._clip(d * q)

    def get_mass_fraction_of_water_constituent_in_air(self, d, dq):
        return self._clip(dq / d)
