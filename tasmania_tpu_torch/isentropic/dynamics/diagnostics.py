"""Diagnostics of the isentropic core: pressure, Exner function, Montgomery
potential, height, density and temperature by column scans (counterpart of
``tasmania_tpu/isentropic/dynamics/diagnostics.py``).

Every call goes through ``ops/diagnostics_step.py::fused_isentropic_diagnostics``,
which launches its kernel on a CUDA tensor (the route the JAX package takes
under its ``"pallas"`` backends) and runs its plain version, cumulative sums
along k, on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.ops.diagnostics_step import fused_isentropic_diagnostics
from tasmania_tpu_torch.utils.constants import get_physical_constants

DEFAULT_CONSTANTS = {
    "air_pressure_at_sea_level": (1e5, "Pa"),
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
    "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
}


class IsentropicDiagnostics(nn.Module):
    """p / exn / mtg / h (+ ρ, T) from the isentropic density.  Buffers: θ on
    the interface levels and the grid's current topography."""

    def __init__(self, grid, physical_constants=None, *, storage_options=None) -> None:
        super().__init__()
        so = storage_options or StorageOptions()
        self.rpc = get_physical_constants(DEFAULT_CONSTANTS, physical_constants)
        theta = np.asarray(grid.z_on_interface_levels.to_units("K").data)
        self.dz = float(np.asarray(grid.dz.to_units("K").data))
        self.register_buffer("theta", torch.as_tensor(theta, dtype=so.dtype, device=so.device))
        hs = np.asarray(grid.topography.profile.to_units("m").data)
        self.register_buffer("hs", torch.as_tensor(hs, dtype=so.dtype, device=so.device))

    def _diagnostics(self, s, pt: float, hs, mode: str):
        rpc = self.rpc
        return fused_isentropic_diagnostics(
            s, self.hs if hs is None else hs.contiguous(), self.theta,
            pt=float(pt), dz=self.dz, g=rpc["gravitational_acceleration"],
            cp=rpc["specific_heat_of_dry_air_at_constant_pressure"],
            rd=rpc["gas_constant_of_dry_air"], pref=rpc["air_pressure_at_sea_level"],
            mode=mode,
        )

    def get_montgomery_potential(self, s, pt: float, hs=None):
        """mtg on the main levels; ``hs`` (nx, ny) overrides the grid's
        topography."""
        return self._diagnostics(s, pt, hs, "mtg")

    def get_diagnostic_variables(self, s, pt: float, hs=None, moist: bool = False):
        """(p, exn, mtg, h[, rho, t])."""
        return self._diagnostics(s, pt, hs, "moist" if moist else "dry")
