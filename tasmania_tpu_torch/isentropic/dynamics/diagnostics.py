"""Diagnostics of the isentropic core: pressure, Exner function, Montgomery
potential, height, density and temperature by column scans (counterpart of
``tasmania_tpu/isentropic/dynamics/diagnostics.py``, its plain path).

Every scan is a cumulative sum along k (the contiguous axis):

* pressure     p[k] = pt + g·dz·Σ_{l<k} s[l]
* Montgomery   mtg[k] = θ_s·exn[nz] + g·hs + ½dz·exn[nz] + dz·Σ_{l>k} exn[l]
* height       h[k] = hs + Σ_{l≥k} dh[l]
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.constants import get_physical_constants

DEFAULT_CONSTANTS = {
    "air_pressure_at_sea_level": (1e5, "Pa"),
    "gas_constant_of_dry_air": (287.05, "J K^-1 kg^-1"),
    "gravitational_acceleration": (9.80665, "m s^-2"),
    "specific_heat_of_dry_air_at_constant_pressure": (1004.0, "J K^-1 kg^-1"),
}


def pressure(s, pt: float, g: float, dz: float):
    """p on the nz+1 interface levels from the isentropic density."""
    csum = torch.cumsum(g * dz * s, dim=2)
    return torch.cat([torch.zeros_like(s[:, :, :1]), csum], dim=2) + pt


def exner(p, cp: float, rd: float, pref: float):
    return cp * (p / pref) ** (rd / cp)


def montgomery(exn, hs, theta_s: float, g: float, dz: float):
    """mtg on the nz main levels; ``hs`` is (nx, ny, 1)."""
    nz = exn.shape[2] - 1
    mtg_s = theta_s * exn[:, :, nz : nz + 1] + g * hs
    base = mtg_s + 0.5 * dz * exn[:, :, nz : nz + 1]
    inc = dz * exn[:, :, 1:nz]  # exn[k+1] for k in 0..nz-2
    rcsum = torch.flip(torch.cumsum(torch.flip(inc, [2]), dim=2), [2])
    return torch.cat([base + rcsum, base], dim=2)


class IsentropicDiagnostics(nn.Module):
    """p / exn / mtg / h (+ ρ, T) from the isentropic density.  Buffers: θ on
    the interface levels and the grid's current topography."""

    def __init__(self, grid, physical_constants=None, *, storage_options=None) -> None:
        super().__init__()
        so = storage_options or StorageOptions()
        self.rpc = get_physical_constants(DEFAULT_CONSTANTS, physical_constants)
        theta = np.asarray(grid.z_on_interface_levels.to_units("K").data)
        self.theta_s = float(theta[-1])
        self.dz = float(np.asarray(grid.dz.to_units("K").data))
        self.register_buffer("theta", torch.as_tensor(theta, dtype=so.dtype, device=so.device))
        hs = np.asarray(grid.topography.profile.to_units("m").data)
        self.register_buffer("hs", torch.as_tensor(hs, dtype=so.dtype, device=so.device))

    def _hs3(self, hs=None):
        """The topography as an (nx, ny, 1) plane; ``hs`` overrides the grid's."""
        return (self.hs if hs is None else hs)[:, :, None]

    def _p_exn_mtg(self, s, pt: float, hs3):
        rpc = self.rpc
        g = rpc["gravitational_acceleration"]
        p = pressure(s, pt, g, self.dz)
        exn = exner(p, rpc["specific_heat_of_dry_air_at_constant_pressure"],
                    rpc["gas_constant_of_dry_air"], rpc["air_pressure_at_sea_level"])
        return p, exn, montgomery(exn, hs3, self.theta_s, g, self.dz)

    def get_montgomery_potential(self, s, pt: float, hs=None):
        """mtg on the main levels."""
        return self._p_exn_mtg(s, pt, self._hs3(hs))[2]

    def get_diagnostic_variables(self, s, pt: float, hs=None, moist: bool = False):
        """(p, exn, mtg, h[, rho, t])."""
        rpc = self.rpc
        g = rpc["gravitational_acceleration"]
        cp = rpc["specific_heat_of_dry_air_at_constant_pressure"]
        rd = rpc["gas_constant_of_dry_air"]
        hs3 = self._hs3(hs)
        p, exn, mtg = self._p_exn_mtg(s, pt, hs3)
        th = self.theta[None, None, :]
        dh = (
            rd
            * (th[:, :, :-1] * exn[:, :, :-1] + th[:, :, 1:] * exn[:, :, 1:])
            * (p[:, :, :-1] - p[:, :, 1:])
            / (cp * g * (p[:, :, :-1] + p[:, :, 1:]))
        )
        rcsum = torch.flip(torch.cumsum(torch.flip(dh, [2]), dim=2), [2])
        h = torch.cat([hs3 - rcsum, hs3], dim=2)
        if not moist:
            return p, exn, mtg, h
        rho = s * (th[:, :, :-1] - th[:, :, 1:]) / (h[:, :, :-1] - h[:, :, 1:])
        t = 0.5 / cp * (th[:, :, :-1] * exn[:, :, :-1] + th[:, :, 1:] * exn[:, :, 1:])
        return p, exn, mtg, h, rho, t
