"""Staggered velocity diagnosis (counterpart of
``tasmania_tpu/dwarfs/diagnostics.py``).  The conversion between water
densities and mass fractions lives inside the stage operation
(``ops/si_stage.py``), where the dycore needs it."""

from __future__ import annotations

import torch


def get_velocity_components(d, du, dv):
    """(u, v) on the C-staggered grid from the isentropic density ``d`` and
    the momenta: u (nx+1, ny, nz), v (nx, ny+1, nz).  The outermost staggered
    layers are zero; callers set them from the lateral boundary."""
    u_in = (du[:-1] + du[1:]) / (d[:-1] + d[1:])
    v_in = (dv[:, :-1] + dv[:, 1:]) / (d[:, :-1] + d[:, 1:])
    zu = torch.zeros_like(u_in[:1])
    zv = torch.zeros_like(v_in[:, :1])
    return torch.cat([zu, u_in, zu], dim=0), torch.cat([zv, v_in, zv], dim=1)
