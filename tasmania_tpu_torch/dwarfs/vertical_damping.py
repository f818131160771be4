"""Rayleigh vertical damping profile (counterpart of
``tasmania_tpu/dwarfs/vertical_damping.py``).

``phi_out = phi_new - dt·rmat·(phi_now - phi_ref)`` with the cosine profile of
Durran & Klemp over the top ``damp_depth`` levels.  The fused stages apply it
inside their kernels (``ops/si_stage.py``, ``ops/advection_step.py``) from the
profile, a buffer, and its support depth; the unfused stage of a
one-dimensional boundary calls the damper itself."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.options import StorageOptions


class Rayleigh(nn.Module):
    def __init__(
        self,
        grid,
        damp_depth: int = 15,
        damp_coeff_max: float = 0.0002,
        *,
        storage_options: StorageOptions | None = None,
    ) -> None:
        super().__init__()
        so = storage_options or StorageOptions()
        damp_depth = min(damp_depth, grid.nz)  # shallow test grids
        self.damp_depth = damp_depth
        z = np.asarray(grid.z.data, dtype=float)
        r = np.zeros_like(z)
        if damp_depth > 0:
            zt = float(np.asarray(grid.z_on_interface_levels.data)[0])
            za = z[damp_depth - 1]
            r = (z >= za) * damp_coeff_max * (1.0 - np.cos(math.pi * (z - za) / (zt - za)))
        r = r.astype(so.np_dtype)
        nonzero = np.nonzero(r)[0]
        #: the levels k < dd hold every nonzero coefficient
        self.dd = int(nonzero[-1]) + 1 if nonzero.size else 0
        self.register_buffer("rmat", torch.as_tensor(r, device=so.device))

    def forward(self, dt: float, field_now, field_new, field_ref):
        """``field_new`` damped toward ``field_ref`` from ``field_now`` over a
        timestep of ``dt`` seconds (cell fields, nz levels)."""
        return field_new - dt * self.rmat * (field_now - field_ref)
