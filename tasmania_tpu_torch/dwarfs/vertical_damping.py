"""Vertical damping toward a reference state (counterpart of
``tasmania_tpu/dwarfs/vertical_damping.py``): the ``VerticalDamping`` base,
which holds the damping profile and the factory, and its ``Rayleigh``
damper.

``phi_out = phi_new - dt·rmat·(phi_now - phi_ref)`` with the cosine profile of
Durran & Klemp over the top ``damp_depth`` levels.  The fused stages apply it
inside their kernels (``ops/si_stage.py``, ``ops/advection_step.py``) from the
profile, a buffer, and its support depth; the unfused stage of a
one-dimensional boundary calls the damper itself."""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.utils.units import conversion_factor


class VerticalDamping(nn.Module, StencilFactory):
    """The damping profile on the main levels (``rmat``, with its support
    depth ``dd``: the levels k < dd hold every nonzero coefficient) and on
    the interfaces (``rmat_if``, the bottom interface undamped); the
    timestep is in seconds and the coefficients in ``time_units``^-1.
    Factory base of the dampers: ``VerticalDamping.factory("rayleigh", grid,
    ...)``."""

    registry = {}

    def __init__(
        self,
        grid,
        damp_depth: int = 15,
        damp_coeff_max: float = 0.0002,
        time_units: str = "s",
        *,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        so = self.storage_options
        damp_depth = min(damp_depth, grid.nz)  # shallow test grids
        self.damp_depth = damp_depth
        self.dt_factor = conversion_factor("s", time_units)
        z = np.asarray(grid.z.data, dtype=float)
        profiles = []
        for zz in (z, np.concatenate((z, [0.0]))):
            r = np.zeros_like(zz)
            if damp_depth > 0:
                zt = float(np.asarray(grid.z_on_interface_levels.data)[0])
                za = z[damp_depth - 1]
                r = (zz >= za) * damp_coeff_max * (1.0 - np.cos(math.pi * (zz - za) / (zt - za)))
            profiles.append(r.astype(so.np_dtype))
        nonzero = np.nonzero(profiles[0])[0]
        self.dd = int(nonzero[-1]) + 1 if nonzero.size else 0
        self.register_buffer("rmat", torch.as_tensor(profiles[0], device=so.device))
        self.register_buffer("rmat_if", torch.as_tensor(profiles[1], device=so.device))

    def profile(self, field):
        """The profile of ``field``'s levels: the main levels', or with one
        level more the interfaces'."""
        return self.rmat_if if field.shape[2] == self.rmat.shape[0] + 1 else self.rmat

    def forward(self, dt: float, field_now, field_new, field_ref):
        raise NotImplementedError

    @staticmethod
    def factory(damp_type: str, grid, *args, **kwargs) -> "VerticalDamping":
        """The damper registered as ``damp_type`` (``"rayleigh"``)."""
        return factorize(damp_type, VerticalDamping, (grid, *args), kwargs)


@factor_register("rayleigh")
class Rayleigh(VerticalDamping):
    def forward(self, dt: float, field_now, field_new, field_ref):
        """``field_new`` damped toward ``field_ref`` from ``field_now`` over a
        timestep of ``dt`` seconds."""
        return field_new - dt * self.dt_factor * self.profile(field_new) * (field_now - field_ref)
