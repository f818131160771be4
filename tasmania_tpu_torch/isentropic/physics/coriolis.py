"""f-plane Coriolis tendencies on the isentropic momenta (counterpart of
``tasmania_tpu/isentropic/physics/coriolis.py``): tnd_su = +f·sv and
tnd_sv = −f·su on the nb-inset interior, zero on the frame.

The JAX package computes it in jnp, with no Pallas kernel, so the port is
plain PyTorch: pointwise everywhere, then the boundary's
``zero_physical_frame``.  On a single device that is the interior-window
write; on a shard of a 2-D decomposition it zeroes only the global frame,
so the shard's halo cells stay valid without an exchange."""

from __future__ import annotations

import numpy as np

from tasmania_tpu_torch.framework.core_components import TendencyComponent
from tasmania_tpu_torch.framework.field import FieldArray

DIMS = ("x", "y", "z")
SU, SV = "x_momentum_isentropic", "y_momentum_isentropic"


class IsentropicConservativeCoriolis(TendencyComponent):
    """``coriolis_parameter``: a ``FieldArray`` (converted to rad s^-1) or a
    float in rad s^-1; 1e-4 when None."""

    def __init__(self, domain, grid_type: str = "numerical", coriolis_parameter=None,
                 **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        if isinstance(coriolis_parameter, FieldArray):
            self.f = float(np.asarray(coriolis_parameter.to_units("rad s^-1").data))
        else:
            self.f = float(coriolis_parameter if coriolis_parameter is not None else 1e-4)
        self.grid_type = grid_type
        self.nb = self.horizontal_boundary.nb if grid_type == "numerical" else 0

    @property
    def input_properties(self):
        return {
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }

    def array_call(self, state):
        tnd_su = self.f * state[SV]
        tnd_sv = -self.f * state[SU]
        if self.grid_type == "numerical":
            hb = self.horizontal_boundary
            tnd_su = hb.zero_physical_frame(tnd_su, self.nb)
            tnd_sv = hb.zero_physical_frame(tnd_sv, self.nb)
        return {SU: tnd_su, SV: tnd_sv}, {}
