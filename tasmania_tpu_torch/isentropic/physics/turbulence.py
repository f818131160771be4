"""Smagorinsky turbulence in conservative (momentum) form for the isentropic
model (counterpart of ``tasmania_tpu/isentropic/physics/turbulence.py:17-95``):
u = su/s, the velocity-form core, tendencies scaled by s.

Under RK2 the stepper takes ``fused_rk_step``: both stages in
``ops/smagorinsky_step.fused_smagorinsky_rk2`` (the kernel on the card).
"""

from __future__ import annotations

from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict
from tasmania_tpu_torch.ops.smagorinsky_step import fused_smagorinsky_rk2
from tasmania_tpu_torch.physics.turbulence import Smagorinsky2d, frame_paste, smagorinsky_core

DIMS = ("x", "y", "z")
SU, SV = "x_momentum_isentropic", "y_momentum_isentropic"


class IsentropicSmagorinsky(Smagorinsky2d):
    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }

    def fused_rk_step(self, scheme, state, dt, output_properties):
        """The whole RK2 step in one operation; None for another scheme."""
        if scheme != "rk2":
            return None
        raw = get_array_dict(state, self.input_properties)
        dx, dy = self.spacings()
        su, sv = fused_smagorinsky_rk2(
            raw["air_isentropic_density"], raw[SU], raw[SV],
            dx=dx, dy=dy, cs=self.cs, nb=self.nb, dt=float(dt),
        )
        return {}, {
            SU: FieldArray(su, output_properties[SU]["units"], DIMS),
            SV: FieldArray(sv, output_properties[SV]["units"], DIMS),
        }

    def array_call(self, state):
        s = state["air_isentropic_density"]
        u = state[SU] / s
        v = state[SV] / s
        dx, dy = self.spacings()
        nb = self.nb
        u_tnd, v_tnd = smagorinsky_core(u, v, dx, dy, self.cs, nb)
        s_in = s[nb : s.shape[0] - nb, nb : s.shape[1] - nb]
        return {
            SU: frame_paste(s.shape, nb, s_in * u_tnd),
            SV: frame_paste(s.shape, nb, s_in * v_tnd),
        }, {}
