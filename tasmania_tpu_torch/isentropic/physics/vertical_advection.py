"""Explicit vertical (flux-form) advection for the isentropic model
(counterpart of ``tasmania_tpu/isentropic/physics/vertical_advection.py:34-166``).

The vertical velocity is w = dθ/dt on the main levels, interpolated to the
interfaces; the tendencies of s, su, sv and the three mass fractions (advected
as s·q) are the vertical flux divergence, zero on the ``extent`` top
and bottom levels.  Under RK3WS the stepper takes
``fused_rk_step``: all three stages in
``ops/vertical_advection_step.fused_vertical_advection_rk3ws`` (the kernel on
the card).
"""

from __future__ import annotations

import numpy as np
import torch

from tasmania_tpu_torch.framework.core_components import TendencyComponent
from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict
from tasmania_tpu_torch.isentropic.dynamics.vertical_fluxes import IsentropicMinimalVerticalFlux
from tasmania_tpu_torch.ops.vertical_advection_step import fused_vertical_advection_rk3ws

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
TTD = "tendency_of_air_potential_temperature"


def interface_w(w_main):
    """Main-level w on the interfaces; the outermost two are zero."""
    nz = w_main.shape[2]
    w_if = torch.zeros((*w_main.shape[:2], nz + 1), dtype=w_main.dtype, device=w_main.device)
    w_if[:, :, 1:nz] = 0.5 * (w_main[:, :, 1:] + w_main[:, :, :-1])
    return w_if


class IsentropicVerticalAdvection(TendencyComponent):
    fields = ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic",
              mfwv, mfcw, mfpw)

    def __init__(self, domain, grid_type: str = "numerical", flux_scheme: str = "upwind",
                 **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        self.vflux = IsentropicMinimalVerticalFlux.factory(flux_scheme)
        self.dz = float(np.asarray(self.grid.dz.to_units("K").data))

    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            TTD: {"dims": DIMS, "units": "K s^-1"},
            mfwv: {"dims": DIMS, "units": "g g^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            mfwv: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfcw: {"dims": DIMS, "units": "g g^-1 s^-1"},
            mfpw: {"dims": DIMS, "units": "g g^-1 s^-1"},
        }

    def array_call(self, state):
        e = self.vflux.extent
        s = state["air_isentropic_density"]
        nz = s.shape[2]
        w = interface_w(state[TTD])

        def tendency(phi, scale=None):
            f = self.vflux(0.0, self.dz, w, phi)  # interfaces [e, nz+1-e)
            div = (f[:, :, 1:] - f[:, :, :-1]) / self.dz  # levels [e, nz-e)
            if scale is not None:
                div = div / scale[:, :, e : nz - e]
            out = torch.zeros_like(phi)
            out[:, :, e : nz - e] = div
            return out

        tends = {name: tendency(state[name]) for name in self.fields[:3]}
        for q in self.fields[3:]:
            tends[q] = tendency(s * state[q], scale=s)
        return tends, {}

    def fused_rk_step(self, scheme, state, dt, output_properties):
        """The whole RK3WS step in one operation; None for another scheme."""
        if scheme != "rk3ws":
            return None
        raw = get_array_dict(state, self.input_properties)
        names = self.fields
        stepped = fused_vertical_advection_rk3ws(
            raw[TTD], *(raw[n] for n in names[:3]), tuple(raw[n] for n in names[3:]),
            order=self.vflux.order, dt=float(dt), dz=self.dz,
        )
        return {}, {
            n: FieldArray(a, output_properties[n]["units"], DIMS) for n, a in zip(names, stepped)
        }
