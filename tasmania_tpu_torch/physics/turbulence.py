"""Two-dimensional Smagorinsky turbulence closure (counterpart of
``tasmania_tpu/physics/turbulence.py``): the strain rate from centred
differences, eddy viscosity ``nu = cs²·dx·dy·|S|``, tendency ``2·∇·(nu·S)``.
The stencil reaches 2 points; the tendencies are zero on the nb-frame.
On a shard of a 2-D decomposition they are zero on the global frame and
their halos are refreshed (``turbulence.py:108-121`` of the JAX package;
the hooks are identities on a single device).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.core_components import TendencyComponent

DIMS = ("x", "y", "z")


def smagorinsky_core(u, v, dx: float, dy: float, cs: float, nb: int):
    """(u_tnd, v_tnd) on the [nb, n-nb) interior window."""
    ib, ie = nb, u.shape[0] - nb
    jb, je = nb, u.shape[1] - nb
    s00 = (u[ib : ie + 2, jb - 1 : je + 1] - u[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx)
    s01 = 0.5 * (
        (u[ib - 1 : ie + 1, jb : je + 2] - u[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
        + (v[ib : ie + 2, jb - 1 : je + 1] - v[ib - 2 : ie, jb - 1 : je + 1]) / (2.0 * dx)
    )
    s11 = (v[ib - 1 : ie + 1, jb : je + 2] - v[ib - 1 : ie + 1, jb - 2 : je]) / (2.0 * dy)
    nu = cs**2 * dx * dy * (2.0 * (s00**2 + 2.0 * s01**2 + s11**2)) ** 0.5
    u_tnd = 2.0 * (
        (nu[2:, 1:-1] * s00[2:, 1:-1] - nu[:-2, 1:-1] * s00[:-2, 1:-1]) / (2.0 * dx)
        + (nu[1:-1, 2:] * s01[1:-1, 2:] - nu[1:-1, :-2] * s01[1:-1, :-2]) / (2.0 * dy)
    )
    v_tnd = 2.0 * (
        (nu[2:, 1:-1] * s01[2:, 1:-1] - nu[:-2, 1:-1] * s01[:-2, 1:-1]) / (2.0 * dx)
        + (nu[1:-1, 2:] * s11[1:-1, 2:] - nu[1:-1, :-2] * s11[1:-1, :-2]) / (2.0 * dy)
    )
    return u_tnd, v_tnd


def frame_paste(shape, nb: int, interior):
    """A zero array of ``shape`` with ``interior`` on [nb, n-nb) x [nb, n-nb)."""
    out = torch.zeros(shape, dtype=interior.dtype, device=interior.device)
    out[nb : shape[0] - nb, nb : shape[1] - nb] = interior
    return out


class Smagorinsky2d(TendencyComponent):
    """Velocity-form Smagorinsky tendencies."""

    def __init__(self, domain, smagorinsky_constant: float = 0.18, **kwargs) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self.cs = smagorinsky_constant
        if self.horizontal_boundary.nb < 2:
            raise ValueError("Smagorinsky needs nb >= 2")
        self.nb = self.horizontal_boundary.nb

    @property
    def input_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-1"},
            "y_velocity": {"dims": DIMS, "units": "m s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            "x_velocity": {"dims": DIMS, "units": "m s^-2"},
            "y_velocity": {"dims": DIMS, "units": "m s^-2"},
        }

    def spacings(self) -> Tuple[float, float]:
        dx = float(np.asarray(self.grid.dx.to_units("m").data))
        dy = float(np.asarray(self.grid.dy.to_units("m").data))
        return dx, dy

    def array_call(self, state):
        u, v = state["x_velocity"], state["y_velocity"]
        dx, dy = self.spacings()
        u_tnd, v_tnd = smagorinsky_core(u, v, dx, dy, self.cs, self.nb)
        hb = self.horizontal_boundary
        out_u, out_v = hb.refresh_halos_many([
            hb.restrict_stencil_output(frame_paste(u.shape, self.nb, u_tnd), nb=self.nb),
            hb.restrict_stencil_output(frame_paste(v.shape, self.nb, v_tnd), nb=self.nb),
        ])
        return {"x_velocity": out_u, "y_velocity": out_v}, {}
