"""RK3WS-SI stage scheme of the isentropic core (counterpart of
``tasmania_tpu/isentropic/dynamics/prognostic.py``: ``RK3WSSI`` ``:1077``,
``_capture_now`` ``:1019``, the whole-stage path ``:372-530`` and the
two-kernel path ``stage_call_fused_epilogue`` ``:553-656``).

Three semi-implicit Wicker-Skamarock stages of dt/3, dt/2 and dt: density
and water advection with the relaxed lateral BC, the Montgomery potential of
the stepped density, the momenta with the off-centred pressure gradient, and
the epilogue (mass fractions, second enforcement, Rayleigh damping).  The
"now" fields are captured at stage 0.  Fifth-order upwind fluxes only.

A stage without tendencies is one call of the whole-stage operation
``ops/si_stage.py``.  A stage with tendencies (as ``_supports_stage_v2``
decides, ``prognostic.py:347-348``) takes two: ``fused_advection_fields``
steps the density (enforced) and the water densities with their
tendencies, the Montgomery potential of the stepped density is computed
between them in plain PyTorch (cumulative sums, as the JAX package's XLA
path), and ``fused_momentum_epilogue`` steps the momenta with theirs and
runs the epilogue (``ops/advection_step.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.dynamics.diagnostics import IsentropicDiagnostics
from tasmania_tpu_torch.ops.advection_step import fused_advection_fields, fused_momentum_epilogue
from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

UNITS = {
    "air_isentropic_density": "kg m^-2 K^-1",
    "x_momentum_isentropic": "kg m^-1 K^-1 s^-1",
    "y_momentum_isentropic": "kg m^-1 K^-1 s^-1",
    mfwv: "g g^-1",
    mfcw: "g g^-1",
    mfpw: "g g^-1",
}


class RK3WSSI(nn.Module):
    """Three-stage semi-implicit Wicker-Skamarock Runge-Kutta."""

    stages = 3
    substep_fractions = (1.0 / 3.0, 0.5, 1.0)

    def __init__(
        self,
        horizontal_flux_scheme: str,
        domain,
        moist: bool,
        *,
        pt=0.0,
        eps: float = 0.5,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__()
        if horizontal_flux_scheme != "fifth_order_upwind":
            raise NotImplementedError(
                f"horizontal flux {horizontal_flux_scheme!r} is not ported (have 'fifth_order_upwind')"
            )
        so = storage_options or StorageOptions()
        hb = domain.horizontal_boundary
        grid = domain.numerical_grid
        if hb.nb < 3:
            raise ValueError(f"nb={hb.nb} must be >= the flux extent 3")
        if not 0.0 <= eps <= 1.0:
            raise ValueError("off-centering eps must be in [0, 1]")
        self.horizontal_boundary = hb
        self.nb = hb.nb
        self.pt = float(np.asarray(pt.to_units("Pa").data)) if isinstance(pt, FieldArray) else float(pt)
        self.eps = float(eps)
        self.dx = float(np.asarray(grid.dx.to_units("m").data))
        self.dy = float(np.asarray(grid.dy.to_units("m").data))
        self.diagnostics = IsentropicDiagnostics(grid, storage_options=so)
        # the stage operation takes γ over the cells, contiguous
        self.register_buffer("gamma", hb.gamma[: grid.nx, : grid.ny].contiguous())
        self.q_names = (mfwv, mfcw, mfpw) if moist else ()
        self._now: Dict[str, Any] = {}

    def _capture_now(self, state: Mapping[str, Any]) -> None:
        names = ["air_isentropic_density", "montgomery_potential",
                 "x_momentum_isentropic", "y_momentum_isentropic", *self.q_names]
        self._now = {n: state[n] for n in names}

    def stage_call(
        self, stage: int, timestep: float, state: Mapping[str, Any],
        tendencies: Optional[Mapping[str, Any]] = None, *,
        rmat: Optional[torch.Tensor] = None, dd: int = 0, dtf: Optional[float] = None,
    ) -> Dict[str, Any]:
        """One stage from the captured "now" state; returns the stepped,
        enforced (and, with ``rmat``, damped) s, su, sv and mass fractions.
        ``state`` must carry the staggered velocities of the "int" state;
        ``tendencies`` holds raw tendencies of s, su, sv and the mass
        fractions, in the dycore's ``stage_tendency_properties`` units."""
        if stage == 0:
            self._capture_now(state)
        now = self._now
        hb = self.horizontal_boundary
        ref = {n: hb.ref_field(n, UNITS[n]) for n in ("air_isentropic_density",
               "x_momentum_isentropic", "y_momentum_isentropic", *self.q_names)}
        dia = self.diagnostics
        rpc = dia.rpc
        hs = state.get("topography_height")
        hs = dia.hs if hs is None else hs.contiguous()
        c = StageConstants(
            dt=self.substep_fractions[stage] * timestep,
            dtf=float(dtf if dtf is not None else timestep),
            dx=self.dx,
            dy=self.dy,
            eps=self.eps,
            pt=self.pt,
            dz=dia.dz,
            g=rpc["gravitational_acceleration"],
            cp=rpc["specific_heat_of_dry_air_at_constant_pressure"],
            rd=rpc["gas_constant_of_dry_air"],
            pref=rpc["air_pressure_at_sea_level"],
        )
        if tendencies:
            return self._stage_with_tendencies(state, tendencies, ref, hs, rmat, c)
        outs = si_stage(
            state["x_velocity_at_u_locations"],
            state["y_velocity_at_v_locations"],
            now["air_isentropic_density"],
            state["air_isentropic_density"],
            [now[q] for q in self.q_names],
            [state[q] for q in self.q_names],
            now["x_momentum_isentropic"],
            now["y_momentum_isentropic"],
            state["x_momentum_isentropic"],
            state["y_momentum_isentropic"],
            now["montgomery_potential"],
            hs,
            dia.theta,
            self.gamma,
            ref["air_isentropic_density"],
            ref["x_momentum_isentropic"],
            ref["y_momentum_isentropic"],
            [ref[q] for q in self.q_names],
            rmat,
            nb=self.nb,
            c=c,
            dd=dd,
        )
        return dict(zip(self._out_names, outs))

    @property
    def _out_names(self):
        return ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic",
                *self.q_names)

    def _stage_with_tendencies(self, state, tendencies, ref, hs, rmat, c: StageConstants):
        """The two-kernel stage (``stage_call_fused_epilogue`` and the fused
        branch of ``_step_density_and_water``, ``prognostic.py:689-732``)."""
        now = self._now
        s_int = state["air_isentropic_density"]
        u, v = state["x_velocity_at_u_locations"], state["y_velocity_at_v_locations"]
        # the mass-fraction tendencies enter the density update times s_int
        tnds = [tendencies.get("air_isentropic_density")] + [
            None if tendencies.get(q) is None else s_int * tendencies[q] for q in self.q_names
        ]
        stepped = fused_advection_fields(
            u, v,
            [now["air_isentropic_density"], *(now[q] for q in self.q_names)],
            [s_int, *(state[q] for q in self.q_names)],
            tnds,
            self.gamma, ref["air_isentropic_density"],
            nb=self.nb, dt=c.dt, dx=c.dx, dy=c.dy,
            q_product=(False,) + (True,) * len(self.q_names),
        )
        s_e = stepped[0]
        mtg = self.diagnostics.get_montgomery_potential(s_e, self.pt, hs)
        su_tnd = tendencies.get("x_momentum_isentropic")
        sv_tnd = tendencies.get("y_momentum_isentropic")
        if (su_tnd is None) != (sv_tnd is None):
            su_tnd = torch.zeros_like(s_e) if su_tnd is None else su_tnd
            sv_tnd = torch.zeros_like(s_e) if sv_tnd is None else sv_tnd
        outs = fused_momentum_epilogue(
            u, v, now["x_momentum_isentropic"], now["y_momentum_isentropic"],
            state["x_momentum_isentropic"], state["y_momentum_isentropic"],
            now["air_isentropic_density"], now["montgomery_potential"], s_e, mtg,
            stepped[1:], self.gamma, ref["air_isentropic_density"], ref["x_momentum_isentropic"],
            ref["y_momentum_isentropic"], [ref[q] for q in self.q_names], rmat, su_tnd, sv_tnd,
            nb=self.nb, c=c,
        )
        return dict(zip(self._out_names, outs))
