"""Semi-implicit stage schemes of the isentropic core (counterpart of
``tasmania_tpu/isentropic/dynamics/prognostic.py``: ``ForwardEulerSI``
``:1040``, ``CenteredSI`` ``:1058``, ``RK3WSSI`` ``:1077``, ``_capture_now``
``:1019``, the whole-stage path ``:372-530``, the two-kernel path
``stage_call_fused_epilogue`` ``:553-656`` and the generic stage
``_si_stage`` ``:981-1017``).

Each stage, from the "now" fields captured at stage 0: density and water
advection, the lateral BC on the stepped density, the Montgomery potential
of the stepped density, the momenta with the off-centred pressure gradient,
and the epilogue (mass fractions, second enforcement, Rayleigh damping).
``RK3WSSI`` runs three stages of dt/3, dt/2 and dt, ``ForwardEulerSI`` one
of dt.

The route is chosen as ``supports_fused_epilogue`` chooses it
(``prognostic.py:283-334``, ``dycore.py:195-215``).  On a two-dimensional
relaxed boundary with third- or fifth-order fluxes the stage is fused: a
stage without tendencies is one call of the whole-stage operation
``ops/si_stage.py``; a stage with tendencies takes two,
``fused_advection_fields`` (the density enforced, the water densities,
with their tendencies) and ``fused_momentum_epilogue`` (the momenta with
theirs and the epilogue), with the Montgomery potential of the stepped
density between them.  Every other boundary (periodic, Dirichlet, the
one-dimensional relaxed one) and the first- and second-order fluxes take
the generic stage (``_si_stage``): the density and the water densities
stepped without the boundary, with their tendencies
(``_step_density_and_water``, ``:658-792``), the density enforced, its
Montgomery potential, the momenta with theirs; the dycore then runs the
epilogue (``dycore.py::_stage_unfused``).  At orders 3 and 5 the generic
stage runs ``fused_advection_fields`` and ``fused_momentum_step``; at orders
1 and 2, which the JAX package computes in jnp, their plain PyTorch
versions on every device.  The Montgomery potential is
``ops/diagnostics_step.py`` in mode ``"mtg"`` on every route.

On a shard of a 2-D decomposition (a ``parallel.distributed.DistributedBoundary``
that is not degenerate, ``_is_distributed`` ``:246-250``) the route is the
JAX package's (``:283-300``): a relaxed inner boundary at order 3 or 5 takes
the whole-stage kernel in its distributed mode (the global frame by the
shard's offset), every other stage the generic one, whose stencil outputs
keep their "now" values on the global frame (``restrict_stencil_output``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.domain.boundaries.relaxed import Relaxed
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.isentropic.dynamics.diagnostics import IsentropicDiagnostics
from tasmania_tpu_torch.isentropic.dynamics.horizontal_fluxes import (
    KERNEL_ORDERS,
    IsentropicMinimalHorizontalFlux,
)
from tasmania_tpu_torch.ops.advection_step import (
    fused_advection_fields,
    fused_advection_fields_plain,
    fused_momentum_epilogue,
    fused_momentum_step,
    fused_momentum_step_plain,
)
from tasmania_tpu_torch.ops.si_stage import StageConstants, clip_pos, si_stage

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"
#: the water densities the generic stage returns, one for each mass fraction
SQ_NAMES = {
    mfwv: "isentropic_density_of_water_vapor",
    mfcw: "isentropic_density_of_cloud_liquid_water",
    mfpw: "isentropic_density_of_precipitation_water",
}

UNITS = {
    "air_isentropic_density": "kg m^-2 K^-1",
    "x_momentum_isentropic": "kg m^-1 K^-1 s^-1",
    "y_momentum_isentropic": "kg m^-1 K^-1 s^-1",
    mfwv: "g g^-1",
    mfcw: "g g^-1",
    mfpw: "g g^-1",
}


class IsentropicPrognostic(nn.Module, StencilFactory):
    """A semi-implicit scheme of ``stages`` stages, stage k of
    ``substep_fractions[k]`` times the timestep.  Factory base of the
    schemes: ``IsentropicPrognostic.factory("rk3ws_si", "fifth_order_upwind",
    domain, moist, pt=pt)``."""

    registry = {}
    stages: int
    substep_fractions: tuple

    def __init__(
        self,
        horizontal_flux_scheme: str,
        domain,
        moist: bool,
        *,
        pt=0.0,
        eps: float = 0.5,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        so = self.storage_options
        hb = domain.horizontal_boundary
        grid = domain.numerical_grid
        self.hflux = IsentropicMinimalHorizontalFlux.factory(horizontal_flux_scheme, backend=backend)
        self.order = self.hflux.order
        if hb.nb < self.hflux.extent:
            raise ValueError(f"nb={hb.nb} must be >= the flux extent {self.hflux.extent}")
        if not 0.0 <= eps <= 1.0:
            raise ValueError("off-centering eps must be in [0, 1]")
        #: a shard of a 2-D decomposition (not the degenerate single shard)
        self.distributed = not hb.is_degenerate
        #: whether the stage runs fused (the whole-stage or the two-kernel
        #: route): a two-dimensional relaxed boundary and a kernel's order
        if self.distributed:
            self.fused = hb.inner_type == "relaxed" and self.order in KERNEL_ORDERS
            d = hb.decomposition
            if self.fused and ((d.px > 1 and d.pad_x < hb.nb + 1) or (d.py > 1 and d.pad_y < hb.nb + 1)):
                raise ValueError(
                    "the whole-stage kernel's distributed mode needs halo pads >= nb + 1 on "
                    "decomposed axes (its Montgomery gradient reads the advected density one "
                    "cell into the halo): pass halo=nb+1 to DistributedModel"
                )
        else:
            self.fused = (isinstance(hb, Relaxed) and not (hb.one_dx or hb.one_dy)
                          and self.order in KERNEL_ORDERS)
        self.horizontal_boundary = hb
        self.nb = hb.nb
        self.pt = float(np.asarray(pt.to_units("Pa").data)) if isinstance(pt, FieldArray) else float(pt)
        self.eps = float(eps)
        self.dx = float(np.asarray(grid.dx.to_units("m").data))
        self.dy = float(np.asarray(grid.dy.to_units("m").data))
        self.diagnostics = IsentropicDiagnostics(grid, storage_options=so)
        if self.fused:
            # the stage operations take γ over the cells, contiguous
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
        generic: bool = False,
    ) -> Dict[str, Any]:
        """One stage from the captured "now" state.  On the fused route it
        returns the stepped, enforced (and, with ``rmat``, damped) s, su, sv
        and mass fractions.  The generic stage returns the stepped s
        (enforced), su, sv and the stepped water densities (``SQ_NAMES``),
        and does not read ``rmat``: the dycore forms the mass fractions,
        enforces and damps.  ``state`` must carry the staggered velocities
        of the "int" state; ``tendencies`` holds raw tendencies of s, su, sv
        and the mass fractions, in the dycore's ``stage_tendency_properties``
        units.  ``generic`` takes the generic stage on the fused route too
        (the dycore's choice for a distributed stage with tendencies)."""
        if stage == 0:
            self._capture_now(state)
        now = self._now
        tendencies = tendencies or {}
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
        if generic or not self.fused:
            return self._stage_unfused(state, tendencies, hs, c)
        hb = self.horizontal_boundary
        ref = {n: hb.ref_field(n, UNITS[n]) for n in ("air_isentropic_density",
               "x_momentum_isentropic", "y_momentum_isentropic", *self.q_names)}
        if tendencies:
            return self._stage_with_tendencies(state, tendencies, ref, hs, rmat, c)
        dist = {}
        if self.distributed:
            gnx, gny = hb.global_extent
            dist = dict(dist=True, goff=hb.offset, gnx=gnx, gny=gny)
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
            order=self.order,
            **dist,
        )
        return dict(zip(self._out_names, outs))

    @property
    def _out_names(self):
        return ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic",
                *self.q_names)

    def _density_tendencies(self, tendencies, s_int):
        """The tendencies of s and of the water densities (a mass fraction's
        times s_int), None where absent; None if there are none."""
        tnds = [tendencies.get("air_isentropic_density")] + [
            None if tendencies.get(q) is None else s_int * tendencies[q] for q in self.q_names
        ]
        return tnds if any(t is not None for t in tnds) else None

    @staticmethod
    def _momentum_tendencies(tendencies, like):
        """su's and sv's tendencies, both or neither (the missing one zero)."""
        su_tnd = tendencies.get("x_momentum_isentropic")
        sv_tnd = tendencies.get("y_momentum_isentropic")
        if (su_tnd is None) != (sv_tnd is None):
            su_tnd = torch.zeros_like(like) if su_tnd is None else su_tnd
            sv_tnd = torch.zeros_like(like) if sv_tnd is None else sv_tnd
        return su_tnd, sv_tnd

    def _stage_with_tendencies(self, state, tendencies, ref, hs, rmat, c: StageConstants):
        """The two-kernel stage (``stage_call_fused_epilogue`` and the fused
        branch of ``_step_density_and_water``, ``prognostic.py:689-732``)."""
        now = self._now
        s_int = state["air_isentropic_density"]
        u, v = state["x_velocity_at_u_locations"], state["y_velocity_at_v_locations"]
        stepped = fused_advection_fields(
            u, v,
            [now["air_isentropic_density"], *(now[q] for q in self.q_names)],
            [s_int, *(state[q] for q in self.q_names)],
            self._density_tendencies(tendencies, s_int),
            self.gamma, ref["air_isentropic_density"],
            nb=self.nb, dt=c.dt, dx=c.dx, dy=c.dy, order=self.order,
            q_product=(False,) + (True,) * len(self.q_names),
        )
        s_e = stepped[0]
        mtg = self.diagnostics.get_montgomery_potential(s_e, self.pt, hs)
        su_tnd, sv_tnd = self._momentum_tendencies(tendencies, s_e)
        outs = fused_momentum_epilogue(
            u, v, now["x_momentum_isentropic"], now["y_momentum_isentropic"],
            state["x_momentum_isentropic"], state["y_momentum_isentropic"],
            now["air_isentropic_density"], now["montgomery_potential"], s_e, mtg,
            stepped[1:], self.gamma, ref["air_isentropic_density"], ref["x_momentum_isentropic"],
            ref["y_momentum_isentropic"], [ref[q] for q in self.q_names], rmat, su_tnd, sv_tnd,
            nb=self.nb, c=c, order=self.order,
        )
        return dict(zip(self._out_names, outs))

    def _stage_unfused(self, state, tendencies, hs, c: StageConstants):
        """The generic stage (``_si_stage``, ``prognostic.py:981-1017``): the
        density and the water densities clip(s·q) stepped without the
        boundary, with their tendencies; the density enforced; its
        Montgomery potential; the momenta with their tendencies.  Each
        stencil output keeps its "now" value on the global frame
        (``restrict_stencil_output``: identity on a single device)."""
        now = self._now
        hb = self.horizontal_boundary
        s_int = state["air_isentropic_density"]
        u, v = state["x_velocity_at_u_locations"], state["y_velocity_at_v_locations"]
        if self.order in KERNEL_ORDERS:
            advect, momenta = fused_advection_fields, fused_momentum_step
        else:
            advect, momenta = fused_advection_fields_plain, fused_momentum_step_plain
        kw = dict(nb=self.nb, dt=c.dt, dx=c.dx, dy=c.dy, order=self.order)
        s_now = now["air_isentropic_density"]
        stepped = advect(
            u, v,
            [s_now, *(now[q] for q in self.q_names)],
            [s_int, *(state[q] for q in self.q_names)],
            self._density_tendencies(tendencies, s_int),
            q_product=(False,) + (True,) * len(self.q_names), **kw,
        )
        if self.distributed:
            bases = [s_now] + [clip_pos(s_now * now[q]) for q in self.q_names]
            stepped = [hb.restrict_stencil_output(phi, base=base, nb=self.nb)
                       for phi, base in zip(stepped, bases)]
        s_new = hb.enforce_field(stepped[0], "air_isentropic_density", UNITS["air_isentropic_density"])
        mtg = self.diagnostics.get_montgomery_potential(s_new, self.pt, hs)
        su, sv = momenta(
            u, v, now["x_momentum_isentropic"], now["y_momentum_isentropic"],
            state["x_momentum_isentropic"], state["y_momentum_isentropic"],
            now["air_isentropic_density"], now["montgomery_potential"], s_new, mtg,
            *self._momentum_tendencies(tendencies, s_new), eps=self.eps, **kw,
        )
        su = hb.restrict_stencil_output(su, base=now["x_momentum_isentropic"], nb=self.nb)
        sv = hb.restrict_stencil_output(sv, base=now["y_momentum_isentropic"], nb=self.nb)
        out = {"air_isentropic_density": s_new, "x_momentum_isentropic": su,
               "y_momentum_isentropic": sv}
        out.update((SQ_NAMES[q], sq) for q, sq in zip(self.q_names, stepped[1:]))
        return out


    @staticmethod
    def factory(time_integration_scheme: str, horizontal_flux_scheme: str, domain, moist: bool,
                **kwargs) -> "IsentropicPrognostic":
        return factorize(time_integration_scheme, IsentropicPrognostic,
                         (horizontal_flux_scheme, domain, moist), kwargs)


@factor_register("forward_euler_si")
class ForwardEulerSI(IsentropicPrognostic):
    """One semi-implicit stage of the whole timestep
    (``prognostic.py:1040-1055``)."""

    stages = 1
    substep_fractions = (1.0,)


@factor_register("centered_si")
class CenteredSI(IsentropicPrognostic):
    """The reference's stub (``prognostic.py:1058-1075``): it defines only
    the name, and using it raises, as it does there."""

    @property
    def stages(self) -> int:
        raise NotImplementedError("centered_si is a stub in the reference too")

    def stage_call(self, *args, **kwargs):
        raise NotImplementedError("centered_si is a stub in the reference too")


@factor_register("rk3ws_si")
class RK3WSSI(IsentropicPrognostic):
    """Three-stage semi-implicit Wicker-Skamarock Runge-Kutta
    (``prognostic.py:1077-1094``)."""

    stages = 3
    substep_fractions = (1.0 / 3.0, 0.5, 1.0)
