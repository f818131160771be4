"""The (moist) isentropic dynamical core (counterpart of
``tasmania_tpu/isentropic/dynamics/dycore.py``: its fused path
``_stage_fused`` ``:217-293`` and its dry unfused path ``_stage_dry``
``:299-345``, dispatched as ``stage_array_call`` ``:188-193`` does).

Per stage on the fused path: the stage operation of the prognostic scheme
(advection, lateral BC, Montgomery, momenta, mass fractions, Rayleigh
damping on the last stage unless ``damp_at_every_stage``; with tendencies,
the two-kernel stage that adds them).  On the unfused path (a
one-dimensional relaxed boundary, dry) the prognostic steps s, su and sv,
and the dycore enforces the lateral BC on all three and damps them toward
the reference from the step's "now" values.  Then the staggered velocities
of the stepped state with their outermost layers taken from the lateral
boundary.  The velocities are recomputed after every stage, so the next
stage reads the stepped state's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from tasmania_tpu_torch.dwarfs.diagnostics import get_velocity_components
from tasmania_tpu_torch.dwarfs.vertical_damping import Rayleigh
from tasmania_tpu_torch.framework.dycore import DynamicalCore
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.dynamics.prognostic import RK3WSSI, UNITS, mfcw, mfpw, mfwv

DIMS = ("x", "y", "z")
DIMS_U = ("x_at_u_locations", "y", "z")
DIMS_V = ("x", "y_at_v_locations", "z")


class IsentropicDynamicalCore(DynamicalCore):
    """Buffers: the steady topography (the driver scales it as the mountain
    grows) and, through the submodules, γ, the reference state, θ and the
    Rayleigh profile."""

    def __init__(
        self,
        domain,
        fast_tendency_component=None,
        fast_diagnostic_component=None,
        moist: bool = False,
        time_integration_scheme: str = "rk3ws_si",
        horizontal_flux_scheme: str = "fifth_order_upwind",
        time_integration_properties: Optional[Dict[str, Any]] = None,
        damp: bool = True,
        damp_at_every_stage: bool = True,
        damp_type: str = "rayleigh",
        damp_depth: int = 15,
        damp_max: float = 0.0002,
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(fast_tendency_component, fast_diagnostic_component)
        if time_integration_scheme != "rk3ws_si":
            raise NotImplementedError(
                f"time integration {time_integration_scheme!r} is not ported (have 'rk3ws_si')"
            )
        if damp and damp_type != "rayleigh":
            raise NotImplementedError(f"damping {damp_type!r} is not ported (have 'rayleigh')")
        so = storage_options or StorageOptions()
        self.horizontal_boundary = domain.horizontal_boundary
        self.moist = moist
        self.damp_at_every_stage = damp_at_every_stage
        self.prognostic = RK3WSSI(
            horizontal_flux_scheme, domain, moist, storage_options=so,
            **(time_integration_properties or {}),
        )
        grid = domain.numerical_grid
        self.damper = (
            Rayleigh(grid, damp_depth, damp_max, storage_options=so) if damp else None
        )
        steady = np.asarray(grid.topography.steady_profile.to_units("m").data)
        self.register_buffer(
            "topography_steady", torch.as_tensor(steady, dtype=so.dtype, device=so.device)
        )

    @property
    def stages(self) -> int:
        return self.prognostic.stages

    @property
    def stage_input_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "montgomery_potential": {"dims": DIMS, "units": "m^2 s^-2"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "x_velocity_at_u_locations": {"dims": DIMS_U, "units": "m s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_velocity_at_v_locations": {"dims": DIMS_V, "units": "m s^-1"},
        }
        if self.moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def stage_tendency_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }
        if self.moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1 s^-1"}
        return props

    @property
    def stage_output_properties(self):
        props = dict(self.stage_input_properties)
        del props["montgomery_potential"]
        return props

    def stage_array_call(
        self, stage: int, raw_state: Mapping[str, Any], raw_tendencies: Mapping[str, Any], timestep: float
    ):
        hb = self.horizontal_boundary
        # an all-zero profile (dd == 0) damps nothing
        damp = (
            self.damper is not None
            and self.damper.dd > 0
            and (self.damp_at_every_stage or stage == self.stages - 1)
        )
        if self.prognostic.fused:
            out = self.prognostic.stage_call(
                stage, timestep, raw_state, raw_tendencies,
                rmat=self.damper.rmat if damp else None,
                dd=self.damper.dd if damp else 0,
                dtf=timestep,
            )
        else:
            out = self._stage_dry(stage, raw_state, raw_tendencies, timestep, damp)
        u, v = get_velocity_components(
            out["air_isentropic_density"],
            out["x_momentum_isentropic"],
            out["y_momentum_isentropic"],
        )
        out["x_velocity_at_u_locations"] = hb.set_outermost_layers_x(
            u, "x_velocity_at_u_locations", "m s^-1"
        )
        out["y_velocity_at_v_locations"] = hb.set_outermost_layers_y(
            v, "y_velocity_at_v_locations", "m s^-1"
        )
        return out

    def _stage_dry(self, stage, raw_state, raw_tendencies, timestep: float, damp: bool):
        """The unfused stage's epilogue (``dycore.py:299-333``): the stepped
        s, su, sv enforced, then damped with the full timestep toward the
        reference from the values captured at stage 0."""
        hb = self.horizontal_boundary
        names = ("air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic")
        if stage == 0:
            self._damp_now = {n: raw_state[n] for n in names}
        out = self.prognostic.stage_call(stage, timestep, raw_state, raw_tendencies)
        out = {n: hb.enforce_field(out[n], n, UNITS[n]) for n in names}
        if damp:
            for n in names:
                out[n] = self.damper(timestep, self._damp_now[n], out[n], hb.ref_field(n, UNITS[n]))
        return out
