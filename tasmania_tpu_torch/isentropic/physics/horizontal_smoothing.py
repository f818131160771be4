"""Horizontal smoothing of the isentropic prognostic fields (counterpart of
``tasmania_tpu/isentropic/physics/horizontal_smoothing.py``, its fused path
``:116-142``): a diagnostic component that overwrites s, su, sv (and the
moist species) with their Shapiro-filtered values.  The two-dimensional
filters smooth all fields in one call of ``ops/smoothing_step.fused_smoothing``;
the one-dimensional ones run the dwarf on each field.  Then the boundary's
distribution hooks (``_finish_all``, ``:87-98``; identities on a single
device): the input kept on the global frame, one halo refresh."""

from __future__ import annotations

from typing import Optional

import torch

from tasmania_tpu_torch.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_tpu_torch.framework.core_components import DiagnosticComponent
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


class IsentropicHorizontalSmoothing(DiagnosticComponent):
    """Buffer: the per-(field, z) coefficient ``gamma`` (F, nz) of the
    fields' filters (``cores``)."""

    def __init__(
        self,
        domain,
        smooth_type: str = "first_order",
        smooth_coeff: float = 0.03,
        smooth_coeff_max: Optional[float] = None,
        smooth_damp_depth: int = 0,
        moist: bool = False,
        smooth_moist_coeff: Optional[float] = None,
        smooth_moist_coeff_max: Optional[float] = None,
        smooth_moist_damp_depth: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self.moist = moist
        g, nb = self.grid, self.horizontal_boundary.nb
        kw = dict(backend=self.backend, backend_options=self.backend_options,
                  storage_options=self.storage_options)
        shape = (g.nx, g.ny, g.nz)
        cmax = smooth_coeff_max if smooth_coeff_max is not None else smooth_coeff
        self.core = HorizontalSmoothing.factory(
            smooth_type, shape, smooth_coeff, cmax, smooth_damp_depth, nb, **kw
        )
        self.order, self.nb, self.axes = self.core.order, self.core.nb, self.core.axes
        cores = [self.core] * 3
        if moist:
            mc = smooth_moist_coeff if smooth_moist_coeff is not None else smooth_coeff
            mcm = smooth_moist_coeff_max if smooth_moist_coeff_max is not None else mc
            self.core_moist = HorizontalSmoothing.factory(
                smooth_type, shape, mc, mcm, smooth_moist_damp_depth or 0, nb, **kw
            )
            cores += [self.core_moist] * 3
        self.cores = cores
        self.register_buffer("gamma", torch.stack([c.gamma for c in cores]))

    @property
    def input_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }
        if self.moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def diagnostic_properties(self):
        return dict(self.input_properties)

    def array_call(self, state):
        names = list(self.input_properties)
        if self.axes != "xy":
            smoothed = [core(state[n]) for n, core in zip(names, self.cores)]
        else:
            smoothed = fused_smoothing(
                [state[n] for n in names], self.gamma, order=self.order, nb=self.nb
            )
        hb = self.horizontal_boundary
        restricted = [hb.restrict_stencil_output(f, base=state[n], nb=self.nb)
                      for n, f in zip(names, smoothed)]
        return dict(zip(names, hb.refresh_halos_many(restricted, names)))
