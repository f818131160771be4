"""Horizontal smoothing of the isentropic prognostic fields (counterpart of
``tasmania_tpu/isentropic/physics/horizontal_smoothing.py``, its fused path
``:116-142``): a diagnostic component that overwrites s, su, sv (and the
moist species) with their Shapiro-filtered values, all fields in one call of
``ops/smoothing_step.fused_smoothing``."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tasmania_tpu_torch.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_tpu_torch.framework.core_components import DiagnosticComponent
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")


class IsentropicHorizontalSmoothing(DiagnosticComponent):
    """Buffer: the per-(field, z) coefficient ``gamma`` (F, nz)."""

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
        nz, nb = self.grid.nz, self.horizontal_boundary.nb
        dtype = self.storage_options.np_dtype
        cmax = smooth_coeff_max if smooth_coeff_max is not None else smooth_coeff
        core = HorizontalSmoothing(
            smooth_type, nz, smooth_coeff, cmax, smooth_damp_depth, nb, dtype
        )
        self.order, self.nb = core.order, core.nb
        gammas = [core.gamma] * 3
        if moist:
            mc = smooth_moist_coeff if smooth_moist_coeff is not None else smooth_coeff
            mcm = smooth_moist_coeff_max if smooth_moist_coeff_max is not None else mc
            moist_core = HorizontalSmoothing(
                smooth_type, nz, mc, mcm, smooth_moist_damp_depth or 0, nb, dtype
            )
            gammas += [moist_core.gamma] * 3
        so = self.storage_options
        self.register_buffer(
            "gamma", torch.as_tensor(np.stack(gammas), dtype=so.dtype, device=so.device)
        )

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
        smoothed = fused_smoothing(
            [state[n] for n in names], self.gamma, order=self.order, nb=self.nb
        )
        return dict(zip(names, smoothed))
