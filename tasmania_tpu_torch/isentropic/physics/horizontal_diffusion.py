"""Horizontal diffusion tendencies of the isentropic prognostic fields
(counterpart of ``tasmania_tpu/isentropic/physics/horizontal_diffusion.py``):
a tendency component that applies the diffusion dwarf to s, su and sv and,
when moist, with coefficients of its own to the three mass fractions.  On a
shard of a 2-D decomposition the tendencies are zero on the global frame and
their halos refreshed in one exchange (``:125-127`` of the JAX component;
identities on a single device)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from tasmania_tpu_torch.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_tpu_torch.framework.core_components import TendencyComponent
from tasmania_tpu_torch.framework.field import FieldArray

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DRY = {
    "air_isentropic_density": "kg m^-2 K^-1",
    "x_momentum_isentropic": "kg m^-1 K^-1 s^-1",
    "y_momentum_isentropic": "kg m^-1 K^-1 s^-1",
}


def _coeff(value, default=0.0) -> float:
    """A coefficient given as a number or, as the JAX component takes it, a
    ``FieldArray`` in s^-1."""
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units("s^-1").data))
    return float(value if value is not None else default)


class IsentropicHorizontalDiffusion(TendencyComponent):
    def __init__(
        self,
        domain,
        diffusion_type: str = "second_order",
        diffusion_coeff=None,
        diffusion_coeff_max=None,
        diffusion_damp_depth: int = 0,
        moist: bool = False,
        diffusion_moist_coeff=None,
        diffusion_moist_coeff_max=None,
        diffusion_moist_damp_depth: Optional[int] = None,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self.moist = moist
        g, nb = self.grid, self.horizontal_boundary.nb
        kw = dict(backend=self.backend, backend_options=self.backend_options,
                  storage_options=self.storage_options)
        shape = (g.nx, g.ny, g.nz)
        dx = float(np.asarray(g.dx.to_units("m").data))
        dy = float(np.asarray(g.dy.to_units("m").data))
        coeff = _coeff(diffusion_coeff, 0.0)
        self.core = HorizontalDiffusion.factory(
            diffusion_type, shape, dx, dy, coeff, _coeff(diffusion_coeff_max, coeff),
            diffusion_damp_depth, nb, **kw
        )
        if moist:
            mcoeff = _coeff(diffusion_moist_coeff, coeff)
            self.core_moist = HorizontalDiffusion.factory(
                diffusion_type, shape, dx, dy, mcoeff, _coeff(diffusion_moist_coeff_max, mcoeff),
                diffusion_moist_damp_depth or 0, nb, **kw
            )

    @property
    def input_properties(self):
        props = {n: {"dims": DIMS, "units": u} for n, u in DRY.items()}
        if self.moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def tendency_properties(self):
        props = {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            "x_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            "y_momentum_isentropic": {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }
        if self.moist:
            for q in (mfwv, mfcw, mfpw):
                props[q] = {"dims": DIMS, "units": "g g^-1 s^-1"}
        return props

    def array_call(self, state):
        tends = {n: self.core(state[n]) for n in DRY}
        if self.moist:
            tends.update({q: self.core_moist(state[q]) for q in (mfwv, mfcw, mfpw)})
        hb = self.horizontal_boundary
        names = list(tends)
        restricted = [hb.restrict_stencil_output(tends[n], nb=self.core.nb) for n in names]
        return dict(zip(names, hb.refresh_halos_many(restricted, names))), {}
