"""Diffusion tendencies of the Burgers velocities (counterpart of
``tasmania_tpu/burgers/physics/diffusion.py``): the horizontal diffusion
dwarf, with a constant coefficient, on both components."""

from __future__ import annotations

import numpy as np

from tasmania_tpu_torch.dwarfs.horizontal_diffusion import HorizontalDiffusion
from tasmania_tpu_torch.framework.core_components import TendencyComponent
from tasmania_tpu_torch.framework.field import FieldArray

DIMS = ("x", "y", "z")


class BurgersHorizontalDiffusion(TendencyComponent):
    """Submodule: the dwarf (``diffuser``), whose coefficient is a buffer."""

    def __init__(self, domain, grid_type: str = "numerical", diffusion_type: str = "second_order",
                 diffusion_coeff=None, **kwargs) -> None:
        super().__init__(domain, grid_type, **kwargs)
        g = self.grid.grid_xy
        dx = float(np.asarray(g.dx.to_units("m").data))
        dy = float(np.asarray(g.dy.to_units("m").data))
        if isinstance(diffusion_coeff, FieldArray):
            coeff = float(np.asarray(diffusion_coeff.to_units("m^2 s^-1").data))
        else:
            coeff = float(diffusion_coeff if diffusion_coeff is not None else 0.0)
        self.diffuser = HorizontalDiffusion.factory(
            diffusion_type, (g.nx, g.ny, 1), dx, dy, coeff, coeff, 0,
            nb=self.horizontal_boundary.nb, backend=self.backend, backend_options=self.backend_options,
            storage_options=self.storage_options,
        )

    @property
    def input_properties(self):
        return {"x_velocity": {"dims": DIMS, "units": "m s^-1"},
                "y_velocity": {"dims": DIMS, "units": "m s^-1"}}

    @property
    def tendency_properties(self):
        return {"x_velocity": {"dims": DIMS, "units": "m s^-2"},
                "y_velocity": {"dims": DIMS, "units": "m s^-2"}}

    def array_call(self, state):
        return {"x_velocity": self.diffuser(state["x_velocity"]),
                "y_velocity": self.diffuser(state["y_velocity"])}, {}
