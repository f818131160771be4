"""Periodic lateral boundary (counterpart of
``tasmania_tpu/domain/boundaries/periodic.py``).

The numerical grid extends the physical one by ``nb`` layers on each side,
filled by the reference's index arithmetic: a period of ``n - 1`` points for
mass points, the east (north) ghosts shifted by one more for a staggered
field.  On a grid one cell deep in x (y) the ghosts repeat the physical
column (row).  The methods take a numpy array or a tensor and return a new
one of the same kind.
"""

from __future__ import annotations

import numpy as np

from tasmania_tpu_torch.domain.horizontal_boundary import (
    HorizontalBoundary,
    extend_axis,
    repeat_axis,
)
from tasmania_tpu_torch.framework.registry import factor_register


def _copy(field):
    return np.array(field, copy=True) if isinstance(field, np.ndarray) else field.clone()


@factor_register("periodic")
class Periodic(HorizontalBoundary):
    def __init__(self, grid, nb, storage_options=None, **kwargs):
        self.one_dx = grid.ny == 1
        self.one_dy = grid.nx == 1
        if not self.one_dy and nb > grid.nx / 2:
            raise ValueError("nb cannot exceed nx/2")
        if not self.one_dx and nb > grid.ny / 2:
            raise ValueError("nb cannot exceed ny/2")
        super().__init__(grid, nb, storage_options=storage_options, **kwargs)

    ni = property(lambda self: self.nx + 2 * self.nb)
    nj = property(lambda self: self.ny + 2 * self.nb)

    def _axis(self, axis, one_d, dims):
        return (repeat_axis if one_d else extend_axis)(axis, self.nb, dims)

    def get_numerical_xaxis(self, dims=None):
        return self._axis(self.physical_grid.x, self.one_dy, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return self._axis(self.physical_grid.x_at_u_locations, self.one_dy, dims)

    def get_numerical_yaxis(self, dims=None):
        return self._axis(self.physical_grid.y, self.one_dx, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        return self._axis(self.physical_grid.y_at_v_locations, self.one_dx, dims)

    def get_numerical_field(self, field, field_name=None):
        nb = self.nb
        shape = (field.shape[0] + 2 * nb, field.shape[1] + 2 * nb) + tuple(field.shape[2:])
        if isinstance(field, np.ndarray):
            out = np.zeros(shape, dtype=field.dtype)
        else:
            out = field.new_zeros(shape)
        out[nb:-nb, nb:-nb] = field
        return self.enforce_field(out, field_name)

    def get_physical_field(self, field, field_name=None):
        nb = self.nb
        return field[nb:-nb, nb:-nb]

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        nx, ny, nb = self.nx, self.ny, self.nb
        name = field_name or ""
        mx = nx + 1 if ("at_u_locations" in name or "at_uv_locations" in name) else nx
        my = ny + 1 if ("at_v_locations" in name or "at_uv_locations" in name) else ny
        mi = mx + 2 * nb
        jy = slice(nb, my + nb)
        out = _copy(field)
        # west ghosts from the east interior, east ghosts from the west one
        # (each source lies apart from its target)
        if not self.one_dy:
            out[:nb, jy] = out[nx - 1 : nx - 1 + nb, jy]
            east = nb + 1 if mx == nx else nb + 2
            out[mx + nb : mx + 2 * nb, jy] = out[east : east + nb, jy]
        else:
            out[:nb, jy] = out[nb : nb + 1, jy]
            east = nb if mx == nx else nb + 1
            out[mx + nb : mx + 2 * nb, jy] = out[east : east + 1, jy]
        if not self.one_dx:
            out[:mi, :nb] = out[:mi, ny - 1 : ny - 1 + nb]
            north = nb + 1 if my == ny else nb + 2
            out[:mi, my + nb : my + 2 * nb] = out[:mi, north : north + nb]
        else:
            out[:mi, :nb] = out[:mi, nb : nb + 1]
            north = nb if my == ny else nb + 1
            out[:mi, my + nb : my + 2 * nb] = out[:mi, north : north + 1]
        return out

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        out = _copy(field)
        out[:1] = out[-2:-1]
        out[-1:] = out[1:2]
        return out

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        out = _copy(field)
        out[:, :1] = out[:, -2:-1]
        out[:, -1:] = out[:, 1:2]
        return out
