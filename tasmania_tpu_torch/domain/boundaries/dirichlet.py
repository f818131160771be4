"""Dirichlet lateral boundary (counterpart of
``tasmania_tpu/domain/boundaries/dirichlet.py``): the nb-wide frame is
pinned to the values of a ``core`` callable,
``core(time, grid, slice_x, slice_y, field_name, field_units)``, evaluated
over each of the four bands at the state's time.

A core may return a numpy array, which is copied to the field's device, or
a tensor.  A core that computes a tensor on the device from a tensor
``time`` (seconds from the run's initial time, see
``framework/field.add_seconds``) can run inside a CUDA graph of the step,
where a copy from the host cannot: ``burgers.state.ZhaoSolutionFactory`` is
one.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from tasmania_tpu_torch.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    field_extent,
)
from tasmania_tpu_torch.framework.registry import factor_register


def placeholder(time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
    """The default core: zero boundary values."""
    sx = slice_x or slice(0, None)
    sy = slice_y or slice(0, None)
    mi = len(np.asarray(grid.x.data)[sx]) if sx.stop is None else sx.stop - (sx.start or 0)
    mj = len(np.asarray(grid.y.data)[sy]) if sy.stop is None else sy.stop - (sy.start or 0)
    return np.zeros((mi, mj, 1))


class ArrayCore:
    """A time-independent core: the frame pinned to given host arrays
    (``values``: field name -> numpy array on the numerical grid, in the
    units the boundary is enforced in)."""

    def __init__(self, values):
        self.values = values

    def __call__(self, time, grid, slice_x=None, slice_y=None, field_name=None, field_units=None):
        return self.values[field_name][slice_x or slice(None), slice_y or slice(None)]


@factor_register("dirichlet")
class Dirichlet(HorizontalBoundary):
    def __init__(self, grid, nb, storage_options=None, core=placeholder, **kwargs):
        self.one_dx = grid.ny == 1
        self.one_dy = grid.nx == 1
        if not self.one_dy and nb > grid.nx / 2:
            raise ValueError("nb cannot exceed nx/2")
        if not self.one_dx and nb > grid.ny / 2:
            raise ValueError("nb cannot exceed ny/2")
        params = tuple(inspect.signature(core).parameters)
        if params[:2] != ("time", "grid"):
            raise ValueError("the core's signature must be core(time, grid, slice_x=None, "
                             "slice_y=None, field_name=None, field_units=None)")
        super().__init__(grid, nb, storage_options=storage_options, **kwargs)
        self.kwargs["core"] = core

    ni = property(lambda self: self.nx)
    nj = property(lambda self: self.ny)

    def get_numerical_xaxis(self, dims=None):
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    def get_numerical_field(self, field, field_name=None):
        return field

    def get_physical_field(self, field, field_name=None):
        return field

    def _paste_bands(self, field, bands, name, units, time):
        """A copy of ``field`` with each (slice_x, slice_y) band set to the
        core's values there, broadcast over the field's levels."""
        core = self.kwargs["core"]
        out = field.clone()
        for sx, sy in bands:
            vals = torch.as_tensor(core(time, self.numerical_grid, sx, sy, name, units),
                                   dtype=field.dtype, device=field.device)
            if field.dim() == 3 and vals.dim() == 2:
                vals = vals[:, :, None]
            out[sx, sy] = vals
        return out

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        nb = self.nb
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        bands = []
        if not self.one_dy:
            bands += [(slice(0, nb), slice(0, mj)), (slice(mi - nb, mi), slice(0, mj))]
        if not self.one_dx:
            bands += [(slice(nb, mi - nb), slice(0, nb)), (slice(nb, mi - nb), slice(mj - nb, mj))]
        return self._paste_bands(field, bands, field_name, field_units, time)

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        bands = [(slice(0, 1), slice(0, mj)), (slice(mi - 1, mi), slice(0, mj))]
        return self._paste_bands(field, bands, field_name, field_units, time)

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        bands = [(slice(0, mi), slice(0, 1)), (slice(0, mi), slice(mj - 1, mj))]
        return self._paste_bands(field, bands, field_name, field_units, time)
