"""Identity lateral boundary: the numerical grid is the physical grid and
enforcement leaves every field as it is (counterpart of
``tasmania_tpu/domain/boundaries/identity.py``)."""

from __future__ import annotations

from tasmania_tpu_torch.domain.horizontal_boundary import HorizontalBoundary, change_dims
from tasmania_tpu_torch.framework.registry import factor_register


@factor_register("identity")
class Identity(HorizontalBoundary):
    def __init__(self, grid, nb, storage_options=None, **kwargs):
        super().__init__(grid, nb, storage_options=storage_options, **kwargs)

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

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        return field

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        return field

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        return field
