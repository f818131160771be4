"""Two-dimensional horizontal grids with staggered axes (counterpart of
``tasmania_tpu/domain/horizontal_grid.py``).  Coordinates are host-side numpy
wrapped in ``FieldArray``; device fields carry only shapes."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions

Interval = Union[FieldArray, Tuple[float, float]]


def make_interval(
    interval: Interval, default_units: str = "m", default_dims: str = "x"
) -> FieldArray:
    """Normalise an axis interval spec to a 2-item ``FieldArray``."""
    if isinstance(interval, FieldArray):
        return interval
    lo, hi = interval
    return FieldArray(np.array([lo, hi], dtype=float), default_units, (default_dims,))


def _axis(values: np.ndarray, units: str, dims: str) -> FieldArray:
    return FieldArray(values, units, (dims,))


class HorizontalGrid:
    """Rectilinear 2-D grid: mass axes, u/v staggered axes and spacings."""

    def __init__(
        self,
        x: FieldArray,
        y: FieldArray,
        x_at_u_locations: Optional[FieldArray] = None,
        y_at_v_locations: Optional[FieldArray] = None,
    ) -> None:
        self.x = x
        self.y = y
        xv, yv = np.asarray(x.data), np.asarray(y.data)
        self.nx, self.ny = xv.shape[0], yv.shape[0]

        dx_v = (xv[-1] - xv[0]) / (self.nx - 1) if self.nx > 1 else 1.0
        dx_v = 1.0 if dx_v == 0.0 else dx_v
        dy_v = (yv[-1] - yv[0]) / (self.ny - 1) if self.ny > 1 else 1.0
        dy_v = 1.0 if dy_v == 0.0 else dy_v
        self.dx = FieldArray(np.asarray(dx_v), x.units, ())
        self.dy = FieldArray(np.asarray(dy_v), y.units, ())

        if x_at_u_locations is None:
            xu = np.linspace(xv[0] - 0.5 * dx_v, xv[-1] + 0.5 * dx_v, self.nx + 1)
            x_at_u_locations = _axis(
                xu.astype(xv.dtype), x.units, x.dims[0] + "_at_u_locations"
            )
        if y_at_v_locations is None:
            yvs = np.linspace(yv[0] - 0.5 * dy_v, yv[-1] + 0.5 * dy_v, self.ny + 1)
            y_at_v_locations = _axis(
                yvs.astype(yv.dtype), y.units, y.dims[0] + "_at_v_locations"
            )
        self.x_at_u_locations = x_at_u_locations
        self.y_at_v_locations = y_at_v_locations


class PhysicalHorizontalGrid(HorizontalGrid):
    """Horizontal grid built from axis intervals."""

    def __init__(
        self,
        domain_x: Interval,
        nx: int,
        domain_y: Interval,
        ny: int,
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        dtype = (storage_options or StorageOptions()).np_dtype
        dom_x = make_interval(domain_x, "m", "x")
        dom_y = make_interval(domain_y, "m", "y")
        xv = np.asarray(dom_x.data, dtype=dtype)
        yv = np.asarray(dom_y.data, dtype=dtype)

        def axis_values(v, n):
            if n > 1:
                return np.linspace(v[0], v[1], n, dtype=dtype)
            return np.array([0.5 * (v[0] + v[1])], dtype=dtype)

        super().__init__(
            _axis(axis_values(xv, nx), dom_x.units, dom_x.dims[0]),
            _axis(axis_values(yv, ny), dom_y.units, dom_y.dims[0]),
        )


class NumericalHorizontalGrid(HorizontalGrid):
    """Horizontal grid spanned by a boundary's numerical axes."""

    def __init__(self, boundary) -> None:
        super().__init__(
            boundary.get_numerical_xaxis(),
            boundary.get_numerical_yaxis(),
            boundary.get_numerical_xaxis_staggered(),
            boundary.get_numerical_yaxis_staggered(),
        )
