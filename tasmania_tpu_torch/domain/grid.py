"""Three-dimensional grids, physical and numerical (counterpart of
``tasmania_tpu/domain/grid.py``).  Vertical levels run top -> surface; the
ported vertical coordinate is potential temperature (θ)."""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional

import numpy as np

from tasmania_tpu_torch.domain.horizontal_grid import (
    HorizontalGrid,
    Interval,
    NumericalHorizontalGrid,
    PhysicalHorizontalGrid,
    make_interval,
)
from tasmania_tpu_torch.domain.topography import (
    NumericalTopography,
    PhysicalTopography,
    Topography,
)
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions


class Grid:
    """Horizontal grid + vertical levels + topography."""

    def __init__(
        self,
        grid_xy: HorizontalGrid,
        z: FieldArray,
        z_on_interface_levels: FieldArray,
        z_interface: FieldArray,
        topography: Topography,
    ) -> None:
        self.grid_xy = grid_xy
        self.z = z
        self.z_on_interface_levels = z_on_interface_levels
        self.z_interface = z_interface
        self.topography = topography
        self.nz = int(np.asarray(z.data).shape[0])
        zhl_v = np.asarray(z_on_interface_levels.data)
        dz_v = abs(float(zhl_v[0]) - float(zhl_v[-1])) / self.nz
        self.dz = FieldArray(np.asarray(1.0 if dz_v == 0.0 else dz_v), z.units, ())

    nx = property(lambda self: self.grid_xy.nx)
    ny = property(lambda self: self.grid_xy.ny)
    dx = property(lambda self: self.grid_xy.dx)
    dy = property(lambda self: self.grid_xy.dy)
    x = property(lambda self: self.grid_xy.x)
    y = property(lambda self: self.grid_xy.y)
    x_at_u_locations = property(lambda self: self.grid_xy.x_at_u_locations)
    y_at_v_locations = property(lambda self: self.grid_xy.y_at_v_locations)

    def update_topography(self, time: timedelta) -> None:
        self.topography.update(time)


class PhysicalGrid(Grid):
    """Grid over the physical domain, built from axis intervals."""

    def __init__(
        self,
        domain_x: Interval,
        nx: int,
        domain_y: Interval,
        ny: int,
        domain_z: Interval,
        nz: int,
        z_interface: Optional[FieldArray] = None,
        topography_type: str = "flat",
        topography_kwargs: Optional[Dict[str, Any]] = None,
        *,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        so = storage_options or StorageOptions()
        grid_xy = PhysicalHorizontalGrid(domain_x, nx, domain_y, ny, storage_options=so)

        dom_z = make_interval(domain_z, "K", "z")
        values_z = np.asarray(dom_z.data, dtype=so.np_dtype)
        dim_z = dom_z.dims[0]
        zhl_v = np.linspace(values_z[0], values_z[1], nz + 1, dtype=so.np_dtype)
        zhl = FieldArray(zhl_v, dom_z.units, (dim_z + "_on_interface_levels",))
        z = FieldArray(0.5 * (zhl_v[:-1] + zhl_v[1:]), dom_z.units, (dim_z,))

        if z_interface is None:
            zi = FieldArray(np.asarray(values_z[0]), dom_z.units, ())
        else:
            zi = z_interface.to_units(dom_z.units)
        zi_v = float(np.asarray(zi.data))
        lo, hi = sorted((float(values_z[0]), float(values_z[1])))
        if not lo <= zi_v <= hi:
            raise ValueError(f"z_interface should be in the range ({lo}, {hi}).")

        topo = PhysicalTopography.factory(topography_type, grid_xy, **(topography_kwargs or {}))
        super().__init__(grid_xy, z, zhl, zi, topo)


class NumericalGrid(Grid):
    """Grid over the numerical domain spanned by a boundary."""

    def __init__(self, boundary) -> None:
        phys = boundary.physical_grid
        super().__init__(
            NumericalHorizontalGrid(boundary),
            phys.z,
            phys.z_on_interface_levels,
            phys.z_interface,
            NumericalTopography(boundary),
        )
