"""The ``Domain``: physical grid + lateral boundary, which owns the numerical
grid (counterpart of ``tasmania_tpu/domain/domain.py``)."""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional

from tasmania_tpu_torch.domain.grid import PhysicalGrid
from tasmania_tpu_torch.domain.horizontal_boundary import HorizontalBoundary
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND


class Domain:
    def __init__(
        self,
        domain_x,
        nx: int,
        domain_y,
        ny: int,
        domain_z,
        nz: int,
        z_interface=None,
        horizontal_boundary_type: str = "relaxed",
        nb: int = 3,
        horizontal_boundary_kwargs: Optional[Dict[str, Any]] = None,
        topography_type: str = "flat",
        topography_kwargs: Optional[Dict[str, Any]] = None,
        *,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        self.physical_grid = PhysicalGrid(
            domain_x,
            nx,
            domain_y,
            ny,
            domain_z,
            nz,
            z_interface=z_interface,
            topography_type=topography_type,
            topography_kwargs=topography_kwargs,
            storage_options=storage_options,
        )
        self.horizontal_boundary = HorizontalBoundary.factory(
            horizontal_boundary_type,
            self.physical_grid,
            nb,
            backend=backend,
            backend_options=backend_options,
            storage_options=storage_options,
            **(horizontal_boundary_kwargs or {}),
        )

    @property
    def numerical_grid(self):
        return self.horizontal_boundary.numerical_grid

    def update_topography(self, time: timedelta) -> None:
        self.physical_grid.update_topography(time)
        self.numerical_grid.update_topography(time)
