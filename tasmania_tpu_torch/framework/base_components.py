"""Grid- and domain-aware component mixins (counterpart of
``tasmania_tpu/framework/base_components.py``): the shape of a staggered
field from its name, the domain and grid type, and the physical constants
with a user's overrides."""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from tasmania_tpu_torch.framework.field import field_shape
from tasmania_tpu_torch.utils.constants import get_physical_constants


class GridComponent:
    """A grid and the shape of a field on it."""

    def __init__(self, grid) -> None:
        self.grid = grid

    def get_field_shape(self, field_name: str) -> Tuple[int, int, int]:
        """The storage shape of ``field_name``, staggered as its name says."""
        g = self.grid
        return field_shape(field_name, (g.nx, g.ny, g.nz))


class DomainComponent(GridComponent):
    """A domain and the grid (numerical or physical) a component runs on."""

    allowed_grid_types = ("numerical", "physical")

    def __init__(self, domain, grid_type: str = "numerical") -> None:
        if grid_type not in self.allowed_grid_types:
            raise ValueError(f"grid_type must be one of {self.allowed_grid_types}, got {grid_type!r}")
        self.domain = domain
        self.grid_type = grid_type
        super().__init__(domain.numerical_grid if grid_type == "numerical" else domain.physical_grid)

    @property
    def horizontal_boundary(self):
        return self.domain.horizontal_boundary


class PhysicalConstantsComponent:
    """The class's default physical constants with a user's overrides, each
    a float in its default units (``rpc``)."""

    default_physical_constants: Dict[str, Any] = {}

    def __init__(self, physical_constants: Optional[Mapping[str, Any]] = None) -> None:
        self.rpc: Dict[str, float] = get_physical_constants(
            self.default_physical_constants, physical_constants
        )
