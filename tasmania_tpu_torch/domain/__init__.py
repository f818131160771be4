from tasmania_tpu_torch.domain import boundaries  # noqa: F401  (register the boundaries)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.domain.grid import Grid, NumericalGrid, PhysicalGrid
from tasmania_tpu_torch.domain.horizontal_boundary import HorizontalBoundary
from tasmania_tpu_torch.domain.horizontal_grid import (
    HorizontalGrid,
    NumericalHorizontalGrid,
    PhysicalHorizontalGrid,
)
from tasmania_tpu_torch.domain.topography import (
    NumericalTopography,
    PhysicalTopography,
    Topography,
)

__all__ = [
    "Domain",
    "Grid",
    "NumericalGrid",
    "PhysicalGrid",
    "HorizontalBoundary",
    "HorizontalGrid",
    "NumericalHorizontalGrid",
    "PhysicalHorizontalGrid",
    "NumericalTopography",
    "PhysicalTopography",
    "Topography",
]
