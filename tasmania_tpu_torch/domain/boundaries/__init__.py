"""The lateral boundaries, each registered on ``HorizontalBoundary`` by its
name (``"dirichlet"``, ``"identity"``, ``"periodic"``, ``"relaxed"``)."""

from tasmania_tpu_torch.domain.boundaries.dirichlet import Dirichlet
from tasmania_tpu_torch.domain.boundaries.identity import Identity
from tasmania_tpu_torch.domain.boundaries.periodic import Periodic
from tasmania_tpu_torch.domain.boundaries.relaxed import Relaxed

__all__ = ["Dirichlet", "Identity", "Periodic", "Relaxed"]
