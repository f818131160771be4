"""The drawer base class (counterpart of ``tasmania_tpu/plot/drawer.py``)."""

from __future__ import annotations

import abc
from typing import Any, Dict, Mapping, Optional


class Drawer(abc.ABC):
    """Draws one layer of a visualization onto (fig, ax)."""

    def __init__(self, properties: Optional[Mapping[str, Any]] = None) -> None:
        self.properties: Dict[str, Any] = dict(properties or {})

    @abc.abstractmethod
    def __call__(self, state: Mapping[str, Any], fig, ax) -> None:
        """Render this drawer's content from ``state`` onto ``ax``."""
