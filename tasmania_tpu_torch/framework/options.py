"""Storage and time-integration options (counterpart of
``tasmania_tpu/framework/options.py``).

The port has no backend or compile options: PyTorch runs eagerly, and the
device a tensor lies on decides between a kernel and its plain version."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass
class StorageOptions:
    """Type and device of every tensor a component allocates."""

    dtype: torch.dtype = torch.float64
    device: torch.device | str = "cpu"

    @property
    def np_dtype(self):
        """The numpy type of ``dtype``, for host-side construction."""
        return torch.empty((), dtype=self.dtype).numpy().dtype


@dataclasses.dataclass
class TimeIntegrationOptions:
    """A component and how a splitting integrates it: ``scheme`` names a
    stepper (``"forward_euler"``, ``"rk2"``, ``"rk3ws"``) or is ``None`` for a
    component whose diagnostics alone feed the state."""

    component: Any = None
    scheme: Optional[str] = None
    enforce_horizontal_boundary: bool = False
    substeps: int = 1
