"""Backend, storage and time-integration options (counterpart of
``tasmania_tpu/framework/options.py``).

PyTorch runs eagerly, and the device a tensor lies on decides between a
kernel and its plain version: no backend name and no backend option chooses
between them.  ``BackendOptions`` keeps the JAX package's fields so that
user code ports unchanged; its ``externals`` are bound into a stencil as
there, and ``jit`` and ``donate`` wrap nothing (the port's compiled unit is
a step's CUDA graph, ``utils/jitx.py``)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch


@dataclasses.dataclass
class BackendOptions:
    """Compile-time options of a stencil: ``externals`` are keyword
    constants bound into each definition that declares them."""

    dtypes: Optional[Mapping[str, Any]] = None
    externals: Dict[str, Any] = dataclasses.field(default_factory=dict)
    jit: bool = True
    donate: bool = False
    validate_args: bool = False
    exec_info: Optional[Dict[str, Any]] = None


@dataclasses.dataclass
class StorageOptions:
    """Type and device of every tensor a component allocates."""

    dtype: torch.dtype = torch.float64
    device: torch.device | str = "cuda"

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
    backend: str = "torch"
    backend_options: Optional[BackendOptions] = None
    storage_options: Optional[StorageOptions] = None
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
