"""Backend-dispatched allocation (counterpart of
``tasmania_tpu/framework/allocators.py``).

The ``"numpy"`` backend allocates host arrays (the oracle); every other
backend (``"torch"`` and the JAX names that map to it) allocates tensors of
``StorageOptions.dtype`` on ``StorageOptions.device``.  ``empty`` returns
zeros, as in the JAX package: a deterministic start is worth more than the
memset.  ``dtype`` may be a torch or a numpy type.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.options import StorageOptions


def _on_host(backend: str) -> bool:
    return backend.startswith("numpy")


def _torch_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _numpy_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype if isinstance(dtype, torch.dtype) else np.dtype(dtype)


def zeros(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    if _on_host(backend):
        return np.zeros(shape, dtype=_numpy_dtype(so.dtype))
    return torch.zeros(shape, dtype=_torch_dtype(so.dtype), device=so.device)


def ones(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    if _on_host(backend):
        return np.ones(shape, dtype=_numpy_dtype(so.dtype))
    return torch.ones(shape, dtype=_torch_dtype(so.dtype), device=so.device)


def empty(backend: str, shape: Tuple[int, ...], *, storage_options: Optional[StorageOptions] = None):
    return zeros(backend, shape, storage_options=storage_options)


def as_storage(backend: str, data: Any, *, storage_options: Optional[StorageOptions] = None):
    so = storage_options or StorageOptions()
    if _on_host(backend):
        host = data.detach().cpu().numpy() if isinstance(data, torch.Tensor) else data
        return np.asarray(host, dtype=_numpy_dtype(so.dtype))
    return torch.as_tensor(data, dtype=_torch_dtype(so.dtype), device=so.device)
