"""Array helpers (counterpart of ``tasmania_tpu/utils/array.py``)."""

from __future__ import annotations

import numpy as np
import torch


def get_namespace(x):
    """``numpy`` for host arrays and scalars, ``torch`` otherwise: the
    namespace one definition uses to serve both."""
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np
    return torch


def to_numpy(x) -> np.ndarray:
    """Any array or tensor as a host numpy array (a tensor on the card is
    copied to the host, which waits for the device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
