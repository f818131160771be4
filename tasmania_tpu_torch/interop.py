"""Moving model state between numpy and the port.

This model has no learned weights: what a run starts from is its initial
state and its lateral-boundary reference state.  Both go through these two
functions, so a state made anywhere (for example by the JAX package) can be
handed to the port as plain arrays, and back.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray, field_dims


def state_from_numpy(
    arrays: Mapping[str, Tuple[np.ndarray, str]], device, dtype: torch.dtype
) -> Dict[str, Any]:
    """``{name: (array, units)}`` -> a state of ``FieldArray`` tensors of
    ``dtype`` on ``device``; dimension labels follow from the field names.
    Any entry that is not a pair (such as ``"time"``) is passed through."""
    state: Dict[str, Any] = {}
    for name, entry in arrays.items():
        if not isinstance(entry, tuple):
            state[name] = entry
            continue
        arr, units = entry
        data = torch.tensor(np.asarray(arr), dtype=dtype, device=device)
        state[name] = FieldArray(data, units, field_dims(name))
    return state


def state_to_numpy(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A state -> ``{name: (array, units)}``, the inverse of
    :func:`state_from_numpy`; non-field entries are passed through."""
    out: Dict[str, Any] = {}
    for name, fa in state.items():
        if isinstance(fa, FieldArray):
            out[name] = (fa.data.detach().cpu().numpy(), fa.units)
        else:
            out[name] = fa
    return out
