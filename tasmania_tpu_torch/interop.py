"""Moving model state between numpy and the port.

This model has no learned weights: what a run starts from is its initial
state and its lateral-boundary reference state.  Both go through these two
functions, so a state made anywhere (for example by the JAX package) can be
handed to the port as plain arrays, and back.

A state's ``"time"`` is a ``datetime``.  Given ``time_origin``, the port
holds it instead as a float64 tensor of seconds from that origin on the
state's device (the form a CUDA graph of a step reads, see
``framework/field.add_seconds``), and gives it back as a ``datetime``.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray, field_dims


def state_from_numpy(
    arrays: Mapping[str, Tuple[np.ndarray, str]], device, dtype: torch.dtype,
    time_origin: Optional[datetime] = None,
) -> Dict[str, Any]:
    """``{name: (array, units)}`` -> a state of ``FieldArray`` tensors of
    ``dtype`` on ``device``; dimension labels follow from the field names.
    Any entry that is not a pair is passed through, but for ``"time"`` with
    ``time_origin``: its seconds from the origin, a float64 tensor."""
    state: Dict[str, Any] = {}
    for name, entry in arrays.items():
        if name == "time" and time_origin is not None:
            seconds = (entry - time_origin).total_seconds()
            state[name] = torch.tensor(seconds, dtype=torch.float64, device=device)
        elif not isinstance(entry, tuple):
            state[name] = entry
        else:
            arr, units = entry
            data = torch.tensor(np.asarray(arr), dtype=dtype, device=device)
            state[name] = FieldArray(data, units, field_dims(name))
    return state


def state_to_numpy(state: Mapping[str, Any], time_origin: Optional[datetime] = None) -> Dict[str, Any]:
    """A state -> ``{name: (array, units)}``, the inverse of
    :func:`state_from_numpy`; non-field entries are passed through, but a
    tensor ``"time"``, which becomes ``time_origin`` plus its seconds."""
    out: Dict[str, Any] = {}
    for name, fa in state.items():
        if isinstance(fa, FieldArray):
            out[name] = (fa.data.detach().cpu().numpy(), fa.units)
        elif name == "time" and isinstance(fa, torch.Tensor):
            if time_origin is None:
                raise ValueError("a tensor time needs the time_origin it counts from")
            out[name] = time_origin + timedelta(seconds=float(fa))
        else:
            out[name] = fa
    return out
