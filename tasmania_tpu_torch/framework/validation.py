"""Runtime checks for debugging (counterpart of
``tasmania_tpu/framework/validation.py``): raise on non-finite values.

The JAX package's ``checked`` instruments a traced function with
``jax.experimental.checkify``, which checks every intermediate operation
(floating-point errors and out-of-bounds indexing) and raises where the
first one failed.  PyTorch has no such instrumentation: the port's
``checked`` runs the function as it is and then sweeps its outputs, so it
sees a NaN or an infinity only where it reaches an output (an intermediate
value that an output no longer carries goes unseen), names the output and
not the operation, and checks no index (PyTorch itself raises on an
out-of-bounds index, on the CPU; on the card a kernel's fault surfaces as a
CUDA error).  The sweep copies a count to the host, so it waits for the
device: drivers run unwrapped.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray


def _leaves(tree, path: str = "") -> List[Tuple[str, Any]]:
    """The arrays of a nest of dicts, lists and tuples (``FieldArray``s by
    their data), each with its path."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in _leaves(v, f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree) for leaf in _leaves(v, f"{path}[{i}]")]
    if isinstance(tree, FieldArray):
        tree = tree.data
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return [(path or "output", tree)]
    return []


def assert_all_finite(tree, names: Sequence[str] = ()) -> None:
    """Raise ``FloatingPointError`` naming the first array of ``tree`` (a
    tensor, an array, a ``FieldArray`` or a nest of them) that holds a NaN
    or an infinity; ``names`` label the arrays in order."""
    for i, (path, arr) in enumerate(_leaves(tree)):
        if isinstance(arr, torch.Tensor):
            bad = int((~torch.isfinite(arr)).sum()) if arr.is_floating_point() else 0
        else:
            bad = int(np.size(arr) - np.isfinite(arr).sum()) if np.issubdtype(arr.dtype, np.inexact) else 0
        if bad:
            label = names[i] if i < len(names) else path
            raise FloatingPointError(f"{label}: {bad} non-finite values")


def checked(fn: Callable) -> Callable:
    """``fn`` wrapped so that each call raises ``FloatingPointError`` if an
    output holds a NaN or an infinity (see the module's docstring for what
    this sees and ``checkify`` sees besides)."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_all_finite(out)
        return out

    return wrapper
