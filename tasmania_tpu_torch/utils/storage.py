"""State-level storage helpers (counterpart of
``tasmania_tpu/utils/storage.py``): a state mapped between the physical and
the numerical grid through the domain's boundary, and deep copies."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray


def _map_fields(state: Mapping[str, Any], fn) -> Dict[str, Any]:
    return {
        name: fa.with_data(fn(fa.data, name)) if name != "time" and isinstance(fa, FieldArray) else fa
        for name, fa in state.items()
    }


def get_numerical_state(domain, state: Mapping[str, Any]) -> Dict[str, Any]:
    """A physical-grid state on the numerical grid."""
    return _map_fields(state, domain.horizontal_boundary.get_numerical_field)


def get_physical_state(domain, state: Mapping[str, Any]) -> Dict[str, Any]:
    """A numerical-grid state back on the physical grid."""
    return _map_fields(state, domain.horizontal_boundary.get_physical_field)


def deepcopy_state(state: Mapping[str, Any]) -> Dict[str, Any]:
    """A deep copy of a state: each tensor cloned on its device, each host
    array copied."""
    def copy(data):
        return data.clone() if isinstance(data, torch.Tensor) else np.array(data, copy=True)

    return {name: fa.with_data(copy(fa.data)) if isinstance(fa, FieldArray) else fa
            for name, fa in state.items()}
