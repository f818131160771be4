"""Offline metrics between two states (counterpart of
``tasmania_tpu/framework/offline_diagnostics.py``): the root-mean-square
deviation, its relative form and a column sum, each computed on the host
with numpy from the fields in the requested units (a tensor on the card is
copied to the host first)."""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.utils.array import to_numpy


def _get(state, name, units, sx, sy, sz):
    fa = state[name]
    arr = to_numpy(fa.to_units(units).data if isinstance(fa, FieldArray) else fa)
    return arr[sx or slice(None), sy or slice(None), sz or slice(None)]


class OfflineDiagnosticComponent:
    """Callable on two states; returns {name: the metric's value}."""

    def __call__(self, state1, state2) -> Dict[str, float]:
        raise NotImplementedError


class _PairMetric(OfflineDiagnosticComponent):
    """A metric of each named field over the slices ``x``, ``y``, ``z``."""

    def __init__(self, grid, fields: Mapping[str, Mapping[str, Any]], x=None, y=None, z=None):
        self._fields = fields
        self._x, self._y, self._z = x, y, z

    def __call__(self, state1, state2) -> Dict[str, float]:
        out = {}
        for name, props in self._fields.items():
            u = props.get("units", "1")
            out[name] = self._metric(_get(state1, name, u, self._x, self._y, self._z),
                                     _get(state2, name, u, self._x, self._y, self._z))
        return out


class RMSD(_PairMetric):
    """The root-mean-square deviation."""

    @staticmethod
    def _metric(a, b) -> float:
        return float(np.sqrt(np.mean((a - b) ** 2)))


class RRMSD(_PairMetric):
    """The root-mean-square deviation relative to the second state's norm
    (0 where that is 0)."""

    @staticmethod
    def _metric(a, b) -> float:
        denom = np.sqrt(np.sum(b**2))
        return float(np.sqrt(np.sum((a - b) ** 2)) / denom) if denom else 0.0


class ColumnSum(OfflineDiagnosticComponent):
    """The vertical sum of one field in each column."""

    def __init__(self, grid, field_name: str, field_units: str):
        self._name = field_name
        self._units = field_units

    def __call__(self, state, state2=None) -> np.ndarray:
        fa = state[self._name]
        return to_numpy(fa.to_units(self._units).data if isinstance(fa, FieldArray) else fa).sum(axis=2)
