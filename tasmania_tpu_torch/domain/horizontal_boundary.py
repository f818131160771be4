"""Lateral boundary handling (counterpart of
``tasmania_tpu/domain/horizontal_boundary.py``).

A boundary is an ``nn.Module``: its coefficient matrices and its reference
state are registered buffers, so ``.to(device)`` moves all of them.  Its
methods are functional: they return new tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.units import conversion_factor, units_are_same


def change_dims(axis: FieldArray, dims: Optional[str] = None) -> FieldArray:
    return FieldArray(axis.data, axis.units, (dims,) if dims else axis.dims)


def repeat_axis(axis: FieldArray, nb: int, dims: Optional[str] = None) -> FieldArray:
    """A singleton axis (or its two-point staggered companion) padded by
    repeating its first and last values ``nb`` times."""
    v = np.asarray(axis.data)
    out = np.concatenate([np.repeat(v[:1], nb), v, np.repeat(v[-1:], nb)])
    return FieldArray(out.astype(v.dtype), axis.units, (dims,) if dims else axis.dims)


def field_extent(
    field_name: Optional[str], ni: int, nj: int, nz: int
) -> Tuple[int, int, int]:
    """Extent (mi, mj, mk) of a named field on the numerical grid."""
    name = field_name or ""
    mi = ni + 1 if ("at_u_locations" in name or "at_uv_locations" in name) else ni
    mj = nj + 1 if ("at_v_locations" in name or "at_uv_locations" in name) else nj
    mk = nz + 1 if "on_interface_levels" in name else nz
    return mi, mj, mk


class HorizontalBoundary(nn.Module):
    """Base class: physical grid, numerical grid and reference state."""

    def __init__(
        self, grid, nb: int, *, storage_options: Optional[StorageOptions] = None
    ) -> None:
        super().__init__()
        self.storage_options = storage_options or StorageOptions()
        self.physical_grid = grid
        self.nb = nb
        self.kwargs: Dict[str, Any] = {}
        self._ref_units: Dict[str, str] = {}
        from tasmania_tpu_torch.domain.grid import NumericalGrid

        self.numerical_grid = NumericalGrid(self)

    nx = property(lambda self: self.physical_grid.nx)
    ny = property(lambda self: self.physical_grid.ny)
    nz = property(lambda self: self.physical_grid.nz)

    @property
    def reference_state(self) -> Dict[str, FieldArray]:
        return {
            name: FieldArray(getattr(self, "ref_" + name), units)
            for name, units in self._ref_units.items()
        }

    @reference_state.setter
    def reference_state(self, state: Mapping[str, Any]) -> None:
        """Keep every tensor field of ``state`` as a buffer."""
        for name in self._ref_units:
            delattr(self, "ref_" + name)
        self._ref_units = {}
        for name, fa in state.items():
            if isinstance(fa, FieldArray) and isinstance(fa.data, torch.Tensor):
                self.register_buffer("ref_" + name, fa.data)
                self._ref_units[name] = fa.units

    def ref_field(self, field_name: str, field_units: Optional[str] = None):
        """The reference value of ``field_name`` in ``field_units``."""
        data = getattr(self, "ref_" + field_name)
        units = self._ref_units[field_name]
        if field_units is None or units_are_same(units, field_units):
            return data
        return data * conversion_factor(units, field_units)

    @staticmethod
    def factory(
        boundary_type: str,
        grid,
        nb: int,
        *,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> "HorizontalBoundary":
        from tasmania_tpu_torch.domain.boundaries.relaxed import Relaxed

        if boundary_type != "relaxed":
            raise NotImplementedError(
                f"horizontal boundary {boundary_type!r} is not ported (have 'relaxed')"
            )
        obj = Relaxed(grid, nb, storage_options=storage_options, **kwargs)
        obj.type = boundary_type
        return obj
