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
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.utils.units import conversion_factor, units_are_same


#: the boundaries the port registers (``domain/boundaries``)
BUILT_IN = ("dirichlet", "identity", "periodic", "relaxed")


def change_dims(axis: FieldArray, dims: Optional[str] = None) -> FieldArray:
    return FieldArray(axis.data, axis.units, (dims,) if dims else axis.dims)


def extend_axis(axis: FieldArray, nb: int, dims: Optional[str] = None) -> FieldArray:
    """A coordinate axis extended linearly by ``nb`` points on each side."""
    v = np.asarray(axis.data)
    d = v[1] - v[0] if v.shape[0] > 1 else 1.0
    left = v[0] - d * np.arange(nb, 0, -1)
    right = v[-1] + d * np.arange(1, nb + 1)
    out = np.concatenate([left, v, right]).astype(v.dtype)
    return FieldArray(out, axis.units, (dims,) if dims else axis.dims)


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


class HorizontalBoundary(nn.Module, StencilFactory):
    """Base class: physical grid, numerical grid and reference state.
    Factory base of the boundaries: ``HorizontalBoundary.factory("relaxed",
    grid, nb, nr=6)``; a subclass registers under a name
    (``@factor_register``)."""

    registry: Dict[str, Any] = {}

    def __init__(
        self,
        grid,
        nb: int,
        *,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self.physical_grid = grid
        self.type = getattr(type(self), "registry_name", "")
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

    def enforce_raw(
        self, state: Mapping[str, Any], field_properties: Optional[Mapping[str, Mapping[str, Any]]] = None
    ) -> Dict[str, Any]:
        """``state`` (raw tensors) with the boundary enforced on each field
        that the reference state holds, in the units of ``field_properties``
        (default: the reference's), at the state's ``"time"``."""
        fps = {n: {"units": u} for n, u in self._ref_units.items()}
        if field_properties is not None:
            fps = {n: {**fps[n], **p} for n, p in field_properties.items() if n in fps}
        time = state.get("time")
        return {
            name: self.enforce_field(f, name, fps[name]["units"], time=time)
            if name in fps and name != "time" else f
            for name, f in state.items()
        }

    # -- distribution hooks (``horizontal_boundary.py:265-300`` of the JAX
    # package): the seams where a shard's boundary
    # (``parallel/distributed.DistributedBoundary``) exchanges halos and masks
    # the global frame; on a single device they change nothing, so the
    # components call them unconditionally.

    #: one shard without a ring, i.e. a single device
    is_degenerate = True

    def refresh_halos(self, field, field_name: Optional[str] = None):
        """The halo rings of a stencil output from the neighbours: identity."""
        return field

    def refresh_halos_many(self, fields, field_names=None):
        return list(fields)

    def restrict_stencil_output(self, out, base=None, nb: Optional[int] = None, field_name=None):
        """A stencil output kept only at least nb cells from the global
        edges: identity, since the stencil writes only there."""
        return out

    def zero_physical_frame(self, full, nb: int, field_name=None):
        """``full`` with its nb-wide frame zeroed."""
        out = torch.zeros_like(full)
        out[nb : full.shape[0] - nb, nb : full.shape[1] - nb] = full[
            nb : full.shape[0] - nb, nb : full.shape[1] - nb
        ]
        return out

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
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> "HorizontalBoundary":
        import tasmania_tpu_torch.domain.boundaries  # noqa: F401  (registers the built-in four)

        child_kwargs = {"backend": backend, "backend_options": backend_options,
                        "storage_options": storage_options, **kwargs}
        obj = factorize(boundary_type, HorizontalBoundary, (grid, nb), child_kwargs)
        obj.type = boundary_type
        return obj

    @property
    def family(self) -> str:
        """The name of the built-in boundary this one is or derives from
        (``"relaxed"`` for a subclass of ``Relaxed`` registered under
        another name), else its own name."""
        for cls in type(self).__mro__:
            name = cls.__dict__.get("registry_name")
            if name in BUILT_IN:
                return name
        return self.type
