"""Units-aware field container (counterpart of ``tasmania_tpu/framework/field.py``).

A ``FieldArray`` pairs an array with its units and dimension labels.  Model
state lives in ``torch.Tensor`` data on the model's device; grid coordinates
stay host-side numpy, as in the reference package.
"""

from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Any, Dict, Mapping, Tuple, Union

import torch

from tasmania_tpu_torch.utils.units import conversion_factor, units_are_same

DimNames = Tuple[str, ...]

#: a field whose *name* contains the key is staggered along that axis
STAGGER_X = "at_u_locations"
STAGGER_Y = "at_v_locations"
STAGGER_Z = "on_interface_levels"


@dataclasses.dataclass(frozen=True)
class FieldArray:
    """A named array with units and dimension labels."""

    data: Any  # torch.Tensor | np.ndarray
    units: str = "1"
    dims: DimNames = ("x", "y", "z")

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def to_units(self, units: str) -> "FieldArray":
        """The field expressed in ``units`` (no copy when already there)."""
        if units_are_same(self.units, units):
            return FieldArray(self.data, units, self.dims)
        factor = conversion_factor(self.units, units)
        return FieldArray(self.data * factor, units, self.dims)

    def with_data(self, data) -> "FieldArray":
        return FieldArray(data, self.units, self.dims)

    def __repr__(self):
        return f"FieldArray(shape={self.shape}, units={self.units!r}, dims={self.dims})"


def field_stagger_axes(name: str) -> Tuple[bool, bool, bool]:
    """(x-staggered, y-staggered, z-staggered) from the field's name."""
    return (STAGGER_X in name, STAGGER_Y in name, STAGGER_Z in name)


def field_dims(name: str, base: DimNames = ("x", "y", "z")) -> DimNames:
    """Dimension labels of field ``name`` from the staggering naming convention."""
    tags = (STAGGER_X, STAGGER_Y, STAGGER_Z)
    return tuple(f"{ax}_{tag}" if tag in name else ax for ax, tag in zip(base, tags))


def field_shape(name: str, grid_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Shape of field ``name`` on a grid with ``grid_shape`` mass points."""
    return tuple(n + int(tag in name) for n, tag in zip(grid_shape, (STAGGER_X, STAGGER_Y, STAGGER_Z)))


def get_array_dict(
    state: Mapping[str, Any], properties: Mapping[str, Mapping[str, Any]]
) -> Dict[str, Any]:
    """Raw arrays from ``state`` converted to the units in ``properties``."""
    out: Dict[str, Any] = {}
    for name, props in properties.items():
        field = state[name]
        if isinstance(field, FieldArray):
            out[name] = field.to_units(props["units"]).data
        else:  # raw array, already in the requested units
            out[name] = field
    return out


def wrap_outputs(
    raw: Mapping[str, Any], properties: Mapping[str, Mapping[str, Any]]
) -> Dict[str, FieldArray]:
    """Raw arrays back into ``FieldArray``s with the declared units."""
    return {
        name: FieldArray(arr, properties.get(name, {}).get("units", "1"), field_dims(name))
        for name, arr in raw.items()
    }


def get_field_dict(
    raw: Mapping[str, Any], properties: Mapping[str, Mapping[str, Any]], time=None
) -> Dict[str, Any]:
    """:func:`wrap_outputs` of ``raw`` (its ``"time"`` left out), with
    ``time`` as the dict's ``"time"`` where given."""
    out: Dict[str, Any] = wrap_outputs({k: v for k, v in raw.items() if k != "time"}, properties)
    if time is not None:
        out["time"] = time
    return out


def ensure_timedelta_seconds(dt: Union[float, int, timedelta]) -> float:
    """A timestep (float seconds or ``timedelta``) as float seconds."""
    if isinstance(dt, timedelta):
        return dt.total_seconds()
    return float(dt)


def add_seconds(time, seconds: float):
    """``time`` advanced by ``seconds`` at a ``timedelta``'s resolution of a
    microsecond, as the reference stamps its stages.  ``time`` is a
    ``datetime`` or a tensor of seconds from the run's initial time: a
    CUDA graph of a step takes its time from such a tensor."""
    step = timedelta(seconds=seconds)
    if isinstance(time, torch.Tensor):
        return time + step.total_seconds()
    return time + step
