"""Algebra over state dictionaries with unit conversion (counterpart of
``tasmania_tpu/framework/dict_operator.py:110-180``, the operations the
splittings and steppers use).

Every function is functional: it returns a new dict of ``FieldArray``s.
``field_properties`` selects the fields an operation acts on and their
units: an empty ``field_properties`` selects no field.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.utils.units import per_second

PropertyDict = Mapping[str, Mapping[str, Any]]


def update(state: Mapping[str, Any], other: Mapping[str, Any]) -> Dict[str, Any]:
    """``dict(state)`` updated with ``other``, whose ``time`` is ignored."""
    out = dict(state)
    out.update({k: v for k, v in other.items() if k != "time"})
    return out


def addsub(a, b, c, field_properties: PropertyDict) -> Dict[str, Any]:
    """``a + b - c`` on the selected fields that all three hold; the other
    selected fields of ``a`` pass through."""
    out: Dict[str, Any] = {}
    for name, props in field_properties.items():
        if name in a and name in b and name in c:
            u = props["units"]
            out[name] = FieldArray(
                a[name].to_units(u).data + b[name].to_units(u).data - c[name].to_units(u).data,
                u, a[name].dims,
            )
        elif name in a:
            out[name] = a[name]
    if "time" in a:
        out["time"] = a["time"]
    return out


def fma(state, tendencies, dt: float, field_properties: PropertyDict) -> Dict[str, Any]:
    """``state + dt·tendency`` on the selected fields of ``state``, each in
    its units (the tendency converted to those units per second); a field
    without a tendency passes through."""
    out: Dict[str, Any] = {}
    for name, props in field_properties.items():
        if name not in state:
            continue
        s = state[name].to_units(props["units"])
        if name in tendencies:
            t = tendencies[name].to_units(per_second(s.units))
            out[name] = FieldArray(s.data + dt * t.data, s.units, s.dims)
        else:
            out[name] = s
    return out


def _sts_stage(state, state_prv, tendencies, field_properties, combine) -> Dict[str, Any]:
    """``combine(state, state_prv, tendency)`` on the selected fields that
    both states hold (every such field needs a tendency)."""
    out: Dict[str, Any] = {}
    for name, props in field_properties.items():
        if name not in state or name not in state_prv:
            continue
        u = props["units"]
        data = combine(state[name].to_units(u).data, state_prv[name].to_units(u).data,
                       tendencies[name].to_units(per_second(u)).data)
        out[name] = FieldArray(data, u, state[name].dims)
    return out


def sts_rk2_0(dt: float, state, state_prv, tendencies, field_properties: PropertyDict) -> Dict[str, Any]:
    """``½(state + state_prv + dt·tendency)``."""
    return _sts_stage(state, state_prv, tendencies, field_properties,
                      lambda s, p, t: 0.5 * (s + p + dt * t))


def sts_rk3ws_0(dt: float, state, state_prv, tendencies, field_properties: PropertyDict) -> Dict[str, Any]:
    """``(2·state + state_prv + dt·tendency) / 3``."""
    return _sts_stage(state, state_prv, tendencies, field_properties,
                      lambda s, p, t: (2.0 * s + p + dt * t) / 3.0)
