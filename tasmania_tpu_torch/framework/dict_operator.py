"""Algebra over state dictionaries with unit conversion (counterpart of
``tasmania_tpu/framework/dict_operator.py``).

Every function is functional: it returns a new dict of ``FieldArray``s.
``field_properties`` selects the fields an operation acts on and their
units: an empty ``field_properties`` selects no field.  ``DictOperator``
gathers the operations in the JAX package's class, where
``field_properties=None`` selects every field in each field's own units.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def _selected(field_properties: Optional[PropertyDict], *dicts) -> Dict[str, Dict[str, Any]]:
    """``field_properties`` with each field's units filled in from the first
    dict that holds it where missing; ``None`` selects every field of
    ``dicts``."""
    if field_properties is None:
        names = dict.fromkeys(k for d in dicts for k in d if k != "time")
        field_properties = {name: {} for name in names}
    out = {}
    for name, props in field_properties.items():
        holder = next((d for d in dicts if name in d), None)
        fallback = {"units": holder[name].units} if holder is not None else {}
        out[name] = {**fallback, **props}
    return out


def _with_time(out: Dict[str, Any], src: Mapping[str, Any]) -> Dict[str, Any]:
    if "time" in src:
        out["time"] = src["time"]
    return out


class DictOperator:
    """The dict operations as one namespace (the JAX package's
    ``DictOperator``); backend arguments are accepted and unused."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    @staticmethod
    def copy(src, field_properties: Optional[PropertyDict] = None) -> Dict[str, Any]:
        props = _selected(field_properties, src)
        out = {name: src[name].to_units(p["units"]) for name, p in props.items() if name in src}
        return _with_time(out, src)

    @staticmethod
    def _combine(a, b, field_properties, unshared_variables_in_output, op, negate_b):
        out: Dict[str, Any] = {}
        for name, p in _selected(field_properties, a, b).items():
            if name in a and name in b:
                u = p["units"]
                out[name] = FieldArray(op(a[name].to_units(u).data, b[name].to_units(u).data), u, a[name].dims)
            elif unshared_variables_in_output and name in a:
                out[name] = a[name]
            elif unshared_variables_in_output and name in b:
                out[name] = b[name].with_data(-b[name].data) if negate_b else b[name]
        return _with_time(out, a)

    @staticmethod
    def add(a, b, field_properties=None, unshared_variables_in_output=True) -> Dict[str, Any]:
        return DictOperator._combine(a, b, field_properties, unshared_variables_in_output,
                                     lambda x, y: x + y, False)

    @staticmethod
    def sub(a, b, field_properties=None, unshared_variables_in_output=True) -> Dict[str, Any]:
        return DictOperator._combine(a, b, field_properties, unshared_variables_in_output,
                                     lambda x, y: x - y, True)

    @staticmethod
    def scale(a, factor: float, field_properties=None) -> Dict[str, Any]:
        out = {}
        for name, p in _selected(field_properties, a).items():
            if name in a:
                fa = a[name].to_units(p["units"])
                out[name] = fa.with_data(factor * fa.data)
        return _with_time(out, a)

    @staticmethod
    def addsub(a, b, c, field_properties=None) -> Dict[str, Any]:
        return addsub(a, b, c, _selected(field_properties, a))

    @staticmethod
    def fma(state, tendencies, dt: float, field_properties=None) -> Dict[str, Any]:
        return fma(state, tendencies, dt, _selected(field_properties, state))

    @staticmethod
    def sts_rk2_0(dt: float, state, state_prv, tendencies, field_properties=None) -> Dict[str, Any]:
        return sts_rk2_0(dt, state, state_prv, tendencies, _selected(field_properties, state))

    @staticmethod
    def sts_rk3ws_0(dt: float, state, state_prv, tendencies, field_properties=None) -> Dict[str, Any]:
        return sts_rk3ws_0(dt, state, state_prv, tendencies, _selected(field_properties, state))

    @staticmethod
    def update(state, other) -> Dict[str, Any]:
        return update(state, other)
