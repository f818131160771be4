"""Build-time checks that components' properties fit together (counterpart
of ``tasmania_tpu/framework/static_checkers.py``): one component's outputs
feed another's inputs with compatible units and dimensions."""

from __future__ import annotations

from typing import Any, Mapping

from tasmania_tpu_torch.utils.exceptions import (
    IncompatibleDimensionsError,
    IncompatibleUnitsError,
    PropertyError,
)
from tasmania_tpu_torch.utils.units import units_are_compatible

_ATTR = {
    "input": "input_properties",
    "tendency": "tendency_properties",
    "diagnostic": "diagnostic_properties",
    "output": "output_properties",
    "provisional_input": "provisional_input_properties",
}


def get_properties(component, kind: str) -> Mapping[str, Mapping[str, Any]]:
    attr = _ATTR.get(kind, kind)
    props = getattr(component, attr, None)
    if props is None:
        raise PropertyError(f"{type(component).__name__} has no {attr}")
    return props


def check_property_compatibility(name: str, props1: Mapping[str, Any], props2: Mapping[str, Any]) -> None:
    """Units must convert into one another; dimensions, where both declare
    them, must be the same."""
    u1 = props1.get("units", "1")
    u2 = props2.get("units", "1")
    if not units_are_compatible(u1, u2):
        raise IncompatibleUnitsError(f"field {name!r}: units {u1!r} and {u2!r} are incompatible")
    d1 = props1.get("dims")
    d2 = props2.get("dims")
    if d1 is not None and d2 is not None and tuple(d1) != tuple(d2):
        raise IncompatibleDimensionsError(f"field {name!r}: dims {d1} and {d2} disagree")


def check_properties_are_compatible(component1, kind1: str, component2, kind2: str) -> None:
    """Every field the two property dictionaries share must be compatible."""
    props1 = get_properties(component1, kind1)
    props2 = get_properties(component2, kind2)
    for name in set(props1) & set(props2):
        check_property_compatibility(name, props1[name], props2[name])


def check_missing_fields(provider, kind1: str, consumer, kind2: str) -> None:
    """Raise if the consumer requires fields the provider does not supply."""
    provided = set(get_properties(provider, kind1))
    required = set(get_properties(consumer, kind2))
    missing = required - provided
    if missing:
        raise PropertyError(
            f"{type(consumer).__name__} requires fields not provided by "
            f"{type(provider).__name__}: {sorted(missing)}"
        )
