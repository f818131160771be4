"""Lightweight units system (pint-free); counterpart of
``tasmania_tpu/utils/units.py``.

Units are parsed once into a ``(dimension-exponent vector, scale)`` pair and
reduced to a single multiplicative conversion factor, applied to a tensor as
one scalar multiply.  Only multiplicative units are supported (no offset units
like degC), which covers every unit string the model uses.
"""

from __future__ import annotations

import functools
import re
from fractions import Fraction
from typing import Dict, NamedTuple, Tuple

# base dimensions: (length, mass, time, temperature)
_DIMLESS = (Fraction(0), Fraction(0), Fraction(0), Fraction(0))


class UnitVector(NamedTuple):
    """Parsed unit: dimension exponents over (m, kg, s, K) and an SI scale factor."""

    dims: Tuple[Fraction, Fraction, Fraction, Fraction]
    scale: float


def _d(m=0, kg=0, s=0, K=0) -> Tuple[Fraction, ...]:
    return (Fraction(m), Fraction(kg), Fraction(s), Fraction(K))


# unit name -> (dims, scale-to-SI)
_UNITS: Dict[str, UnitVector] = {
    "m": UnitVector(_d(m=1), 1.0),
    "meter": UnitVector(_d(m=1), 1.0),
    "meters": UnitVector(_d(m=1), 1.0),
    "g": UnitVector(_d(kg=1), 1e-3),
    "gram": UnitVector(_d(kg=1), 1e-3),
    "s": UnitVector(_d(s=1), 1.0),
    "sec": UnitVector(_d(s=1), 1.0),
    "second": UnitVector(_d(s=1), 1.0),
    "seconds": UnitVector(_d(s=1), 1.0),
    "min": UnitVector(_d(s=1), 60.0),
    "minute": UnitVector(_d(s=1), 60.0),
    "h": UnitVector(_d(s=1), 3600.0),
    "hr": UnitVector(_d(s=1), 3600.0),
    "hour": UnitVector(_d(s=1), 3600.0),
    "hours": UnitVector(_d(s=1), 3600.0),
    "day": UnitVector(_d(s=1), 86400.0),
    "days": UnitVector(_d(s=1), 86400.0),
    "K": UnitVector(_d(K=1), 1.0),
    "kelvin": UnitVector(_d(K=1), 1.0),
    "Pa": UnitVector(_d(m=-1, kg=1, s=-2), 1.0),
    "pascal": UnitVector(_d(m=-1, kg=1, s=-2), 1.0),
    "bar": UnitVector(_d(m=-1, kg=1, s=-2), 1e5),
    "atm": UnitVector(_d(m=-1, kg=1, s=-2), 101325.0),
    "N": UnitVector(_d(m=1, kg=1, s=-2), 1.0),
    "J": UnitVector(_d(m=2, kg=1, s=-2), 1.0),
    "W": UnitVector(_d(m=2, kg=1, s=-3), 1.0),
    "Hz": UnitVector(_d(s=-1), 1.0),
    "rad": UnitVector(_DIMLESS, 1.0),
    "radian": UnitVector(_DIMLESS, 1.0),
    "%": UnitVector(_DIMLESS, 0.01),
    "percent": UnitVector(_DIMLESS, 0.01),
    "1": UnitVector(_DIMLESS, 1.0),
    "": UnitVector(_DIMLESS, 1.0),
    "dimensionless": UnitVector(_DIMLESS, 1.0),
}

_PREFIXES: Dict[str, float] = {
    "Y": 1e24, "Z": 1e21, "E": 1e18, "P": 1e15, "T": 1e12, "G": 1e9,
    "M": 1e6, "k": 1e3, "h": 1e2, "da": 1e1,
    "d": 1e-1, "c": 1e-2, "m": 1e-3, "u": 1e-6, "µ": 1e-6,
    "n": 1e-9, "p": 1e-12, "f": 1e-15,
}

# token: name optionally followed by exponent:  "m", "s^-1", "s**-2", "m2", "s-1"
_TOKEN_RE = re.compile(
    r"^(?P<name>[A-Za-zµ%]+|1)"
    r"(?:(?:\^|\*\*)?(?P<exp>[+-]?\d+(?:\.\d+)?(?:/\d+)?))?$"
)


def _resolve_name(name: str) -> UnitVector:
    if name in _UNITS:
        return _UNITS[name]
    # try prefix + unit (longest prefix first so "da" beats "d")
    for plen in (2, 1):
        if len(name) > plen:
            pref, rest = name[:plen], name[plen:]
            if pref in _PREFIXES and rest in _UNITS:
                u = _UNITS[rest]
                return UnitVector(u.dims, u.scale * _PREFIXES[pref])
    raise ValueError(f"unknown unit {name!r}")


@functools.lru_cache(maxsize=4096)
def parse_units(units: str) -> UnitVector:
    """Parse a unit string like ``"kg m^-2 s^-1"`` into dims + SI scale."""
    units = units.strip()
    if units in ("", "1", "dimensionless"):
        return UnitVector(_DIMLESS, 1.0)
    dims = list(_DIMLESS)
    scale = 1.0
    # normalise '/' division: "m/s" -> "m s^-1" (single-level)
    parts = re.split(r"\s*/\s*", units)
    token_groups = [(p, 1) for p in parts[:1]] + [(p, -1) for p in parts[1:]]
    for group, sign in token_groups:
        for tok in group.replace("*", " ").split():
            mt = _TOKEN_RE.match(tok)
            if mt is None:
                raise ValueError(f"cannot parse unit token {tok!r} in {units!r}")
            name = mt.group("name")
            exp_s = mt.group("exp")
            exp = Fraction(exp_s) if exp_s else Fraction(1)
            exp *= sign
            uv = _resolve_name(name)
            dims = [d + e * exp for d, e in zip(dims, uv.dims)]
            scale *= uv.scale ** float(exp)
    return UnitVector(tuple(dims), scale)


@functools.lru_cache(maxsize=4096)
def conversion_factor(src: str, dst: str) -> float:
    """Multiplicative factor converting values in ``src`` units to ``dst`` units."""
    u_src = parse_units(src)
    u_dst = parse_units(dst)
    if u_src.dims != u_dst.dims:
        raise ValueError(
            f"incompatible units: {src!r} {tuple(map(str, u_src.dims))} vs "
            f"{dst!r} {tuple(map(str, u_dst.dims))}"
        )
    return u_src.scale / u_dst.scale


def units_are_same(a: str, b: str) -> bool:
    """True if the two unit strings are exactly equivalent (same dims and scale)."""
    ua, ub = parse_units(a), parse_units(b)
    return ua.dims == ub.dims and abs(ua.scale / ub.scale - 1.0) < 1e-12


def units_are_compatible(a: str, b: str) -> bool:
    """True if values can be converted between the two unit strings."""
    return parse_units(a).dims == parse_units(b).dims


def per_second(units: str) -> str:
    """Units of the time tendency of a field carrying ``units``."""
    units = units.strip()
    if units in ("", "1", "dimensionless"):
        return "s^-1"
    return f"{units} s^-1"


def strip_per_second(units: str) -> str:
    """Units of the field whose tendency carries ``units`` (inverse of
    :func:`per_second`): drops one ``s^-1`` token where there is one,
    otherwise appends ``s``."""
    tokens = units.split()
    for i, tok in enumerate(tokens):
        if tok in ("s^-1", "s**-1", "s-1"):
            rest = tokens[:i] + tokens[i + 1 :]
            return " ".join(rest) if rest else "1"
    return f"{units} s" if units.strip() not in ("", "1") else "s"
