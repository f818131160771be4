"""Whether the timed path's forecasts are right: the final fields of
forecasts the window produced, held to the plain reference
(``reference/model.py``) run afterwards from the same namelist values and
the same perturbation, in float64.

Four numbers, each the largest difference over the fields it covers, the
first three as a share of a scale of the reference's:

* ``s``: the isentropic density, over its largest magnitude;
* ``momentum``: both momenta, over the larger of their largest magnitudes
  (``sv`` is a small field beside ``su``);
* ``water``: the three water mass fractions, over the largest water vapour
  mass fraction (cloud and rain form late and small, so their own
  magnitudes would make the number swing with their onset);
* ``precipitation``: the accumulated surface precipitation, in mm, not as
  a share: within a forecast rain often only starts to reach the ground, so
  the reference's largest is nought or a trace and a share of it would
  swing with the step at which rain arrives.

Over several checked forecasts a number is the largest.  A cell's limits
(``limits/<cell>.json``) name the numbers it compares, each with its limit;
a run is correct when each of those is finite and within its limit.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable

import torch

from benchmark.reference.model import Reference

#: the numbers, and the fields each covers
COMPARED = {"s": ("s",), "momentum": ("su", "sv"), "water": ("qv", "qc", "qr"),
            "precipitation": ("accprec",)}
#: the reference's fields whose largest magnitude scales each number; none: the field's own unit
SCALE = {"s": ("s",), "momentum": ("su", "sv"), "water": ("qv",), "precipitation": ()}
FIELDS = ("s", "su", "sv", "qv", "qc", "qr", "accprec")


def nan_as_inf(x: float) -> float:
    """``x``, with NaN read as infinite: Python's ``max`` keeps a NaN only
    where it comes first, so a NaN field must not reach it as NaN."""
    return math.inf if math.isnan(x) else x


def numbers(program: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The four numbers of one forecast (module docstring)."""
    diff = {k: nan_as_inf(float((program[k].to(ref[k].device, torch.float64) - ref[k].to(torch.float64))
                                .abs().max())) for k in FIELDS}
    big = {k: nan_as_inf(float(ref[k].abs().max())) for k in FIELDS}
    out = {}
    for name, fields in COMPARED.items():
        d = max(diff[k] for k in fields)
        scale = max((big[k] for k in SCALE[name]), default=1.0)
        if math.isinf(d) or math.isinf(scale):
            out[name] = math.inf
        elif scale > 0.0:
            out[name] = d / scale
        else:
            out[name] = 0.0 if d == 0.0 else math.inf
    return out


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def within(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Each number ``limits`` names finite and within its limit."""
    return all(math.isfinite(values.get(k, math.inf)) and values[k] <= lim for k, lim in limits.items())


def reference_forecast(reference: Reference, pert: Dict[str, torch.Tensor], steps: int) -> Dict[str, torch.Tensor]:
    st = reference.initial_state(pert["du"], pert["dv"], pert["rq"])
    st = reference.forecast(st, steps)
    return {k: st[k] for k in FIELDS}
