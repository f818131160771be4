"""The one traffic generator: a traffic file's parameters (``traffic/<name>.json``)
and a configuration's perturbation (its ``assumed.perturbation``) give each
forecast of a run its initial state and decide which forecasts are checked.

A forecast's perturbation depends only on ``--seed`` and the forecast's
index.  It is made on the device in a few calls: three fields of normal
draws on a coarse grid (a point every ``scale_cells`` cells and
``scale_levels`` levels), interpolated trilinearly to the grid, each scaled
to a largest magnitude of one, then tapered to zero towards the lateral
edges (zero on the ``edge_cells`` outermost cells, which hold the relaxation
zone, then a sin² ramp over ``taper_cells``) and multiplied by its
amplitude:

* ``du`` (nx+1, ny, nz) and ``dv`` (nx, ny+1, nz): m s^-1 added to the
  staggered velocities, at most ``u_m_s`` and ``v_m_s``;
* ``rq`` (nx, ny, nz): the relative change of the water vapour, at most
  ``qv_relative`` (below one, so no mass fraction turns negative).

Both sides receive the same arrays: the program through
``Program.initial``, the reference through ``Reference.initial_state``.
"""

from __future__ import annotations

import hashlib
import math
import random
from typing import Dict, List

import torch
import torch.nn.functional as F


def forecast_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed of forecast ``index`` of run ``seed``."""
    digest = hashlib.sha256(f"{seed}:{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2**63 - 1)


def edge_window(n: int, edge: int, taper: int, device) -> torch.Tensor:
    """(n,) float32: zero on the ``edge`` outermost points of each end, a
    sin² ramp over the next ``taper``, one inside."""
    i = torch.arange(n, device=device, dtype=torch.float32)
    d = torch.minimum(i, n - 1 - i) - (edge - 1)
    ramp = torch.sin(0.5 * math.pi * torch.clamp(d / (taper + 1), 0.0, 1.0)) ** 2
    return torch.where(d <= 0, torch.zeros_like(ramp), ramp)


def perturbation(shape, p: dict, seed: int, index: int, device) -> Dict[str, torch.Tensor]:
    """The perturbation of forecast ``index`` on a grid of ``shape`` (nx, ny,
    nz), float32, from the configuration's parameters ``p``."""
    nx, ny, nz = shape
    gen = torch.Generator(device=device)
    gen.manual_seed(forecast_seed(seed, index))
    coarse = (nx // p["scale_cells"] + 2, ny // p["scale_cells"] + 2, nz // p["scale_levels"] + 2)
    draws = torch.randn((1, 3, *coarse), generator=gen, device=device, dtype=torch.float32)
    fine = F.interpolate(draws, size=(nx + 1, ny + 1, nz), mode="trilinear", align_corners=True)[0]
    wx = edge_window(nx, p["edge_cells"], p["taper_cells"], device)
    wy = edge_window(ny, p["edge_cells"], p["taper_cells"], device)
    wxu = edge_window(nx + 1, p["edge_cells"], p["taper_cells"], device)
    wyv = edge_window(ny + 1, p["edge_cells"], p["taper_cells"], device)

    def scaled(a, amplitude, w1, w2):
        return amplitude * a / a.abs().max() * w1[:, None, None] * w2[None, :, None]

    return {
        "du": scaled(fine[0, :, :ny], p["u_m_s"], wxu, wy),
        "dv": scaled(fine[1, :nx, :], p["v_m_s"], wx, wyv),
        "rq": scaled(fine[2, :nx, :ny], p["qv_relative"], wx, wy),
    }


def check_traffic(traffic: dict) -> None:
    """The generator drives one client in a closed loop; raise on another mix."""
    if traffic.get("loop") != "closed" or traffic.get("clients") != 1:
        raise ValueError(f"traffic {traffic.get('name')!r}: the generator runs one client in a closed "
                         "loop (loop 'closed', clients 1)")
    if traffic.get("checked_forecasts", 0) < 1:
        raise ValueError(f"traffic {traffic.get('name')!r}: check at least one forecast")


class Sample:
    """Reservoir sampling of ``k`` forecasts from a run's stream of
    forecasts, drawn from the seed: ``offer(index)`` says whether forecast
    ``index`` (0, 1, ...) takes a slot, and which; ``chosen`` maps each
    filled slot to its forecast's index."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = random.Random(f"{seed}:checked")
        self.chosen: List[int] = []

    def offer(self, index: int):
        if index < self.k:
            self.chosen.append(index)
            return index
        j = self.rng.randrange(index + 1)
        if j < self.k:
            self.chosen[j] = index
            return j
        return None
