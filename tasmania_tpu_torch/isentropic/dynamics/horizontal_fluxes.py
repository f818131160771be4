"""Horizontal upwind flux schemes of the isentropic core (counterpart of
``tasmania_tpu/isentropic/dynamics/horizontal_fluxes.py``, its third- and
fifth-order upwind schemes).

A scheme is its order: the face flux of order 3 reads two cells on each side
of the face (extent 2), that of order 5 three (extent 3).  The fifth-order
flux is ``ops/si_stage.py::flux5``; the third-order one is here.  The flux
divergence of either is ``ops/si_stage.py::flux_divergence``.
"""

from __future__ import annotations

import torch

ORDERS = {"third_order_upwind": 3, "fifth_order_upwind": 5}


def flux_order(scheme: str) -> int:
    """The order of a ported flux scheme."""
    if scheme not in ORDERS:
        raise NotImplementedError(f"horizontal flux {scheme!r} is not ported (have {sorted(ORDERS)})")
    return ORDERS[scheme]


def extent(order: int) -> int:
    """Cells read on each side of a face by the flux of ``order``."""
    if order not in (3, 5):
        raise ValueError(f"upwind order {order} (have 3, 5)")
    return 2 if order == 3 else 3


def flux3(w, pm2, pm1, p0, pp1):
    """Third-order upwind flux at a face between pm1 and p0: the fourth-order
    centred flux minus |w|-weighted dissipation."""
    flux4 = w / 12.0 * (7.0 * (p0 + pm1) - (pp1 + pm2))
    return flux4 - torch.abs(w) / 12.0 * (3.0 * (p0 - pm1) - (pp1 - pm2))
