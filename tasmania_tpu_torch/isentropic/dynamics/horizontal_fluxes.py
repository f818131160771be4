"""Horizontal flux schemes of the isentropic core (counterpart of
``tasmania_tpu/isentropic/dynamics/horizontal_fluxes.py``: ``Upwind``,
``Centered``, ``ThirdOrderUpwind`` and ``FifthOrderUpwind``, ``:81-163``).

A scheme is its order: 1 (upwind) and 2 (centred) read one cell on each
side of a face (extent 1), the third-order upwind flux two (extent 2), the
fifth-order one three (extent 3).  Each flux below takes the face velocity
and the 2·extent cell values around the face, left to right (the face lies
between ``pm1`` and ``p0``).  The flux divergence of any of them is
``ops/si_stage.py::flux_divergence``.

Orders 3 and 5 have kernels (``csrc/si_stage.cu``, ``csrc/advection.cu``);
the JAX package computes orders 1 and 2 in jnp, never in a Pallas kernel,
so the port's stage computes them in plain PyTorch on every device.
"""

from __future__ import annotations

import torch

ORDERS = {"upwind": 1, "centered": 2, "third_order_upwind": 3, "fifth_order_upwind": 5}
#: the orders whose stage runs through the kernels
KERNEL_ORDERS = (3, 5)


def flux_order(scheme: str) -> int:
    """The order of a flux scheme (the reference registers these four)."""
    if scheme not in ORDERS:
        raise ValueError(f"unknown horizontal flux {scheme!r} (have {sorted(ORDERS)})")
    return ORDERS[scheme]


def extent(order: int) -> int:
    """Cells read on each side of a face by the flux of ``order``."""
    if order not in (1, 2, 3, 5):
        raise ValueError(f"flux order {order} (have 1, 2, 3, 5)")
    return {1: 1, 2: 1, 3: 2, 5: 3}[order]


def flux1(w, pm1, p0):
    """First-order upwind flux: the upwind cell's value times w."""
    return w * torch.where(w > 0.0, pm1, p0)


def flux2(w, pm1, p0):
    """Second-order centred flux."""
    return w * 0.5 * (pm1 + p0)


def flux3(w, pm2, pm1, p0, pp1):
    """Third-order upwind flux: the fourth-order centred flux minus
    |w|-weighted dissipation."""
    flux4 = w / 12.0 * (7.0 * (p0 + pm1) - (pp1 + pm2))
    return flux4 - torch.abs(w) / 12.0 * (3.0 * (p0 - pm1) - (pp1 - pm2))


def flux5(w, pm3, pm2, pm1, p0, pp1, pp2):
    """Fifth-order upwind flux: the sixth-order centred flux minus
    |w|-weighted dissipation."""
    flux6 = w / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3))
    return flux6 - torch.abs(w) / 60.0 * (
        10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3)
    )


FLUXES = {1: flux1, 2: flux2, 3: flux3, 5: flux5}
