"""Horizontal flux schemes of the isentropic core (counterpart of
``tasmania_tpu/isentropic/dynamics/horizontal_fluxes.py``): the factory
bases ``IsentropicMinimalHorizontalFlux`` and ``IsentropicHorizontalFlux``
(one registry) and the registered schemes ``Upwind``, ``Centered``,
``ThirdOrderUpwind`` and ``FifthOrderUpwind``.

A scheme is its order: 1 (upwind) and 2 (centred) read one cell on each
side of a face (extent 1), the third-order upwind flux two (extent 2), the
fifth-order one three (extent 3).  Each flux function below takes the face
velocity and the 2·extent cell values around the face, left to right (the
face lies between ``pm1`` and ``p0``); a scheme's ``flux_x`` and ``flux_y``
apply its order's function along x and y, with the JAX package's index
convention: ``flux_x(u, phi)[k]`` is the flux through face ``k + extent``.
The stage reads a scheme's order (``ops/si_stage.py::flux_divergence``).

Orders 3 and 5 have kernels (``csrc/si_stage.cu``, ``csrc/advection.cu``);
the JAX package computes orders 1 and 2 in jnp, never in a Pallas kernel,
so the port's stage computes them in plain PyTorch on every device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND

#: the orders whose stage runs through the kernels
KERNEL_ORDERS = (3, 5)


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


class IsentropicMinimalHorizontalFlux:
    """Factory base: ``IsentropicMinimalHorizontalFlux.factory("upwind")``."""

    registry = {}
    extent: int = 1
    order: int = 1

    def __init__(self, *, backend: str = DEFAULT_BACKEND) -> None:
        self.backend = backend

    @classmethod
    def factory(cls, scheme: str, *, backend: str = DEFAULT_BACKEND):
        return factorize(scheme, IsentropicMinimalHorizontalFlux, (), {"backend": backend})

    def _faces(self, w, phi, axis: int):
        """The order's flux through the faces [extent, n + 1 - extent) along
        ``axis``: ``w`` on the n + 1 faces, ``phi`` on the n cells."""
        e, n = self.extent, phi.shape[axis]
        cells = [phi.narrow(axis, k, n - 2 * e + 1) for k in range(2 * e)]
        return FLUXES[self.order](w.narrow(axis, e, w.shape[axis] - 2 * e), *cells)

    def flux_x(self, u, phi):
        return self._faces(u, phi, 0)

    def flux_y(self, v, phi):
        return self._faces(v, phi, 1)

    def flux_dry(self, dt, dx, dy, s, u, v, su, sv, mtg=None, **kw) -> Tuple:
        """(flux_s_x, flux_s_y, flux_su_x, flux_su_y, flux_sv_x, flux_sv_y)"""
        return (self.flux_x(u, s), self.flux_y(v, s), self.flux_x(u, su), self.flux_y(v, su),
                self.flux_x(u, sv), self.flux_y(v, sv))

    def flux_moist(self, dt, dx, dy, s, u, v, sqv, sqc, sqr, **kw) -> Tuple:
        return (self.flux_x(u, sqv), self.flux_y(v, sqv), self.flux_x(u, sqc), self.flux_y(v, sqc),
                self.flux_x(u, sqr), self.flux_y(v, sqr))


class IsentropicHorizontalFlux(IsentropicMinimalHorizontalFlux):
    """The full-flux factory; it shares the minimal schemes (the pressure
    gradient lives in the semi-implicit stage)."""

    registry = IsentropicMinimalHorizontalFlux.registry


@factor_register("upwind")
class Upwind(IsentropicMinimalHorizontalFlux):
    extent, order = 1, 1


@factor_register("centered")
class Centered(IsentropicMinimalHorizontalFlux):
    extent, order = 1, 2


@factor_register("third_order_upwind")
class ThirdOrderUpwind(IsentropicMinimalHorizontalFlux):
    extent, order = 2, 3


@factor_register("fifth_order_upwind")
class FifthOrderUpwind(IsentropicMinimalHorizontalFlux):
    extent, order = 3, 5
