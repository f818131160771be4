"""Minimal vertical numerical fluxes of the isentropic model (counterpart of
``tasmania_tpu/isentropic/dynamics/vertical_fluxes.py``).

``w`` is on the nz+1 interface levels and ``phi`` on the nz main levels (k
from the top down); ``__call__`` returns the fluxes at the interior
interfaces [extent, nz+1-extent).  Positive w is dθ/dt, so the upwind cell of
interface m is phi[m], the one below it.
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND


class IsentropicMinimalVerticalFlux:
    """Factory base: ``IsentropicMinimalVerticalFlux.factory("upwind")``."""

    registry = {}
    extent = 1
    order = 1

    def __init__(self, *, backend: str = DEFAULT_BACKEND) -> None:
        self.backend = backend

    @classmethod
    def factory(cls, scheme: str, *, backend: str = DEFAULT_BACKEND) -> "IsentropicMinimalVerticalFlux":
        return factorize(scheme, IsentropicMinimalVerticalFlux, (), {"backend": backend})

    def __call__(self, dt, dz, w, phi):
        raise NotImplementedError


@factor_register("upwind")
class Upwind(IsentropicMinimalVerticalFlux):
    extent, order = 1, 1

    def __call__(self, dt, dz, w, phi):
        wf = w[:, :, 1:-1]
        return wf * torch.where(wf > 0.0, phi[:, :, 1:], phi[:, :, :-1])


@factor_register("centered")
class Centered(IsentropicMinimalVerticalFlux):
    extent, order = 1, 2

    def __call__(self, dt, dz, w, phi):
        return w[:, :, 1:-1] * 0.5 * (phi[:, :, 1:] + phi[:, :, :-1])


@factor_register("third_order_upwind")
class ThirdOrderUpwind(IsentropicMinimalVerticalFlux):
    extent, order = 2, 3

    def __call__(self, dt, dz, w, phi):
        wf = w[:, :, 2:-2]
        return wf / 12.0 * (
            7.0 * (phi[:, :, 1:-2] + phi[:, :, 2:-1]) - (phi[:, :, :-3] + phi[:, :, 3:])
        ) - wf.abs() / 12.0 * (
            3.0 * (phi[:, :, 1:-2] - phi[:, :, 2:-1]) - (phi[:, :, :-3] - phi[:, :, 3:])
        )


@factor_register("fifth_order_upwind")
class FifthOrderUpwind(IsentropicMinimalVerticalFlux):
    extent, order = 3, 5

    def __call__(self, dt, dz, w, phi):
        wf = w[:, :, 3:-3]
        return wf / 60.0 * (
            37.0 * (phi[:, :, 2:-3] + phi[:, :, 3:-2])
            - 8.0 * (phi[:, :, 1:-4] + phi[:, :, 4:-1])
            + (phi[:, :, :-5] + phi[:, :, 5:])
        ) - wf.abs() / 60.0 * (
            10.0 * (phi[:, :, 2:-3] - phi[:, :, 3:-2])
            - 5.0 * (phi[:, :, 1:-4] - phi[:, :, 4:-1])
            + (phi[:, :, :-5] - phi[:, :, 5:])
        )

