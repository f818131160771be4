"""Minimal vertical numerical fluxes of the isentropic model (counterpart of
``tasmania_tpu/isentropic/dynamics/vertical_fluxes.py``).

``w`` is on the nz+1 interface levels and ``phi`` on the nz main levels (k
from the top down); ``__call__`` returns the fluxes at the interior
interfaces [extent, nz+1-extent).  Positive w is dθ/dt, so the upwind cell of
interface m is phi[m], the one below it.
"""

from __future__ import annotations

import torch


class IsentropicMinimalVerticalFlux:
    extent = 1
    order = 1

    @staticmethod
    def factory(scheme: str) -> "IsentropicMinimalVerticalFlux":
        if scheme not in _SCHEMES:
            raise ValueError(f"unknown vertical flux scheme {scheme!r} (have {sorted(_SCHEMES)})")
        return _SCHEMES[scheme]()

    def __call__(self, dt, dz, w, phi):
        raise NotImplementedError


class Upwind(IsentropicMinimalVerticalFlux):
    extent, order = 1, 1

    def __call__(self, dt, dz, w, phi):
        wf = w[:, :, 1:-1]
        return wf * torch.where(wf > 0.0, phi[:, :, 1:], phi[:, :, :-1])


class Centered(IsentropicMinimalVerticalFlux):
    extent, order = 1, 2

    def __call__(self, dt, dz, w, phi):
        return w[:, :, 1:-1] * 0.5 * (phi[:, :, 1:] + phi[:, :, :-1])


class ThirdOrderUpwind(IsentropicMinimalVerticalFlux):
    extent, order = 2, 3

    def __call__(self, dt, dz, w, phi):
        wf = w[:, :, 2:-2]
        return wf / 12.0 * (
            7.0 * (phi[:, :, 1:-2] + phi[:, :, 2:-1]) - (phi[:, :, :-3] + phi[:, :, 3:])
        ) - wf.abs() / 12.0 * (
            3.0 * (phi[:, :, 1:-2] - phi[:, :, 2:-1]) - (phi[:, :, :-3] - phi[:, :, 3:])
        )


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


_SCHEMES = {
    "upwind": Upwind,
    "centered": Centered,
    "third_order_upwind": ThirdOrderUpwind,
    "fifth_order_upwind": FifthOrderUpwind,
}
