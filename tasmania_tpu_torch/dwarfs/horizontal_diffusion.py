"""Horizontal diffusion: the Laplacian tendency of a field with a
vertically graded coefficient (counterpart of
``tasmania_tpu/dwarfs/horizontal_diffusion.py``).

Second order is the three-point second difference along each axis, fourth
order the five-point one; the ``_1dx`` and ``_1dy`` variants difference
along one axis.  The tendency is zero outside the window inset by ``nb``
along each differenced axis.  The JAX package computes these in XLA, so the
port's are plain PyTorch on the field's device.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory

#: second-difference weights of each order, from offset -n to +n, and their divisor
STENCILS = {2: ((1.0, -2.0, 1.0), 1.0), 4: ((-1.0, 16.0, -30.0, 16.0, -1.0), 12.0)}


def build_damped_coeff(nz: int, coeff: float, coeff_max: float, damp_depth: int, dtype) -> np.ndarray:
    """(nz,) coefficient profile with a sin² ramp from ``coeff`` to
    ``coeff_max`` over the top ``damp_depth`` levels."""
    gamma = coeff * np.ones(nz, dtype=dtype)
    n = min(damp_depth, nz)  # shallow grids
    if n > 0:
        pert = np.sin(0.5 * math.pi * (n - np.arange(0, n, dtype=dtype)) / n) ** 2
        gamma[:n] += (coeff_max - coeff) * pert
    return gamma


def window(nb: int, n: int, off: int) -> slice:
    """The interior ``[nb, n - nb)`` along one axis, shifted by ``off``."""
    return slice(nb + off, n - nb + off)


def interior_paste(shape, nb_x: int, nb_y: int, interior: torch.Tensor) -> torch.Tensor:
    """Zeros of ``shape`` with ``interior`` in the window inset by
    (``nb_x``, ``nb_y``)."""
    out = interior.new_zeros(shape)
    out[nb_x : shape[0] - nb_x, nb_y : shape[1] - nb_y] = interior
    return out


class HorizontalDiffusion(nn.Module, StencilFactory):
    """Buffer: the coefficient profile ``gamma`` (nz,).  Factory base of the
    diffusers, each its ``order`` and the ``axes`` it differences:
    ``HorizontalDiffusion.factory("fourth_order", shape, dx, dy, ...)``."""

    registry = {}
    order: int = 2
    axes: str = "xy"

    def __init__(
        self, shape: Tuple[int, int, int], dx: float, dy: float,
        diffusion_coeff: float, diffusion_coeff_max: float, diffusion_damp_depth: int,
        nb: Optional[int] = None, *, backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        min_nb = self.order // 2
        self.nb = min_nb if (nb is None or nb < min_nb) else nb
        for axis, n in zip("xy", shape[:2]):
            if axis in self.axes and n < 2 * self.nb + 1:
                raise ValueError(f"the {axis} extent {n} must be at least {2 * self.nb + 1}")
        self.dx, self.dy = float(dx), float(dy)
        so = self.storage_options
        gamma = build_damped_coeff(shape[2], diffusion_coeff, diffusion_coeff_max,
                                   diffusion_damp_depth, so.np_dtype)
        self.register_buffer("gamma", torch.as_tensor(gamma, dtype=so.dtype, device=so.device))

    def _second_difference(self, phi, axis: int):
        """The order's second difference of ``phi`` along ``axis`` over the
        interior of the differenced axes."""
        weights, div = STENCILS[self.order]
        half = len(weights) // 2
        nb, d = self.nb, (self.dx, self.dy)[axis]
        idx = [window(nb, n, 0) if a in self.axes else slice(None)
               for a, n in zip("xy", phi.shape[:2])]
        acc = 0.0
        for k, w in enumerate(weights):
            idx[axis] = window(nb, phi.shape[axis], k - half)
            acc = acc + w * phi[tuple(idx)]
        return acc / (div * d * d)

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        """The diffusion tendency of ``phi`` (zero on the frame)."""
        lap = None
        for axis, name in enumerate("xy"):
            if name in self.axes:
                term = self._second_difference(phi, axis)
                lap = term if lap is None else lap + term
        gamma = self.gamma.to(phi.dtype)
        nb_x = self.nb if "x" in self.axes else 0
        nb_y = self.nb if "y" in self.axes else 0
        return interior_paste(phi.shape, nb_x, nb_y, gamma * lap)

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalDiffusion":
        return factorize(name, HorizontalDiffusion, args, kwargs)


@factor_register("second_order")
class SecondOrder(HorizontalDiffusion):
    order, axes = 2, "xy"


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalDiffusion):
    order, axes = 2, "x"


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalDiffusion):
    order, axes = 2, "y"


@factor_register("fourth_order")
class FourthOrder(HorizontalDiffusion):
    order, axes = 4, "xy"


@factor_register("fourth_order_1dx")
class FourthOrder1DX(HorizontalDiffusion):
    order, axes = 4, "x"


@factor_register("fourth_order_1dy")
class FourthOrder1DY(HorizontalDiffusion):
    order, axes = 4, "y"
