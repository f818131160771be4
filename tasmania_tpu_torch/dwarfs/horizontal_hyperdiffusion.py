"""Horizontal hyperdiffusion: the Laplacian of a field iterated ``order``
times (1 to 3), with a vertically graded coefficient (counterpart of
``tasmania_tpu/dwarfs/horizontal_hyperdiffusion.py``).

Each Laplacian is the five-point one (three-point along one axis for the
``_1dx`` and ``_1dy`` variants) and shrinks the window by one layer on each
side; the tendency is zero outside the window inset by ``nb``.  Plain
PyTorch, as the JAX package computes it in XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tasmania_tpu_torch.dwarfs.horizontal_diffusion import build_damped_coeff, interior_paste
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory



def laplacian(dx: float, dy: float, phi):
    """The five-point Laplacian over the window one layer inside ``phi``."""
    return (phi[:-2, 1:-1] - 2.0 * phi[1:-1, 1:-1] + phi[2:, 1:-1]) / (dx * dx) + (
        phi[1:-1, :-2] - 2.0 * phi[1:-1, 1:-1] + phi[1:-1, 2:]
    ) / (dy * dy)


def laplacian_x(dx: float, phi):
    return (phi[:-2] - 2.0 * phi[1:-1] + phi[2:]) / (dx * dx)


def laplacian_y(dy: float, phi):
    return (phi[:, :-2] - 2.0 * phi[:, 1:-1] + phi[:, 2:]) / (dy * dy)


class HorizontalHyperDiffusion(nn.Module, StencilFactory):
    """Buffer: the coefficient profile ``gamma`` (nz,).  Factory base of the
    hyperdiffusers, each its ``order`` (Laplacians iterated) and the ``axes``
    it differences: ``HorizontalHyperDiffusion.factory("third_order", ...)``."""

    registry = {}
    order: int = 1
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
        self.nb = self.order if (nb is None or nb < self.order) else nb
        self.dx, self.dy = float(dx), float(dy)
        so = self.storage_options
        gamma = build_damped_coeff(shape[2], diffusion_coeff, diffusion_coeff_max,
                                   diffusion_damp_depth, so.np_dtype)
        self.register_buffer("gamma", torch.as_tensor(gamma, dtype=so.dtype, device=so.device))

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        """The hyperdiffusion tendency of ``phi`` (zero on the frame)."""
        nb, n = self.nb, self.order
        nb_x = nb if "x" in self.axes else 0
        nb_y = nb if "y" in self.axes else 0
        sx = slice(nb - n, phi.shape[0] - nb + n) if nb_x else slice(None)
        sy = slice(nb - n, phi.shape[1] - nb + n) if nb_y else slice(None)
        win = phi[sx, sy]
        for _ in range(n):
            if self.axes == "x":
                win = laplacian_x(self.dx, win)
            elif self.axes == "y":
                win = laplacian_y(self.dy, win)
            else:
                win = laplacian(self.dx, self.dy, win)
        return interior_paste(phi.shape, nb_x, nb_y, self.gamma.to(phi.dtype) * win)

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalHyperDiffusion":
        return factorize(name, HorizontalHyperDiffusion, args, kwargs)


@factor_register("first_order")
class FirstOrder(HorizontalHyperDiffusion):
    order, axes = 1, "xy"


@factor_register("first_order_1dx")
class FirstOrder1DX(HorizontalHyperDiffusion):
    order, axes = 1, "x"


@factor_register("first_order_1dy")
class FirstOrder1DY(HorizontalHyperDiffusion):
    order, axes = 1, "y"


@factor_register("second_order")
class SecondOrder(HorizontalHyperDiffusion):
    order, axes = 2, "xy"


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalHyperDiffusion):
    order, axes = 2, "x"


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalHyperDiffusion):
    order, axes = 2, "y"


@factor_register("third_order")
class ThirdOrder(HorizontalHyperDiffusion):
    order, axes = 3, "xy"


@factor_register("third_order_1dx")
class ThirdOrder1DX(HorizontalHyperDiffusion):
    order, axes = 3, "x"


@factor_register("third_order_1dy")
class ThirdOrder1DY(HorizontalHyperDiffusion):
    order, axes = 3, "y"
