"""Horizontal Shapiro smoothing with a vertically graded coefficient
(counterpart of ``tasmania_tpu/dwarfs/horizontal_smoothing.py``).

A call returns the smoothed field: the interior filtered, the frame of
width ``nb`` (along each filtered axis) passed through.  The
two-dimensional filters of order 1-3 are ``ops/smoothing_step.fused_smoothing``
(the CUDA kernel on the card); the ``_1dx`` and ``_1dy`` filters are plain
PyTorch, as the JAX package computes them in XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from tasmania_tpu_torch.dwarfs.horizontal_diffusion import build_damped_coeff
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing

#: the one-dimensional filters' weight of the centre
CW_1D = {1: 0.5, 2: 0.375, 3: 0.3125}


class HorizontalSmoothing(nn.Module, StencilFactory):
    """Buffer: the coefficient profile ``gamma`` (nz,).  Factory base of the
    filters, each its ``order`` and the ``axes`` it filters:
    ``HorizontalSmoothing.factory("third_order", shape, ...)``."""

    registry = {}
    order: int = 1
    axes: str = "xy"

    def __init__(
        self, shape: Tuple[int, int, int], smooth_coeff: float,
        smooth_coeff_max: float, smooth_damp_depth: int, nb: Optional[int] = None, *,
        backend: str = DEFAULT_BACKEND, backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        self.nb = self.order if (nb is None or nb < self.order) else nb
        so = self.storage_options
        gamma = build_damped_coeff(shape[2], smooth_coeff, smooth_coeff_max, smooth_damp_depth,
                                   so.np_dtype)
        self.register_buffer("gamma", torch.as_tensor(gamma, dtype=so.dtype, device=so.device))

    def _filter_1d(self, w, g, axis: int):
        """The order's Shapiro correction along ``axis`` of a window that
        carries ``order`` more layers on each side along it."""
        n = self.order

        def sh(off):
            idx = [slice(None)] * w.dim()
            idx[axis] = slice(n + off, w.shape[axis] - n + off)
            return w[tuple(idx)]

        if n == 1:
            return 0.25 * g * (sh(-1) + sh(+1))
        if n == 2:
            return 0.0625 * g * (-sh(-2) + 4.0 * sh(-1) - sh(+2) + 4.0 * sh(+1))
        return 0.015625 * g * (
            sh(-3) - 6.0 * sh(-2) + 15.0 * sh(-1) + sh(+3) - 6.0 * sh(+2) + 15.0 * sh(+1)
        )

    def forward(self, phi: torch.Tensor) -> torch.Tensor:
        g = self.gamma.to(phi.dtype)
        nb, n = self.nb, self.order
        if self.axes == "xy":
            return fused_smoothing([phi], g[None], order=n, nb=nb)[0]
        axis = "xy".index(self.axes)
        idx = [slice(None), slice(None)]
        idx[axis] = slice(nb - n, phi.shape[axis] - nb + n)
        w = phi[tuple(idx)]
        idx[axis] = slice(nb, phi.shape[axis] - nb)
        out = phi.clone()
        out[tuple(idx)] = (1.0 - CW_1D[n] * g) * phi[tuple(idx)] + self._filter_1d(w, g, axis)
        return out

    @staticmethod
    def factory(name: str, *args, **kwargs) -> "HorizontalSmoothing":
        return factorize(name, HorizontalSmoothing, args, kwargs)


@factor_register("first_order")
class FirstOrder(HorizontalSmoothing):
    order, axes = 1, "xy"


@factor_register("first_order_1dx")
class FirstOrder1DX(HorizontalSmoothing):
    order, axes = 1, "x"


@factor_register("first_order_1dy")
class FirstOrder1DY(HorizontalSmoothing):
    order, axes = 1, "y"


@factor_register("second_order")
class SecondOrder(HorizontalSmoothing):
    order, axes = 2, "xy"


@factor_register("second_order_1dx")
class SecondOrder1DX(HorizontalSmoothing):
    order, axes = 2, "x"


@factor_register("second_order_1dy")
class SecondOrder1DY(HorizontalSmoothing):
    order, axes = 2, "y"


@factor_register("third_order")
class ThirdOrder(HorizontalSmoothing):
    order, axes = 3, "xy"


@factor_register("third_order_1dx")
class ThirdOrder1DX(HorizontalSmoothing):
    order, axes = 3, "x"


@factor_register("third_order_1dy")
class ThirdOrder1DY(HorizontalSmoothing):
    order, axes = 3, "y"
