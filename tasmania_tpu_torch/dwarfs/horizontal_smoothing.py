"""Horizontal Shapiro smoothing: filter order and vertically graded
coefficient (counterpart of ``tasmania_tpu/dwarfs/horizontal_smoothing.py``).
The filter itself is ``ops/smoothing_step.py``; the two-dimensional filters
of order 1-3 are ported."""

from __future__ import annotations

import math

import numpy as np

ORDERS = {"first_order": 1, "second_order": 2, "third_order": 3}


def build_damped_coeff(nz: int, coeff: float, coeff_max: float, damp_depth: int, dtype) -> np.ndarray:
    """(nz,) coefficient profile with a sin² ramp from ``coeff`` to
    ``coeff_max`` over the top ``damp_depth`` levels."""
    gamma = coeff * np.ones(nz, dtype=dtype)
    n = min(damp_depth, nz)  # shallow grids
    if n > 0:
        pert = np.sin(0.5 * math.pi * (n - np.arange(0, n, dtype=dtype)) / n) ** 2
        gamma[:n] += (coeff_max - coeff) * pert
    return gamma


class HorizontalSmoothing:
    """Order and coefficient profile of one smoothing filter."""

    def __init__(
        self, smooth_type: str, nz: int, smooth_coeff: float, smooth_coeff_max: float,
        smooth_damp_depth: int, nb: int | None, dtype,
    ) -> None:
        if smooth_type not in ORDERS:
            raise NotImplementedError(
                f"smoothing {smooth_type!r} is not ported (have {sorted(ORDERS)})"
            )
        self.order = ORDERS[smooth_type]
        self.nb = self.order if (nb is None or nb < self.order) else nb
        self.gamma = build_damped_coeff(
            nz, smooth_coeff, smooth_coeff_max, smooth_damp_depth, dtype
        )
