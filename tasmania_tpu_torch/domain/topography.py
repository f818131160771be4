"""Time-dependent topography (counterpart of ``tasmania_tpu/domain/topography.py``).

The profile is host-side numpy; its linear growth over ``time`` is a plain
float, so a driver can hand the current profile to the model as a tensor.
Only the profiles the ported configurations use are here (flat, Gaussian,
user-defined)."""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.utils.units import conversion_factor


def _scalar(value, units: str, default, target_units: str) -> float:
    """A float in ``target_units`` from value-or-FieldArray-or-None."""
    if value is None:
        return float(default)
    if isinstance(value, FieldArray):
        return float(np.asarray(value.to_units(target_units).data))
    return float(value) * conversion_factor(units, target_units)


class Topography:
    """Steady profile plus optional linear growth over ``time``."""

    def __init__(
        self,
        steady_profile: FieldArray,
        profile: Optional[FieldArray] = None,
        time: Optional[timedelta] = None,
    ) -> None:
        self.steady_profile = steady_profile.to_units("m")
        self.time = time or timedelta(seconds=0)
        self._fact = float(self.time.total_seconds() == 0.0)
        sp = np.asarray(self.steady_profile.data)
        self.profile = FieldArray(
            self._fact * sp if profile is None else np.asarray(profile.to_units("m").data),
            "m",
            steady_profile.dims,
        )

    def update(self, time: timedelta) -> None:
        """Grow the profile linearly until ``time >= self.time``."""
        if self._fact < 1.0 and self.time.total_seconds() > 0.0:
            self._fact = min(time.total_seconds() / self.time.total_seconds(), 1.0)
            self.profile = FieldArray(
                self._fact * np.asarray(self.steady_profile.data),
                "m",
                self.steady_profile.dims,
            )


def _gaussian(grid, max_height=None, center_x=None, center_y=None,
              width_x=None, width_y=None):
    """h = hmax·exp(-((x-cx)/sx)² - ((y-cy)/sy)²)."""
    xv, yv = np.asarray(grid.x.data), np.asarray(grid.y.data)
    xu, yu = grid.x.units, grid.y.units
    hmax = _scalar(max_height, "m", 500.0, "m")
    wx = _scalar(width_x, xu, 1.0, xu)
    wy = _scalar(width_y, yu, 1.0, yu)
    cx = _scalar(center_x, xu, 0.5 * (xv[0] + xv[-1]), xu)
    cy = _scalar(center_y, yu, 0.5 * (yv[0] + yv[-1]), yu)
    xx, yy = np.meshgrid(xv, yv, indexing="ij")
    return hmax * np.exp(-(((xx - cx) / wx) ** 2) - ((yy - cy) / wy) ** 2)


def _flat(grid):
    return np.zeros((grid.nx, grid.ny))


def _user_defined(grid, profile=None):
    """``profile``: a callable ``f(x, y)`` on the (nx, ny) host arrays of the
    mass points, an array or a ``FieldArray``; None is flat."""
    if profile is None:
        return _flat(grid)
    if callable(profile):
        xx, yy = np.meshgrid(np.asarray(grid.x.data), np.asarray(grid.y.data), indexing="ij")
        return np.asarray(profile(xx, yy))
    if isinstance(profile, FieldArray):
        return np.asarray(profile.to_units("m").data)
    return np.asarray(profile)


_PROFILES = {"flat": _flat, "gaussian": _gaussian, "user_defined": _user_defined}


class PhysicalTopography(Topography):
    """Topography over a physical horizontal grid."""

    def __init__(
        self,
        topography_type: str,
        grid,
        time: Optional[timedelta] = None,
        smooth: bool = False,
        **kwargs,
    ) -> None:
        if topography_type not in _PROFILES:
            raise NotImplementedError(
                f"topography {topography_type!r} is not ported (have {sorted(_PROFILES)})"
            )
        self.type = topography_type
        steady = np.asarray(
            _PROFILES[topography_type](grid, **kwargs),
            dtype=np.asarray(grid.x.data).dtype,
        )
        if smooth and steady.shape[0] > 2 and steady.shape[1] > 2:
            steady = steady.copy()
            steady[1:-1, 1:-1] += 0.125 * (
                steady[:-2, 1:-1]
                + steady[2:, 1:-1]
                + steady[1:-1, :-2]
                + steady[1:-1, 2:]
                - 4.0 * steady[1:-1, 1:-1]
            )
        super().__init__(
            FieldArray(steady, "m", (grid.x.dims[0], grid.y.dims[0])), time=time
        )


class NumericalTopography(Topography):
    """The physical topography carried over to the numerical grid."""

    def __init__(self, boundary) -> None:
        phys = boundary.physical_grid.topography
        self.type = phys.type
        steady = boundary.get_numerical_field(np.asarray(phys.steady_profile.data))
        profile = boundary.get_numerical_field(np.asarray(phys.profile.data))
        dims = phys.steady_profile.dims
        super().__init__(
            FieldArray(np.asarray(steady), "m", dims),
            FieldArray(np.asarray(profile), "m", dims),
            phys.time,
        )
