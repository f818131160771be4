"""Time-dependent topography (counterpart of ``tasmania_tpu/domain/topography.py``).

The profile is host-side numpy; its linear growth over ``time`` is a plain
float, so a driver can hand the current profile to the model as a tensor.
The profiles are the JAX package's, registered on ``PhysicalTopography``:
``Flat``, ``Gaussian``, ``Schaer`` and ``UserDefined``."""

from __future__ import annotations

import abc
from datetime import timedelta
from typing import Dict, Optional

import numpy as np

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.registry import factor_register, factorize
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


def _centred_axes(grid, kwargs):
    """hmax, the widths and the centres (defaults 500 m, 1 and the domain's
    centre) in the grid's units, and the (nx, ny) mass-point coordinates."""
    xv, yv = np.asarray(grid.x.data), np.asarray(grid.y.data)
    xu, yu = grid.x.units, grid.y.units
    hmax = _scalar(kwargs.get("max_height"), "m", 500.0, "m")
    wx = _scalar(kwargs.get("width_x"), xu, 1.0, xu)
    wy = _scalar(kwargs.get("width_y"), yu, 1.0, yu)
    cx = _scalar(kwargs.get("center_x"), xu, 0.5 * (xv[0] + xv[-1]), xu)
    cy = _scalar(kwargs.get("center_y"), yu, 0.5 * (yv[0] + yv[-1]), yu)
    xx, yy = np.meshgrid(xv, yv, indexing="ij")
    return hmax, wx, wy, cx, cy, xx, yy


class PhysicalTopography(Topography, abc.ABC):
    """Topography over a physical horizontal grid; factory base of the
    profiles: ``PhysicalTopography.factory("gaussian", grid, **kwargs)``.
    A subclass computes its steady profile (``compute_steady_profile``) and
    registers under a name (``@factor_register``)."""

    registry: Dict[str, type] = {}

    def __init__(self, grid, time: Optional[timedelta], smooth: bool, **kwargs) -> None:
        self.type: Optional[str] = getattr(self, "registry_name", None)
        self.kwargs = {"smooth": smooth, **kwargs}
        steady = np.asarray(self.compute_steady_profile(grid, **kwargs),
                            dtype=np.asarray(grid.x.data).dtype)
        if smooth and steady.shape[0] > 2 and steady.shape[1] > 2:
            steady = steady.copy()
            steady[1:-1, 1:-1] += 0.125 * (
                steady[:-2, 1:-1]
                + steady[2:, 1:-1]
                + steady[1:-1, :-2]
                + steady[1:-1, 2:]
                - 4.0 * steady[1:-1, 1:-1]
            )
        super().__init__(FieldArray(steady, "m", (grid.x.dims[0], grid.y.dims[0])), time=time)

    @abc.abstractmethod
    def compute_steady_profile(self, grid, **kwargs) -> np.ndarray:
        """The steady profile in m over the (nx, ny) mass points of ``grid``."""

    @staticmethod
    def factory(
        topography_type: str,
        grid,
        time: Optional[timedelta] = None,
        smooth: bool = False,
        **kwargs,
    ) -> "PhysicalTopography":
        obj = factorize(topography_type, PhysicalTopography, (grid, time, smooth), kwargs)
        obj.type = topography_type
        return obj


@factor_register("flat")
class Flat(PhysicalTopography):
    def __init__(self, grid, time, smooth, **kwargs):
        super().__init__(grid, time, smooth)

    def compute_steady_profile(self, grid, **kwargs):
        return np.zeros((grid.nx, grid.ny))


@factor_register("gaussian")
class Gaussian(PhysicalTopography):
    """h = hmax·exp(-((x-cx)/sx)² - ((y-cy)/sy)²)."""

    def __init__(self, grid, time, smooth, *, max_height=None, center_x=None, center_y=None,
                 width_x=None, width_y=None, **kwargs):
        super().__init__(grid, time, smooth, max_height=max_height, center_x=center_x,
                         center_y=center_y, width_x=width_x, width_y=width_y)

    def compute_steady_profile(self, grid, **kwargs):
        hmax, wx, wy, cx, cy, xx, yy = _centred_axes(grid, kwargs)
        return hmax * np.exp(-(((xx - cx) / wx) ** 2) - ((yy - cy) / wy) ** 2)


@factor_register("schaer")
class Schaer(PhysicalTopography):
    """The Schaer and Durran (1997) mountain,
    h = hmax / [1 + ((x-cx)/sx)² + ((y-cy)/sy)²]^1.5."""

    def __init__(self, grid, time, smooth, *, max_height=None, center_x=None, center_y=None,
                 width_x=None, width_y=None, **kwargs):
        super().__init__(grid, time, smooth, max_height=max_height, center_x=center_x,
                         center_y=center_y, width_x=width_x, width_y=width_y)

    def compute_steady_profile(self, grid, **kwargs):
        hmax, wx, wy, cx, cy, xx, yy = _centred_axes(grid, kwargs)
        return hmax / (1.0 + ((xx - cx) / wx) ** 2 + ((yy - cy) / wy) ** 2) ** 1.5


@factor_register("user_defined")
class UserDefined(PhysicalTopography):
    """``profile``: a callable ``f(x, y)`` on the (nx, ny) host arrays of the
    mass points, an array or a ``FieldArray``; None is flat."""

    def __init__(self, grid, time, smooth, *, profile=None, **kwargs):
        super().__init__(grid, time, smooth, profile=profile)

    def compute_steady_profile(self, grid, **kwargs):
        profile = kwargs.get("profile")
        if profile is None:
            return np.zeros((grid.nx, grid.ny))
        if callable(profile):
            xx, yy = np.meshgrid(np.asarray(grid.x.data), np.asarray(grid.y.data), indexing="ij")
            return np.asarray(profile(xx, yy))
        if isinstance(profile, FieldArray):
            return np.asarray(profile.to_units("m").data)
        return np.asarray(profile)


class NumericalTopography(Topography):
    """The physical topography carried over to the numerical grid."""

    def __init__(self, boundary) -> None:
        phys = boundary.physical_grid.topography
        self.type = phys.type
        self.kwargs = phys.kwargs
        steady = boundary.get_numerical_field(np.asarray(phys.steady_profile.data))
        profile = boundary.get_numerical_field(np.asarray(phys.profile.data))
        dims = phys.steady_profile.dims
        super().__init__(
            FieldArray(np.asarray(steady), "m", dims),
            FieldArray(np.asarray(profile), "m", dims),
            phys.time,
        )
