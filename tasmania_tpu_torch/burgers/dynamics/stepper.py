"""Time steppers of the Burgers dynamical core (counterpart of
``tasmania_tpu/burgers/dynamics/stepper.py``): the registered schemes
``ForwardEuler``, ``RK2`` and ``RK3WS`` of the factory base
``BurgersStepper``.

Each stage steps from the base state (the state at stage 0) with the
advection of the latest provisional state, ``out = u0 - dt_s·(A(u) - tnd)``,
on the interior inset by ``nb``; the frame keeps the provisional state's
values, which the dycore then overwrites with the boundary's.

* forward Euler: one stage of dt;
* RK2: dt/2, dt;
* RK3WS: dt/3, dt/2, dt.

Each stage stamps its output with the cumulative time of the stage: RK2
t + dt/2 twice, RK3WS t + dt/3, + dt/6, + dt/2 (each offset at a
``timedelta``'s microsecond resolution, as the reference's; see
``framework/field.add_seconds``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np

from tasmania_tpu_torch.burgers.dynamics.advection import BurgersAdvection
from tasmania_tpu_torch.framework.field import add_seconds
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory


class BurgersStepper(StencilFactory):
    """Factory base: ``BurgersStepper.factory("rk3ws", grid_xy, nb,
    "third_order")``.  A scheme is the divisors of dt that give each stage's
    step (``divisors``) and the offset of its time stamp
    (``offset_divisors``)."""

    registry = {}
    divisors: tuple = ()
    offset_divisors: tuple = ()

    def __init__(
        self,
        grid_xy,
        nb: int,
        flux_scheme: str,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> None:
        super().__init__(backend, backend_options, storage_options)
        self.advection = BurgersAdvection.factory(flux_scheme, backend)
        if nb < self.advection.extent:
            raise ValueError(f"nb={nb} must be >= the flux extent {self.advection.extent}")
        self.nb = nb
        self.dx = float(np.asarray(grid_xy.dx.to_units("m").data))
        self.dy = float(np.asarray(grid_xy.dy.to_units("m").data))
        self._base = None

    @staticmethod
    def factory(
        time_integration_scheme: str,
        grid_xy,
        nb: int,
        flux_scheme: str,
        *,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
    ) -> "BurgersStepper":
        return factorize(time_integration_scheme, BurgersStepper,
                         (grid_xy, nb, flux_scheme, backend, backend_options, storage_options))

    @property
    def stages(self) -> int:
        return len(self.divisors)

    def _stage(self, dt: float, u0, v0, state, tendencies) -> Dict[str, Any]:
        nb, ext = self.nb, self.advection.extent
        u_tmp, v_tmp = state["x_velocity"], state["y_velocity"]
        nx, ny = u_tmp.shape[0], u_tmp.shape[1]
        iw, jw = slice(nb - ext, nx - nb + ext), slice(nb - ext, ny - nb + ext)
        adv_u_x, adv_u_y, adv_v_x, adv_v_y = self.advection(self.dx, self.dy, u_tmp[iw, jw], v_tmp[iw, jw])
        i, j = slice(nb, nx - nb), slice(nb, ny - nb)
        du = adv_u_x + adv_u_y
        dv = adv_v_x + adv_v_y
        if "x_velocity" in tendencies:
            du = du - tendencies["x_velocity"][i, j]
        if "y_velocity" in tendencies:
            dv = dv - tendencies["y_velocity"][i, j]
        out_u, out_v = u_tmp.clone(), v_tmp.clone()
        out_u[i, j] = u0[i, j] - dt * du
        out_v[i, j] = v0[i, j] - dt * dv
        return {"x_velocity": out_u, "y_velocity": out_v}

    def __call__(self, stage: int, state: Mapping[str, Any], tendencies: Mapping[str, Any],
                 timestep: float) -> Dict[str, Any]:
        if stage == 0:
            self._base = (state["x_velocity"], state["y_velocity"])
        out = self._stage(timestep / self.divisors[stage], *self._base, state, tendencies)
        if "time" in state:
            out["time"] = add_seconds(state["time"], timestep / self.offset_divisors[stage])
        return out


@factor_register("forward_euler")
class ForwardEuler(BurgersStepper):
    divisors, offset_divisors = (1.0,), (1.0,)


@factor_register("rk2")
class RK2(BurgersStepper):
    divisors, offset_divisors = (2.0, 1.0), (2.0, 2.0)


@factor_register("rk3ws")
class RK3WS(RK2):
    """Wicker-Skamarock RK3 (a subclass of RK2, as in the reference)."""

    divisors, offset_divisors = (3.0, 2.0, 1.0), (3.0, 6.0, 2.0)
