"""Time steppers over a tendency coupling: forward Euler, RK2 and RK3WS, and
their sequential-tendency variants (counterpart of
``tasmania_tpu/framework/steppers.py``).

Stage algebra, with ``f`` the coupling's tendencies and, for the
sequential-tendency steppers, ``x'`` the provisional state:

* FE    : out = x + dt·f(x)
* RK2   : x1 = x + dt/2·f(x);  out = x + dt·f(x1)
* RK2SA : RK2, returning the diagnostics of the second stage
* RK3WS : x1 = x + dt/3·f(x);  x2 = x + dt/2·f(x1);  out = x + dt·f(x2)
* STS-FE    : out = x' + dt·f(x)
* STS-RK2   : x1 = ½(x + x' + dt·f(x));  out = x' + dt·f(x1)
* STS-RK3WS : x1 = (2x + x' + dt·f(x))/3;  x2 = ½(x + x' + dt·f(x1));
              out = x' + dt·f(x2)

The diagnostics returned are those of the first stage (RK2SA's: of the
second).  Each family is a factory base whose schemes register by name
(``@factor_register``): ``TendencyStepper.factory("rk3ws", ...)``;
``isentropic/physics/sequential_tendency_stepper.py`` registers the
sequential-tendency scheme ``"isentropic_vertical_advection"``.  RK2 and
RK3WS first ask the coupling, then its single component, for one operation
that runs the whole step (``fused_rk_step``, by the scheme's ``name``);
that is the kernel path on the card.  The sequential-tendency steppers
always go stage by stage.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Optional, Tuple

from torch import nn

from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.dict_operator import fma, sts_rk2_0, sts_rk3ws_0
from tasmania_tpu_torch.framework.field import ensure_timedelta_seconds
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
from tasmania_tpu_torch.framework.registry import factor_register, factorize
from tasmania_tpu_torch.framework.stencil import DEFAULT_BACKEND, StencilFactory
from tasmania_tpu_torch.utils.units import strip_per_second

PropertyDict = Dict[str, Dict[str, Any]]


class _Stepper(nn.Module, StencilFactory):
    """A coupling, the variables it has tendencies for (each in its state
    units: the coupling's input units, else the tendency's units times a
    second) and the optional boundary enforcement between stages."""

    name = ""

    def __init__(
        self,
        *components,
        execution_policy: str = "serial",
        enforce_horizontal_boundary: bool = False,
        enable_checks: bool = True,
        backend: str = DEFAULT_BACKEND,
        backend_options: Optional[BackendOptions] = None,
        storage_options: Optional[StorageOptions] = None,
        **kwargs,
    ) -> None:
        nn.Module.__init__(self)
        StencilFactory.__init__(self, backend, backend_options, storage_options)
        if len(components) == 1 and isinstance(components[0], ConcurrentCoupling):
            self.coupling = components[0]
        else:
            self.coupling = ConcurrentCoupling(*components, execution_policy=execution_policy)
        cin = self.coupling.input_properties
        self.output_properties: PropertyDict = {}
        for name, tprops in self.coupling.tendency_properties.items():
            units = cin[name]["units"] if name in cin else strip_per_second(tprops.get("units", "s^-1"))
            self.output_properties[name] = {**tprops, "units": units}
        self.enforce_hb = enforce_horizontal_boundary and self.coupling.horizontal_boundary is not None

    def _post_stage(self, state, stepped):
        """Enforce the lateral boundary where asked; the stage's full state."""
        if self.enforce_hb:
            hb = self.coupling.horizontal_boundary
            stepped = {
                k: fa.with_data(hb.enforce_field(fa.data, k, fa.units)) for k, fa in stepped.items()
            }
        stage_state = dict(state)
        stage_state.update(stepped)
        return stepped, stage_state


class TendencyStepper(_Stepper):
    """Steps the variables a coupling has tendencies for; ``__call__`` returns
    ``(diagnostics, new_state)``.  Factory base of the tendency steppers."""

    registry: Dict[str, type] = {}

    @staticmethod
    def factory(scheme: str, *components, **kwargs) -> "TendencyStepper":
        return factorize(scheme, TendencyStepper, components, kwargs)

    def forward(self, state, timestep) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        dt = ensure_timedelta_seconds(timestep)
        diagnostics, out = self._call(state, dt)
        if "time" in state:
            out["time"] = state["time"] + timedelta(seconds=dt)
        return diagnostics, out

    def _call(self, state, dt: float):
        raise NotImplementedError

    def _try_fused(self, state, dt: float):
        """The whole step as one operation, when the coupling (a recognised
        chain) or its single component offers one; None otherwise or when the
        boundary is enforced between stages."""
        if self.enforce_hb:
            return None
        res = self.coupling.fused_rk_step(self.name, state, dt, self.output_properties)
        if res is not None:
            return res
        comps = self.coupling.components
        fused = getattr(comps[0], "fused_rk_step", None) if len(comps) == 1 else None
        return None if fused is None else fused(self.name, state, dt, self.output_properties)

    def _stage(self, state, base, dt_stage: float, dt: float):
        """``base + dt_stage·f(state)``: (diagnostics, stepped, stage state)."""
        k, diagnostics = self.coupling(state, dt)
        stepped, stage_state = self._post_stage(base, fma(base, k, dt_stage, self.output_properties))
        return diagnostics, stepped, stage_state


@factor_register("forward_euler")
class ForwardEuler(TendencyStepper):
    name = "forward_euler"

    def _call(self, state, dt):
        diagnostics, out, _ = self._stage(state, state, dt, dt)
        return diagnostics, out


@factor_register("rk2")
class RK2(TendencyStepper):
    name = "rk2"

    def _call(self, state, dt):
        fused = self._try_fused(state, dt)
        if fused is not None:
            return fused
        diagnostics, _, stage1 = self._stage(state, state, 0.5 * dt, dt)
        _, out, _ = self._stage(stage1, state, dt, dt)
        return diagnostics, out


@factor_register("rk2sa")
class RK2SA(TendencyStepper):
    """RK2 that returns the diagnostics of its second stage, for a component
    whose diagnostics are the adjusted state
    (``KesslerSaturationAdjustmentDiagnostic``); it never fuses."""

    name = "rk2sa"

    def _call(self, state, dt):
        _, _, stage1 = self._stage(state, state, 0.5 * dt, dt)
        diagnostics, out, _ = self._stage(stage1, state, dt, dt)
        return diagnostics, out


@factor_register("rk3ws")
class RK3WS(TendencyStepper):
    """Wicker-Skamarock three-stage Runge-Kutta."""

    name = "rk3ws"

    def _call(self, state, dt):
        fused = self._try_fused(state, dt)
        if fused is not None:
            return fused
        diagnostics, _, stage1 = self._stage(state, state, dt / 3.0, dt)
        _, _, stage2 = self._stage(stage1, state, 0.5 * dt, dt)
        _, out, _ = self._stage(stage2, state, dt, dt)
        return diagnostics, out


class SequentialTendencyStepper(_Stepper):
    """Evaluates the tendencies on the current state and applies them to the
    provisional one; ``__call__(state, prv_state, timestep)`` returns
    ``(diagnostics, new_provisional_state)``.  Factory base of the
    sequential-tendency steppers."""

    registry: Dict[str, type] = {}

    @staticmethod
    def factory(scheme: str, *components, **kwargs) -> "SequentialTendencyStepper":
        return factorize(scheme, SequentialTendencyStepper, components, kwargs)

    def forward(self, state, prv_state, timestep) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        dt = ensure_timedelta_seconds(timestep)
        diagnostics, out = self._call(state, prv_state, dt)
        if "time" in state:
            out["time"] = state["time"] + timedelta(seconds=dt)
        return diagnostics, out

    def _call(self, state, prv_state, dt: float):
        raise NotImplementedError

    def _stage(self, state, stepped):
        """The stage's full state: ``state`` with the stepped variables."""
        return self._post_stage(state, stepped)[1]

    def _last(self, state, prv_state, k, dt: float):
        return self._post_stage(state, fma(prv_state, k, dt, self.output_properties))[0]


@factor_register("forward_euler")
class ForwardEulerSTS(SequentialTendencyStepper):
    name = "forward_euler"

    def _call(self, state, prv_state, dt):
        k1, diagnostics = self.coupling(state, dt)
        return diagnostics, self._last(state, prv_state, k1, dt)


@factor_register("rk2")
class RK2STS(SequentialTendencyStepper):
    name = "rk2"

    def _call(self, state, prv_state, dt):
        k1, diagnostics = self.coupling(state, dt)
        stage1 = self._stage(state, sts_rk2_0(dt, state, prv_state, k1, self.output_properties))
        k2, _ = self.coupling(stage1, dt)
        return diagnostics, self._last(state, prv_state, k2, dt)


@factor_register("rk3ws")
class RK3WSSTS(SequentialTendencyStepper):
    name = "rk3ws"

    def _call(self, state, prv_state, dt):
        k1, diagnostics = self.coupling(state, dt)
        stage1 = self._stage(state, sts_rk3ws_0(dt, state, prv_state, k1, self.output_properties))
        k2, _ = self.coupling(stage1, dt)
        stage2 = self._stage(state, sts_rk2_0(dt, state, prv_state, k2, self.output_properties))
        k3, _ = self.coupling(stage2, dt)
        return diagnostics, self._last(state, prv_state, k3, dt)
