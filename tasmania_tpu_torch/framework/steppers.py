"""Time steppers over a tendency coupling: forward Euler, RK2 and RK3WS
(counterpart of ``tasmania_tpu/framework/steppers.py``, the tendency
steppers).

Stage algebra, with ``f`` the coupling's tendencies:

* FE    : out = x + dt·f(x)
* RK2   : x1 = x + dt/2·f(x);  out = x + dt·f(x1)
* RK3WS : x1 = x + dt/3·f(x);  x2 = x + dt/2·f(x1);  out = x + dt·f(x2)

The diagnostics returned are those of the first stage.  RK2 and RK3WS first
ask the coupling, then its single component, for one operation that runs the
whole step (``fused_rk_step``); that is the kernel path on the card.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Any, Dict, Tuple

from torch import nn

from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.field import FieldArray, ensure_timedelta_seconds
from tasmania_tpu_torch.utils.units import per_second, strip_per_second

PropertyDict = Dict[str, Dict[str, Any]]


def fma(state, tendencies, dt: float, field_properties) -> Dict[str, FieldArray]:
    """``state + dt·tendency`` over the fields of ``field_properties``, each in
    its declared units (the tendency converted to those units per second)."""
    out: Dict[str, FieldArray] = {}
    for name, props in field_properties.items():
        if name not in state:
            continue
        s = state[name].to_units(props["units"])
        if name in tendencies:
            t = tendencies[name].to_units(per_second(props["units"]))
            out[name] = FieldArray(s.data + dt * t.data, s.units, s.dims)
        else:
            out[name] = s
    return out


class TendencyStepper(nn.Module):
    """Steps the variables a coupling has tendencies for; ``__call__`` returns
    ``(diagnostics, new_state)``."""

    name = ""

    def __init__(self, *components, enforce_horizontal_boundary: bool = False) -> None:
        super().__init__()
        if len(components) == 1 and isinstance(components[0], ConcurrentCoupling):
            self.coupling = components[0]
        else:
            self.coupling = ConcurrentCoupling(*components)
        # each stepped variable in its state units: the coupling's input
        # units, else the tendency's units times a second
        cin = self.coupling.input_properties
        self.output_properties: PropertyDict = {}
        for name, tprops in self.coupling.tendency_properties.items():
            units = cin[name]["units"] if name in cin else strip_per_second(tprops.get("units", "s^-1"))
            self.output_properties[name] = {**tprops, "units": units}
        self.enforce_hb = enforce_horizontal_boundary and self.coupling.horizontal_boundary is not None

    @staticmethod
    def factory(scheme: str, *components, **kwargs) -> "TendencyStepper":
        if scheme not in _SCHEMES:
            raise NotImplementedError(f"time integration scheme {scheme!r} is not ported (have {sorted(_SCHEMES)})")
        return _SCHEMES[scheme](*components, **kwargs)

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

    def _stage(self, state, base, dt_stage: float, dt: float):
        """``base + dt_stage·f(state)``: (diagnostics, stepped, stage state)."""
        k, diagnostics = self.coupling(state, dt)
        stepped, stage_state = self._post_stage(base, fma(base, k, dt_stage, self.output_properties))
        return diagnostics, stepped, stage_state


class ForwardEuler(TendencyStepper):
    name = "forward_euler"

    def _call(self, state, dt):
        diagnostics, out, _ = self._stage(state, state, dt, dt)
        return diagnostics, out


class RK2(TendencyStepper):
    name = "rk2"

    def _call(self, state, dt):
        fused = self._try_fused(state, dt)
        if fused is not None:
            return fused
        diagnostics, _, stage1 = self._stage(state, state, 0.5 * dt, dt)
        _, out, _ = self._stage(stage1, state, dt, dt)
        return diagnostics, out


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


_SCHEMES = {cls.name: cls for cls in (ForwardEuler, RK2, RK3WS)}
