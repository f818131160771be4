"""The sequential-tendency stepper that folds Crank–Nicolson vertical
advection into the stepping algebra (counterpart of
``tasmania_tpu/isentropic/physics/sequential_tendency_stepper.py``, the
scheme ``"isentropic_vertical_advection"``).

Per column, d[k] = φ'[k] − γ·(w[k-1]·φ[k-1] − w[k+1]·φ[k+1]) with the
off-diagonals and φ from the current state and the right-hand side anchored
to the provisional state φ' (first and last rows φ'), γ = dt/(4·dz); the
same column solve as ``implicit_vertical_advection``, in plain PyTorch.
"""

from __future__ import annotations

from typing import Any, Dict

from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict, wrap_outputs
from tasmania_tpu_torch.framework.registry import factor_register
from tasmania_tpu_torch.framework.stencil import compile_stencil
from tasmania_tpu_torch.utils.array import get_namespace
from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper
from tasmania_tpu_torch.isentropic.physics.implicit_vertical_advection import (
    S,
    SU,
    SV,
    TTD,
    TTD_Z,
    WATER,
    IsentropicImplicitVerticalAdvectionDiagnostic,
    solve_columns,
    vertical_velocity,
)


def setup_thomas_sts(gamma: float, w, phi, phi_prv, xp=None):
    """(a, b, c, d) of the CN system anchored to the provisional state, in
    the reference layout (the level last), on host arrays or tensors (``xp``
    numpy or torch, by default ``phi``'s); the stepper builds the same
    system level-major (``implicit_vertical_advection.setup_thomas``)."""
    xp = xp or get_namespace(phi)
    nz = phi.shape[2]
    zeros_edge = xp.zeros_like(phi[:, :, :1])
    a = xp.concatenate([zeros_edge, gamma * w[:, :, : nz - 2], zeros_edge], axis=2)
    c = xp.concatenate([zeros_edge, -gamma * w[:, :, 2:nz], zeros_edge], axis=2)
    b = xp.ones_like(phi)
    d_mid = phi_prv[:, :, 1 : nz - 1] - gamma * (
        w[:, :, : nz - 2] * phi[:, :, : nz - 2] - w[:, :, 2:nz] * phi[:, :, 2:nz]
    )
    d = xp.concatenate([phi_prv[:, :, :1], d_mid, phi_prv[:, :, nz - 1 :]], axis=2)
    return a, b, c, d


@factor_register("isentropic_vertical_advection")
class IsentropicVerticalAdvectionSTS(SequentialTendencyStepper):
    """A sequential-tendency stepper whose component must be an
    :class:`IsentropicImplicitVerticalAdvectionDiagnostic`; it returns no
    diagnostics and the stepped s, su, sv (and the mass fractions, when
    moist) as the new provisional state.  The lateral boundary is never
    enforced."""

    name = "isentropic_vertical_advection"

    def __init__(self, *components, enforce_horizontal_boundary: bool = False, **kwargs) -> None:
        super().__init__(*components, **kwargs)
        core = next((c for c in components
                     if isinstance(c, IsentropicImplicitVerticalAdvectionDiagnostic)), None)
        if core is None:
            raise TypeError("isentropic_vertical_advection expects an "
                            "IsentropicImplicitVerticalAdvectionDiagnostic component")
        self.core = core
        self.thomas = compile_stencil("thomas", core.backend, core.backend_options)
        self.input_properties = dict(core.input_properties)
        self.provisional_input_properties = {
            k: v for k, v in core.input_properties.items() if k not in (TTD, TTD_Z)
        }
        self.output_properties: Dict[str, Any] = dict(core.diagnostic_properties)
        self.enforce_hb = False

    def _call(self, state, prv_state, dt: float):
        raw = get_array_dict(state, self.input_properties)
        prv = get_array_dict(prv_state, self.provisional_input_properties)
        core = self.core
        fields, anchors = [raw[S], raw[SU], raw[SV]], [prv[S], prv[SU], prv[SV]]
        if core.moist:
            fields += [raw[S] * raw[q] for q in WATER]
            anchors += [prv[S] * prv[q] for q in WATER]
        x = solve_columns(self.thomas, dt / (4.0 * core.dz), vertical_velocity(raw, core.stgz), fields,
                          anchors)
        if core.moist:
            x[3:].div_(x[:1])
        out: Dict[str, FieldArray] = wrap_outputs(dict(zip(self.output_properties, x)),
                                                  self.output_properties)
        return {}, out
