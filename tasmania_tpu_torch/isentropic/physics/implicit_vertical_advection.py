"""Implicit (Crank–Nicolson) vertical advection by column Thomas solves
(counterpart of ``tasmania_tpu/isentropic/physics/implicit_vertical_advection.py``).

With γ = dt/(4·dz) each advected field φ solves the tridiagonal system with
rows a[k] = γ·w[k-1], b = 1, c[k] = −γ·w[k+1] and
d[k] = φ[k] − γ·(w[k-1]·φ[k-1] − w[k+1]·φ[k+1]), and identity first and last
rows.  The fields are s, su, sv and, when moist, s·q for the three water
species; a, b and c depend on w alone, so the six systems share them and
the port solves them together: the right-hand sides stacked on one axis of
a level-major tensor, the sweep of the coefficients done once.  The solve is
the registered stencil ``"thomas"`` of the component's backend
(``compile_stencil``, as in the JAX package), given the level-major tensors
as views whose last axis is the level (``framework/stencil_definitions.thomas``
copies nothing on the way in).  The arithmetic of each field is the JAX
package's, in its order.

The JAX package computes this with ``lax.scan`` and no Pallas kernel, so the
port is plain PyTorch: about nz levels of plane-sized operations in each
direction.

Two flavours, as in the JAX package:

* ``...Diagnostic``: the stepped fields as diagnostics (the SUS chain's
  process when ``implicit_vertical_advection`` is set);
* ``...Prognostic``: the tendencies (new − old)/dt.
"""

from __future__ import annotations

import numpy as np
import torch

from tasmania_tpu_torch.framework.core_components import ImplicitTendencyComponent

mfwv = "mass_fraction_of_water_vapor_in_air"
mfcw = "mass_fraction_of_cloud_liquid_water_in_air"
mfpw = "mass_fraction_of_precipitation_water_in_air"

DIMS = ("x", "y", "z")
DIMS_Z = ("x", "y", "z_on_interface_levels")
TTD = "tendency_of_air_potential_temperature"
TTD_Z = "tendency_of_air_potential_temperature_on_interface_levels"
S, SU, SV = "air_isentropic_density", "x_momentum_isentropic", "y_momentum_isentropic"
WATER = (mfwv, mfcw, mfpw)


def level_major(fields):
    """(n, m, nx, ny): the m (nx, ny, n) ``fields`` with the level first."""
    nx, ny, n = fields[0].shape
    out = torch.empty((n, len(fields), nx, ny), dtype=fields[0].dtype, device=fields[0].device)
    for i, f in enumerate(fields):
        out[:, i].copy_(f.permute(2, 0, 1))
    return out


def setup_thomas(gamma: float, w, phi, phi_prv=None):
    """(a, b, c, d) of the CN systems, level-major: ``w`` (n, nx, ny), ``phi``
    (n, m, nx, ny); the right-hand side anchored to ``phi_prv`` where given
    (the sequential-tendency stepper's provisional state), else to ``phi``."""
    n = w.shape[0]
    anchor = phi if phi_prv is None else phi_prv
    edge = torch.zeros_like(w[:1])
    a = torch.cat([edge, gamma * w[: n - 2], edge])
    c = torch.cat([edge, -gamma * w[2:n], edge])
    b = torch.ones_like(w)
    wm, wp = w[: n - 2].unsqueeze(1), w[2:n].unsqueeze(1)
    d_mid = anchor[1 : n - 1] - gamma * (wm * phi[: n - 2] - wp * phi[2:n])
    d = torch.cat([anchor[:1], d_mid, anchor[n - 1 :]])
    return a, b, c, d


def solve_columns(thomas, gamma: float, w, fields, anchors=None):
    """The CN solutions of ``fields`` (each (nx, ny, n)), optionally anchored
    to ``anchors``, by the registered solve ``thomas``: (m, nx, ny, n), one
    contiguous field per index of the first axis."""
    w_lm = w.permute(2, 0, 1).contiguous()
    phi = level_major(fields)
    phi_prv = None if anchors is None else level_major(anchors)
    return thomas(*(t.movedim(0, -1) for t in setup_thomas(gamma, w_lm, phi, phi_prv)))


def vertical_velocity(state, stgz: bool):
    """w on the main levels: the θ-tendency, or the mean of its interface
    values."""
    if stgz:
        w_if = state[TTD_Z]
        return 0.5 * (w_if[:, :, :-1] + w_if[:, :, 1:])
    return state[TTD]


class _ImplicitVerticalAdvectionBase(ImplicitTendencyComponent):
    def __init__(
        self,
        domain,
        moist: bool = False,
        tendency_of_air_potential_temperature_on_interface_levels: bool = False,
        **kwargs,
    ) -> None:
        super().__init__(domain, "numerical", **kwargs)
        self.moist = moist
        self.stgz = tendency_of_air_potential_temperature_on_interface_levels
        self.dz = float(np.asarray(self.grid.dz.to_units("K").data))
        self.thomas = self.compile_stencil("thomas")

    @property
    def input_properties(self):
        props = {
            S: {"dims": DIMS, "units": "kg m^-2 K^-1"},
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }
        if self.stgz:
            props[TTD_Z] = {"dims": DIMS_Z, "units": "K s^-1"}
        else:
            props[TTD] = {"dims": DIMS, "units": "K s^-1"}
        if self.moist:
            for q in WATER:
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    @property
    def stepped_properties(self):
        """The units of the stepped fields."""
        props = {name: dict(self.input_properties[name]) for name in (S, SU, SV)}
        if self.moist:
            for q in WATER:
                props[q] = {"dims": DIMS, "units": "g g^-1"}
        return props

    def solve_all(self, state, dt: float):
        """The stepped s, su, sv and, when moist, q = (s·q)_new / s_new, in
        the reference layout."""
        s = state[S]
        fields = [s, state[SU], state[SV]]
        if self.moist:
            fields += [s * state[q] for q in WATER]
        x = solve_columns(self.thomas, dt / (4.0 * self.dz), vertical_velocity(state, self.stgz), fields)
        if self.moist:
            x[3:].div_(x[:1])
        return dict(zip(self.stepped_properties, x))


class IsentropicImplicitVerticalAdvectionDiagnostic(_ImplicitVerticalAdvectionBase):
    """The stepped fields, returned as diagnostics."""

    @property
    def tendency_properties(self):
        return {}

    @property
    def diagnostic_properties(self):
        return self.stepped_properties

    def array_call(self, state, timestep: float):
        return {}, self.solve_all(state, timestep)


class IsentropicImplicitVerticalAdvectionPrognostic(_ImplicitVerticalAdvectionBase):
    """The tendencies (new − old)/dt."""

    @property
    def tendency_properties(self):
        return {
            S: {"dims": DIMS, "units": "kg m^-2 K^-1 s^-1"},
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            **({q: {"dims": DIMS, "units": "g g^-1 s^-1"} for q in WATER} if self.moist else {}),
        }

    @property
    def diagnostic_properties(self):
        return {}

    def array_call(self, state, timestep: float):
        new = self.solve_all(state, timestep)
        return {name: (x - state[name]) / timestep for name, x in new.items()}, {}


# the sequential-tendency stepper of this process registers itself with the
# stepper factory when its module is imported
from tasmania_tpu_torch.isentropic.physics import sequential_tendency_stepper  # noqa: E402,F401
