"""Smagorinsky turbulence in conservative (momentum) form for the isentropic
model (counterpart of ``tasmania_tpu/isentropic/physics/turbulence.py:17-95``):
u = su/s, the velocity-form core, tendencies scaled by s.

Under RK2 the stepper takes ``fused_rk_step``: both stages in
``ops/smagorinsky_step.fused_smagorinsky_rk2`` (the kernel on the card).
With the merge ``"smooth_smag"`` (``SequentialUpdateSplitting(...,
merges=...)``) the smoothing before it and its RK2 step run as one
operation, ``fused_smoothing_smagorinsky_rk2``.

On a shard of a 2-D decomposition both decline, as the JAX package's do
(``turbulence.py:37-43``, ``:128-131``: their frames are local), and the
tendency runs as ``array_call`` with the boundary's restrict and refresh
hooks (``:80-91``).
"""

from __future__ import annotations

from tasmania_tpu_torch.framework.field import FieldArray, get_array_dict
from tasmania_tpu_torch.framework.splitting import register_process_pair_fuser
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import IsentropicHorizontalSmoothing
from tasmania_tpu_torch.ops.smagorinsky_step import (
    fused_smagorinsky_rk2,
    fused_smoothing_smagorinsky_rk2,
)
from tasmania_tpu_torch.physics.turbulence import Smagorinsky2d, frame_paste, smagorinsky_core
from tasmania_tpu_torch.utils.timer import Timer

DIMS = ("x", "y", "z")
SU, SV = "x_momentum_isentropic", "y_momentum_isentropic"


class IsentropicSmagorinsky(Smagorinsky2d):
    @property
    def input_properties(self):
        return {
            "air_isentropic_density": {"dims": DIMS, "units": "kg m^-2 K^-1"},
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-1"},
        }

    @property
    def tendency_properties(self):
        return {
            SU: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
            SV: {"dims": DIMS, "units": "kg m^-1 K^-1 s^-2"},
        }

    def fused_rk_step(self, scheme, state, dt, output_properties):
        """The whole RK2 step in one operation; None for another scheme or
        on a shard of a decomposition."""
        if scheme != "rk2" or not self.horizontal_boundary.is_degenerate:
            return None
        with Timer.timing(type(self).__name__):
            raw = get_array_dict(state, self.input_properties)
            dx, dy = self.spacings()
            su, sv = fused_smagorinsky_rk2(
                raw["air_isentropic_density"], raw[SU], raw[SV],
                dx=dx, dy=dy, cs=self.cs, nb=self.nb, dt=float(dt),
            )
        return {}, {
            SU: FieldArray(su, output_properties[SU]["units"], DIMS),
            SV: FieldArray(sv, output_properties[SV]["units"], DIMS),
        }

    def array_call(self, state):
        s = state["air_isentropic_density"]
        u = state[SU] / s
        v = state[SV] / s
        dx, dy = self.spacings()
        nb = self.nb
        u_tnd, v_tnd = smagorinsky_core(u, v, dx, dy, self.cs, nb)
        s_in = s[nb : s.shape[0] - nb, nb : s.shape[1] - nb]
        hb = self.horizontal_boundary
        out_su, out_sv = hb.refresh_halos_many([
            hb.restrict_stencil_output(frame_paste(s.shape, nb, s_in * u_tnd), nb=nb),
            hb.restrict_stencil_output(frame_paste(s.shape, nb, s_in * v_tnd), nb=nb),
        ])
        return {SU: out_su, SV: out_sv}, {}


# the SUS process pair [IsentropicHorizontalSmoothing -> IsentropicSmagorinsky(rk2)]
# as one operation, the merge "smooth_smag" (counterpart of
# tasmania_tpu/isentropic/physics/turbulence.py:103-199)


def _smooth_smag_pair_matches(smoothing, stepper) -> bool:
    # The JAX matcher also asks nx >= 8 + 2n + 4 for its TPU x-tile; the CUDA
    # kernel tiles (x, y) itself and needs only the frame conditions below.
    if not isinstance(smoothing, IsentropicHorizontalSmoothing) or smoothing.axes != "xy":
        return False
    if not smoothing.horizontal_boundary.is_degenerate:
        return False  # the merged kernel's frame is local
    if getattr(stepper, "name", "") != "rk2" or stepper.enforce_hb:
        return False
    comps = stepper.coupling.components
    if len(comps) != 1 or not isinstance(comps[0], IsentropicSmagorinsky):
        return False
    # the merged kernel runs both processes with one nb: the boundary's, which
    # the separate Smagorinsky uses; the smoothing's own nb is max(order,
    # hb.nb), so the merge holds only where that is the boundary's too
    nb, grid = smoothing.horizontal_boundary.nb, smoothing.grid
    return nb >= max(smoothing.order, 2) and min(grid.nx, grid.ny) >= 2 * nb + 1


def _smooth_smag_pair_fuser(smoothing, stepper, state, td):
    """Smooth every field and RK2-step the smoothed momenta in one operation
    (``fused_smoothing_smagorinsky_rk2``): the smoothed s and mass fractions
    as diagnostics, the stepped momenta as the stepped state."""
    smag = stepper.coupling.components[0]
    names = list(smoothing.input_properties)
    raw = get_array_dict(state, smoothing.input_properties)
    dx, dy = smag.spacings()
    outs = fused_smoothing_smagorinsky_rk2(
        [raw[n] for n in names], smoothing.gamma, order=smoothing.order, nb=smag.nb,
        dx=dx, dy=dy, cs=smag.cs, dt=td.total_seconds(),
    )
    dprops = smoothing.diagnostic_properties
    diagnostics = {
        n: FieldArray(a, dprops[n]["units"], DIMS) for i, (n, a) in enumerate(zip(names, outs))
        if i not in (1, 2)
    }
    oprops = stepper.output_properties
    stepped = {n: FieldArray(outs[i], oprops[n]["units"], DIMS) for i, n in ((1, SU), (2, SV))}
    return diagnostics, stepped


register_process_pair_fuser(_smooth_smag_pair_matches, _smooth_smag_pair_fuser, "smooth_smag")
