"""Both RK2 stages of the conservative Smagorinsky update of (su, sv)
(counterpart of ``tasmania_tpu/ops/smagorinsky_step.py:261
fused_smagorinsky_rk2``, whose default path is the one-kernel
``_smag_rk2_fused`` at ``:149``), and one stage alone (:func:`smag_stage`,
counterpart of ``:33 _smag_stage``, which the JAX package takes when
``nx < tile_x + 8``).

With u = su/s and v = sv/s at the stage's input:

* strain  s00 = ∂x u,  s01 = ½(∂y u + ∂x v),  s11 = ∂y v  (centred),
* eddy viscosity  ν = cs²·dx·dy·sqrt(2(s00² + 2 s01² + s11²)),
* tendency  (2(∂x(ν s00) + ∂y(ν s01)), 2(∂x(ν s01) + ∂y(ν s11))),
* stage  out = base + c·s·tendency on [nb, nx-nb) x [nb, ny-nb); the frame
  keeps the base state (the stage-1 frame too),

with c = dt/2 at stage 1 (on the base state) and c = dt at stage 2 (on the
stage-1 state).  Kernel: ``csrc/smagorinsky.cu``, one launch for both stages
(the stage-1 values stay in shared memory) or for one stage, writing the
whole array, frame included, so no paste follows.
``fused_smagorinsky_rk2_plain`` and ``smagorinsky_stage_plain`` are the
plain PyTorch versions; the wrappers take them for CPU tensors only.

:func:`fused_smoothing_smagorinsky_rk2` runs the SUS pair [smoothing ->
Smagorinsky RK2] in one launch (``csrc/smooth_smag.cu``), its plain version
the two plain versions in turn.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.smoothing_step import CW_2D, fused_smoothing_plain


def smagorinsky_tendency(u, v, dx: float, dy: float, cs: float):
    """(u_tnd, v_tnd) on [2, nx-2) x [2, ny-2) of full (nx, ny, nz) velocities."""
    s00 = (u[2:, 1:-1] - u[:-2, 1:-1]) / (2.0 * dx)
    s01 = 0.5 * ((u[1:-1, 2:] - u[1:-1, :-2]) / (2.0 * dy) + (v[2:, 1:-1] - v[:-2, 1:-1]) / (2.0 * dx))
    s11 = (v[1:-1, 2:] - v[1:-1, :-2]) / (2.0 * dy)
    nu = cs**2 * dx * dy * (2.0 * (s00**2 + 2.0 * s01**2 + s11**2)) ** 0.5

    def ddx(f):
        return (f[2:, 1:-1] - f[:-2, 1:-1]) / (2.0 * dx)

    def ddy(f):
        return (f[1:-1, 2:] - f[1:-1, :-2]) / (2.0 * dy)

    u_tnd = 2.0 * (ddx(nu * s00) + ddy(nu * s01))
    v_tnd = 2.0 * (ddx(nu * s01) + ddy(nu * s11))
    return u_tnd, v_tnd


def smagorinsky_stage_plain(s, su_st, sv_st, su_base, sv_base, *, dx, dy, cs, nb, c):
    """One stage: ``base + c·s·T(su_st/s, sv_st/s)`` inside the nb-frame,
    ``base`` on it."""
    nx, ny, _ = s.shape
    u_tnd, v_tnd = smagorinsky_tendency(su_st / s, sv_st / s, dx, dy, cs)
    inner = (slice(nb, nx - nb), slice(nb, ny - nb))
    tnd = (slice(nb - 2, nx - nb - 2), slice(nb - 2, ny - nb - 2))
    s_in = s[inner]
    su_out, sv_out = su_base.clone(), sv_base.clone()
    su_out[inner] = su_base[inner] + c * s_in * u_tnd[tnd]
    sv_out[inner] = sv_base[inner] + c * s_in * v_tnd[tnd]
    return su_out, sv_out


def fused_smagorinsky_rk2_plain(s, su, sv, *, dx, dy, cs, nb, dt):
    kw = dict(dx=dx, dy=dy, cs=cs, nb=nb)
    su1, sv1 = smagorinsky_stage_plain(s, su, sv, su, sv, c=0.5 * dt, **kw)
    return smagorinsky_stage_plain(s, su1, sv1, su, sv, c=dt, **kw)


def _check_geometry(name, shape, nb):
    nx, ny, _ = shape
    if nb < 2 or nx < 2 * nb + 1 or ny < 2 * nb + 1:
        raise ValueError(f"{name}: nb={nb} (needs >= 2) on a {nx}x{ny} grid")


def smag_stage(s, su_st, sv_st, su_base, sv_base, *, dx: float, dy: float, cs: float, nb: int,
               c: float):
    """One stage, ``base + c·s·T(su_st/s, sv_st/s)``, in one kernel launch on
    a CUDA device.  Returns new tensors (su, sv)."""
    args = (s, su_st, sv_st, su_base, sv_base)
    kw = dict(dx=dx, dy=dy, cs=cs, nb=nb, c=c)
    _check_geometry("smag_stage", s.shape, nb)
    if not s.is_cuda:
        return smagorinsky_stage_plain(*args, **kw)
    _lib.check_cuda_tensors("smag_stage", args, s.dtype, [s.shape] * 5)
    outs = (torch.empty_like(su_st), torch.empty_like(sv_st))
    nx, ny, nz = s.shape
    err = _lib.lib().tt_smagorinsky_stage(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array(args), _lib.pointer_array(outs),
        nx, ny, nz, nb, _lib.scalar_array([c, cs**2 * dx * dy, 2.0 * dx, 2.0 * dy]), _lib.stream_handle(),
    )
    _lib.launch_counts["smag_stage"] += 1
    _lib.check(err, "smag_stage")
    return outs


def fused_smagorinsky_rk2(s, su, sv, *, dx: float, dy: float, cs: float, nb: int, dt: float):
    """RK2 update of (su, sv); one kernel launch on a CUDA device.  Returns
    new tensors."""
    nx, ny, nz = s.shape
    _check_geometry("fused_smagorinsky_rk2", s.shape, nb)
    if not s.is_cuda:
        return fused_smagorinsky_rk2_plain(s, su, sv, dx=dx, dy=dy, cs=cs, nb=nb, dt=dt)
    _lib.check_cuda_tensors("fused_smagorinsky_rk2", (s, su, sv), s.dtype, [(nx, ny, nz)] * 3)
    outs = (torch.empty_like(su), torch.empty_like(sv))
    err = _lib.lib().tt_smagorinsky_rk2(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array((s, su, sv)), _lib.pointer_array(outs),
        nx, ny, nz, nb, _lib.scalar_array([0.5 * dt, dt, cs**2 * dx * dy, 2.0 * dx, 2.0 * dy]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_smagorinsky_rk2"] += 1
    _lib.check(err, "fused_smagorinsky_rk2")
    return outs


def fused_smoothing_smagorinsky_rk2_plain(fields, gamma, *, order, nb, dx, dy, cs, dt):
    """``fused_smoothing_plain`` of every field, then
    ``fused_smagorinsky_rk2_plain`` of the smoothed (s, su, sv): returns
    (s smoothed, su and sv stepped, *q smoothed)."""
    smoothed = fused_smoothing_plain(fields, gamma, order=order, nb=nb)
    su, sv = fused_smagorinsky_rk2_plain(*smoothed[:3], dx=dx, dy=dy, cs=cs, nb=nb, dt=dt)
    return (smoothed[0], su, sv) + tuple(smoothed[3:])


def fused_smoothing_smagorinsky_rk2(fields: Sequence[torch.Tensor], gamma: torch.Tensor, *,
                                    order: int, nb: int, dx: float, dy: float, cs: float,
                                    dt: float):
    """The SUS pair [smoothing -> Smagorinsky RK2] (counterpart of
    ``tasmania_tpu/ops/smagorinsky_step.py:303
    fused_smoothing_smagorinsky_rk2``): ``fields`` is (s, su, sv[, qv, qc,
    qr]) and ``gamma`` (F, nz) the smoothing's coefficients.  One launch of
    ``csrc/smooth_smag.cu`` on a CUDA device, which writes every cell, frame
    included, and gives the bits of ``fused_smoothing`` followed by
    :func:`fused_smagorinsky_rk2`.  Returns new tensors (s smoothed, su and sv stepped, *q
    smoothed)."""
    fields = tuple(fields)
    if len(fields) < 3 or len(fields) > 8:
        raise ValueError(f"fused_smoothing_smagorinsky_rk2: {len(fields)} fields (3 to 8)")
    if order not in CW_2D or nb < order:
        raise ValueError(f"fused_smoothing_smagorinsky_rk2: order {order} with nb={nb}")
    _check_geometry("fused_smoothing_smagorinsky_rk2", fields[0].shape, nb)
    kw = dict(order=order, nb=nb, dx=dx, dy=dy, cs=cs, dt=dt)
    if not fields[0].is_cuda:
        return fused_smoothing_smagorinsky_rk2_plain(fields, gamma, **kw)
    nx, ny, nz = fields[0].shape
    F, dtype = len(fields), fields[0].dtype
    _lib.check_cuda_tensors("fused_smoothing_smagorinsky_rk2", fields + (gamma,), dtype,
                            [(nx, ny, nz)] * F + [(F, nz)])
    outs = tuple(torch.empty_like(phi) for phi in fields)
    err = _lib.lib().tt_smoothing_smagorinsky_rk2(
        _lib.DTYPE_CODES[dtype], _lib.pointer_array(fields), _lib.pointer_array(outs),
        gamma.data_ptr(), F, nx, ny, nz, order, nb,
        _lib.scalar_array([0.5 * dt, dt, cs**2 * dx * dy, 2.0 * dx, 2.0 * dy]), _lib.stream_handle(),
    )
    _lib.launch_counts["fused_smoothing_smagorinsky_rk2"] += 1
    _lib.check(err, "fused_smoothing_smagorinsky_rk2")
    return outs
