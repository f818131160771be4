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
stage-1 state).  Kernel: ``csrc/smagorinsky.cu``, one launch per stage (stage
1 into a scratch pair), each writing the whole array, frame included, so no
paste follows.  ``fused_smagorinsky_rk2_plain`` is the plain PyTorch version;
the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.ops import _lib


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


def _stage_kernel(s, su_st, sv_st, su_base, sv_base, su_out, sv_out, *, dx, dy, cs, nb, c,
                  name="fused_smagorinsky_rk2"):
    """One launch of the stage kernel, counted under the wrapper ``name``."""
    nx, ny, nz = s.shape
    scalars = _lib.scalar_array([c, cs**2 * dx * dy, 2.0 * dx, 2.0 * dy])
    err = _lib.lib().tt_smagorinsky_stage(
        _lib.DTYPE_CODES[s.dtype],
        _lib.pointer_array((s, su_st, sv_st, su_base, sv_base)),
        _lib.pointer_array((su_out, sv_out)),
        nx, ny, nz, nb, scalars, _lib.stream_handle(),
    )
    _lib.launch_counts[name] += 1
    _lib.check(err, name)


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
    su_out, sv_out = torch.empty_like(su_st), torch.empty_like(sv_st)
    _stage_kernel(*args, su_out, sv_out, name="smag_stage", **kw)
    return su_out, sv_out


def fused_smagorinsky_rk2(s, su, sv, *, dx: float, dy: float, cs: float, nb: int, dt: float):
    """RK2 update of (su, sv); two kernel launches on a CUDA device.  Returns
    new tensors."""
    nx, ny, nz = s.shape
    _check_geometry("fused_smagorinsky_rk2", s.shape, nb)
    if not s.is_cuda:
        return fused_smagorinsky_rk2_plain(s, su, sv, dx=dx, dy=dy, cs=cs, nb=nb, dt=dt)
    _lib.check_cuda_tensors("fused_smagorinsky_rk2", (s, su, sv), s.dtype, [(nx, ny, nz)] * 3)
    kw = dict(dx=dx, dy=dy, cs=cs, nb=nb)
    su1, sv1 = torch.empty_like(su), torch.empty_like(sv)
    _stage_kernel(s, su, sv, su, sv, su1, sv1, c=0.5 * dt, **kw)
    su2, sv2 = torch.empty_like(su), torch.empty_like(sv)
    _stage_kernel(s, su1, sv1, su, sv, su2, sv2, c=dt, **kw)
    return su2, sv2
