"""Three RK3WS stages of explicit vertical advection in one operation
(counterpart of ``tasmania_tpu/ops/vertical_advection_step.py:158
fused_vertical_advection_rk3ws``, its default ``gcoef=True`` flux form).

Advects (s, su, sv[, qv, qc, qr]) with the main-level velocity w = dθ/dt,
interpolated to the interior interfaces.  The flux at interface m is written
in coefficient form, f[m] = Σ_d g_d[m]·φ[m+d] (``flux_coefficients``); the
tendency is (f[k+1] - f[k])/dz on levels [e, nz-e) and zero on the e top and
bottom levels (e = 1, 1, 2, 3 for orders 1, 2, 3, 5).  The mass fractions are
advected as s·q and divided by the stage's density.  Stages:
x_i = x_0 + c_i·T(x_{i-1}), c = (dt/3, dt/2, dt).

Kernel: ``csrc/vertical_advection.cu``, one warp per (x, y) column.
``fused_vertical_advection_rk3ws_plain`` is the plain PyTorch version; the
wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.ops import _lib

EXTENT = {1: 1, 2: 1, 3: 2, 5: 3}


def flux_coefficients(order: int, wf):
    """``{d: g_d}`` with f[m] = Σ_d g_d[m]·φ[m+d] at the interfaces of ``wf``."""
    if order == 1:
        pos = (wf > 0.0).to(wf.dtype)
        return {0: wf * pos, -1: wf * (1.0 - pos)}
    if order == 2:
        half = 0.5 * wf
        return {0: half, -1: half}
    denom = {3: 12.0, 5: 60.0}[order]
    aw = wf / denom
    bw = wf.abs() / denom
    if order == 3:
        return {-2: bw - aw, -1: 7.0 * aw - 3.0 * bw, 0: 7.0 * aw + 3.0 * bw, 1: -(aw + bw)}
    return {
        -3: aw - bw,
        -2: -8.0 * aw + 5.0 * bw,
        -1: 37.0 * aw - 10.0 * bw,
        0: 37.0 * aw + 10.0 * bw,
        1: -8.0 * aw - 5.0 * bw,
        2: aw + bw,
    }


def fused_vertical_advection_rk3ws_plain(w, s, su, sv, q=(), *, order: int, dt: float, dz: float):
    """Returns the stepped ``(s, su, sv, *q)``."""
    if order not in EXTENT:
        raise ValueError(f"unsupported vertical flux order {order}")
    nz = s.shape[-1]
    e = EXTENT[order]
    wf = 0.5 * (w[..., e - 1 : nz - e] + w[..., e : nz + 1 - e])
    g = flux_coefficients(order, wf)

    def tendency(phi):
        f = None
        for d, gd in g.items():
            term = gd * phi[..., e + d : nz + 1 - e + d]
            f = term if f is None else f + term
        return (f[..., 1:] - f[..., :-1]) / dz  # levels [e, nz-e)

    def padz(t):
        z = torch.zeros(t.shape[:-1] + (e,), dtype=t.dtype, device=t.device)
        return torch.cat([z, t, z], dim=-1)

    def stage(c, sx, sux, svx, qx):
        s_new = s + c * padz(tendency(sx))
        su_new = su + c * padz(tendency(sux))
        sv_new = sv + c * padz(tendency(svx))
        inv_s = 1.0 / sx[..., e : nz - e]
        q_new = tuple(qb + c * padz(tendency(sx * qi) * inv_s) for qb, qi in zip(q, qx))
        return s_new, su_new, sv_new, q_new

    x = (s, su, sv, tuple(q))
    for c in (dt / 3.0, dt / 2.0, dt):
        x = stage(c, *x)
    return x[:3] + x[3]


def fused_vertical_advection_rk3ws(w, s, su, sv, q=(), *, order: int, dt: float, dz: float):
    """All three stages in one kernel launch on a CUDA device; ``q`` is
    empty or (qv, qc, qr).  Returns new tensors."""
    q = tuple(q)
    if len(q) not in (0, 3):
        raise ValueError("fused_vertical_advection_rk3ws: pass no mass fraction or all three")
    if order not in EXTENT:
        raise ValueError(f"unsupported vertical flux order {order}")
    nx, ny, nz = s.shape
    if nz < 2 * EXTENT[order] + 1:
        raise ValueError(f"fused_vertical_advection_rk3ws: nz={nz} too small for order {order}")
    if not s.is_cuda:
        return fused_vertical_advection_rk3ws_plain(w, s, su, sv, q, order=order, dt=dt, dz=dz)
    inputs = (w, s, su, sv) + q
    _lib.check_cuda_tensors("fused_vertical_advection_rk3ws", inputs, s.dtype, [(nx, ny, nz)] * len(inputs))
    outs = tuple(torch.empty_like(s) for _ in range(len(inputs) - 1))
    err = _lib.lib().tt_vertical_advection_rk3ws(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        len(outs), nx * ny, nz, order, _lib.scalar_array([dt, dz]), _lib.stream_handle(),
    )
    _lib.launch_counts["fused_vertical_advection_rk3ws"] += 1
    _lib.check(err, "fused_vertical_advection_rk3ws")
    return outs
