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

Kernel: ``csrc/vertical_advection.cu``, a column's levels a thread each (a
few a thread where nz > 128; nz up to ``MAX_NZ``), its state in registers and
its fluxes in shared memory for the three stages.  A taller column takes the
tall path, ``csrc/tall_column.cu``: one launch a stage, a thread a cell and
level, the stages' states through device memory (counted as
``vertical_advection_tall``, one count a call of its three launches).
``fused_vertical_advection_rk3ws_plain`` is the plain PyTorch version; the
wrapper takes it for CPU tensors only.

:func:`fused_vadv_sedimentation_rk3ws` runs the SUS pair [vertical advection
-> fall velocity + sedimentation] in one launch (``csrc/vadv_sed.cu``, nz up
to ``VADV_SED_MAX_NZ``; above it the two tall paths in turn, counted as
``vertical_advection_tall`` and ``sedimentation_tall``), its plain version
the two plain versions in turn.  Every kernel here indexes cells in 32 bits: the wrappers
raise ``ValueError`` for a grid of more than ``MAX_CELLS`` cells (interface
cells where the interface heights are an input).
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.sedimentation_step import (  # noqa: F401  (MAX_CELLS re-exported: the limit)
    MAX_CELLS,
    VT_MODES,
    check_cells,
    fused_sedimentation_rk3ws_plain,
    sedimentation_tall,
)

EXTENT = {1: 1, 2: 1, 3: 2, 5: 3}
# the tallest column of the fused kernels (vertical_advection.cu: 128
# threads of 8 levels; vadv_sed.cu: 256 threads of 4 levels)
MAX_NZ = 1024
VADV_SED_MAX_NZ = 1024


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
    name = "fused_vertical_advection_rk3ws"
    check_cells(name, nx * ny * nz)
    inputs = (w, s, su, sv) + q
    _lib.check_cuda_tensors(name, inputs, s.dtype, [(nx, ny, nz)] * len(inputs))
    if nz > MAX_NZ:
        return vertical_advection_tall(inputs, order=order, dt=dt, dz=dz)
    outs = tuple(torch.empty_like(s) for _ in range(len(inputs) - 1))
    err = _lib.lib().tt_vertical_advection_rk3ws(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        len(outs), nx * ny, nz, order, _lib.scalar_array([dt, dz]), _lib.stream_handle(),
    )
    _lib.launch_counts[name] += 1
    _lib.check(err, name)
    return outs


def vertical_advection_tall(inputs, *, order: int, dt: float, dz: float):
    """The tall path of ``(w, s, su, sv[, qv, qc, qr])`` on the card
    (``csrc/tall_column.cu``, three launches, any nz, counted once as
    ``vertical_advection_tall``); the caller has checked the tensors.
    Returns new tensors."""
    s = inputs[1]
    nx, ny, nz = s.shape
    outs = tuple(torch.empty_like(s) for _ in range(len(inputs) - 1))
    scratch = tuple(torch.empty_like(s) for _ in range(2 * len(outs)))
    err = _lib.lib().tt_vertical_advection_tall(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array(inputs), _lib.pointer_array(scratch),
        _lib.pointer_array(outs), len(outs), nx * ny, nz, order, _lib.scalar_array([dt, dz]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["vertical_advection_tall"] += 1
    _lib.check(err, "vertical_advection_tall")
    return outs


def fused_vadv_sedimentation_rk3ws_plain(w, s, su, sv, qv, qc, qr, rho, h_if, *, vorder: int,
                                         sorder: int, dt: float, dz: float, vt_mode: str):
    """``fused_vertical_advection_rk3ws_plain`` of the six fields, then
    ``fused_sedimentation_rk3ws_plain`` of the advected qr."""
    adv = fused_vertical_advection_rk3ws_plain(w, s, su, sv, (qv, qc, qr), order=vorder, dt=dt, dz=dz)
    qr_sed, vt = fused_sedimentation_rk3ws_plain(rho, h_if, adv[5], order=sorder, dt=dt,
                                                 vt_mode=vt_mode)
    return adv[:5] + (qr_sed, vt)


def fused_vadv_sedimentation_rk3ws(w, s, su, sv, qv, qc, qr, rho, h_if, *, vorder: int, sorder: int,
                                   dt: float, dz: float, vt_mode: str = "stage"):
    """The SUS pair [vertical advection RK3WS -> fall velocity +
    sedimentation RK3WS] (counterpart of
    ``tasmania_tpu/ops/vertical_advection_step.py:242
    fused_vadv_sedimentation_rk3ws``): one launch of ``csrc/vadv_sed.cu`` on
    a CUDA device (a block a column, nz up to ``VADV_SED_MAX_NZ``), which
    gives the bits of :func:`fused_vertical_advection_rk3ws` followed by
    ``fused_sedimentation_rk3ws``; a taller column takes the tall paths of
    the two in turn.  ``rho`` and ``h_if`` (nz + 1 levels) are the state's
    before the pair.  Returns new tensors (s, su, sv, qv, qc advected, qr
    advected and sedimented, the stage-1 fall velocity)."""
    if vorder not in EXTENT:
        raise ValueError(f"unsupported vertical flux order {vorder}")
    if sorder not in (1, 2):
        raise ValueError(f"fused_vadv_sedimentation_rk3ws: sedimentation order {sorder} (have 1, 2)")
    if vt_mode not in VT_MODES:
        raise ValueError(f"fused_vadv_sedimentation_rk3ws: vt_mode {vt_mode!r} (have {VT_MODES})")
    nx, ny, nz = s.shape
    if nz < 2 * EXTENT[vorder] + 1:
        raise ValueError(f"fused_vadv_sedimentation_rk3ws: nz={nz} too small for order {vorder}")
    kw = dict(vorder=vorder, sorder=sorder, dt=dt, dz=dz, vt_mode=vt_mode)
    if not s.is_cuda:
        return fused_vadv_sedimentation_rk3ws_plain(w, s, su, sv, qv, qc, qr, rho, h_if, **kw)
    name = "fused_vadv_sedimentation_rk3ws"
    check_cells(name, nx * ny * (nz + 1))
    inputs = (w, s, su, sv, qv, qc, qr, rho, h_if)
    _lib.check_cuda_tensors(name, inputs, s.dtype, [(nx, ny, nz)] * 8 + [(nx, ny, nz + 1)])
    if nz > VADV_SED_MAX_NZ:
        adv = vertical_advection_tall(inputs[:7], order=vorder, dt=dt, dz=dz)
        return adv[:5] + sedimentation_tall((rho, h_if, adv[5]), order=sorder, dt=dt, vt_mode=vt_mode)
    outs = tuple(torch.empty_like(s) for _ in range(7))
    err = _lib.lib().tt_vadv_sedimentation_rk3ws(
        _lib.DTYPE_CODES[s.dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        nx * ny, nz, vorder, sorder, int(vt_mode == "step"), _lib.scalar_array([dt, dz]),
        _lib.stream_handle(),
    )
    _lib.launch_counts[name] += 1
    _lib.check(err, name)
    return outs
