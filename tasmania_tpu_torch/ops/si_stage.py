"""One whole semi-implicit stage of the isentropic core (counterpart of
``tasmania_tpu/ops/si_stage.py:146 fused_si_stage``).

Kernel: ``csrc/si_stage.cu`` (three launches on one stream: density,
Montgomery column scans, momenta + water species + epilogue) over x columns
[nb, nx-nb); the nb-wide x-frame columns are composed from "now" values by
:func:`frame_strips` and pasted with the paste kernel.  :func:`si_stage_plain`
is the plain PyTorch version of the whole stage; the wrapper takes it for CPU
tensors only.

Layout: cell fields (nx, ny, nz), u (nx+1, ny, nz), v (nx, ny+1, nz), θ on
the nz+1 interfaces, γ and the topography (nx, ny), the Rayleigh profile
(nz,).  Only fifth-order upwind fluxes are ported.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from tasmania_tpu_torch.domain.boundaries.relaxed import enforce_relaxed
from tasmania_tpu_torch.isentropic.dynamics.horizontal_fluxes import extent, flux3
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.paste import paste_x_edges_multi


@dataclass(frozen=True)
class StageConstants:
    """Scalars of one stage: stage and full timesteps, spacings, off-centring,
    top pressure, θ spacing and the physical constants of the Exner scan."""

    dt: float
    dtf: float
    dx: float
    dy: float
    eps: float
    pt: float
    dz: float
    g: float
    cp: float
    rd: float
    pref: float


def clip_pos(x):
    """Positivity clip ``x > 0 ? x : 0`` (a select, not a max)."""
    return torch.where(x > 0.0, x, torch.zeros_like(x))


def flux5(w, pm3, pm2, pm1, p0, pp1, pp2):
    """Fifth-order upwind flux at a face between pm1 and p0."""
    flux6 = w / 60.0 * (37.0 * (p0 + pm1) - 8.0 * (pp1 + pm2) + (pp2 + pm3))
    return flux6 - torch.abs(w) / 60.0 * (
        10.0 * (p0 - pm1) - 5.0 * (pp1 - pm2) + (pp2 - pm3)
    )


def flux_divergence(u, v, phi, nb: int, dx: float, dy: float, order: int = 5):
    """Divergence of the upwind fluxes of ``order`` (3 or 5) of ``phi`` on
    the nb-inset interior (nx-2nb, ny-2nb, nz)."""
    nx, ny, _ = phi.shape
    e = extent(order)
    flux = flux3 if order == 3 else flux5
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    fx = flux(u[nb : nx - nb + 1, jin],
              *[phi[nb - e + k : nx - nb - e + 1 + k, jin] for k in range(2 * e)])
    fy = flux(v[iin, nb : ny - nb + 1],
              *[phi[iin, nb - e + k : ny - nb - e + 1 + k] for k in range(2 * e)])
    return (fx[1:] - fx[:-1]) / dx + (fy[:, 1:] - fy[:, :-1]) / dy


def stage_montgomery(s, hs, theta, c: StageConstants):
    """Montgomery potential of the isentropic density ``s`` (θ on the
    interfaces, ``hs`` (nx, ny)): the dycore's column scans, summed level by
    level in the kernel's order and with its roundings (a forward scan for
    the pressure, a backward one for the potential).  A cumulative sum in
    another order would differ from the kernel by float32 noise of the size
    of the potential's last digit, which the gradient of a small field such
    as sv then amplifies."""
    nz = s.shape[2]
    gdz = c.g * c.dz
    p = [torch.full_like(s[:, :, 0], c.pt)]
    for k in range(nz):
        p.append(p[-1] + gdz * s[:, :, k])
    # p/pref as a product with the reciprocal, spelled out: PyTorch's CUDA
    # division by a scalar does that, its CPU division does not
    exn = c.cp * (torch.stack(p, dim=2) * (1.0 / c.pref)) ** (c.rd / c.cp)
    exn_s = exn[:, :, nz]
    base = theta[nz] * exn_s + c.g * hs + 0.5 * c.dz * exn_s
    mtg = [base]
    r = torch.zeros_like(base)
    for k in range(nz - 2, -1, -1):
        r = r + c.dz * exn[:, :, k + 1]
        mtg.append(base + r)
    return torch.stack(mtg[::-1], dim=2)


def with_interior(base, interior, nb):
    """A copy of ``base`` with its nb-inset interior replaced."""
    out = base.clone()
    out[nb : base.shape[0] - nb, nb : base.shape[1] - nb] = interior
    return out


def rayleigh_damp(phi, now, ref, rmat, dtf):
    """``phi`` damped toward ``ref`` from ``now``; ``rmat`` None: no damping."""
    return phi if rmat is None else phi - dtf * rmat * (now - ref)


def pressure_gradient(s_now, s_e, mtg_now, mtg, nb: int, eps: float, dx: float, dy: float):
    """The semi-implicit pressure gradient (1-eps)·s_now·∇mtg_now +
    eps·s_e·∇mtg on the nb-inset interior, as (x, y) components."""
    nx, ny, _ = s_now.shape
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    ip1, im1 = slice(nb + 1, nx - nb + 1), slice(nb - 1, nx - nb - 1)
    jp1, jm1 = slice(nb + 1, ny - nb + 1), slice(nb - 1, ny - nb - 1)
    sn_i, se_i = s_now[iin, jin], s_e[iin, jin]
    pgx = (1.0 - eps) * sn_i * (mtg_now[ip1, jin] - mtg_now[im1, jin]) / (
        2.0 * dx
    ) + eps * se_i * (mtg[ip1, jin] - mtg[im1, jin]) / (2.0 * dx)
    pgy = (1.0 - eps) * sn_i * (mtg_now[iin, jp1] - mtg_now[iin, jm1]) / (
        2.0 * dy
    ) + eps * se_i * (mtg[iin, jp1] - mtg[iin, jm1]) / (2.0 * dy)
    return pgx, pgy


def si_stage_plain(
    u, v, s_now, s_int, q_now, q_int, su_now, sv_now, su_int, sv_int, mtg_now,
    hs, theta, gamma, s_ref, su_ref, sv_ref, q_refs, rmat, *, nb: int,
    c: StageConstants, dd: int = 0,
):
    """The stage on whole arrays; returns (s, su, sv, *q).  ``rmat`` None
    switches damping off (``dd`` is the kernel's damping depth and is not
    needed here)."""
    nx, ny, _ = s_now.shape
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    g3 = gamma[:, :, None]

    def div(phi):
        return flux_divergence(u, v, phi, nb, c.dx, c.dy)

    s_res = with_interior(s_now, s_now[iin, jin] - c.dt * div(s_int), nb)
    s_e = enforce_relaxed(s_res, g3, s_ref)
    mtg = stage_montgomery(s_e, hs, theta, c)
    pgx, pgy = pressure_gradient(s_now, s_e, mtg_now, mtg, nb, c.eps, c.dx, c.dy)
    su_pre = with_interior(su_now, su_now[iin, jin] - c.dt * (div(su_int) + pgx), nb)
    sv_pre = with_interior(sv_now, sv_now[iin, jin] - c.dt * (div(sv_int) + pgy), nb)

    s_f = rayleigh_damp(enforce_relaxed(s_e, g3, s_ref), s_now, s_ref, rmat, c.dtf)
    su_f = rayleigh_damp(enforce_relaxed(su_pre, g3, su_ref), su_now, su_ref, rmat, c.dtf)
    sv_f = rayleigh_damp(enforce_relaxed(sv_pre, g3, sv_ref), sv_now, sv_ref, rmat, c.dtf)
    q_f = []
    for qn, qi, qref in zip(q_now, q_int, q_refs):
        sq_now = clip_pos(s_now * qn)
        sq_res = with_interior(sq_now, sq_now[iin, jin] - c.dt * div(clip_pos(s_int * qi)), nb)
        q_f.append(enforce_relaxed(clip_pos(sq_res / s_e), g3, qref))
    return (s_f, su_f, sv_f, *q_f)


def frame_strips(sl, s_now, su_now, sv_now, q_now, gamma, s_ref, su_ref, sv_ref, q_refs, rmat, dtf):
    """The stage's values on the x-column slice ``sl`` of the frame, composed
    from "now" values (advection keeps "now" there): the same algebra as
    :func:`si_stage_plain`, so the kernel path's pasted frame is bitwise the
    plain version's."""
    g = gamma[sl][:, :, None]
    sn = s_now[sl]
    s_e = enforce_relaxed(sn, g, s_ref[sl])
    s_f = rayleigh_damp(enforce_relaxed(s_e, g, s_ref[sl]), sn, s_ref[sl], rmat, dtf)
    su_f = rayleigh_damp(enforce_relaxed(su_now[sl], g, su_ref[sl]), su_now[sl], su_ref[sl], rmat, dtf)
    sv_f = rayleigh_damp(enforce_relaxed(sv_now[sl], g, sv_ref[sl]), sv_now[sl], sv_ref[sl], rmat, dtf)
    q_f = [
        enforce_relaxed(clip_pos(clip_pos(sn * qn[sl]) / s_e), g, qref[sl])
        for qn, qref in zip(q_now, q_refs)
    ]
    return [s_f, su_f, sv_f, *q_f]


def si_stage(
    u, v, s_now, s_int, q_now: Sequence, q_int: Sequence, su_now, sv_now, su_int,
    sv_int, mtg_now, hs, theta, gamma, s_ref, su_ref, sv_ref, q_refs: Sequence,
    rmat: Optional[torch.Tensor], *, nb: int, c: StageConstants, dd: int = 0,
):
    """One stage; returns new tensors (s, su, sv, *q).  On a CUDA device it
    runs the kernel; ``rmat[dd:]`` must then be zero (damping is applied on
    the levels k < dd only), as it is for a Rayleigh profile of depth dd."""
    if not s_now.is_cuda:
        return si_stage_plain(
            u, v, s_now, s_int, q_now, q_int, su_now, sv_now, su_int, sv_int,
            mtg_now, hs, theta, gamma, s_ref, su_ref, sv_ref, q_refs, rmat, nb=nb, c=c,
        )
    nx, ny, nz = s_now.shape
    nq = len(q_now)
    if len(q_int) != nq or len(q_refs) != nq or nq > 3:
        raise ValueError("si_stage: need the same number (<= 3) of q_now, q_int, q_refs")
    if nb < 3 or nx < 2 * nb + 1 or ny < 2 * nb + 1:
        raise ValueError(f"si_stage: nb={nb} on a {nx}x{ny} grid (fifth-order stencils need nb >= 3)")
    if rmat is None:
        dd, rmat_arg = 0, s_now  # never read with dd = 0
        rshape = (nx, ny, nz)
    elif 1 <= dd <= nz:
        rmat_arg, rshape = rmat, (nz,)
    else:
        raise ValueError(f"si_stage: damping depth dd={dd} outside [1, {nz}]")
    cell = (nx, ny, nz)
    ins = [u, v, s_now, s_int, su_now, sv_now, su_int, sv_int, mtg_now, hs, theta,
           gamma, s_ref, su_ref, sv_ref, rmat_arg, *q_now, *q_int, *q_refs]
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz)] + [cell] * 7 + [
        (nx, ny), (nz + 1,), (nx, ny), cell, cell, cell, rshape] + [cell] * (3 * nq)
    _lib.check_cuda_tensors("si_stage", ins, s_now.dtype, shapes)
    scratch = [torch.empty_like(s_now), torch.empty_like(s_now)]  # s_e, mtg
    outs = [torch.empty_like(s_now) for _ in range(3 + nq)]
    scalars = (ctypes.c_double * 11)(
        c.dt, c.dtf, c.dx, c.dy, c.eps, c.pt, c.dz, c.g, c.cp, c.rd, c.pref
    )
    err = _lib.lib().tt_si_stage(
        _lib.DTYPE_CODES[s_now.dtype],
        _lib.pointer_array(ins),
        _lib.pointer_array(scratch + outs),
        nq, nx, ny, nz, nb, dd,
        ctypes.cast(scalars, ctypes.c_void_p),
        _lib.stream_handle(),
    )
    _lib.launch_counts["si_stage"] += 1
    _lib.check(err, "si_stage")
    strip_args = (s_now, su_now, sv_now, q_now, gamma, s_ref, su_ref, sv_ref, q_refs,
                  rmat, c.dtf)
    lo = frame_strips(slice(0, nb), *strip_args)
    hi = frame_strips(slice(nx - nb, nx), *strip_args)
    return paste_x_edges_multi(outs, lo, hi)
