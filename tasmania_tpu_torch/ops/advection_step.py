"""The advection kernels of the semi-implicit stages that do not run as one
whole-stage kernel (counterparts of ``tasmania_tpu/ops/advection_step.py:140
fused_advection_fields``, ``:282 fused_momentum_step`` and ``:422
fused_momentum_epilogue``).

Kernels: ``csrc/advection.cu``.  Each takes a tile of columns and a run of
levels a block, with the stencil inputs staged in shared memory and each
face flux computed once a block; the momentum step and the momentum
epilogue are one kernel, the epilogue a compile-time switch.  Each writes
the frame itself (no paste follows).  The ``_plain``
functions are the plain PyTorch versions of the same algebra, in the same
operation order; the wrappers take them for CPU tensors only.

* :func:`fused_advection_fields`: each of F fields stepped by
  ``φ_now - dt·(div(u, v, φ_int) - tnd)`` on the nb-inset interior, "now"
  on the frame; a field flagged in ``q_product`` is a mass fraction q that
  enters as the water density ``clip(s·q)`` built from field 0 (the air
  density); with ``gamma`` the relaxed BC is applied to field 0.  Third- or
  fifth-order upwind fluxes (``order``).
* :func:`fused_momentum_step`: the momenta with the off-centred pressure
  gradient ``(1-eps)·s_now·∇mtg_now + eps·s_new·∇mtg_new`` and the optional
  momentum tendencies, "now" on the frame: the momentum step of a stage
  whose lateral boundary and damping run outside the kernels (the
  one-dimensional relaxed boundary).  Third- or fifth-order fluxes.
* :func:`fused_momentum_epilogue`: the momenta with the semi-implicit
  pressure gradient and the momentum tendencies, then the stage epilogue:
  ``q = clip(sq/s_e)``, the relaxed BC on every output (s a second time) and,
  with a Rayleigh profile, damping of s, su, sv with the full timestep
  toward the reference from the "now" values.  Third- or fifth-order fluxes.

Layout: cell fields (nx, ny, nz), u (nx+1, ny, nz), v (nx, ny+1, nz), γ
(nx, ny), the Rayleigh profile (nz,).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from tasmania_tpu_torch.domain.boundaries.relaxed import enforce_relaxed
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.si_stage import (
    StageConstants,
    check_geometry,
    clip_pos,
    flux_divergence,
    pressure_gradient,
    rayleigh_damp,
    with_interior,
)

MAX_FIELDS = 8  # csrc/advection.cu kMaxFields
MAX_Q = 3  # csrc/advection.cu kMaxQ


def fused_advection_fields_plain(
    u, v, fields_now, fields_int, tnds=None, gamma=None, ref0=None, *, nb: int,
    dt: float, dx: float, dy: float, q_product=None, order: int = 5,
):
    """Returns the F stepped fields; a ``q_product`` field's output is the
    stepped water density ``sq``."""
    qp = tuple(q_product) if q_product is not None else (False,) * len(fields_now)
    nx, ny, _ = fields_now[0].shape
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    outs = []
    for f, (now, phi) in enumerate(zip(fields_now, fields_int)):
        if qp[f]:
            now = clip_pos(fields_now[0] * now)
            phi = clip_pos(fields_int[0] * phi)
        rhs = flux_divergence(u, v, phi, nb, dx, dy, order)
        tnd = tnds[f] if tnds is not None else None
        if tnd is not None:
            rhs = rhs - tnd[iin, jin]
        out = with_interior(now, now[iin, jin] - dt * rhs, nb)
        if f == 0 and gamma is not None:
            out = enforce_relaxed(out, gamma[:, :, None], ref0)
        outs.append(out)
    return tuple(outs)


def _check_advection_args(fields_now, fields_int, tnds, gamma, ref0, qp, nb, order):
    nf = len(fields_now)
    if not nf or len(fields_int) != nf or len(qp) != nf or (tnds is not None and len(tnds) != nf):
        raise ValueError("fused_advection_fields: need F now, int (and tendency) fields and F flags")
    if qp[0]:
        raise ValueError("fused_advection_fields: field 0 is the density and cannot be a mass fraction")
    if (gamma is None) != (ref0 is None):
        raise ValueError("fused_advection_fields: give both gamma and ref0, or neither")
    check_geometry("fused_advection_fields", fields_now[0].shape, nb, order)


def fused_advection_fields(
    u, v, fields_now: Sequence, fields_int: Sequence, tnds: Optional[Sequence] = None,
    gamma=None, ref0=None, *, nb: int, dt: float, dx: float, dy: float, q_product=None,
    order: int = 5,
):
    """Step the F fields in one kernel launch on a CUDA device; returns new
    tensors.  ``tnds`` entries may be None (that field has no tendency)."""
    fields_now, fields_int = tuple(fields_now), tuple(fields_int)
    qp = tuple(bool(q) for q in q_product) if q_product is not None else (False,) * len(fields_now)
    _check_advection_args(fields_now, fields_int, tnds, gamma, ref0, qp, nb, order)
    kw = dict(nb=nb, dt=dt, dx=dx, dy=dy, q_product=qp, order=order)
    if not fields_now[0].is_cuda:
        return fused_advection_fields_plain(u, v, fields_now, fields_int, tnds, gamma, ref0, **kw)
    nf = len(fields_now)
    if nf > MAX_FIELDS:
        raise ValueError(f"fused_advection_fields: {nf} fields, the kernel takes at most {MAX_FIELDS}")
    nx, ny, nz = fields_now[0].shape
    cell = (nx, ny, nz)
    tnd_list = list(tnds) if tnds is not None else [None] * nf
    given = [(t, cell) for t in (*fields_now, *fields_int, *tnd_list) if t is not None]
    if gamma is not None:
        given += [(gamma, (nx, ny)), (ref0, cell)]
    tensors = [u, v] + [t for t, _ in given]
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz)] + [s for _, s in given]
    _lib.check_cuda_tensors("fused_advection_fields", tensors, fields_now[0].dtype, shapes)
    outs = tuple(torch.empty_like(fields_now[0]) for _ in range(nf))
    q_mask = sum(1 << f for f, q in enumerate(qp) if q)
    err = _lib.lib().tt_advection_fields(
        _lib.DTYPE_CODES[fields_now[0].dtype],
        _lib.pointer_array([u, v, gamma, ref0, *fields_now, *fields_int, *tnd_list]),
        _lib.pointer_array(outs),
        nf, q_mask, nx, ny, nz, nb, order,
        _lib.scalar_array([dt, dx, dy]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_advection_fields"] += 1
    _lib.check(err, "fused_advection_fields")
    return outs


def fused_advection_step(u, v, phi_now, phi_int, tnd=None, *, order: int = 3, nb: int = 3,
                         dt: float = 1.0, dx: float = 1.0, dy: float = 1.0):
    """``fused_advection_fields`` on the stacked layout: ``phi_now``,
    ``phi_int`` and ``tnd`` of shape (F, nx, ny, nz), the result stacked the
    same way (the JAX package's convenience wrapper, ``advection_step.py:380``)."""
    outs = fused_advection_fields(
        u, v, phi_now.unbind(0), phi_int.unbind(0), None if tnd is None else tnd.unbind(0),
        nb=nb, dt=dt, dx=dx, dy=dy, order=order,
    )
    return torch.stack(outs)


def fused_momentum_step_plain(
    u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_new, mtg_new, su_tnd=None,
    sv_tnd=None, *, order: int, nb: int, dt: float, dx: float, dy: float, eps: float,
):
    """Returns (su, sv); the tendencies are both given or both None."""
    nx, ny, _ = s_now.shape
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    pgx, pgy = pressure_gradient(s_now, s_new, mtg_now, mtg_new, nb, eps, dx, dy)
    su_rhs = flux_divergence(u, v, su_int, nb, dx, dy, order) + pgx
    sv_rhs = flux_divergence(u, v, sv_int, nb, dx, dy, order) + pgy
    if su_tnd is not None:
        su_rhs = su_rhs - su_tnd[iin, jin]
        sv_rhs = sv_rhs - sv_tnd[iin, jin]
    return (with_interior(su_now, su_now[iin, jin] - dt * su_rhs, nb),
            with_interior(sv_now, sv_now[iin, jin] - dt * sv_rhs, nb))


def fused_momentum_step(
    u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_new, mtg_new, su_tnd=None,
    sv_tnd=None, *, order: int, nb: int, dt: float, dx: float, dy: float, eps: float,
):
    """The momentum step in one kernel launch on a CUDA device; returns new
    tensors (su, sv)."""
    if (su_tnd is None) != (sv_tnd is None):
        raise ValueError("fused_momentum_step: give both momentum tendencies, or neither")
    check_geometry("fused_momentum_step", s_now.shape, nb, order)
    args = (u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_new, mtg_new, su_tnd, sv_tnd)
    kw = dict(order=order, nb=nb, dt=dt, dx=dx, dy=dy, eps=eps)
    if not s_now.is_cuda:
        return fused_momentum_step_plain(*args, **kw)
    nx, ny, nz = s_now.shape
    cell = (nx, ny, nz)
    given = [(t, s) for t, s in zip(args, [(nx + 1, ny, nz), (nx, ny + 1, nz)] + [cell] * 10)
             if t is not None]
    _lib.check_cuda_tensors("fused_momentum_step", [t for t, _ in given], s_now.dtype,
                            [s for _, s in given])
    outs = (torch.empty_like(su_now), torch.empty_like(sv_now))
    err = _lib.lib().tt_momentum_step(
        _lib.DTYPE_CODES[s_now.dtype],
        _lib.pointer_array(args),
        _lib.pointer_array(outs),
        nx, ny, nz, nb, order,
        _lib.scalar_array([dt, dx, dy, eps]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_momentum_step"] += 1
    _lib.check(err, "fused_momentum_step")
    return outs


def fused_momentum_epilogue_plain(
    u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg, sqs, gamma, s_ref,
    su_ref, sv_ref, q_refs, rmat=None, su_tnd=None, sv_tnd=None, *, nb: int,
    c: StageConstants, order: int = 5,
):
    """Returns (s, su, sv, *q).  ``c`` gives dt (the stage's), dtf (the full
    timestep, for the damping), dx, dy and eps; ``rmat`` None switches
    damping off; the tendencies are both given or both None; upwind fluxes
    of ``order`` (3 or 5)."""
    nx, ny, _ = s_now.shape
    iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
    g3 = gamma[:, :, None]
    pgx, pgy = pressure_gradient(s_now, s_e, mtg_now, mtg, nb, c.eps, c.dx, c.dy)
    su_rhs = flux_divergence(u, v, su_int, nb, c.dx, c.dy, order) + pgx
    sv_rhs = flux_divergence(u, v, sv_int, nb, c.dx, c.dy, order) + pgy
    if su_tnd is not None:
        su_rhs = su_rhs - su_tnd[iin, jin]
        sv_rhs = sv_rhs - sv_tnd[iin, jin]
    su_pre = with_interior(su_now, su_now[iin, jin] - c.dt * su_rhs, nb)
    sv_pre = with_interior(sv_now, sv_now[iin, jin] - c.dt * sv_rhs, nb)
    s_f = rayleigh_damp(enforce_relaxed(s_e, g3, s_ref), s_now, s_ref, rmat, c.dtf)
    su_f = rayleigh_damp(enforce_relaxed(su_pre, g3, su_ref), su_now, su_ref, rmat, c.dtf)
    sv_f = rayleigh_damp(enforce_relaxed(sv_pre, g3, sv_ref), sv_now, sv_ref, rmat, c.dtf)
    q_f = [enforce_relaxed(clip_pos(sq / s_e), g3, qref) for sq, qref in zip(sqs, q_refs)]
    return (s_f, su_f, sv_f, *q_f)


def fused_momentum_epilogue(
    u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg, sqs: Sequence, gamma,
    s_ref, su_ref, sv_ref, q_refs: Sequence, rmat=None, su_tnd=None, sv_tnd=None, *,
    nb: int, c: StageConstants, order: int = 5,
):
    """The momentum step and the stage epilogue in one kernel launch on a
    CUDA device; returns new tensors (s, su, sv, *q)."""
    sqs, q_refs = tuple(sqs), tuple(q_refs)
    nq = len(sqs)
    if len(q_refs) != nq or nq > MAX_Q:
        raise ValueError(f"fused_momentum_epilogue: need the same number (<= {MAX_Q}) of sqs and q_refs")
    if (su_tnd is None) != (sv_tnd is None):
        raise ValueError("fused_momentum_epilogue: give both momentum tendencies, or neither")
    nx, ny, nz = s_now.shape
    check_geometry("fused_momentum_epilogue", s_now.shape, nb, order)
    args = (u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg, sqs, gamma, s_ref,
            su_ref, sv_ref, q_refs, rmat, su_tnd, sv_tnd)
    if not s_now.is_cuda:
        return fused_momentum_epilogue_plain(*args, nb=nb, c=c, order=order)
    cell = (nx, ny, nz)
    ins = [u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg, gamma, s_ref, su_ref,
           sv_ref, rmat, su_tnd, sv_tnd, *sqs, *q_refs]
    shapes = [(nx + 1, ny, nz), (nx, ny + 1, nz)] + [cell] * 8 + [(nx, ny)] + [cell] * 3 + [
        (nz,), cell, cell] + [cell] * (2 * nq)
    given = [(t, s) for t, s in zip(ins, shapes) if t is not None]
    _lib.check_cuda_tensors("fused_momentum_epilogue", [t for t, _ in given], s_now.dtype,
                            [s for _, s in given])
    outs = tuple(torch.empty_like(s_now) for _ in range(3 + nq))
    err = _lib.lib().tt_momentum_epilogue(
        _lib.DTYPE_CODES[s_now.dtype],
        _lib.pointer_array(ins),
        _lib.pointer_array(outs),
        nq, nx, ny, nz, nb, order,
        _lib.scalar_array([c.dt, c.dtf, c.dx, c.dy, c.eps]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_momentum_epilogue"] += 1
    _lib.check(err, "fused_momentum_epilogue")
    return outs
