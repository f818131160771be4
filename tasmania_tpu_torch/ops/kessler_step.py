"""Kessler microphysics and relaxed saturation adjustment, each RK2, alone or
the two in one operation (counterparts of ``tasmania_tpu/ops/kessler_step.py:39
fused_kessler_rk2``, ``:111 fused_kessler_satadj_rk2`` and ``:204
fused_satadj_rk2``).

Kernels: ``csrc/kessler.cu``, one thread per cell, three instantiations of
the same device functions.  The ``_plain`` functions are the plain PyTorch
versions of the same algebra, in the same operation order; the wrappers take
them for CPU tensors only.

Per cell, with T held fixed over the processes and their stages:

* qvs = β·e_s(T)/p (Tetens), p and Exner the means of their interface values;
* Kessler RK2 on (qv, qc, qr): autoconversion k1·max(qc - a, 0), accretion
  k2·qc·qr^0.875, rain evaporation 0.0484794·(qvs - qv)·(ρ·qr)^0.65; its
  θ-tendency is the stage-1 value -L/Π·ev1;
* saturation adjustment RK2 at rate sr on (qv, qc); it adds its stage-1
  θ-tendency -sr·(L/Π)·d1 to the θ-tendency it is given (the pair: Kessler's).
"""

from __future__ import annotations

import dataclasses

import torch

from tasmania_tpu_torch.ops import _lib


@dataclasses.dataclass(frozen=True)
class KesslerConstants:
    """Scalars of the fused steps (python floats; cast to the tensor type).
    A step that runs one process only leaves the other one's coefficients
    (a, k1, k2 or sr) at zero."""

    beta: float  # Rd / Rv
    lhvw: float  # latent heat of vaporisation [J kg^-1]
    cp: float  # specific heat of dry air at constant pressure [J K^-1 kg^-1]
    rv: float  # gas constant of water vapour [J K^-1 kg^-1]
    dt: float  # timestep [s]
    a: float = 0.0  # autoconversion threshold [g g^-1]
    k1: float = 0.0  # autoconversion rate [s^-1]
    k2: float = 0.0  # collection rate [s^-1]
    sr: float = 0.0  # saturation rate [s^-1]

    def as_list(self):
        """The scalars in the kernels' order (csrc/kessler.cu ``launch``)."""
        return [self.a, self.k1, self.k2, self.sr, self.beta, self.lhvw, self.cp, self.rv, self.dt]


def tetens(t):
    return 610.78 * torch.exp(17.27 * (t - 273.16) / (t - 35.86))


def _thermodynamics(t, p_if, exn_if, c: KesslerConstants):
    """(Exner function on the main levels, saturation mixing ratio)."""
    p = 0.5 * (p_if[..., :-1] + p_if[..., 1:])
    exn = 0.5 * (exn_if[..., :-1] + exn_if[..., 1:])
    return exn, c.beta * tetens(t) / p


def _kessler(rho, exn, qvs, qv, qc, qr, c: KesslerConstants):
    """Kessler RK2: (qv', qc', qr', stage-1 θ-tendency)."""
    zero = torch.zeros((), dtype=qv.dtype, device=qv.device)

    def tend(qv0, qc0, qr0):
        ar = c.k1 * torch.where(qc0 > c.a, qc0 - c.a, zero)
        cr = c.k2 * qc0 * torch.where(qr0 > 0.0, qr0**0.875, zero)
        er = torch.where(qr0 > 0.0, 0.0484794 * (qvs - qv0) * (rho * qr0) ** 0.65, zero)
        return er, -(ar + cr), ar + cr - er

    ev1, ec1, er1 = tend(qv, qc, qr)
    h = 0.5 * c.dt
    ev2, ec2, er2 = tend(qv + h * ev1, qc + h * ec1, qr + h * er1)
    return qv + c.dt * ev2, qc + c.dt * ec2, qr + c.dt * er2, -c.lhvw / exn * ev1


def _satadj(t, exn, qvs, qv, qc, th_in, c: KesslerConstants):
    """Saturation adjustment RK2: (qv', qc', th_in + stage-1 θ-tendency)."""
    denom = 1.0 + qvs * c.lhvw**2 / (c.cp * c.rv * t**2)

    def dq(qva, qca):
        sat = (qvs - qva) / denom
        return torch.where(sat <= qca, sat, qca)

    d1 = dq(qv, qc)
    hs = 0.5 * c.dt * c.sr
    d2 = dq(qv + hs * d1, qc - hs * d1)
    return qv + c.dt * c.sr * d2, qc - c.dt * c.sr * d2, th_in - c.sr * (c.lhvw / exn) * d1


def fused_kessler_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Returns ``(qv', qc', qr', θ-tendency)``."""
    exn, qvs = _thermodynamics(t, p_if, exn_if, c)
    return _kessler(rho, exn, qvs, qv, qc, qr, c)


def fused_satadj_rk2_plain(t, p_if, exn_if, qv, qc, th_in, c: KesslerConstants):
    """Returns ``(qv', qc', θ-tendency)``, the last ``th_in`` plus the
    adjustment's."""
    exn, qvs = _thermodynamics(t, p_if, exn_if, c)
    return _satadj(t, exn, qvs, qv, qc, th_in, c)


def fused_kessler_satadj_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Returns ``(qv'', qc'', qr', θ-tendency)``."""
    exn, qvs = _thermodynamics(t, p_if, exn_if, c)
    qv1, qc1, qr_out, th1 = _kessler(rho, exn, qvs, qv, qc, qr, c)
    qv_out, qc_out, th = _satadj(t, exn, qvs, qv1, qc1, th1, c)
    return qv_out, qc_out, qr_out, th


def _launch(name, entry, inputs, shapes, nout, c: KesslerConstants):
    """Check the inputs, allocate ``nout`` cell outputs, launch, count."""
    cell = inputs[-1].shape
    dtype = inputs[0].dtype
    _lib.check_cuda_tensors(name, inputs, dtype, shapes)
    outs = tuple(torch.empty(cell, dtype=dtype, device=inputs[0].device) for _ in range(nout))
    err = getattr(_lib.lib(), entry)(
        _lib.DTYPE_CODES[dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        cell[0] * cell[1], cell[2], _lib.scalar_array(c.as_list()), _lib.stream_handle(),
    )
    _lib.launch_counts[name] += 1
    _lib.check(err, name)
    return outs


def fused_kessler_rk2(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Kessler RK2 in one kernel launch on a CUDA device; returns new tensors
    ``(qv', qc', qr', θ-tendency)``."""
    if not rho.is_cuda:
        return fused_kessler_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c)
    nx, ny, nz = rho.shape
    cell, iface = (nx, ny, nz), (nx, ny, nz + 1)
    return _launch("fused_kessler_rk2", "tt_kessler_rk2", (rho, t, p_if, exn_if, qv, qc, qr),
                   [cell, cell, iface, iface, cell, cell, cell], 4, c)


def fused_satadj_rk2(t, p_if, exn_if, qv, qc, th_in, c: KesslerConstants):
    """Saturation adjustment RK2 in one kernel launch on a CUDA device;
    returns new tensors ``(qv', qc', θ-tendency)``."""
    if not t.is_cuda:
        return fused_satadj_rk2_plain(t, p_if, exn_if, qv, qc, th_in, c)
    nx, ny, nz = t.shape
    cell, iface = (nx, ny, nz), (nx, ny, nz + 1)
    return _launch("fused_satadj_rk2", "tt_satadj_rk2", (t, p_if, exn_if, qv, qc, th_in),
                   [cell, iface, iface, cell, cell, cell], 3, c)


def fused_kessler_satadj_rk2(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Both processes in one kernel launch on a CUDA device; returns new
    tensors ``(qv'', qc'', qr', θ-tendency)``."""
    if not rho.is_cuda:
        return fused_kessler_satadj_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c)
    nx, ny, nz = rho.shape
    cell, iface = (nx, ny, nz), (nx, ny, nz + 1)
    return _launch("fused_kessler_satadj_rk2", "tt_kessler_satadj",
                   (rho, t, p_if, exn_if, qv, qc, qr),
                   [cell, cell, iface, iface, cell, cell, cell], 4, c)
