"""Kessler microphysics then relaxed saturation adjustment, both RK2, in one
operation (counterpart of ``tasmania_tpu/ops/kessler_step.py:111
fused_kessler_satadj_rk2``).

Kernel: ``csrc/kessler.cu``, one thread per cell.  ``fused_kessler_satadj_rk2_plain``
is the plain PyTorch version of the same algebra, in the same operation
order; the wrapper takes it for CPU tensors only.

Per cell, with T held fixed over both processes and both stages:

* qvs = β·e_s(T)/p (Tetens), p and Exner the means of their interface values;
* Kessler RK2 on (qv, qc, qr): autoconversion k1·max(qc - a, 0), accretion
  k2·qc·qr^0.875, rain evaporation 0.0484794·(qvs - qv)·(ρ·qr)^0.65;
* saturation adjustment RK2 at rate sr on the Kessler output (qv', qc');
* the θ-tendency is the stage-1 value of both: -L/Π·ev1 - sr·(L/Π)·d1.
"""

from __future__ import annotations

import dataclasses

import torch

from tasmania_tpu_torch.ops import _lib


@dataclasses.dataclass(frozen=True)
class KesslerConstants:
    """Scalars of the fused step (python floats; cast to the tensor type)."""

    a: float  # autoconversion threshold [g g^-1]
    k1: float  # autoconversion rate [s^-1]
    k2: float  # collection rate [s^-1]
    sr: float  # saturation rate [s^-1]
    beta: float  # Rd / Rv
    lhvw: float  # latent heat of vaporisation [J kg^-1]
    cp: float  # specific heat of dry air at constant pressure [J K^-1 kg^-1]
    rv: float  # gas constant of water vapour [J K^-1 kg^-1]
    dt: float  # timestep [s]

    def as_list(self):
        """The scalars in the kernel's order (csrc/kessler.cu ``Scalars``)."""
        return [self.a, self.k1, self.k2, self.sr, self.beta, self.lhvw, self.cp, self.rv, self.dt]


def tetens(t):
    return 610.78 * torch.exp(17.27 * (t - 273.16) / (t - 35.86))


def fused_kessler_satadj_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Returns ``(qv'', qc'', qr', θ-tendency)``."""
    p = 0.5 * (p_if[..., :-1] + p_if[..., 1:])
    exn = 0.5 * (exn_if[..., :-1] + exn_if[..., 1:])
    qvs = c.beta * tetens(t) / p
    zero = torch.zeros((), dtype=qv.dtype, device=qv.device)

    def tend(qv0, qc0, qr0):
        ar = c.k1 * torch.where(qc0 > c.a, qc0 - c.a, zero)
        cr = c.k2 * qc0 * torch.where(qr0 > 0.0, qr0**0.875, zero)
        er = torch.where(qr0 > 0.0, 0.0484794 * (qvs - qv0) * (rho * qr0) ** 0.65, zero)
        return er, -(ar + cr), ar + cr - er

    ev1, ec1, er1 = tend(qv, qc, qr)
    h = 0.5 * c.dt
    ev2, ec2, er2 = tend(qv + h * ev1, qc + h * ec1, qr + h * er1)
    qv1 = qv + c.dt * ev2
    qc1 = qc + c.dt * ec2
    qr_out = qr + c.dt * er2
    th1 = -c.lhvw / exn * ev1

    denom = 1.0 + qvs * c.lhvw**2 / (c.cp * c.rv * t**2)

    def dq(qva, qca):
        sat = (qvs - qva) / denom
        return torch.where(sat <= qca, sat, qca)

    d1 = dq(qv1, qc1)
    hs = 0.5 * c.dt * c.sr
    d2 = dq(qv1 + hs * d1, qc1 - hs * d1)
    qv_out = qv1 + c.dt * c.sr * d2
    qc_out = qc1 - c.dt * c.sr * d2
    th = th1 - c.sr * (c.lhvw / exn) * d1
    return qv_out, qc_out, qr_out, th


def fused_kessler_satadj_rk2(rho, t, p_if, exn_if, qv, qc, qr, c: KesslerConstants):
    """Both processes in one kernel launch on a CUDA device; returns new
    tensors ``(qv'', qc'', qr', θ-tendency)``."""
    if not rho.is_cuda:
        return fused_kessler_satadj_rk2_plain(rho, t, p_if, exn_if, qv, qc, qr, c)
    nx, ny, nz = rho.shape
    dtype = rho.dtype
    cell, iface = (nx, ny, nz), (nx, ny, nz + 1)
    inputs = (rho, t, p_if, exn_if, qv, qc, qr)
    _lib.check_cuda_tensors(
        "fused_kessler_satadj_rk2", inputs, dtype, [cell, cell, iface, iface, cell, cell, cell]
    )
    outs = tuple(torch.empty_like(qv) for _ in range(4))
    scalars = _lib.scalar_array(c.as_list())
    err = _lib.lib().tt_kessler_satadj(
        _lib.DTYPE_CODES[dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        nx * ny, nz, scalars, _lib.stream_handle(),
    )
    _lib.launch_counts["fused_kessler_satadj_rk2"] += 1
    _lib.check(err, "fused_kessler_satadj_rk2")
    return outs
