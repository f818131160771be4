"""Three RK3WS stages of rain sedimentation with the Kessler fall velocity, in
one operation (counterpart of ``tasmania_tpu/ops/sedimentation_step.py:123
fused_sedimentation_rk3ws``, body ``_sed_rk3ws_body`` at ``:61``).

Per column, with the surface the LAST level:

* vt = 36.34·sqrt(ρ_s/ρ)·(1e-3·ρ·max(qr, 0))^0.1346, the two qr-free factors
  hoisted out of the stages;
* T(qr) = the upwind flux divergence of ρ·qr·vt over the main-level heights,
  divided by ρ, on levels [nb, nz) (nb = the scheme's order, 1 or 2) and zero
  above; its height coefficients (with 1/ρ folded in) are hoisted;
* qr_i = qr_0 + c_i·T(qr_{i-1}), c = (dt/3, dt/2, dt); with ``vt_mode="step"``
  vt is evaluated at stage 1 and reused, with ``"stage"`` at every stage.

Returns the stepped qr and the stage-1 vt.  Kernel:
``csrc/sedimentation.cu``, one warp per column;
``fused_sedimentation_rk3ws_plain`` is the plain PyTorch version, which the
wrapper takes for CPU tensors only.
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.ops import _lib

VT_MODES = ("stage", "step")


def fused_sedimentation_rk3ws_plain(rho, h_if, qr, *, order: int, dt: float, vt_mode: str):
    nb = order
    h = 0.5 * (h_if[..., :-1] + h_if[..., 1:])
    mrho = 1.0e-3 * rho
    wsq = 36.34 * (rho[..., -1:] / rho) ** 0.5
    inv_rho = 1.0 / rho[..., nb:]
    if order == 1:
        ca = inv_rho / (h[..., :-1] - h[..., 1:])
    else:
        h2, h1, h0 = h[..., 2:], h[..., 1:-1], h[..., :-2]
        d1 = h1 - h2
        d2 = h0 - h2
        d3 = h0 - h1
        ca = (2.0 * h2 - h1 - h0) / (d1 * d2) * inv_rho
        cb = d2 / (d1 * d3) * inv_rho
        cc = (h2 - h1) / (d2 * d3) * inv_rho
    zero = torch.zeros((), dtype=qr.dtype, device=qr.device)

    def fall_velocity(q):
        return wsq * (mrho * torch.where(q > 0.0, q, zero)) ** 0.1346

    def tendency(q, vt):
        rqv = rho * q * vt
        if order == 1:
            d = ca * (rqv[..., :-1] - rqv[..., 1:])
        else:
            d = ca * rqv[..., 2:] + cb * rqv[..., 1:-1] + cc * rqv[..., :-2]
        z = torch.zeros(d.shape[:-1] + (nb,), dtype=d.dtype, device=d.device)
        return torch.cat([z, d], dim=-1)

    vt1 = fall_velocity(qr)
    q1 = qr + dt / 3.0 * tendency(qr, vt1)
    q2 = qr + dt / 2.0 * tendency(q1, vt1 if vt_mode == "step" else fall_velocity(q1))
    q3 = qr + dt * tendency(q2, vt1 if vt_mode == "step" else fall_velocity(q2))
    return q3, vt1


def fused_sedimentation_rk3ws(rho, h_if, qr, *, order: int, dt: float, vt_mode: str = "stage"):
    """All three stages in one kernel launch on a CUDA device; returns new
    tensors ``(qr', vt_stage1)``."""
    if order not in (1, 2):
        raise ValueError(f"fused_sedimentation_rk3ws: order {order} (have 1, 2)")
    if vt_mode not in VT_MODES:
        raise ValueError(f"fused_sedimentation_rk3ws: vt_mode {vt_mode!r} (have {VT_MODES})")
    nx, ny, nz = qr.shape
    if nz <= order:
        raise ValueError(f"fused_sedimentation_rk3ws: nz={nz} too small for order {order}")
    if not qr.is_cuda:
        return fused_sedimentation_rk3ws_plain(rho, h_if, qr, order=order, dt=dt, vt_mode=vt_mode)
    inputs = (rho, h_if, qr)
    _lib.check_cuda_tensors(
        "fused_sedimentation_rk3ws", inputs, qr.dtype, [(nx, ny, nz), (nx, ny, nz + 1), (nx, ny, nz)]
    )
    outs = (torch.empty_like(qr), torch.empty_like(qr))
    err = _lib.lib().tt_sedimentation_rk3ws(
        _lib.DTYPE_CODES[qr.dtype], _lib.pointer_array(inputs), _lib.pointer_array(outs),
        nx * ny, nz, order, int(vt_mode == "step"), float(dt), _lib.stream_handle(),
    )
    _lib.launch_counts["fused_sedimentation_rk3ws"] += 1
    _lib.check(err, "fused_sedimentation_rk3ws")
    return outs
