"""Isentropic diagnostics by column scans (counterpart of
``tasmania_tpu/ops/diagnostics_step.py:103 fused_isentropic_diagnostics``).

From the isentropic density s (nx, ny, nz), the topography hs (nx, ny) and θ
on the nz+1 interfaces:

* pressure     p[k] = pt + g·dz·Σ_{l<k} s[l]                    (nz+1 levels)
* Exner        exn = cp·(p/pref)^(rd/cp)                          (nz+1)
* Montgomery   mtg[k] = θ_s·exn[nz] + g·hs + ½dz·exn[nz] + dz·Σ_{l>k} exn[l]  (nz)
* height       h[k] = hs + Σ_{l≥k} dh[l]                          (nz+1)
* density ρ and temperature T                                     (nz)

Modes: ``"mtg"`` returns mtg alone; ``"dry"`` (p, exn, mtg, h); ``"moist"``
(p, exn, mtg, h, ρ, T).  Kernel: ``csrc/diagnostics.cu``, one thread per
column.  :func:`fused_isentropic_diagnostics_plain` is the plain PyTorch
version, with cumulative sums; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import torch

from tasmania_tpu_torch.ops import _lib

MODES = {"mtg": 0, "dry": 1, "moist": 2}


def pressure(s, pt: float, g: float, dz: float):
    """p on the nz+1 interface levels from the isentropic density."""
    csum = torch.cumsum(g * dz * s, dim=2)
    return torch.cat([torch.zeros_like(s[:, :, :1]), csum], dim=2) + pt


def exner(p, cp: float, rd: float, pref: float):
    return cp * (p / pref) ** (rd / cp)


def montgomery(exn, hs3, theta_s, g: float, dz: float):
    """mtg on the nz main levels; ``hs3`` is (nx, ny, 1), ``theta_s`` the
    surface θ (a number or a 0-d tensor)."""
    nz = exn.shape[2] - 1
    mtg_s = theta_s * exn[:, :, nz : nz + 1] + g * hs3
    base = mtg_s + 0.5 * dz * exn[:, :, nz : nz + 1]
    inc = dz * exn[:, :, 1:nz]  # exn[k+1] for k in 0..nz-2
    rcsum = torch.flip(torch.cumsum(torch.flip(inc, [2]), dim=2), [2])
    return torch.cat([base + rcsum, base], dim=2)


def fused_isentropic_diagnostics_plain(
    s, hs, theta, *, pt: float, dz: float, g: float, cp: float, rd: float, pref: float,
    mode: str = "moist",
):
    """The diagnostics of ``mode`` with cumulative sums (see the module)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} (have {sorted(MODES)})")
    hs3 = hs[:, :, None]
    p = pressure(s, pt, g, dz)
    exn = exner(p, cp, rd, pref)
    mtg = montgomery(exn, hs3, theta[-1], g, dz)
    if mode == "mtg":
        return mtg
    th = theta[None, None, :]
    dh = (
        rd
        * (th[:, :, :-1] * exn[:, :, :-1] + th[:, :, 1:] * exn[:, :, 1:])
        * (p[:, :, :-1] - p[:, :, 1:])
        / (cp * g * (p[:, :, :-1] + p[:, :, 1:]))
    )
    rcsum = torch.flip(torch.cumsum(torch.flip(dh, [2]), dim=2), [2])
    h = torch.cat([hs3 - rcsum, hs3], dim=2)
    if mode == "dry":
        return p, exn, mtg, h
    rho = s * (th[:, :, :-1] - th[:, :, 1:]) / (h[:, :, :-1] - h[:, :, 1:])
    t = 0.5 / cp * (th[:, :, :-1] * exn[:, :, :-1] + th[:, :, 1:] * exn[:, :, 1:])
    return p, exn, mtg, h, rho, t


def fused_isentropic_diagnostics(
    s, hs, theta, *, pt: float, dz: float, g: float, cp: float, rd: float, pref: float,
    mode: str = "moist",
):
    """The diagnostics of ``mode`` in one kernel launch on a CUDA device:
    mtg for ``"mtg"``, else a tuple of new tensors."""
    kw = dict(pt=pt, dz=dz, g=g, cp=cp, rd=rd, pref=pref)
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} (have {sorted(MODES)})")
    if not s.is_cuda:
        return fused_isentropic_diagnostics_plain(s, hs, theta, mode=mode, **kw)
    nx, ny, nz = s.shape
    _lib.check_cuda_tensors("fused_isentropic_diagnostics", (s, hs, theta), s.dtype,
                            [(nx, ny, nz), (nx, ny), (nz + 1,)])
    cell, iface = (nx, ny, nz), (nx, ny, nz + 1)
    shapes = {"mtg": [cell], "dry": [iface, iface, cell, iface],
              "moist": [iface, iface, cell, iface, cell, cell]}[mode]
    outs = tuple(torch.empty(shape, dtype=s.dtype, device=s.device) for shape in shapes)
    err = _lib.lib().tt_isentropic_diagnostics(
        _lib.DTYPE_CODES[s.dtype],
        _lib.pointer_array((s, hs, theta)),
        _lib.pointer_array(outs),
        nx * ny, nz, MODES[mode],
        _lib.scalar_array([pt, dz, g, cp, rd, pref]),
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_isentropic_diagnostics"] += 1
    _lib.check(err, "fused_isentropic_diagnostics")
    return outs[0] if mode == "mtg" else outs
