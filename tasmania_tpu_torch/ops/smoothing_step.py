"""Multi-field Shapiro smoothing (counterpart of
``tasmania_tpu/ops/smoothing_step.py:44 fused_smoothing``).

Kernel: ``csrc/smoothing.cu``, which writes every cell (the nb-wide frame
copied): no paste follows.  ``fused_smoothing_plain`` is the plain PyTorch
version; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tasmania_tpu_torch.ops import _lib

CW_2D = {1: 1.0, 2: 0.75, 3: 0.625}
WEIGHTS = {
    1: ((-1, 0.25), (1, 0.25)),
    2: ((-2, -0.0625), (-1, 0.25), (1, 0.25), (2, -0.0625)),
    3: (
        (-3, 0.015625),
        (-2, -0.09375),
        (-1, 0.234375),
        (1, 0.234375),
        (2, -0.09375),
        (3, 0.015625),
    ),
}


def fused_smoothing_plain(fields, gamma, *, order: int = 2, nb: int = 3):
    """Order-n 2-D Shapiro filter of each (nx, ny, nz) field with the
    per-(field, z) coefficient ``gamma`` (F, nz): interior
    ``(1-c·γ)φ + γ·Σ w_k (x-shifts + y-shifts)``, nb-frame passed through."""
    cw, weights = CW_2D[order], WEIGHTS[order]
    outs = []
    for f, phi in enumerate(fields):
        nx, ny, _ = phi.shape
        g = gamma[f][None, None, :]
        iin, jin = slice(nb, nx - nb), slice(nb, ny - nb)
        centre = phi[iin, jin]
        acc = (1.0 - cw * g) * centre
        for off, wt in weights:
            acc = acc + wt * g * phi[nb + off : nx - nb + off, jin]
        for off, wt in weights:
            acc = acc + wt * g * phi[iin, nb + off : ny - nb + off]
        out = phi.clone()
        out[iin, jin] = acc
        outs.append(out)
    return tuple(outs)


def fused_smoothing(
    fields: Sequence[torch.Tensor], gamma: torch.Tensor, *, order: int = 2, nb: int = 3
):
    """Smooth every field in one kernel launch on a CUDA device; returns new
    tensors."""
    fields = tuple(fields)
    if order not in CW_2D or nb < order:
        raise ValueError(f"fused_smoothing: order {order} with nb={nb}")
    nx, ny, nz = fields[0].shape
    if not fields[0].is_cuda:
        return fused_smoothing_plain(fields, gamma, order=order, nb=nb)
    dtype = fields[0].dtype
    F = len(fields)
    _lib.check_cuda_tensors(
        "fused_smoothing", fields + (gamma,), dtype, [(nx, ny, nz)] * F + [(F, nz)]
    )
    outs = tuple(torch.empty_like(phi) for phi in fields)
    err = _lib.lib().tt_smoothing(
        _lib.DTYPE_CODES[dtype],
        _lib.pointer_array(fields),
        _lib.pointer_array(outs),
        gamma.data_ptr(),
        F, nx, ny, nz, order, nb,
        _lib.stream_handle(),
    )
    _lib.launch_counts["fused_smoothing"] += 1
    _lib.check(err, "fused_smoothing")
    return outs
