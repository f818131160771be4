"""In-place x-edge paste of N arrays (counterpart of
``tasmania_tpu/ops/paste.py:67 paste_x_edges_multi``) and of one array
(``:23 paste_x_edges``, the same kernel with N = 1).

Kernel: ``csrc/paste.cu``.  ``paste_x_edges_multi_plain`` is its plain
PyTorch version; the wrappers take it for CPU tensors only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tasmania_tpu_torch.ops import _lib

MAX_ARRAYS = 16  # csrc/paste.cu kMaxArrays: the pointers ride in the kernel arguments


def paste_x_edges_multi_plain(fulls, lo_vals, hi_vals):
    """Write columns [0, w) <- lo and [nx-w, nx) <- hi of each array IN PLACE
    (w = lo.shape[0]); returns ``fulls``."""
    for full, lo, hi in zip(fulls, lo_vals, hi_vals):
        w = lo.shape[0]
        full[:w].copy_(lo)
        full[full.shape[0] - w :].copy_(hi)
    return tuple(fulls)


def paste_x_edges(full: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Paste the x-edge strips of one (nx, ny, nz) array IN PLACE, in one
    launch of the paste kernel on a CUDA device; returns ``full``."""
    return paste_x_edges_multi((full,), (lo,), (hi,), name="paste_x_edges")[0]


def paste_x_edges_multi(
    fulls: Sequence[torch.Tensor],
    lo_vals: Sequence[torch.Tensor],
    hi_vals: Sequence[torch.Tensor],
    *,
    name: str = "paste_x_edges_multi",
):
    """Paste the x-edge strips of N same-shape (nx, ny, nz) arrays IN PLACE,
    in one kernel launch on a CUDA device; returns ``fulls``.  ``name`` is
    the wrapper whose launch is counted."""
    fulls, lo_vals, hi_vals = tuple(fulls), tuple(lo_vals), tuple(hi_vals)
    n = len(fulls)
    if not n or len(lo_vals) != n or len(hi_vals) != n:
        raise ValueError(f"{name}: need N arrays and N strips per side")
    nx, ny, nz = fulls[0].shape
    w = lo_vals[0].shape[0]
    if 2 * w > nx:
        raise ValueError(f"{name}: strips of width {w} overlap in nx={nx}")
    if not fulls[0].is_cuda:
        return paste_x_edges_multi_plain(fulls, lo_vals, hi_vals)
    _lib.check_cuda_tensors(
        name,
        fulls + lo_vals + hi_vals,
        fulls[0].dtype,
        [(nx, ny, nz)] * n + [(w, ny, nz)] * (2 * n),
    )
    if n > MAX_ARRAYS:
        raise ValueError(f"{name}: {n} arrays, the kernel takes at most {MAX_ARRAYS}")
    err = _lib.lib().tt_paste_x_edges_multi(
        _lib.DTYPE_CODES[fulls[0].dtype], _lib.pointer_array(fulls), _lib.pointer_array(lo_vals),
        _lib.pointer_array(hi_vals), n, nx, ny, nz, w, _lib.stream_handle(),
    )
    _lib.launch_counts[name] += 1
    _lib.check(err, name)
    return fulls
