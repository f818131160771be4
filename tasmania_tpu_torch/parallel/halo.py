"""Halo exchange between the ranks of a 2-D decomposition over
``torch.distributed`` (counterpart of ``tasmania_tpu/parallel/halo.py``).

Each rank holds a halo-extended block; the ``pad``-wide rings of its
decomposed axes are filled from the neighbouring ranks, x first and then y
over the x-exchanged block, so the corners come through.  On a periodic
axis the ring wraps; an axis of extent 1 wraps locally without a message,
or, when it is not periodic, is left alone.  The rings at a true domain edge
are left for the physical boundary conditions.

One call packs the strips of all its fields into one message each way per
axis and posts them in one ``torch.distributed.batch_isend_irecv``, in the
same order on every rank: the high strip to the right neighbour, the low
strip to the left one, then the receive from the left and the one from the
right, the high strips tagged apart from the low ones.  On a periodic axis
of extent 2 both strips go to the same peer, and that order (NCCL matches a
pair's messages in order) and the tags (gloo matches by tag) keep them from
crossing.  The received strips are copied into a copy of each block.

The backend is an argument, never a fallback: ``"gloo"`` carries host
tensors, so a rank whose blocks lie on the card stages its strips through
host memory; ``"nccl"`` sends the card's tensors as they are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tasmania_tpu_torch.parallel.mesh import RankGrid

BACKENDS = ("gloo", "nccl")
TAG_HI, TAG_LO = 1, 2


@dataclass(frozen=True)
class Exchange:
    """What one rank needs to exchange halos: the rank grid, its rank, the
    backend of its process group (``"gloo"`` or ``"nccl"``), whether the
    domain is periodic, and the group (None: the default group)."""

    grid: RankGrid
    rank: int
    backend: str
    periodic: bool
    group: Optional[object] = None

    def __post_init__(self) -> None:
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: one of {BACKENDS}")

    @property
    def coords(self) -> Tuple[int, int]:
        return self.grid.coords(self.rank)

    def neighbours(self, axis: int) -> Tuple[Optional[int], Optional[int]]:
        """The ranks to the left and to the right along ``axis`` (None at a
        non-periodic domain edge)."""
        ix, iy = self.coords
        n = self.grid.shape[axis]
        idx = ix if axis == 0 else iy

        def rank_at(k: int) -> Optional[int]:
            if not self.periodic and not 0 <= k < n:
                return None
            k %= n
            return self.grid.rank_of(k, iy) if axis == 0 else self.grid.rank_of(ix, k)

        return rank_at(idx - 1), rank_at(idx + 1)


def _strip(f: torch.Tensor, axis: int, start: int, width: int) -> torch.Tensor:
    return f.narrow(axis, start, width)


def _post(ex: Exchange, sends, recvs) -> None:
    """Post the sends, then the receives, as one batch and wait for it;
    under gloo through host buffers."""
    host = ex.backend == "gloo"
    ops = []
    for buf, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, buf.cpu() if host else buf, peer, ex.group, tag))
    staged = []
    for buf, peer, tag in recvs:
        tmp = torch.empty(buf.shape, dtype=buf.dtype) if host else buf
        staged.append(tmp)
        ops.append(dist.P2POp(dist.irecv, tmp, peer, ex.group, tag))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host:
        for (buf, _, _), tmp in zip(recvs, staged):
            buf.copy_(tmp)


def _exchange_axis_multi(fields: Sequence[torch.Tensor], nb: int, axis: int,
                         ex: Exchange) -> List[torch.Tensor]:
    """The ``nb``-wide rings along ``axis`` of every field filled from the
    neighbours (one message each way for all fields); new tensors."""
    fields = list(fields)
    if nb == 0 or not fields:
        return fields
    outs = [f.clone() for f in fields]
    if ex.grid.shape[axis] == 1:
        if ex.periodic:
            # one shard holds the whole ring: wrap it locally
            for f, out in zip(fields, outs):
                m = f.shape[axis]
                _strip(out, axis, 0, nb).copy_(_strip(f, axis, m - 2 * nb, nb))
                _strip(out, axis, m - nb, nb).copy_(_strip(f, axis, nb, nb))
        return outs
    left, right = ex.neighbours(axis)
    hi = torch.cat([_strip(f, axis, f.shape[axis] - 2 * nb, nb).reshape(-1) for f in fields])
    lo = torch.cat([_strip(f, axis, nb, nb).reshape(-1) for f in fields])
    from_left = torch.empty_like(hi) if left is not None else None
    from_right = torch.empty_like(lo) if right is not None else None
    sends, recvs = [], []
    if right is not None:
        sends.append((hi, right, TAG_HI))
    if left is not None:
        sends.append((lo, left, TAG_LO))
        recvs.append((from_left, left, TAG_HI))
    if right is not None:
        recvs.append((from_right, right, TAG_LO))
    _post(ex, sends, recvs)
    off = 0
    for out in outs:
        m = out.shape[axis]
        shape = _strip(out, axis, 0, nb).shape
        size = _strip(out, axis, 0, nb).numel()
        if from_left is not None:
            _strip(out, axis, 0, nb).copy_(from_left[off : off + size].view(shape))
        if from_right is not None:
            _strip(out, axis, m - nb, nb).copy_(from_right[off : off + size].view(shape))
        off += size
    return outs


def halo_exchange_multi(fields: Sequence[torch.Tensor], pads: Tuple[int, int],
                        ex: Exchange) -> List[torch.Tensor]:
    """Both horizontal axes of a list of same-dtype fields, x first, then y
    over the x-exchanged blocks; ``pads`` = (pad_x, pad_y)."""
    fields = list(fields)
    if fields and any(f.dtype != fields[0].dtype for f in fields):
        raise ValueError("halo_exchange_multi packs one message: the fields must share a dtype")
    fields = _exchange_axis_multi(fields, pads[0], 0, ex)
    return _exchange_axis_multi(fields, pads[1], 1, ex)


def halo_exchange(f: torch.Tensor, pads: Tuple[int, int], ex: Exchange) -> torch.Tensor:
    """One field's halos, both axes."""
    return halo_exchange_multi([f], pads, ex)[0]
