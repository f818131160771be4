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

Each :class:`Exchange` counts what it sends in an :class:`ExchangeCounter`:
plain integers on the host, formed from the tensors' shapes, so counting
adds no device synchronisation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from tasmania_tpu_torch.parallel.mesh import RankGrid

BACKENDS = ("gloo", "nccl")
TAG_HI, TAG_LO = 1, 2


@dataclass
class ExchangeCounter:
    """What a rank's exchanges sent: ``exchanges`` (calls that exchange at
    least one axis with a neighbour), ``messages`` and ``bytes_sent``; and,
    for checking the bytes against the ring, ``column_bytes`` (the bytes of
    one column of every field of each such call, summed over the calls)
    and ``blocks`` (the horizontal shapes of the exchanged blocks)."""

    exchanges: int = 0
    messages: int = 0
    bytes_sent: int = 0
    column_bytes: int = 0
    blocks: set = field(default_factory=set)

    def snapshot(self) -> Dict[str, int]:
        return {"exchanges": self.exchanges, "messages": self.messages,
                "bytes_sent": self.bytes_sent, "column_bytes": self.column_bytes}

    def reset(self) -> None:
        self.exchanges = self.messages = self.bytes_sent = self.column_bytes = 0
        self.blocks = set()


@dataclass(frozen=True)
class Exchange:
    """What one rank needs to exchange halos: the rank grid, its rank, the
    backend of its process group (``"gloo"`` or ``"nccl"``), whether the
    domain is periodic, and the group (None: the default group); and the
    counter of what it sends."""

    grid: RankGrid
    rank: int
    backend: str
    periodic: bool
    group: Optional[object] = None
    counter: ExchangeCounter = field(default_factory=ExchangeCounter, compare=False)

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
    ex.counter.messages += len(sends)
    ex.counter.bytes_sent += sum(buf.numel() * buf.element_size() for buf, _, _ in sends)
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
    if fields and any(n > 1 and pad for n, pad in zip(ex.grid.shape, pads)):
        c = ex.counter
        c.exchanges += 1
        c.column_bytes += sum(f[:1, :1].numel() * f.element_size() for f in fields)
        c.blocks.update(tuple(f.shape[:2]) for f in fields)
    fields = _exchange_axis_multi(fields, pads[0], 0, ex)
    return _exchange_axis_multi(fields, pads[1], 1, ex)


def ring_bytes(ex: Exchange, pads: Tuple[int, int], block: Tuple[int, int],
               column_bytes: int) -> int:
    """The bytes the exchanges of ``ex``'s rank send, worked out from the
    ring: on each decomposed axis, a strip ``pad`` wide across the
    halo-extended ``block`` (mi, mj) to each neighbour, for exchanges whose
    fields' columns hold ``column_bytes`` in all (``ExchangeCounter``)."""
    mi, mj = block
    strips = 0
    for axis, (pad, across) in enumerate(zip(pads, (mj, mi))):
        if ex.grid.shape[axis] > 1 and pad:
            strips += sum(n is not None for n in ex.neighbours(axis)) * pad * across
    return column_bytes * strips


def halo_exchange(f: torch.Tensor, pads: Tuple[int, int], ex: Exchange) -> torch.Tensor:
    """One field's halos, both axes."""
    return halo_exchange_multi([f], pads, ex)[0]
