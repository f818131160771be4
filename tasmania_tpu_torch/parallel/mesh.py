"""A grid of ranks and the 2-D horizontal domain decomposition over it
(counterpart of ``tasmania_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with axes
``('x', 'y')``; here each shard is one process of a ``torch.distributed``
group, and :class:`RankGrid` places rank ``r`` at ``divmod(r, py)``, the
row-major order in which ``make_mesh`` reshapes its device list, unless it
is given an explicit order of the ranks (as ``multihost.make_hybrid_rank_grid``
gives one, keeping each node's ranks in one block).  The vertical axis
stays whole on every rank, so column scans never communicate.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple


def _factor_2d(n: int) -> Tuple[int, int]:
    """Most-square (px, py) factorisation of ``n`` (px·py == n, px >= py)."""
    best = (n, 1)
    for py in range(1, int(math.isqrt(n)) + 1):
        if n % py == 0:
            best = (n // py, py)
    return best


@dataclass(frozen=True)
class RankGrid:
    """A (px, py) grid of ranks: ``order[ix * py + iy]`` is the rank at
    (ix, iy); without an order (or with the identity), rank r sits at
    (r // py, r % py)."""

    px: int
    py: int
    order: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.order is None:
            return
        order = tuple(int(r) for r in self.order)
        if sorted(order) != list(range(self.px * self.py)):
            raise ValueError(f"rank order {order} is not a permutation of the "
                             f"{self.px}x{self.py} grid's ranks")
        identity = order == tuple(range(len(order)))
        object.__setattr__(self, "order", None if identity else order)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.px, self.py)

    @property
    def size(self) -> int:
        return self.px * self.py

    def coords(self, rank: int) -> Tuple[int, int]:
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a {self.px}x{self.py} grid")
        return divmod(rank if self.order is None else self.order.index(rank), self.py)

    def rank_of(self, ix: int, iy: int) -> int:
        k = ix * self.py + iy
        return k if self.order is None else self.order[k]


def make_rank_grid(n: int, shape: Optional[Tuple[int, int]] = None) -> RankGrid:
    """The rank grid of ``n`` ranks: ``shape``, or the most-square one."""
    px, py = shape if shape is not None else _factor_2d(n)
    if px * py != n:
        raise ValueError(f"mesh shape {px}x{py} != {n} ranks")
    return RankGrid(px, py)


def axis_pads(grid: RankGrid, nb: int, halo: int, periodic: bool) -> Tuple[int, int]:
    """The ghost-ring width of each axis: ``halo`` on a decomposed axis,
    ``nb`` on a periodic axis of extent 1 (it wraps locally), and 0 on a
    non-periodic axis of extent 1, whose shard then holds the whole axis in
    global coordinates."""
    if halo < nb:
        raise ValueError(f"halo={halo} must be >= nb={nb}")

    def pad(extent: int) -> int:
        return halo if extent > 1 else (nb if periodic else 0)

    return pad(grid.px), pad(grid.py)


class CartesianDecomposition:
    """Block decomposition of an (nx, ny) horizontal grid over a rank grid:
    the shard-local extents and the ghost-ring widths ``pad_x``, ``pad_y``
    (default ``nb``).  The fused whole-stage kernel needs a pad of at least
    nb + 1 on a decomposed axis (its Montgomery gradient reads the advected
    density one cell into the halo)."""

    def __init__(
        self,
        nx: int,
        ny: int,
        grid: RankGrid,
        nb: int,
        pad_x: Optional[int] = None,
        pad_y: Optional[int] = None,
    ) -> None:
        self.grid = grid
        self.nb = nb
        self.px, self.py = grid.shape
        if nx % self.px:
            raise ValueError(f"nx={nx} not divisible by mesh x-extent {self.px}")
        if ny % self.py:
            raise ValueError(f"ny={ny} not divisible by mesh y-extent {self.py}")
        self.nx, self.ny = nx, ny
        self.bx, self.by = nx // self.px, ny // self.py
        self.pad_x = nb if pad_x is None else pad_x
        self.pad_y = nb if pad_y is None else pad_y
        if self.bx < max(nb, self.pad_x) or self.by < max(nb, self.pad_y):
            raise ValueError(
                f"shard block ({self.bx}, {self.by}) smaller than halo width "
                f"({max(nb, self.pad_x)}, {max(nb, self.pad_y)})"
            )

    @property
    def local_shape_with_halo(self) -> Tuple[int, int]:
        return (self.bx + 2 * self.pad_x, self.by + 2 * self.pad_y)

    def offset(self, rank: int) -> Tuple[int, int]:
        """The global coordinates (gx0, gy0) of local cell (0, 0) of
        ``rank``'s halo-extended block."""
        ix, iy = self.grid.coords(rank)
        return ix * self.bx - self.pad_x, iy * self.by - self.pad_y
