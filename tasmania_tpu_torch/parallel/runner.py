"""One timestep of a framework model on a rank of a 2-D decomposition
(counterpart of ``tasmania_tpu/parallel/runner.py::DistributedModel``).

Every rank builds the unmodified framework components (dycore and physics
chain) against its :class:`~tasmania_tpu_torch.parallel.distributed.LocalDomain`
and runs each step on its halo-extended block: the owned block is padded
and its halos exchanged at entry, the framework's own step runs with the
:class:`DistributedBoundary` supplying the boundary and the exchanges at
its seams, and the owned block is cropped at exit.  Staggered fields cross
the shard boundary cell-anchored (face i of cell i); inside the step the
local staggered view gets one more face that no stencil reads, and the
face just past the last owned cell, which on the global high edge is the
pinned outermost face, is kept so that :meth:`gather_state` returns every
face from the step itself.

A (1, 1) grid on a non-periodic domain has no ring: its components are
bound to the global domain and the step is the single-device program.

:class:`ShardLayout` is where a rank's shard lies in the global state,
without the components: the window of each field a rank owns (its block
and, for a staggered field, the face just past it), the scatter of a global
state or of such windows, and the parts a rank writes to a checkpoint.  A
sharded checkpoint (``utils/checkpoint.py``) restores through it onto any
grid of ranks, one layout at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.parallel.distributed import (
    DistributedBoundary,
    LocalDomain,
    stagger_axes,
)
from tasmania_tpu_torch.parallel.halo import Exchange, halo_exchange_multi
from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition, RankGrid, axis_pads


def pad_edge(f: torch.Tensor, hx: int, hy: int) -> torch.Tensor:
    """``f`` padded by ``hx`` and ``hy`` cells in x and y, repeating its edge
    values."""
    if hx == 0 and hy == 0:
        return f
    ix = torch.arange(-hx, f.shape[0] + hx, device=f.device).clamp(0, f.shape[0] - 1)
    iy = torch.arange(-hy, f.shape[1] + hy, device=f.device).clamp(0, f.shape[1] - 1)
    return f.index_select(0, ix).index_select(1, iy)


Region = Tuple[int, int, int, int]  # x0, x1, y0, y1 in global cells


class ShardLayout:
    """Where ``rank``'s shard of a ``grid`` of ranks lies in the state of
    ``global_domain`` (ring ``halo`` on a decomposed axis, default nb), for
    the fields that :meth:`set_fields` names.

    Fields are laid out as the decomposed step keeps them: on the global
    physical grid (a periodic grid's frame cropped), the owned block of a
    staggered field cell-anchored and the face just past it apart
    (``faces``).  On the degenerate grid (one rank, no ring) the rank owns
    every field whole, as the single device holds it."""

    def __init__(self, global_domain, grid: RankGrid, rank: int, *,
                 halo: Optional[int] = None) -> None:
        gpg = global_domain.physical_grid
        ghb = global_domain.horizontal_boundary
        nb = ghb.nb
        self.grid, self.rank = grid, rank
        self.periodic = ghb.family == "periodic"
        self.pads = axis_pads(grid, nb, nb if halo is None else int(halo), self.periodic)
        self.decomp = CartesianDecomposition(gpg.nx, gpg.ny, grid, nb, *self.pads)
        self.degenerate = grid.size == 1 and self.pads == (0, 0)
        self.extent = (gpg.nx, gpg.ny)
        self._global_hb = ghb
        self.names: List[str] = []
        self.units: Dict[str, str] = {}
        self.dims: Dict[str, Tuple[str, ...]] = {}

    def set_fields(self, state: Mapping[str, Any]) -> None:
        """The fields of ``state`` that the layout places (every field of two
        or more dimensions but the time), with their units and dims."""
        self.names = sorted(
            k for k, v in state.items()
            if k != "time" and isinstance(v, FieldArray) and v.data.dim() >= 2
        )
        self.units = {k: state[k].units for k in self.names}
        self.dims = {k: state[k].dims for k in self.names}

    def physical(self, d: torch.Tensor, name) -> torch.Tensor:
        crop = getattr(self._global_hb, "get_physical_field", None)
        return d if crop is None else crop(d, name)

    # -- regions ----------------------------------------------------------- #
    def global_shape(self, name: str, rest: Tuple[int, ...] = ()) -> Tuple[int, ...]:
        sx, sy = stagger_axes(name)
        return (self.extent[0] + sx, self.extent[1] + sy) + tuple(rest)

    def block_region(self, name: str, rank: Optional[int] = None) -> Region:
        """The global cells of ``rank``'s owned block of ``name`` (the whole
        field on the degenerate grid)."""
        if self.degenerate:
            gx, gy = self.global_shape(name)
            return 0, gx, 0, gy
        ix, iy = self.grid.coords(self.rank if rank is None else rank)
        bx, by = self.decomp.bx, self.decomp.by
        return ix * bx, (ix + 1) * bx, iy * by, (iy + 1) * by

    def face_region(self, name: str, rank: Optional[int] = None) -> Optional[Region]:
        """The global cells of the face just past ``rank``'s block of a
        staggered field (None for a cell field, or on the degenerate grid)."""
        sx, sy = stagger_axes(name)
        if self.degenerate or not (sx or sy):
            return None
        x0, x1, y0, y1 = self.block_region(name, rank)
        return (x1, x1 + 1, y0, y1) if sx else (x0, x1, y1, y1 + 1)

    def window(self, name: str) -> Region:
        """The global cells this rank's block and its face cover."""
        x0, x1, y0, y1 = self.block_region(name)
        face = self.face_region(name)
        if face is not None:
            x1, y1 = max(x1, face[1]), max(y1, face[3])
        return x0, x1, y0, y1

    # -- scatter and gather ----------------------------------------------- #
    def split_windows(self, windows: Mapping[str, torch.Tensor]):
        """This rank's owned blocks and last faces from its :meth:`window`
        of each field: (blocks, faces)."""
        if self.degenerate:
            return {n: windows[n] for n in self.names}, {}
        bx, by = self.decomp.bx, self.decomp.by
        blocks, faces = {}, {}
        for name in self.names:
            w = windows[name]
            sx, sy = stagger_axes(name)
            if sx:
                faces[name] = w[bx : bx + 1, :by].contiguous()
            if sy:
                faces[name] = w[:bx, by : by + 1].contiguous()
            blocks[name] = w[:bx, :by].contiguous()
        return blocks, faces

    def scatter_state(self, global_state: Mapping[str, Any]):
        """This rank's owned blocks and last faces of a global state (on its
        global numerical grid): (blocks, faces)."""
        if self.degenerate:
            return {n: global_state[n].data for n in self.names}, {}
        windows = {}
        for name in self.names:
            x0, x1, y0, y1 = self.window(name)
            windows[name] = self.physical(global_state[name].data, name)[x0:x1, y0:y1]
        return self.split_windows(windows)

    def regions(self, rank: Optional[int] = None) -> Dict[str, List[int]]:
        """The global cells ``[x0, x1, y0, y1]`` of what ``rank`` (default
        this layout's) writes to a sharded checkpoint: ``"block:<name>"``,
        its owned block, and ``"face:<name>"``, the face past it."""
        out = {}
        for name in self.names:
            out[f"block:{name}"] = list(self.block_region(name, rank))
            face = self.face_region(name, rank)
            if face is not None:
                out[f"face:{name}"] = list(face)
        return out

    def parts(self, blocks: Mapping[str, torch.Tensor],
              faces: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's blocks and faces under the keys of :meth:`regions`."""
        return {key: (blocks if key.startswith("block:") else faces)[key.split(":", 1)[1]]
                for key in self.regions()}


class DistributedModel:
    """A framework model's timestep on ``rank`` of a ``grid`` of ranks.

    ``model_factory(domain) -> (dycore, physics or None)`` builds the
    components against the domain it is given; ``global_state`` is the
    initial state on the global numerical grid (its reference state set on
    ``global_domain.horizontal_boundary``); ``backend`` is the process
    group's (``"gloo"`` or ``"nccl"``).  ``halo`` is the ring's width on a
    decomposed axis (default nb): the fused whole-stage kernel needs nb + 1.
    """

    def __init__(
        self,
        global_domain,
        global_state: Mapping[str, Any],
        grid: RankGrid,
        rank: int,
        model_factory: Callable[[Any], Tuple[Any, Any]],
        dt: float,
        *,
        backend: str,
        halo: Optional[int] = None,
        group=None,
    ) -> None:
        ghb = global_domain.horizontal_boundary
        self.layout = ShardLayout(global_domain, grid, rank, halo=halo)
        self.layout.set_fields(global_state)
        self.grid, self.rank = grid, rank
        self.pads, self.decomp = self.layout.pads, self.layout.decomp
        self.ex = Exchange(grid, rank, backend, self.layout.periodic, group)
        self.dt = float(dt)
        self.degenerate = self.layout.degenerate
        self._global_hb = ghb
        if self.degenerate:
            # the whole domain on one shard without a ring: the single-device
            # program, with the global domain's own boundary
            self.hb = None
            self.dycore, self.physics = model_factory(global_domain)
        else:
            self.hb = DistributedBoundary(global_domain, self.decomp, self.ex)
            self.hb.set_reference_state(ghb.reference_state)
            self.dycore, self.physics = model_factory(LocalDomain(self.hb))
        self.names = self.layout.names
        self.units, self.dims = self.layout.units, self.layout.dims
        self.device = global_state[self.names[0]].data.device
        self.last_faces: Dict[str, torch.Tensor] = {}

    # -- the state's layout ------------------------------------------------------ #
    def scatter_state(self, global_state: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """This rank's owned blocks of a global state (every rank holds the
        global state): staggered fields cell-anchored, the face just past
        the block kept in ``last_faces``."""
        out, self.last_faces = self.layout.scatter_state(global_state)
        return out

    def scatter_windows(self, windows: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's owned blocks from its window of each field
        (``layout.window``: the block and, staggered, the face past it, as
        a restored checkpoint gives them); the faces kept in
        ``last_faces``."""
        out, self.last_faces = self.layout.split_windows(windows)
        return out

    def checkpoint_parts(self, fields: Mapping[str, torch.Tensor]):
        """What this rank writes to a sharded checkpoint of ``fields`` (its
        owned blocks) and its ``last_faces``: ``layout.parts``."""
        return self.layout.parts(fields, self.last_faces)

    def put_topography(self, hs: torch.Tensor) -> torch.Tensor:
        """This rank's owned block of the topography height on the global
        numerical grid (as the state's fields: a periodic grid's frame is
        cropped first)."""
        if self.degenerate:
            return hs
        x0, x1, y0, y1 = self.layout.block_region("")
        return self.layout.physical(hs, None)[x0:x1, y0:y1].contiguous()

    def gather_state(self, fields: Mapping[str, torch.Tensor]) -> Optional[Dict[str, FieldArray]]:
        """The global state on rank 0 (host tensors), None on the others:
        each rank sends its blocks and its last faces in one message, and
        a staggered field's last global face is the one the high-edge ranks
        computed."""
        if self.degenerate:
            return {n: FieldArray(fields[n].cpu(), self.units[n], self.dims[n]) for n in self.names}
        faces = [n for n in self.names if any(stagger_axes(n))]
        parts = [fields[n] for n in self.names] + [self.last_faces[n] for n in faces]
        packed = torch.cat([p.reshape(-1) for p in parts])
        if self.ex.backend == "gloo":
            packed = packed.cpu()
        bufs = [torch.empty_like(packed) for _ in range(self.grid.size)] if self.rank == 0 else None
        dist.gather(packed, bufs, dst=0, group=self.ex.group)
        if self.rank != 0:
            return None
        shapes = [p.shape for p in parts]
        blocks = []
        for buf in bufs:
            buf, off, got = buf.cpu(), 0, []
            for shape in shapes:
                n = shape.numel()
                got.append(buf[off : off + n].view(shape))
                off += n
            blocks.append(dict(zip(self.names + [f"face:{n}" for n in faces], got)))
        px, py = self.grid.shape
        out = {}
        for name in self.names:
            rows = [torch.cat([blocks[self.grid.rank_of(i, j)][name] for j in range(py)], dim=1)
                    for i in range(px)]
            d = torch.cat(rows, dim=0)
            sx, sy = stagger_axes(name)
            if sx:  # the x-high ranks' faces
                d = torch.cat([d, torch.cat([blocks[self.grid.rank_of(px - 1, j)][f"face:{name}"]
                                             for j in range(py)], dim=1)], dim=0)
            if sy:
                d = torch.cat([d, torch.cat([blocks[self.grid.rank_of(i, py - 1)][f"face:{name}"]
                                             for i in range(px)], dim=0)], dim=1)
            out[name] = FieldArray(d, self.units[name], self.dims[name])
        return out

    # -- the step -------------------------------------------------------------------- #
    def step(self, fields: Mapping[str, torch.Tensor], hs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Advance this rank's owned blocks one timestep; ``hs`` is its owned
        block of the topography height.  The faces just past the owned
        block are kept in ``last_faces`` for :meth:`gather_state`."""
        if self.degenerate:
            st = {n: FieldArray(fields[n], self.units[n], self.dims[n]) for n in self.names}
            st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
            st = self._model(st)
            return {n: st[n].data for n in self.names}
        hx, hy = self.pads
        bx, by = self.decomp.bx, self.decomp.by
        padded = [pad_edge(fields[n], hx, hy) for n in self.names] + [pad_edge(hs, hx, hy)]
        exchanged = halo_exchange_multi(padded, self.pads, self.ex)
        hs_local = exchanged.pop()
        st = {}
        for name, f in zip(self.names, exchanged):
            # the local staggered view: one more face, which no stencil reads
            sx, sy = stagger_axes(name)
            if sx:
                f = torch.cat([f, f[-1:]], dim=0)
            if sy:
                f = torch.cat([f, f[:, -1:]], dim=1)
            st[name] = FieldArray(f, self.units[name], self.dims[name])
        st["topography_height"] = FieldArray(hs_local, "m", ("x", "y"))
        st = self._model(st)
        out, self.last_faces = {}, {}
        for name in self.names:
            d = st[name].data
            out[name] = d[hx : hx + bx, hy : hy + by].contiguous()
            sx, sy = stagger_axes(name)
            if sx:
                self.last_faces[name] = d[hx + bx : hx + bx + 1, hy : hy + by].contiguous()
            if sy:
                self.last_faces[name] = d[hx : hx + bx, hy + by : hy + by + 1].contiguous()
        return out

    def step_state(self, fields: Mapping[str, FieldArray], hs: torch.Tensor) -> Dict[str, FieldArray]:
        """:meth:`step` on ``FieldArray``s, as the drivers' step loop takes a
        step; on the degenerate grid the single-device step itself (the
        fields passed through, so that a traced step sees only the fields
        the components read)."""
        if self.degenerate:
            st = dict(fields)
            st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
            st = self._model(st)
            return {n: st[n] for n in self.names}
        out = self.step({n: fields[n].data for n in self.names}, hs)
        return {n: FieldArray(out[n], self.units[n], self.dims[n]) for n in self.names}

    def _model(self, st):
        st = self.dycore(st, {}, self.dt)
        return st if self.physics is None else self.physics(st, self.dt)
