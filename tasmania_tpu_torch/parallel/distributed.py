"""The lateral boundary of one shard of a 2-D decomposition (counterpart of
``tasmania_tpu/parallel/distributed.py``: ``LocalDomain`` ``:60-81``,
``DistributedBoundary`` ``:115-591``).

The framework's own components run unchanged on a rank's halo-extended
block; the boundary supplies the distributed semantics at the seams where
the single-device code enforces its lateral boundary:

* ``enforce_field`` and ``enforce_raw``: the physical boundary condition on
  every local cell (the relaxed three-way select against the shard's
  windows of the global γ and reference fields), then a halo exchange;
* ``refresh_halos(_many)``: the exchange alone, for stencil outputs that
  leave their rings stale (smoothing, Smagorinsky, diffusion);
* ``restrict_stencil_output`` and ``zero_physical_frame``: a stencil output
  kept only at least nb cells from every global edge, where the
  single-device stencil writes;
* ``post_stage_sync``: the exchange after a fused stage, whose kernel
  applied the boundary and the damping itself;
* ``set_outermost_layers_x/y``: the staggered velocity pinned to the
  reference on the global outermost faces.

The shard's global offset is a host pair of ints (``offset``): the rank
knows its coordinates.  Inner boundaries: relaxed (the flagship), periodic
(the period-nx ring of the JAX class), identity, and Dirichlet with a
time-independent core (one that returns host arrays): the core is
evaluated once over the four global bands and windowed per shard
(``_dirichlet_pin_global``, ``:319-361``).  A core that returns a tensor, as
a time-dependent one does, raises ``NotImplementedError``; a grid one cell
deep raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from tasmania_tpu_torch.domain.boundaries.relaxed import enforce_relaxed
from tasmania_tpu_torch.domain.grid import PhysicalGrid
from tasmania_tpu_torch.domain.horizontal_boundary import BUILT_IN, HorizontalBoundary, change_dims
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.utils.units import conversion_factor, units_are_same
from tasmania_tpu_torch.parallel.halo import Exchange, halo_exchange, halo_exchange_multi
from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition


def stagger_axes(field_name: Optional[str]) -> Tuple[bool, bool]:
    """Whether a named field is staggered in x and in y."""
    name = field_name or ""
    return ("at_u_locations" in name or "at_uv_locations" in name,
            "at_v_locations" in name or "at_uv_locations" in name)


def window(global_field: np.ndarray, decomp: CartesianDecomposition, rank: int,
           staggered: Tuple[bool, bool] = (False, False), pad_mode: str = "constant") -> np.ndarray:
    """``rank``'s halo-extended window of a global host array: its owned
    block and the ring around it, the ring outside the domain padded with
    zeros (``"constant"``) or the edge values (``"edge"``)."""
    hx, hy = decomp.pad_x, decomp.pad_y
    f = np.asarray(global_field)
    pads = [(hx, hx), (hy, hy)] + [(0, 0)] * (f.ndim - 2)
    fp = np.pad(f, pads, mode=pad_mode)
    ix, iy = decomp.grid.coords(rank)
    lx = decomp.bx + 2 * hx + int(staggered[0])
    ly = decomp.by + 2 * hy + int(staggered[1])
    return np.ascontiguousarray(fp[ix * decomp.bx : ix * decomp.bx + lx,
                                   iy * decomp.by : iy * decomp.by + ly])


class LocalDomain:
    """The domain a rank's components are built against: the boundary's
    local grids (the surface of ``domain.Domain``)."""

    def __init__(self, boundary: "DistributedBoundary") -> None:
        self._hb = boundary

    @property
    def physical_grid(self):
        return self._hb.physical_grid

    @property
    def numerical_grid(self):
        return self._hb.numerical_grid

    @property
    def horizontal_boundary(self):
        return self._hb


class DistributedBoundary(HorizontalBoundary):
    """The lateral boundary of ``ex.rank``'s shard, built from the global
    domain; its reference state is set from the global one by
    :meth:`set_reference_state`."""

    one_dx = False
    one_dy = False

    def __init__(self, global_domain, decomp: CartesianDecomposition, ex: Exchange) -> None:
        ghb = global_domain.horizontal_boundary
        gpg = global_domain.physical_grid
        if gpg.nx < 2 or gpg.ny < 2:
            raise ValueError("a grid one cell deep runs on a single device only")
        inner = ghb.family
        if inner not in BUILT_IN:
            raise NotImplementedError(
                f"the decomposed step takes the boundaries {BUILT_IN}, not {inner!r}"
            )
        # the global grid's frame cropped off a reference field (periodic)
        self._physical_field = ghb.get_physical_field if inner == "periodic" else None
        # the Dirichlet core and the global numerical grid it is evaluated on
        self._core = (ghb.kwargs["core"], ghb.numerical_grid) if inner == "dirichlet" else None
        self._decomp = decomp
        self._ex = ex
        self._gnx, self._gny = gpg.nx, gpg.ny
        self._inner_type = inner
        self._periodic = inner == "periodic"
        lx, ly = decomp.local_shape_with_halo
        dx = float(np.asarray(gpg.dx.data))
        dy = float(np.asarray(gpg.dy.data))
        zhl = np.asarray(gpg.z_on_interface_levels.data)
        so = ghb.storage_options
        local = PhysicalGrid(
            FieldArray(np.array([0.0, dx * (lx - 1)]), gpg.x.units, gpg.x.dims),
            lx,
            FieldArray(np.array([0.0, dy * (ly - 1)]), gpg.y.units, gpg.y.dims),
            ly,
            FieldArray(np.array([zhl[0], zhl[-1]]), gpg.z.units, (gpg.z.dims[0],)),
            gpg.nz,
            z_interface=gpg.z_interface,
            topography_kwargs={"time": gpg.topography.time},  # flat: hs is a state input
            storage_options=so,
        )
        # the global spacings exactly: (dx·(lx-1))/(lx-1) may round
        local.grid_xy.dx, local.grid_xy.dy = gpg.dx, gpg.dy
        super().__init__(local, ghb.nb, storage_options=so)
        self.numerical_grid.grid_xy.dx, self.numerical_grid.grid_xy.dy = gpg.dx, gpg.dy
        self.type = f"distributed_{inner}"
        self.kwargs = dict(ghb.kwargs)
        if inner == "relaxed":
            g = ghb.gamma[: self._gnx, : self._gny].cpu().numpy()
        else:
            g = np.zeros((self._gnx, self._gny))
            if inner == "dirichlet":  # the pinned nb-wide frame
                nb = ghb.nb
                g[:nb], g[-nb:], g[:, :nb], g[:, -nb:] = 1.0, 1.0, 1.0, 1.0
        self.register_buffer(
            "gamma", torch.as_tensor(window(g, decomp, ex.rank), dtype=so.dtype, device=so.device)
        )

    # -- geometry: the numerical grid is the halo-extended local block -------- #
    ni = property(lambda self: self._decomp.bx + 2 * self._decomp.pad_x)
    nj = property(lambda self: self._decomp.by + 2 * self._decomp.pad_y)

    @property
    def pads(self) -> Tuple[int, int]:
        return (self._decomp.pad_x, self._decomp.pad_y)

    @property
    def is_degenerate(self) -> bool:
        """One shard without a ring: local coordinates are global ones."""
        d = self._decomp
        return d.px == 1 and d.py == 1 and d.pad_x == 0 and d.pad_y == 0

    @property
    def decomposition(self) -> CartesianDecomposition:
        return self._decomp

    @property
    def inner_type(self) -> str:
        return self._inner_type

    @property
    def global_extent(self) -> Tuple[int, int]:
        return (self._gnx, self._gny)

    @property
    def offset(self) -> Tuple[int, int]:
        """The global coordinates (gx0, gy0) of local cell (0, 0)."""
        return self._decomp.offset(self._ex.rank)

    def get_numerical_xaxis(self, dims=None):
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    def get_numerical_field(self, field, field_name=None):
        return field

    def get_physical_field(self, field, field_name=None):
        return field

    # -- the shard's reference state ------------------------------------------ #
    def set_reference_state(self, ref_state: Mapping[str, Any]) -> None:
        """The shard's windows of the GLOBAL reference state (fields on the
        global numerical grid; a periodic grid's frame is cropped first),
        kept as this boundary's reference state; under Dirichlet also the
        windows of the core's values over the global bands (``pin_<name>``
        buffers)."""
        so = self.storage_options
        local = {}
        for name, fa in ref_state.items():
            if not isinstance(fa, FieldArray) or not isinstance(fa.data, torch.Tensor):
                continue
            if fa.data.dim() < 2:
                continue
            data = fa.data
            if self._physical_field is not None:
                data = self._physical_field(data, name)
            host = data.cpu().numpy()
            local[name] = FieldArray(self._window(host, name, data.dtype), fa.units, fa.dims)
            if self._core is not None:
                pin = self._dirichlet_pin_global(name, fa.units, host)
                self.register_buffer("pin_" + name, self._window(pin, name, data.dtype))
        self.reference_state = local

    def _window(self, host, name, dtype) -> torch.Tensor:
        w = window(host, self._decomp, self._ex.rank, stagger_axes(name), pad_mode="edge")
        return torch.as_tensor(w, dtype=dtype, device=self.storage_options.device)

    def _dirichlet_pin_global(self, name, units, data: np.ndarray) -> np.ndarray:
        """The Dirichlet core over the four nb-wide global bands (the windows
        the single-device class pastes), the reference elsewhere (never
        read: γ is 0 there)."""
        core, ggrid = self._core
        nb = self.nb
        mi, mj = data.shape[:2]
        pin = np.array(data, copy=True)

        def band(si, sj):
            vals = core(None, ggrid, si, sj, name, units)
            if isinstance(vals, torch.Tensor):
                raise NotImplementedError(
                    "a Dirichlet core that returns a tensor (a time-dependent one) runs on a single "
                    "device only: the decomposed boundary evaluates the core once, on the host"
                )
            vals = np.asarray(vals, dtype=data.dtype)
            if data.ndim == 3 and vals.ndim == 2:
                vals = vals[:, :, None]
            return np.broadcast_to(vals, (si.stop - si.start, sj.stop - sj.start) + data.shape[2:])

        pin[0:nb, :] = band(slice(0, nb), slice(0, mj))
        pin[mi - nb :, :] = band(slice(mi - nb, mi), slice(0, mj))
        pin[nb : mi - nb, 0:nb] = band(slice(nb, mi - nb), slice(0, nb))
        pin[nb : mi - nb, mj - nb :] = band(slice(nb, mi - nb), slice(mj - nb, mj))
        return pin

    def _pin_target(self, field_name, field_units):
        """What the frame is pinned to: the Dirichlet core's values, or the
        reference (relaxed)."""
        if self._core is None:
            return self.ref_field(field_name, field_units)
        pin = getattr(self, "pin_" + field_name)
        units = self._ref_units[field_name]
        if field_units is None or units_are_same(units, field_units):
            return pin
        return pin * conversion_factor(units, field_units)

    # -- masks ------------------------------------------------------------------ #
    def _global_coords(self, length: int, axis: int, device) -> torch.Tensor:
        return self.offset[axis] + torch.arange(length, device=device)

    def _interior_mask(self, mi: int, mj: int, nb: int, device) -> torch.Tensor:
        """(mi, mj) bool: at least nb cells from every global edge."""
        gx = self._global_coords(mi, 0, device)
        gy = self._global_coords(mj, 1, device)
        mx = (gx >= nb) & (gx < self._gnx - nb)
        my = (gy >= nb) & (gy < self._gny - nb)
        return mx[:, None] & my[None, :]

    # -- the distribution hooks ---------------------------------------------------- #
    def _exchange_many(self, fields: Sequence[torch.Tensor]):
        return halo_exchange_multi(fields, self.pads, self._ex)

    def refresh_halos(self, field, field_name: Optional[str] = None):
        """The halo rings of ``field`` from the neighbours.  A staggered
        field travels cell-anchored: its last face, which no stencil reads
        beyond the owned faces, is kept."""
        sx, sy = stagger_axes(field_name)
        if not (sx or sy):
            return halo_exchange(field, self.pads, self._ex)
        core = halo_exchange(field[: field.shape[0] - int(sx), : field.shape[1] - int(sy)],
                             self.pads, self._ex)
        if sx:
            core = torch.cat([core, field[-1:, : field.shape[1] - int(sy)]], dim=0)
        if sy:
            core = torch.cat([core, field[: core.shape[0], -1:]], dim=1)
        return core

    def refresh_halos_many(self, fields, field_names=None):
        fields = list(fields)
        names = list(field_names) if field_names is not None else [""] * len(fields)
        if any(any(stagger_axes(n)) for n in names):
            raise ValueError("the bulk refresh takes cell fields; a staggered one goes through "
                             "refresh_halos")
        return self._exchange_many(fields)

    def restrict_stencil_output(self, out, base=None, nb: Optional[int] = None, field_name=None):
        """``out`` where the cell is at least ``nb`` from every global edge,
        ``base`` (zero if None) elsewhere."""
        nb = self.nb if nb is None else nb
        mask = self._interior_mask(out.shape[0], out.shape[1], nb, out.device)
        mask = mask.reshape(mask.shape + (1,) * (out.dim() - 2))
        keep = torch.zeros_like(out) if base is None else base
        return torch.where(mask, out, keep)

    def zero_physical_frame(self, full, nb: int, field_name=None):
        return self.restrict_stencil_output(full, base=None, nb=nb)

    # -- enforcement ------------------------------------------------------------------ #
    def _apply_physical_bc(self, field, field_name=None, field_units=None):
        """The boundary condition alone, without the exchange."""
        if any(stagger_axes(field_name)):
            raise NotImplementedError(
                "the decomposed enforce_field takes cell fields; the staggered outermost "
                "faces go through set_outermost_layers_x/y"
            )
        if self._inner_type not in ("relaxed", "dirichlet"):
            return field
        g = self.gamma[: field.shape[0], : field.shape[1]].to(field.dtype)
        g = g.reshape(g.shape + (1,) * (field.dim() - 2))
        target = self._pin_target(field_name, field_units)
        return enforce_relaxed(field, g, target[tuple(slice(0, m) for m in field.shape)])

    def enforce_field(self, field, field_name=None, field_units=None, time=None):
        return halo_exchange(self._apply_physical_bc(field, field_name, field_units),
                             self.pads, self._ex)

    def enforce_raw(self, state, field_properties=None):
        """The boundary condition on each field of the reference state, then
        one exchange for all of them (the base's per-field enforcement with
        the exchanges packed into one)."""
        fps = {n: {"units": u} for n, u in self._ref_units.items()}
        if field_properties is not None:
            fps = {n: {**fps[n], **p} for n, p in field_properties.items() if n in fps}
        names = [n for n in state if n != "time" and n in fps]
        bced = [self._apply_physical_bc(state[n], n, fps[n]["units"]) for n in names]
        out = dict(state)
        out.update(zip(names, self._exchange_many(bced)))
        return out

    def post_stage_sync(self, out: Mapping[str, Any]) -> Dict[str, Any]:
        """The halo rings of a fused stage's cell fields, in one exchange
        (the stage kernel applied the boundary and the damping; the caller
        derives the staggered velocities from the synced fields)."""
        out = dict(out)
        names = [n for n in out if not any(stagger_axes(n))]
        out.update(zip(names, self._exchange_many([out[n] for n in names])))
        return out

    def _pin_outermost(self, field, field_name, field_units, axis: int):
        staggered = stagger_axes(field_name)[axis]
        g = self._global_coords(field.shape[axis], axis, field.device)
        gmax = (self._gnx if axis == 0 else self._gny) - 1 + int(staggered)
        mask = (g == 0) | (g == gmax)
        mask = mask.reshape((-1,) + (1,) * (field.dim() - 1) if axis == 0
                            else (1, -1) + (1,) * (field.dim() - 2))
        if self._inner_type == "identity":
            # the single-device step leaves the zero faces of the velocity
            # diagnosis there
            pinned = torch.zeros_like(field)
        else:
            pinned = self._pin_target(field_name, field_units)[tuple(slice(0, m) for m in field.shape)]
        return torch.where(mask, pinned, field)

    def set_outermost_layers_x(self, field, field_name=None, field_units=None, time=None):
        if self._periodic:
            return field  # every face of the period-nx ring is an interior face
        return self._pin_outermost(field, field_name, field_units, 0)

    def set_outermost_layers_y(self, field, field_name=None, field_units=None, time=None):
        if self._periodic:
            return field
        return self._pin_outermost(field, field_name, field_units, 1)
