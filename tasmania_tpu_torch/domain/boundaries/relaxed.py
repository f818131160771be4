"""Relaxed (Lehmann/Davies) lateral boundary conditions (counterpart of
``tasmania_tpu/domain/boundaries/relaxed.py``): two-dimensional grids and
grids one cell deep in y (``ny == 1``); one cell deep in x is not ported.

The tanh relaxation ramp over ``nr <= 8`` layers becomes one host-built
coefficient matrix γ, kept as a buffer; enforcement is the three-way select
``γ == 0 -> φ; γ == 1 -> ref; else φ - γ(φ - ref)``.

On a grid with ``ny == 1`` the numerical grid is ``2·nb + 1`` rows deep in y:
fields are padded by repeating the physical row, γ relaxes only the x-edges
of row nb, and enforcement copies row nb over the nb-wide y-frame, so every
row of the numerical grid carries the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from tasmania_tpu_torch.domain.horizontal_boundary import (
    HorizontalBoundary,
    change_dims,
    field_extent,
    repeat_axis,
)


def _relaxation_ramp(nr: int, nb: int) -> np.ndarray:
    rel = np.array([1.0 - np.tanh(0.5 * i) for i in range(8)])
    rel = rel[:nr].copy()
    rel[:nb] = 1.0
    return rel


def enforce_relaxed(phi, gamma, ref):
    """The relaxed-BC three-way select (exact pinning at γ == 1, identity at
    γ == 0, a lerp between)."""
    return torch.where(
        gamma == 0.0, phi, torch.where(gamma == 1.0, ref, phi - gamma * (phi - ref))
    )


class Relaxed(HorizontalBoundary):
    """Relaxation toward the reference state over ``nr`` boundary layers."""

    def __init__(self, grid, nb, storage_options=None, nr: int = 8):
        if grid.nx == 1:
            raise NotImplementedError("the relaxed boundary of a grid with nx == 1 is not ported")
        self.one_dx = grid.ny == 1
        if self.one_dx and not nr <= grid.nx / 2:
            raise ValueError("nr cannot exceed nx/2")
        if not self.one_dx and not (nr <= grid.nx / 2 and nr <= grid.ny / 2):
            raise ValueError("nr cannot exceed nx/2, ny/2")
        if nr > 8:
            raise ValueError("nr cannot exceed 8")
        if nb > nr:
            raise ValueError("nb cannot exceed nr")
        super().__init__(grid, nb, storage_options=storage_options)
        self.kwargs["nr"] = nr
        so = self.storage_options
        self.register_buffer(
            "gamma", torch.as_tensor(self._build_gamma(), dtype=so.dtype, device=so.device)
        )

    @property
    def nr(self) -> int:
        return self.kwargs["nr"]

    ni = property(lambda self: self.nx)
    nj = property(lambda self: 2 * self.nb + 1 if self.one_dx else self.ny)

    def get_numerical_xaxis(self, dims=None):
        return change_dims(self.physical_grid.x, dims)

    def get_numerical_xaxis_staggered(self, dims=None):
        return change_dims(self.physical_grid.x_at_u_locations, dims)

    def get_numerical_yaxis(self, dims=None):
        if self.one_dx:
            return repeat_axis(self.physical_grid.y, self.nb, dims)
        return change_dims(self.physical_grid.y, dims)

    def get_numerical_yaxis_staggered(self, dims=None):
        if self.one_dx:
            return repeat_axis(self.physical_grid.y_at_v_locations, self.nb, dims)
        return change_dims(self.physical_grid.y_at_v_locations, dims)

    def get_numerical_field(self, field, field_name=None):
        """The host array ``field`` on the numerical grid: with ``ny == 1``
        its y rows padded by repeating the first and the last."""
        if not self.one_dx:
            return field
        ny = field.shape[1]
        rows = np.clip(np.arange(-self.nb, ny + self.nb), 0, ny - 1)
        # numpy lays an index along axis 1 out last: copy to row-major order
        return np.ascontiguousarray(field[:, rows])

    def enforce_field(self, field, field_name=None, field_units=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        g = self.gamma[:mi, :mj]
        while g.dim() < field.dim():
            g = g[..., None]
        ref = self.ref_field(field_name, field_units)
        ref = ref[tuple(slice(0, m) for m in field.shape)]
        out = enforce_relaxed(field, g, ref)
        if self.one_dx:
            # the y-frame repeats the enforced row nb (and its mirror)
            nb = self.nb
            out[:mi, :nb] = out[:mi, nb : nb + 1]
            out[:mi, mj - nb : mj] = out[:mi, mj - nb - 1 : mj - nb]
        return out

    def set_outermost_layers_x(self, field, field_name=None, field_units=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        ref = self.ref_field(field_name, field_units)
        out = field.clone()
        out[0:1, :mj] = ref[0:1, :mj]
        out[mi - 1 : mi, :mj] = ref[mi - 1 : mi, :mj]
        return out

    def set_outermost_layers_y(self, field, field_name=None, field_units=None):
        mi, mj, _ = field_extent(field_name, self.ni, self.nj, self.nz)
        ref = self.ref_field(field_name, field_units)
        out = field.clone()
        out[:mi, 0:1] = ref[:mi, 0:1]
        out[:mi, mj - 1 : mj] = ref[:mi, mj - 1 : mj]
        return out

    def _build_gamma(self) -> np.ndarray:
        """(nx+1, nj+1) relaxation coefficients over the numerical grid,
        sliced per field in ``enforce_field``."""
        nb, nr = self.nb, self.nr
        nx, ny = self.nx, self.nj
        rel = _relaxation_ramp(nr, nb)
        rrel = rel[::-1]
        g = np.zeros((nx + 1, ny + 1))
        if self.one_dx:
            # only row nb (and the staggered row above it) relaxes; the
            # y-frame is overwritten by that row after the select
            g[:nr, nb : nb + 2] = rel[:, None]
            g[nx - nr : nx, nb : nb + 2] = rrel[:, None]
            g[nx, nb : nb + 2] = 1.0
            return g
        # corner block: gamma[i, j] = rel[min(i, j)]
        xnegyneg = np.zeros((nr, nr))
        for i in range(nr):
            xnegyneg[i, i:] = rel[i]
            xnegyneg[i:, i] = rel[i]
        xposyneg = xnegyneg[::-1, :]
        xposypos = xposyneg[:, ::-1]
        xnegypos = xnegyneg[:, ::-1]
        g[:nr, :nr] = xnegyneg
        g[:nr, nr : ny - nr] = rel[:, None]
        g[:nr, ny - nr : ny] = xnegypos
        g[nx - nr : nx, :nr] = xposyneg
        g[nx - nr : nx, nr : ny - nr] = rrel[:, None]
        g[nx - nr : nx, ny - nr : ny] = xposypos
        g[nr : nx - nr, :nr] = rel[None, :]
        g[nr : nx - nr, ny - nr : ny] = rrel[None, :]
        # staggered outermost row/column pinned to the reference state
        g[nx, : ny + 1] = 1.0
        g[: nx + 1, ny] = 1.0
        return g
