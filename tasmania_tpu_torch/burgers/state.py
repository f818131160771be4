"""The Zhao test case: an exact solution of the two-dimensional viscous
Burgers equations with diffusivity ``eps`` (counterpart of
``tasmania_tpu/burgers/state.py``)::

    d = exp(-5 π² eps t),   D = 2 + d sin(2πx) sin(πy)
    u = -4 eps π d cos(2πx) sin(πy) / D
    v = -2 eps π d sin(2πx) cos(πy) / D

The solution is computed in float64 with tensor operations.  Its ``time``
is a ``datetime`` (the solution is then computed on the CPU, as the
reference computes it in numpy) or a tensor of seconds from the initial
time, on whose device it is computed: as the Dirichlet boundary's core
inside a CUDA graph of the step, the time comes from the device and no
value from the host.
"""

from __future__ import annotations

import math
from datetime import datetime
from typing import Any, Dict, Optional

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.utils.units import conversion_factor

DIMS = ("x", "y", "z")


class ZhaoSolutionFactory:
    """The exact velocities; a Dirichlet core
    (``core(time, grid, slice_x, slice_y, field_name, field_units)``).  The
    sines and cosines of the grid's axes are kept on each device they are
    asked for, so that a call inside a CUDA graph copies nothing from the
    host."""

    def __init__(self, initial_time: datetime, eps) -> None:
        self.initial_time = initial_time
        if isinstance(eps, FieldArray):
            self.eps = float(np.asarray(eps.to_units("m^2 s^-1").data))
        else:
            self.eps = float(eps)
        self._trig: Dict[Any, Any] = {}

    def _trig_on(self, grid, device):
        """sin(2πx), cos(2πx), sin(πy), cos(πy) on the grid's axes in metres,
        float64, on ``device`` (kept with the grid)."""
        key = (id(grid), str(device))
        if key not in self._trig:
            x, y = (torch.as_tensor(np.asarray(a.to_units("m").data), dtype=torch.float64, device=device)
                    for a in (grid.x, grid.y))
            pi = math.pi
            trig = (torch.sin(2.0 * pi * x), torch.cos(2.0 * pi * x), torch.sin(pi * y), torch.cos(pi * y))
            self._trig[key] = (grid, trig)
        return self._trig[key][1]

    def __call__(self, time, grid, slice_x: Optional[slice] = None, slice_y: Optional[slice] = None,
                 field_name: str = "x_velocity", field_units: Optional[str] = None) -> torch.Tensor:
        rate = -5.0 * math.pi**2 * self.eps
        if isinstance(time, torch.Tensor):
            device = time.device
            decay = torch.exp(time.to(torch.float64) * rate)
        else:
            device = torch.device("cpu")
            t = (time - self.initial_time).total_seconds()
            decay = torch.exp(torch.tensor(rate * t, dtype=torch.float64))
        sx = slice(0, grid.nx) if slice_x is None else slice_x
        sy = slice(0, grid.ny) if slice_y is None else slice_y
        sin2x, cos2x, siny, cosy = self._trig_on(grid, device)
        sin2x, cos2x = sin2x[sx, None, None], cos2x[sx, None, None]
        siny, cosy = siny[None, sy, None], cosy[None, sy, None]
        eps, pi = self.eps, math.pi
        denom = 2.0 + decay * sin2x * siny
        if field_name == "x_velocity":
            tmp = (-4.0 * eps * pi * decay * cos2x * siny) / denom
        elif field_name == "y_velocity":
            tmp = (-2.0 * eps * pi * decay * sin2x * cosy) / denom
        else:
            raise ValueError(f"unknown field {field_name!r}")
        if field_units not in (None, "m s^-1"):
            tmp = conversion_factor("m s^-1", field_units) * tmp
        return tmp.expand(sin2x.shape[0], siny.shape[1], grid.nz)


class ZhaoStateFactory:
    """The state of the Zhao case at a time: its ``"time"`` and the exact
    velocities, (nx, ny, 1) tensors of the storage options' type on their
    device."""

    def __init__(self, initial_time: datetime, eps, *,
                 storage_options: Optional[StorageOptions] = None) -> None:
        self.solution = ZhaoSolutionFactory(initial_time, eps)
        self.storage_options = storage_options or StorageOptions()

    def __call__(self, time, grid) -> Dict[str, Any]:
        so = self.storage_options
        state: Dict[str, Any] = {"time": time}
        for name in ("x_velocity", "y_velocity"):
            data = self.solution(time, grid, field_name=name).to(so.dtype).to(so.device).contiguous()
            state[name] = FieldArray(data, "m s^-1", DIMS)
        return state
