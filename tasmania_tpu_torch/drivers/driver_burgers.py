"""Burgers driver (BASELINE config 1; the port's counterpart of the JAX
``bench.py::bench_burgers``): the two-dimensional Burgers model, RK3WS with
third-order fluxes, float32 by default, at 2048x2048 by default.  Two cases:

* ``bench``: ``bench_burgers`` itself.  u and v on (nx + 2 nb, ny + 2 nb, 1)
  are 0.1 times standard normal draws of numpy generators seeded by
  ``seed`` and ``seed + 1`` (in place of ``jax.random``).  Each RK3WS stage
  adds ``-frac·dt·(advection of the latest stage)`` to the step's initial
  u and v on the interior inset by nb (fractions 1/3, 1/2, 1; dx = dy =
  1/nx, dt = 1e-4), so the frame keeps its initial values.
* ``zhao``: the model through its entry points: ``BurgersDynamicalCore``
  with ``BurgersHorizontalDiffusion`` (second order, eps = 0.1) as its fast
  tendency, on the unit square with the Dirichlet boundary whose core is
  the exact Zhao solution, from that solution at the initial time; dt from
  the explicit-diffusion number eps·dt/dx² = 0.16 (``tests/test_burgers.py``).
  The time each stage stamps has a ``timedelta``'s microsecond resolution,
  as in the reference: at 2048x2048, where dt is 3.8e-7 s, the stamps, and
  with them the Dirichlet frames, stay at the initial time.  The driver
  prints max|u|, max|v| and the largest difference from the exact solution
  at the state's time.

One warm-up step, then ``steps`` timed steps (50 for bench, 100 for zhao)
on the host clock ending in a device synchronisation; the driver prints
ms/step and gridpoints/s (nx·ny·steps/s, the metric of ``bench.py``).
On a CUDA device the timed steps are replays of one CUDA graph of the step
(``driver_namelist_sus.step_sequence``), as ``bench.py`` jits its step: the
zhao step then takes its start time from the graph's device table, and the
Dirichlet core computes the frames from it on the card.  On the CPU, or
with ``fused_loop=False`` from Python, they are eager; ``--fused-loop``
asks for the graph and raises without a CUDA device.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_burgers [--case bench|zhao] [--nx 2048]
        [--ny NY] [--nb 3] [--steps N] [--seed 0] [--dtype float32|float64]
        [--device cuda|cpu] [--fused-loop]

The device defaults to ``cuda``; without a GPU the run raises unless the CPU
is named (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime, timedelta
from typing import Any, Dict, Optional

import numpy as np
import torch

from tasmania_tpu_torch.burgers import (
    BurgersAdvection,
    BurgersDynamicalCore,
    BurgersHorizontalDiffusion,
    ZhaoSolutionFactory,
    ZhaoStateFactory,
)
from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device, cli_mode, step_sequence
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions

CASES = ("bench", "zhao")
STEPS = {"bench": 50, "zhao": 100}
BENCH_DT = 1e-4
EPS = 0.1
DIFFUSION_NUMBER = 0.16  # eps·dt/dx², tests/test_burgers.py:144
INITIAL_TIME = datetime(2000, 1, 1)
UV = ("x_velocity", "y_velocity")
DIMS = ("x", "y", "z")


def bench_fields(nx: int, ny: int, nb: int, seed: int, so: StorageOptions) -> Dict[str, FieldArray]:
    """The bench case's initial u and v."""
    shape = (nx + 2 * nb, ny + 2 * nb, 1)
    return {
        name: FieldArray(torch.as_tensor(0.1 * np.random.default_rng(seed + k).standard_normal(shape),
                                         dtype=so.dtype, device=so.device), "m s^-1", DIMS)
        for k, name in enumerate(UV)
    }


def bench_step(nx: int, nb: int, dt: float = BENCH_DT):
    """``step(fields, _)``: one RK3WS step of ``bench_burgers``."""
    adv = BurgersAdvection.factory("third_order")
    ext = adv.extent
    dx = dy = 1.0 / nx

    def stage(u, v, u0, v0, frac):
        iw = slice(nb - ext, u.shape[0] - nb + ext)
        jw = slice(nb - ext, u.shape[1] - nb + ext)
        a_ux, a_uy, a_vx, a_vy = adv(dx, dy, u[iw, jw], v[iw, jw])
        i, j = slice(nb, u.shape[0] - nb), slice(nb, u.shape[1] - nb)
        un, vn = u0.clone(), v0.clone()
        un[i, j] += -frac * dt * (a_ux + a_uy)
        vn[i, j] += -frac * dt * (a_vx + a_vy)
        return un, vn

    def step(fields, _):
        u, v = (fields[n].data for n in UV)
        u1, v1 = stage(u, v, u, v, 1.0 / 3.0)
        u2, v2 = stage(u1, v1, u, v, 0.5)
        u3, v3 = stage(u2, v2, u, v, 1.0)
        return {n: fields[n].with_data(d) for n, d in zip(UV, (u3, v3))}

    return step


def build_zhao(nx: int, ny: int, nb: int, so: StorageOptions, scheme: str = "rk3ws",
               flux_scheme: str = "third_order"):
    """``(domain, exact solution, initial state, dycore, dt)`` of the zhao
    case: the grid in float64 on the host, as the JAX package's default
    storage builds it; the state, the reference state and the diffusion's
    coefficient in ``so``'s type on its device."""
    zsf = ZhaoSolutionFactory(INITIAL_TIME, EPS)
    domain = Domain((0.0, 1.0), nx, (0.0, 1.0), ny, FieldArray(np.array([1.0, 0.0]), "1", ("z",)), 1,
                    horizontal_boundary_type="dirichlet", nb=nb, horizontal_boundary_kwargs={"core": zsf},
                    storage_options=StorageOptions(dtype=torch.float64, device=so.device))
    grid = domain.numerical_grid
    state = ZhaoStateFactory(INITIAL_TIME, EPS, storage_options=so)(INITIAL_TIME, grid)
    domain.horizontal_boundary.reference_state = state
    diffusion = BurgersHorizontalDiffusion(domain, "numerical", "second_order",
                                           FieldArray(np.asarray(EPS), "m^2 s^-1", ()), storage_options=so)
    dycore = BurgersDynamicalCore(domain, fast_tendency_component=diffusion,
                                  time_integration_scheme=scheme, flux_scheme=flux_scheme)
    dx = float(np.asarray(grid.dx.to_units("m").data))
    return domain, zsf, state, dycore, DIFFUSION_NUMBER * dx * dx / EPS


def validation(fields, zsf=None, grid=None, time=None) -> Dict[str, float]:
    """max|u|, max|v|, the float64 sums of u, v and their magnitudes, and,
    given the exact solution, the largest difference from it at ``time``
    (``err_u``, ``err_v``)."""
    out: Dict[str, float] = {}
    for short, name in zip("uv", UV):
        a = fields[name].data.double()
        out[f"{short}max"] = float(a.abs().max())
        out[f"{short}_sum"] = float(a.sum())
        out[f"{short}_abs_sum"] = float(a.abs().sum())
        if zsf is not None:
            exact = zsf(time, grid, field_name=name).to(a.device)
            out[f"err_{short}"] = float((a - exact).abs().max())
    return out


def make_case(case: str, nx: int, ny: int, nb: int, steps: int, seed: int, so: StorageOptions):
    """``(step, fields, starts, dt, summary)`` of ``case``: the step
    ``step(fields, t)`` (``t`` a float64 tensor of the step's start time,
    seconds from the initial time; the bench step reads none), the initial
    fields, the start time of each of the ``1 + steps`` steps as the
    reference's datetimes count it, dt in seconds and ``summary(fields)``,
    :func:`validation`'s numbers of the final fields."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r} (have {CASES})")
    if case == "bench":
        return (bench_step(nx, nb), bench_fields(nx, ny, nb, seed, so), [0.0] * (steps + 1), BENCH_DT,
                validation)
    domain, zsf, state, dycore, dt = build_zhao(nx, ny, nb, so)

    def step(fields, t):
        out = dycore({**fields, "time": t}, {}, dt)
        return {n: out[n] for n in UV}

    starts = [(k * timedelta(seconds=dt)).total_seconds() for k in range(steps + 1)]
    end = INITIAL_TIME + (steps + 1) * timedelta(seconds=dt)
    return (step, {n: state[n] for n in UV}, starts, dt,
            lambda fields: validation(fields, zsf, domain.numerical_grid, end))


def run_case(case: str = "bench", nx: int = 2048, ny: Optional[int] = None, nb: int = 3,
             steps: Optional[int] = None, *, seed: int = 0, so: Optional[StorageOptions] = None,
             verbose: bool = True, fused_loop: Optional[bool] = None) -> Dict[str, Any]:
    """One warm-up step and ``steps`` timed steps of ``case`` on the storage
    device (cuda by default); on a CUDA device the timed steps are replays
    of one CUDA graph of the step, unless ``fused_loop`` is False
    (``driver_namelist_sus.graph_mode``: True raises on a CPU device).
    Returns :func:`validation`'s numbers, ``ms_per_step``, ``gps``, the final
    ``fields``, the kernel launches of one step and ``capture_s`` (None
    without a graph)."""
    so = so or StorageOptions(dtype=torch.float32, device="cuda")
    check_device(so.device, fused_loop=fused_loop)
    ny = nx if ny is None else ny
    steps = STEPS[case] if steps is None else steps
    step, fields, starts, dt, summary = make_case(case, nx, ny, nb, steps, seed, so)
    one = torch.ones((), dtype=torch.float64, device=so.device)
    fields, elapsed, per_step, capture_s = step_sequence(
        step, fields, starts[0] * one, one, starts[1:], so.device, verbose=verbose, fused_loop=fused_loop)

    res: Dict[str, Any] = {"case": case, "nx": nx, "ny": ny, "nb": nb, "steps": steps, "dt": dt}
    res.update(summary(fields))
    res["ms_per_step"] = 1e3 * elapsed / max(steps, 1)
    res["gps"] = nx * ny * max(steps, 1) / elapsed
    if verbose:
        print(json.dumps(res), flush=True)
        print(f"{res['ms_per_step']:.3f} ms/step, {res['gps']:.4e} gridpoints/s over {steps} steps "
              f"on {so.device}")
    res.update(fields=fields, launches_per_step=per_step, capture_s=capture_s)
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--case", choices=CASES, default="bench")
    parser.add_argument("--nx", type=int, default=2048)
    parser.add_argument("--ny", type=int, default=None, help="default: nx")
    parser.add_argument("--nb", type=int, default=3)
    parser.add_argument("--steps", type=int, default=None,
                        help="timed steps after the warm-up (default 50 for bench, 100 for zhao)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--fused-loop", action="store_true",
                        help="run the timed steps as replays of one CUDA graph of the step, as "
                             "on a CUDA device by default (raises without a CUDA device)")
    cli = parser.parse_args(argv)
    so = StorageOptions(dtype=getattr(torch, cli.dtype), device=cli.device)
    return run_case(cli.case, cli.nx, cli.ny, cli.nb, cli.steps, seed=cli.seed, so=so,
                    fused_loop=cli_mode(cli))


if __name__ == "__main__":
    main()
