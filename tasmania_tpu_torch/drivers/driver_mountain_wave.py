"""Linear mountain-wave validation driver (counterpart of
``drivers/driver_mountain_wave.py``): the dry isentropic core on a vertical
x-z slice, validated against the analytic solution.

Isothermal flow (T0 = 300 K, U = 10 m/s) over a 1-m Witch-of-Agnesi mountain
of half-width 10 km, on a grid one cell deep in y (``ny = 1``, so the
relaxed lateral boundary is one-dimensional and the stage runs unfused:
``fused_advection_fields`` on s, the boundary, the Montgomery potential and
``fused_momentum_step``), RK3WS-SI with third-order upwind fluxes and
Rayleigh damping on the last stage.  After every step the Montgomery
potential is recomputed from the stepped density, with the mountain at
``min((i+1)·dt / growth, 1)`` of its height (all of it without growth).  The
steady u-perturbation is compared with Durran's analytic solution
(``utils/meteo.py``) away from the sponge and the lateral frame.

The JAX driver reads the domain half-width, the θ at the top and the
damping depth and maximum from the environment (``MW_XHALF``,
``MW_THETA_TOP``, ``MW_DAMP_DEPTH``, ``MW_DAMP_MAX``); here they are
arguments (command-line flags) with the same defaults, and nothing is read
from the environment.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_mountain_wave [--nx 81] [--nz 60]
        [--hours 5] [--dt 20] [--growth-hours 0] [--x-half 2e5] [--theta-top 360]
        [--damp-depth N] [--damp-max 5e-4] [--dtype float32|float64]
        [--device cuda|cpu]

The device defaults to ``cuda``; without a GPU the run raises unless the CPU
is named (``--device cpu``).  The first of the steps is a warm-up; the rest
are timed on the host clock, ending in a device synchronisation, and the
driver prints their ms/step.
"""

from __future__ import annotations

import argparse
import json
import time
from datetime import datetime, timedelta
from typing import Any, Dict, Optional

import numpy as np
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device, synchronize
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.dynamics.diagnostics import IsentropicDiagnostics
from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tasmania_tpu_torch.isentropic.state import get_isentropic_state_from_brunt_vaisala_frequency
from tasmania_tpu_torch.utils.meteo import get_isothermal_isentropic_analytical_solution

T0, CP, G0 = 300.0, 1004.0, 9.80665
U0 = 10.0
H_MOUNTAIN, A_HALF = 1.0, 1e4
# the analytic gate of the deep domain (tests/test_mountain_wave_validation.py:146-151)
WINDOWS = (2, 3, 4)


def build(nx: int, nz: int, growth_hours: float = 0.0, *, x_half: float = 2e5,
          theta_top: float = 360.0, damp_depth: Optional[int] = None, damp_max: float = 5e-4,
          so: Optional[StorageOptions] = None):
    """``(domain, initial state, dycore, Montgomery diagnostics, pt)`` as the
    JAX ``run_case`` builds them (``drivers/driver_mountain_wave.py:49-92``):
    the grid and the initial state in float64 on the host, as the JAX
    package's default storage builds them, then the state, the reference
    state and the boundary's coefficients in ``so``'s type on its device."""
    so = so or StorageOptions(dtype=torch.float32, device="cuda")
    host = StorageOptions(dtype=torch.float64, device=so.device)
    damp_depth = max(8, nz // 5) if damp_depth is None else damp_depth
    bv = G0 / np.sqrt(CP * T0)  # isothermal Brunt-Vaisala frequency
    topo_kwargs: Dict[str, Any] = {"profile": lambda x, y: H_MOUNTAIN * A_HALF**2 / (x**2 + A_HALF**2)}
    if growth_hours > 0.0:
        topo_kwargs["time"] = timedelta(hours=growth_hours)
    domain = Domain(
        (-x_half, x_half), nx, (0.0, 1.0), 1,
        FieldArray(np.array([theta_top, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=3, horizontal_boundary_kwargs={"nr": 6},
        topography_type="user_defined", topography_kwargs=topo_kwargs,
        storage_options=host,
    )
    cgrid = domain.numerical_grid
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        cgrid, datetime(2000, 1, 1),
        FieldArray(np.asarray(U0), "m s^-1", ()), FieldArray(np.asarray(0.0), "m s^-1", ()),
        FieldArray(np.asarray(bv), "s^-1", ()), storage_options=host,
    )
    state = {k: FieldArray(fa.data.to(so.dtype), fa.units, fa.dims) if isinstance(fa, FieldArray) else fa
             for k, fa in state.items()}
    domain.horizontal_boundary.reference_state = state
    domain.horizontal_boundary.to(so.dtype)
    pt = float(state["air_pressure_on_interface_levels"].data[0, 0, 0])
    core = IsentropicDynamicalCore(
        domain, moist=False, time_integration_scheme="rk3ws_si",
        horizontal_flux_scheme="third_order_upwind",
        time_integration_properties={"pt": pt, "eps": 0.5},
        damp=True, damp_depth=damp_depth, damp_max=damp_max, damp_at_every_stage=False,
        storage_options=so,
    )
    return domain, state, core, IsentropicDiagnostics(cgrid, storage_options=so), pt


def validation(u_num, u_an, xs, kd: int) -> Dict[str, float]:
    """The JAX ``run_case`` summary (``drivers/driver_mountain_wave.py:137-160``)
    and the deep-domain gate's readings, from the numerical and analytic u on
    the u-points (numpy (nx+1, nz)), their x and the damping depth ``kd``:
    the correlation of the u-perturbations over the interior below the
    sponge (``corr``), over |x| <= 6a (``corr_focused``, with its rms error),
    the amplitude ratio over the interior, and, over |x| <= n·a for n = 2, 3,
    4, the correlations ``corr_<n>a`` and the 2a amplitude ratio."""
    kz = slice(kd + 4, None)
    dn, da = u_num[6:-6, kz] - U0, u_an[6:-6, kz] - U0
    out = {
        "corr": float(np.corrcoef(dn.ravel(), da.ravel())[0, 1]),
        "amplitude_ratio": float(np.abs(dn).max() / np.abs(da).max()),
    }
    m = np.abs(xs) <= 6.0 * A_HALF
    dn, da = u_num[m, kz] - U0, u_an[m, kz] - U0
    out["corr_focused"] = float(np.corrcoef(dn.ravel(), da.ravel())[0, 1])
    out["rms_err_focused"] = float(np.sqrt(np.mean((dn - da) ** 2)))
    for n in WINDOWS:
        m = np.abs(xs) <= n * A_HALF
        dn, da = u_num[m, kz] - U0, u_an[m, kz] - U0
        out[f"corr_{n}a"] = float(np.corrcoef(dn.ravel(), da.ravel())[0, 1])
        if n == 2:
            out["amplitude_ratio_2a"] = float(np.abs(dn).max() / np.abs(da).max())
    out["umax"] = float(u_num.max())
    return out


def analytic_u(domain) -> np.ndarray:
    """The analytic u on the physical grid's u-points, numpy (nx+1, nz)."""
    u_an, _ = get_isothermal_isentropic_analytical_solution(
        domain.physical_grid,
        FieldArray(np.asarray(U0), "m s^-1", ()), FieldArray(np.asarray(T0), "K", ()),
        FieldArray(np.asarray(H_MOUNTAIN), "m", ()), FieldArray(np.asarray(A_HALF), "m", ()),
    )
    return u_an[:, 0, :]


def make_step(core, diagnostics, pt: float, state, dt: float):
    """``(names, step)``: the names of the state's fields and one timestep of
    the JAX ``run_case`` (``drivers/driver_mountain_wave.py:98-106``) on a
    dict of them, ``step(fields, hs)``: the dycore, then the Montgomery
    potential of the stepped density over the topography ``hs``."""
    names = sorted(k for k in state if k != "time")
    mtg_fa = state["montgomery_potential"]

    def step(fields, hs):
        st = dict(fields)
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = core(st, {}, dt)
        mtg = diagnostics.get_montgomery_potential(st["air_isentropic_density"].data, pt, hs=hs)
        st["montgomery_potential"] = FieldArray(mtg, mtg_fa.units, mtg_fa.dims)
        return {k: st[k] for k in names}

    return names, step


def run_case(nx: int, nz: int, hours: float, dt: float, growth_hours: float = 0.0, *,
             x_half: float = 2e5, theta_top: float = 360.0, damp_depth: Optional[int] = None,
             damp_max: float = 5e-4, so: Optional[StorageOptions] = None,
             verbose: bool = True) -> Dict[str, Any]:
    """The JAX ``run_case``'s ``round(hours·3600 / dt)`` steps on the storage
    device (cuda by default).  Returns :func:`validation`'s numbers, the grid
    size, ``ms_per_step`` (all but the first step, timed) and the final
    ``fields``."""
    so = so or StorageOptions(dtype=torch.float32, device="cuda")
    check_device(so.device)
    damp_depth = max(8, nz // 5) if damp_depth is None else damp_depth
    domain, state, core, diagnostics, pt = build(
        nx, nz, growth_hours, x_half=x_half, theta_top=theta_top, damp_depth=damp_depth,
        damp_max=damp_max, so=so,
    )
    names, step = make_step(core, diagnostics, pt, state, dt)
    hs_steady = core.topography_steady
    nt = int(round(hours * 3600.0 / dt))
    growth_s = growth_hours * 3600.0

    def fact(i):
        return min((i + 1) * dt / growth_s, 1.0) if growth_s > 0.0 else 1.0

    fields = {k: state[k] for k in names}
    t0 = time.perf_counter()
    fields = step(fields, fact(0) * hs_steady)
    synchronize(so.device)
    if verbose:
        print(f"warmup step: {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    for i in range(1, nt):
        fields = step(fields, fact(i) * hs_steady)
    synchronize(so.device)
    elapsed = time.perf_counter() - t0

    u_num = fields["x_velocity_at_u_locations"].data[:, 0, :].double().cpu().numpy()
    xs = np.asarray(domain.physical_grid.x_at_u_locations.data)
    res: Dict[str, Any] = {"nx": nx, "nz": nz, "hours": hours, "dt": dt, "steps": nt}
    res.update(validation(u_num, analytic_u(domain), xs, damp_depth))
    res["ms_per_step"] = 1e3 * elapsed / max(nt - 1, 1)
    if verbose:
        print(json.dumps(res), flush=True)
        print(f"{res['ms_per_step']:.3f} ms/step over {nt - 1} steps on {so.device}")
    res["fields"] = fields
    return res


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nx", type=int, default=81)
    parser.add_argument("--nz", type=int, default=60)
    parser.add_argument("--hours", type=float, default=5.0)
    parser.add_argument("--dt", type=float, default=20.0)
    parser.add_argument("--growth-hours", type=float, default=0.0)
    parser.add_argument("--x-half", type=float, default=2e5)
    parser.add_argument("--theta-top", type=float, default=360.0)
    parser.add_argument("--damp-depth", type=int, default=None,
                        help="Rayleigh damping depth in levels (default max(8, nz // 5))")
    parser.add_argument("--damp-max", type=float, default=5e-4)
    parser.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    so = StorageOptions(dtype=getattr(torch, cli.dtype), device=cli.device)
    return run_case(cli.nx, cli.nz, cli.hours, cli.dt, cli.growth_hours, x_half=cli.x_half,
                    theta_top=cli.theta_top, damp_depth=cli.damp_depth, damp_max=cli.damp_max,
                    so=so)


if __name__ == "__main__":
    main()
