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

``--sweep`` is the resolution-convergence study (:func:`sweep`: the three
cases of ``SWEEP_CASES`` and the observed order of the focused rms error
between consecutive cases); ``--diagnose`` the window and sponge attribution
study at ``--nx``, ``--nz``, ``--dt`` (:func:`diagnose`), which wins over
``--sweep`` as in the JAX driver, and writes the u profiles to
``--diagnose-out`` (an ``.npz``) only when that is given.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_mountain_wave [--nx 81] [--nz 60]
        [--hours 5] [--dt 20] [--growth-hours 0] [--x-half 2e5] [--theta-top 360]
        [--damp-depth N] [--damp-max 5e-4] [--dtype float32|float64]
        [--device cuda|cpu] [--fused-loop] [--sweep] [--diagnose [--diagnose-out PATH]]

The device defaults to ``cuda``; without a GPU the run raises unless the CPU
is named (``--device cpu``).  The first of the steps is a warm-up; the rest
are timed on the host clock, ending in a device synchronisation, and the
driver prints their ms/step.  On a CUDA device the timed steps are
replays of one CUDA graph of the step, captured after the warm-up
(``driver_namelist_sus.step_sequence``), as the JAX driver jits its step;
on the CPU, or with ``fused_loop=False`` from Python, they are eager.
``--fused-loop`` asks for the graph and raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime, timedelta
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device, cli_mode, step_sequence
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
# the JAX --sweep's cases (nx, nz, dt): dx halves from one to the next
SWEEP_CASES = ((81, 60, 20.0), (161, 90, 10.0), (321, 120, 5.0))
# --diagnose: the comparison windows' half-widths in units of a ("full" the
# whole x-axis) and the clearances below the sponge, in levels
DIAGNOSE_WINDOWS = (2.0, 4.0, 6.0, 10.0, 20.0, "full")
DIAGNOSE_CLEARANCES = (0, 4, 8)


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
             verbose: bool = True, fused_loop: Optional[bool] = None) -> Dict[str, Any]:
    """The JAX ``run_case``'s ``round(hours·3600 / dt)`` steps on the storage
    device (cuda by default); on a CUDA device all but the first as replays
    of one CUDA graph of the step, unless ``fused_loop`` is False
    (``driver_namelist_sus.graph_mode``: True raises on a CPU device).
    Returns :func:`validation`'s numbers, the grid size, ``ms_per_step`` (all
    but the first step, timed), the final ``fields``, the kernel launches of
    one step (the warm-up's, or the captured step's), ``capture_s``, the
    seconds of the capture (None without a graph), and ``profiles``: the
    numerical and analytic u on the u-points as float64 numpy (nx+1, nz),
    their x and the damping depth (``u_num``, ``u_an``, ``xs``, ``kd``)."""
    so = so or StorageOptions(dtype=torch.float32, device="cuda")
    check_device(so.device, fused_loop=fused_loop)
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

    fields, elapsed, per_step, capture_s = step_sequence(
        step, {k: state[k] for k in names}, fact(0) * hs_steady, hs_steady,
        [fact(i) for i in range(1, nt)], so.device, verbose=verbose, fused_loop=fused_loop)

    u_num = fields["x_velocity_at_u_locations"].data[:, 0, :].double().cpu().numpy()
    u_an = analytic_u(domain)
    xs = np.asarray(domain.physical_grid.x_at_u_locations.data)
    res: Dict[str, Any] = {"nx": nx, "nz": nz, "hours": hours, "dt": dt, "steps": nt}
    res.update(validation(u_num, u_an, xs, damp_depth))
    res["ms_per_step"] = 1e3 * elapsed / max(nt - 1, 1)
    if verbose:
        print(json.dumps(res), flush=True)
        print(f"{res['ms_per_step']:.3f} ms/step over {nt - 1} steps on {so.device}")
    res.update(fields=fields, launches_per_step=per_step, capture_s=capture_s,
               profiles=dict(u_num=u_num, u_an=u_an, xs=xs, kd=damp_depth))
    return res


# the keys of run_case's result that are not numbers of the row
NOT_ROW = ("fields", "launches_per_step", "capture_s", "profiles")


def row(res: Dict[str, Any]) -> Dict[str, Any]:
    """The numbers of a :func:`run_case` result, without its fields."""
    return {k: v for k, v in res.items() if k not in NOT_ROW}


def convergence_order(coarse: Dict[str, Any], fine: Dict[str, Any]) -> Dict[str, Any]:
    """The observed order of the focused rms error from ``coarse`` to
    ``fine`` (dx halves between them), as the JAX ``--sweep`` computes it
    (``drivers/driver_mountain_wave.py:248-256``), unrounded."""
    p = float(np.log2(coarse["rms_err_focused"] / fine["rms_err_focused"]))
    return {"convergence_order": p, "from_nx": coarse["nx"], "to_nx": fine["nx"]}


def sweep(cases=SWEEP_CASES, hours: float = 5.0, growth_hours: float = 0.0, *,
          verbose: bool = True, **kwargs) -> Dict[str, Any]:
    """The resolution-convergence study: :func:`run_case` at each (nx, nz,
    dt) of ``cases`` (``kwargs`` are its keywords: the domain, the damping,
    ``so``, ``fused_loop``), then the convergence order of each consecutive
    pair.  Returns ``{"results": run_case's results, "orders": [...]}``;
    prints each case's row, then each order, as JSON lines."""
    results = [run_case(nx, nz, hours, dt, growth_hours, verbose=False, **kwargs) for nx, nz, dt in cases]
    orders = [convergence_order(a, b) for a, b in zip(results, results[1:])]
    if verbose:
        for line in [row(r) for r in results] + orders:
            print(json.dumps(line), flush=True)
    return {"results": results, "orders": orders}


def window_rows(u_num, u_an, xs, kd: int) -> List[Dict[str, Any]]:
    """The JAX ``diagnose``'s 18 rows (``drivers/driver_mountain_wave.py:172-188``):
    for each window |x| <= w·a of ``DIAGNOSE_WINDOWS`` and each clearance
    of ``DIAGNOSE_CLEARANCES`` below the damping depth ``kd``, the
    correlation of the numerical and analytic u-perturbations (unrounded),
    the rms of the analytic one and the rms of their difference."""
    rows = []
    for w in DIAGNOSE_WINDOWS:
        m = np.ones(len(xs), dtype=bool) if w == "full" else np.abs(xs) <= w * A_HALF
        for koff in DIAGNOSE_CLEARANCES:
            dn, da = u_num[m, kd + koff:] - U0, u_an[m, kd + koff:] - U0
            rows.append({
                "window_halfwidths": w, "sponge_clearance": koff,
                "corr": float(np.corrcoef(dn.ravel(), da.ravel())[0, 1]),
                "rms_analytic": float(np.sqrt(np.mean(da**2))),
                "rms_error": float(np.sqrt(np.mean((dn - da) ** 2))),
            })
    return rows


def localisation(u_num, u_an, xs, kd: int) -> Dict[str, Any]:
    """The JAX ``diagnose``'s error localisation (``drivers/driver_mountain_wave.py:189-210``),
    under its keys: the rms of the u error below the sponge's clearance of 4
    levels upstream of -2a, over |x| <= 2a and downstream of 2a, and by
    quarters of those levels from the top down."""
    err = (u_num - u_an)[:, kd + 4:]
    nq = err.shape[1]
    return {
        "rms_upstream(x<-2a)": float(np.sqrt(np.mean(err[xs < -2 * A_HALF] ** 2))),
        "rms_mountain(|x|<2a)": float(np.sqrt(np.mean(err[np.abs(xs) <= 2 * A_HALF] ** 2))),
        "rms_downstream(x>2a)": float(np.sqrt(np.mean(err[xs > 2 * A_HALF] ** 2))),
        "rms_by_k_quartile_top_to_sfc": [
            float(np.sqrt(np.mean(err[:, q * nq // 4:(q + 1) * nq // 4] ** 2))) for q in range(4)
        ],
    }


def diagnose(nx: int, nz: int, hours: float, dt: float, growth_hours: float = 0.0, *,
             out: Optional[str] = None, verbose: bool = True, **kwargs) -> Dict[str, Any]:
    """The JAX ``diagnose`` (``drivers/driver_mountain_wave.py:163-210``):
    one :func:`run_case` (``kwargs`` its keywords), then, on the host from
    its float64 u profiles, :func:`window_rows` and :func:`localisation`.
    Prints the case's row, the 18 rows and the localisation as JSON lines;
    writes ``u_num``, ``u_an``, ``xs`` and ``kd`` to ``out`` (an ``.npz``)
    only when it is given.  Returns ``{"result", "rows", "localisation"}``."""
    res = run_case(nx, nz, hours, dt, growth_hours, verbose=False, **kwargs)
    prof = res["profiles"]
    args = (prof["u_num"], prof["u_an"], prof["xs"], prof["kd"])
    rows, loc = window_rows(*args), localisation(*args)
    if verbose:
        for line in [row(res), *rows, loc]:
            print(json.dumps(line), flush=True)
    if out is not None:
        np.savez(out, **prof)
    return {"result": res, "rows": rows, "localisation": loc}


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
    parser.add_argument("--fused-loop", action="store_true",
                        help="run the timed steps as replays of one CUDA graph of the step, as "
                             "on a CUDA device by default (raises without a CUDA device)")
    parser.add_argument("--sweep", action="store_true",
                        help="resolution-convergence study over SWEEP_CASES (ignores --nx, --nz, --dt)")
    parser.add_argument("--diagnose", action="store_true",
                        help="window/sponge attribution study at (--nx, --nz); wins over --sweep")
    parser.add_argument("--diagnose-out", type=str, default=None, metavar="PATH",
                        help="with --diagnose, write u_num, u_an, xs and kd to this .npz")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    kwargs = dict(x_half=cli.x_half, theta_top=cli.theta_top, damp_depth=cli.damp_depth,
                  damp_max=cli.damp_max, so=StorageOptions(dtype=getattr(torch, cli.dtype), device=cli.device),
                  fused_loop=cli_mode(cli))
    if cli.diagnose:
        return diagnose(cli.nx, cli.nz, cli.hours, cli.dt, cli.growth_hours, out=cli.diagnose_out, **kwargs)
    if cli.sweep:
        return sweep(SWEEP_CASES, cli.hours, cli.growth_hours, **kwargs)
    return run_case(cli.nx, cli.nz, cli.hours, cli.dt, cli.growth_hours, **kwargs)


if __name__ == "__main__":
    main()
