"""Record the JAX package's result of the deep-domain mountain wave.

Runs ``drivers/driver_mountain_wave.py``'s ``run_case`` as
``tests/test_mountain_wave_validation.py::test_deep_domain_validation_gate``
configures it (161x1x120, θ at the top 420 K, Rayleigh damping over the top
60 levels with a maximum of 5e-4 1/s, 10 h at dt 20 s, 1800 steps, no
growth), on the CPU with the ``"jax"`` backend in float32 (JAX without
``jax_enable_x64``; about 20 s).  Writes
``tasmania_tpu_torch/drivers/mountain_wave_reference.json``: the numbers of
the port's ``driver_mountain_wave.validation`` computed from the JAX run's
u (the correlations with the analytic solution over the interior, over
|x| <= 6a and over |x| <= 2a, 3a and 4a, the amplitude ratios, the focused
rms error, umax); ``chip_smoke.py`` phase 8 holds the port's run on the GPU
against them.

Usage: ``python tests/make_torch_mountain_wave_reference.py [--check-port]``.
With ``--check-port`` it writes nothing: it runs the port on the CPU in
float32 at the same configuration (about a minute) and prints each number's
deviation from the file, absolute for the correlations and relative for the
rest: the measurement behind the limits of ``chip_smoke.py`` phase 8.

``--sweep`` and ``--diagnose`` (either or both) record the JAX driver's
``--sweep`` (``run_case`` at 81x1x60 dt 20 s, 161x1x90 dt 10 s and 321x1x120
dt 5 s, 5 h, no growth, θ at the top 360 K, damping depth max(8, nz // 5),
maximum 5e-4 1/s) and ``--diagnose`` (81x1x60, 5 h at dt 20 s) in float32
on the CPU (about two minutes for the sweep) into
``tasmania_tpu_torch/drivers/mountain_wave_sweep_reference.json``, each
under its own key: each case's numbers (the port's ``validation`` of the
JAX run's u), the convergence orders, and the diagnose's 18 window rows and
localisation (the port's ``window_rows`` and ``localisation`` of the JAX
run's u profiles, the numbers of the JAX ``diagnose`` unrounded).
``chip_smoke.py`` phase 19 holds the card's runs against them.  With
``--check-port`` they run the port on the CPU in float32 (about four
minutes for the sweep) and print the largest deviation of each kind of
number: the measurement behind phase 19's limits.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tasmania_tpu_torch" / "drivers" / "mountain_wave_reference.json"
CASE = dict(nx=161, nz=120, hours=10.0, dt=20.0)
ENV = {"MW_THETA_TOP": "420", "MW_DAMP_DEPTH": "60", "MW_DAMP_MAX": "0.0005", "MW_XHALF": "2e5"}
ABSOLUTE = ("corr", "corr_focused", "corr_2a", "corr_3a", "corr_4a")


def check_port() -> None:
    import torch

    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
    from tasmania_tpu_torch.framework.options import StorageOptions

    t0 = time.perf_counter()
    got = mw.run_case(CASE["nx"], CASE["nz"], CASE["hours"], CASE["dt"], theta_top=420.0, damp_depth=60,
                      damp_max=5e-4, so=StorageOptions(dtype=torch.float32, device="cpu"), verbose=False)
    ref = json.loads(OUT.read_text())
    for key, r in ref.items():
        if isinstance(r, (int, float)):
            dev = abs(got[key] - r) / (1.0 if key in ABSOLUTE else abs(r))
            kind = "absolute" if key in ABSOLUTE else "relative"
            print(f"{key:20s} port {got[key]:.9g}  reference {r:.9g}  {kind} deviation {dev:.3e}")
    print(f"{time.perf_counter() - t0:.1f} s")


SWEEP_OUT = ROOT / "tasmania_tpu_torch" / "drivers" / "mountain_wave_sweep_reference.json"
SWEEP_HOURS = 5.0
DIAGNOSE_CASE = dict(nx=81, nz=60, hours=5.0, dt=20.0)
# the numbers phase 19 compares: correlations absolutely, the rest relatively
SWEEP_KEYS = ("corr", "corr_focused", "rms_err_focused", "amplitude_ratio")


def jax_profiles(nx, nz, hours, dt):
    """The JAX ``run_case`` at its defaults (float32 on the CPU): its row,
    the float64 u profiles, xs and the damping depth, and its seconds."""
    import numpy as np

    import drivers.driver_mountain_wave as jmw

    t0 = time.perf_counter()
    res = jmw.run_case(nx, nz, hours, dt, 0.0)
    u_num, u_an, xs, kd = res.pop("_fields")
    assert u_num.dtype == np.float32, u_num.dtype
    return res, (np.asarray(u_num, dtype=np.float64), u_an, xs, kd), time.perf_counter() - t0


def case_numbers(nx, nz, hours, dt, profiles):
    from tasmania_tpu_torch.drivers.driver_mountain_wave import validation

    steps = int(round(hours * 3600.0 / dt))
    return {"nx": nx, "nz": nz, "hours": hours, "dt": dt, "steps": steps, **validation(*profiles)}


def make_sweep() -> dict:
    from tasmania_tpu_torch.drivers.driver_mountain_wave import SWEEP_CASES, convergence_order

    rows, jax_rows, seconds = [], [], []
    for nx, nz, dt in SWEEP_CASES:
        jrow, prof, sec = jax_profiles(nx, nz, SWEEP_HOURS, dt)
        rows.append(case_numbers(nx, nz, SWEEP_HOURS, dt, prof))
        jax_rows.append(jrow)
        seconds.append(sec)
        print(json.dumps(rows[-1]), f"{sec:.1f} s", flush=True)
    return {"rows": rows, "orders": [convergence_order(a, b) for a, b in zip(rows, rows[1:])],
            "jax_rows_as_printed": jax_rows, "seconds": seconds,
            "config": {"driver": "drivers/driver_mountain_wave.py --sweep (run_case)",
                       "cases": [list(c) for c in SWEEP_CASES], "hours": SWEEP_HOURS, "growth_hours": 0.0,
                       "environment": "defaults (theta top 360 K, damping depth max(8, nz // 5), "
                                      "damping maximum 5e-4 1/s, x half-width 2e5 m)",
                       "dtype": "float32", "backend": "jax (CPU)"},
            "command": "python tests/make_torch_mountain_wave_reference.py --sweep"}


def make_diagnose() -> dict:
    from tasmania_tpu_torch.drivers.driver_mountain_wave import localisation, window_rows

    c = DIAGNOSE_CASE
    jrow, prof, sec = jax_profiles(c["nx"], c["nz"], c["hours"], c["dt"])
    return {"row": case_numbers(c["nx"], c["nz"], c["hours"], c["dt"], prof), "rows": window_rows(*prof),
            "localisation": localisation(*prof), "jax_row_as_printed": jrow, "seconds": sec,
            "config": {"driver": "drivers/driver_mountain_wave.py --diagnose", **c, "growth_hours": 0.0,
                       "dtype": "float32", "backend": "jax (CPU)"},
            "command": "python tests/make_torch_mountain_wave_reference.py --diagnose"}


def deviation(got: float, ref: float, absolute: bool) -> float:
    return abs(got - ref) / (1.0 if absolute else abs(ref))


def check_port_sweep(which) -> None:
    """The port's float32 CPU runs against the file: the largest deviation
    of each kind of number."""
    import torch

    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
    from tasmania_tpu_torch.framework.options import StorageOptions

    so = StorageOptions(dtype=torch.float32, device="cpu")
    ref = json.loads(SWEEP_OUT.read_text())
    if "sweep" in which:
        t0 = time.perf_counter()
        got = mw.sweep(mw.SWEEP_CASES, SWEEP_HOURS, so=so, verbose=False)
        for g, r in zip(got["results"], ref["sweep"]["rows"]):
            devs = {k: deviation(g[k], r[k], k.startswith("corr")) for k in SWEEP_KEYS}
            print(f"sweep {g['nx']}x{g['nz']}: " + " ".join(f"{k} {g[k]:.7g} ({d:.2e})" for k, d in devs.items()))
        for g, r in zip(got["orders"], ref["sweep"]["orders"]):
            print(f"order {g['from_nx']}->{g['to_nx']}: port {g['convergence_order']:.4f}, "
                  f"reference {r['convergence_order']:.4f}")
        print(f"sweep {time.perf_counter() - t0:.1f} s", flush=True)
    if "diagnose" in which:
        c = DIAGNOSE_CASE
        d = mw.diagnose(c["nx"], c["nz"], c["hours"], c["dt"], so=so, verbose=False)
        dref = ref["diagnose"]
        worst = {"corr": 0.0, "rms_analytic": 0.0, "rms_error": 0.0}
        for g, r in zip(d["rows"], dref["rows"]):
            for k in worst:
                worst[k] = max(worst[k], deviation(g[k], r[k], k == "corr"))
        loc = d["localisation"]
        flat = [(k, v, dref["localisation"][k]) for k, v in loc.items() if not isinstance(v, list)]
        flat += [(f"quartile {q}", v, dref["localisation"]["rms_by_k_quartile_top_to_sfc"][q])
                 for q, v in enumerate(loc["rms_by_k_quartile_top_to_sfc"])]
        print("diagnose rows, largest deviation: " + " ".join(f"{k} {v:.2e}" for k, v in worst.items())
              + " (corr absolute, the rms relative)")
        print("diagnose localisation, relative: " + " ".join(f"{k} {deviation(g, r, False):.2e}"
                                                             for k, g, r in flat))
        print("diagnose case: " + " ".join(
            f"{k} {deviation(d['result'][k], dref['row'][k], k.startswith('corr')):.2e}" for k in SWEEP_KEYS))


def main() -> None:
    which = [w for w in ("sweep", "diagnose") if f"--{w}" in sys.argv[1:]]
    if which:
        if "--check-port" in sys.argv[1:]:
            check_port_sweep(which)
            return
        ref = json.loads(SWEEP_OUT.read_text()) if SWEEP_OUT.exists() else {}
        for w in which:
            ref[w] = make_sweep() if w == "sweep" else make_diagnose()
        SWEEP_OUT.write_text(json.dumps(ref, indent=1) + "\n")
        print(f"wrote {', '.join(which)} to {SWEEP_OUT}")
        return
    if "--check-port" in sys.argv[1:]:
        check_port()
        return
    os.environ.update(ENV)
    import numpy as np

    import drivers.driver_mountain_wave as jmw
    from tasmania_tpu_torch.drivers.driver_mountain_wave import validation

    t0 = time.perf_counter()
    res = jmw.run_case(CASE["nx"], CASE["nz"], CASE["hours"], CASE["dt"], 0.0)
    elapsed = time.perf_counter() - t0
    u_num, u_an, xs, kd = res.pop("_fields")
    assert u_num.dtype == np.float32, u_num.dtype
    ref = validation(np.asarray(u_num, dtype=np.float64), u_an, xs, kd)
    ref["config"] = {
        "driver": "drivers/driver_mountain_wave.py run_case", **CASE,
        "steps": int(round(CASE["hours"] * 3600.0 / CASE["dt"])), "growth_hours": 0.0,
        "environment": ENV, "dtype": "float32", "backend": "jax (CPU)",
    }
    ref["command"] = "python tests/make_torch_mountain_wave_reference.py"
    OUT.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


if __name__ == "__main__":
    main()
