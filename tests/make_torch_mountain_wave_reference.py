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


def main() -> None:
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
