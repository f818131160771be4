"""Record the JAX package's result of the full flagship step at full size.

Runs the JAX driver's ``build_domain_and_state``/``build_model`` with
``drivers/namelist_sus.py`` unchanged (161x161x120, float32, the whole SUS
chain, ``sedimentation_vt_mode="step"``) on the CPU with the
``"pallas:interpret"`` backend, so that the chain takes the same fused
kernels as the flagship run: one warm-up step at zero mountain height, then
100 steps with the growing mountain, as both drivers do.  Writes
``tasmania_tpu_torch/drivers/flagship_reference.json`` with the validation
summary of ``driver_namelist_sus.validation_summary`` (umax, vmax, and the max
and mean magnitude of s, su, sv, qv, qc, qr, precipitation and accumulated
precipitation); ``chip_smoke.py`` holds the port's run on the GPU against it.

In that run no rain forms (cloud water stays below the autoconversion
threshold), so ``--rain`` makes a second reference,
``flagship_rain_reference.json``: the same namelist from a supersaturated
start (relative humidity 1.05), 1 warm-up + 30 steps, in which saturation
adjustment makes cloud water above the threshold in the lower levels and
every branch of the Kessler scheme, sedimentation and precipitation run on
rain.  (At relative humidity 1.2 the full-size run is unstable within 30
steps: its largest water vapour mass fraction reaches 84.)

Usage: ``python tests/make_torch_flagship_reference.py [--rain]`` (about five
minutes, or a minute and a half with ``--rain``).  With ``--check-port`` it writes nothing:
it runs the port on the CPU in float32 at the same configuration and prints
each number's relative deviation from the file, the measurement behind the
limits ``chip_smoke.py`` holds the card to.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

DRIVERS = ROOT / "tasmania_tpu_torch" / "drivers"
BACKEND = "pallas:interpret"
# the raining run: namelist overrides and output file
RAIN = {"relative_humidity": 1.05, "niter": 30}


def check_port(out, overrides) -> None:
    import torch

    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.options import StorageOptions

    nl = load_namelist(so=StorageOptions(dtype=torch.float32, device="cpu"), **overrides)
    res = drv.run(nl, verbose=False)
    got = drv.validation_summary({k: fa.data.numpy() for k, fa in res["fields"].items()})
    ref = json.loads(out.read_text())
    for key, r in ref.items():
        if isinstance(r, (int, float)):
            dev = abs(got[key] - r) / abs(r) if r else abs(got[key])
            print(f"{key:18s} port {got[key]:.9g}  reference {r:.9g}  deviation {dev:.3e}")


def main() -> None:
    rain = "--rain" in sys.argv[1:]
    overrides = RAIN if rain else {}
    out = DRIVERS / ("flagship_rain_reference.json" if rain else "flagship_reference.json")
    if "--check-port" in sys.argv[1:]:
        check_port(out, overrides)
        return
    import jax
    import jax.numpy as jnp

    import drivers.namelist_sus as jnl
    from drivers.driver_namelist_sus import build_domain_and_state, build_model
    from tasmania_tpu.framework.field import FieldArray
    from tasmania_tpu_torch.drivers.driver_namelist_sus import validation_summary

    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    nl.backend = BACKEND
    for key, value in overrides.items():
        setattr(nl, key, value)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt)
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    hs_steady = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = physics(dycore(st, {}, dt_s), dt_s)
        return {k: st[k].data for k in names}

    step_c = jax.jit(step)
    t0 = time.perf_counter()
    fields = step_c({k: state[k].data for k in names}, hs_steady * 0.0)
    for i in range(nl.niter):
        fields = step_c(fields, min((i + 1) * dt_s / topo_time, 1.0) * hs_steady)
    fields = {k: np.asarray(v) for k, v in fields.items()}
    elapsed = time.perf_counter() - t0

    ref = validation_summary(fields)
    ref["config"] = {
        "namelist": "drivers/namelist_sus.py", "nx": nl.nx, "ny": nl.ny, "nz": nl.nz,
        "steps": f"1 warm-up + {nl.niter}", "niter": nl.niter, "dtype": "float32",
        "backend": f"{BACKEND} (CPU)", "sedimentation_vt_mode": nl.sedimentation_vt_mode,
        "skip": [], "relative_humidity": nl.relative_humidity,
    }
    ref["command"] = "python tests/make_torch_flagship_reference.py" + (" --rain" if rain else "")
    out.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


if __name__ == "__main__":
    main()
