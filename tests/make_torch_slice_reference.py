"""Record the JAX package's result of the port's slice at full size.

Runs the JAX driver's ``build_domain_and_state``/``build_model`` with the
port's ``skip`` (chain: diagnostics -> smoothing -> velocities) on the CPU,
``"jax"`` backend, float32, 161x161x120: one warm-up step at zero mountain
height, then 100 steps with the growing mountain, as both drivers do.
Writes ``tasmania_tpu_torch/drivers/slice_reference.json`` with umax, vmax and
the max and mean of s, su, sv, qv, qc, qr; ``chip_smoke.py`` holds the port's
run on the GPU against it.

Usage: ``python tests/make_torch_slice_reference.py`` (about a minute).
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

OUT = ROOT / "tasmania_tpu_torch" / "drivers" / "slice_reference.json"
def main() -> None:
    import jax
    import jax.numpy as jnp

    import drivers.namelist_sus as jnl
    from drivers.driver_namelist_sus import build_domain_and_state, build_model
    from tasmania_tpu.framework.field import FieldArray
    from tasmania_tpu_torch.drivers.driver_namelist_sus import validation_summary
    from tasmania_tpu_torch.drivers.namelist_sus import slice_skip

    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    nl.backend = "jax"
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip=slice_skip)
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
        "steps": f"1 warm-up + {nl.niter}", "dtype": "float32", "backend": "jax (CPU)",
        "skip": sorted(slice_skip),
    }
    ref["command"] = "python tests/make_torch_slice_reference.py"
    OUT.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


if __name__ == "__main__":
    main()
