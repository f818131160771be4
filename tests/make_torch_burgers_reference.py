"""Record the JAX package's result of the Burgers zhao case at 2048x2048.

Runs the JAX ``BurgersDynamicalCore`` as ``tasmania_tpu_torch/drivers/driver_burgers.py
--case zhao`` configures the port's: the unit square at 2048x2048 with the
Dirichlet boundary (nb 3) whose core is the JAX ``ZhaoSolutionFactory``,
``BurgersHorizontalDiffusion`` (second order, eps 0.1) as the fast
tendency, RK3WS with third-order fluxes, dt from eps·dt/dx² = 0.16, 1 +
100 steps from the exact solution at the initial time, on the CPU in
float32 (JAX without ``jax_enable_x64``; about two minutes).  Writes
``tasmania_tpu_torch/drivers/burgers_reference.json``: the numbers of the
port's ``driver_burgers.validation`` computed from the JAX run's u and v
(max|u|, max|v|, the sums of u and v and of their magnitudes, and the
largest difference from the exact solution at the state's time);
``chip_smoke.py`` phase 11 holds the port's run on the GPU against them.

Usage: ``python tests/make_torch_burgers_reference.py [--check-port]``.  With
``--check-port`` it writes nothing: it runs the port's driver on the CPU in
float32 at the same configuration and prints each number's deviation from
the file (relative; the sums of u and v relative to the sums of their
magnitudes): the measurement behind the limits of ``chip_smoke.py`` phase
11.
"""

from __future__ import annotations

import json
import os
import sys
import time
from datetime import timedelta
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

OUT = ROOT / "tasmania_tpu_torch" / "drivers" / "burgers_reference.json"
CASE = dict(nx=2048, ny=2048, nb=3, steps=100)


def deviation(key, value, ref):
    """The deviation ``chip_smoke.py`` phase 11 gates: relative, but for the
    sums of u and v, which are relative to the sums of their magnitudes."""
    if key in ("u_sum", "v_sum"):
        return abs(value - ref[key]) / ref[key[0] + "_abs_sum"]
    return abs(value - ref[key]) / abs(ref[key])


def check_port() -> None:
    import torch

    from tasmania_tpu_torch.drivers import driver_burgers as drv
    from tasmania_tpu_torch.framework.options import StorageOptions

    t0 = time.perf_counter()
    got = drv.run_case("zhao", CASE["nx"], CASE["ny"], CASE["nb"], CASE["steps"],
                       so=StorageOptions(dtype=torch.float32, device="cpu"), verbose=False)
    ref = json.loads(OUT.read_text())
    for key, r in ref.items():
        if isinstance(r, (int, float)):
            print(f"{key:12s} port {got[key]:.9g}  reference {r:.9g}  deviation "
                  f"{deviation(key, got[key], ref):.3e}")
    print(f"{time.perf_counter() - t0:.1f} s")


def main() -> None:
    if "--check-port" in sys.argv[1:]:
        check_port()
        return
    import numpy as np
    import torch

    from tasmania_tpu.burgers import (
        BurgersDynamicalCore,
        BurgersHorizontalDiffusion,
        ZhaoSolutionFactory,
        ZhaoStateFactory,
    )
    from tasmania_tpu.domain import Domain
    from tasmania_tpu.framework.field import FieldArray
    from tasmania_tpu.framework.options import StorageOptions
    from tasmania_tpu_torch.drivers import driver_burgers as drv
    from tasmania_tpu_torch.framework.field import FieldArray as PortFieldArray
    from tasmania_tpu_torch.framework.options import StorageOptions as PortStorageOptions

    nx, ny, nb, steps = CASE["nx"], CASE["ny"], CASE["nb"], CASE["steps"]
    so = StorageOptions(dtype=np.float32)
    itime, eps = drv.INITIAL_TIME, drv.EPS
    zsf = ZhaoSolutionFactory(itime, eps)
    domain = Domain((0.0, 1.0), nx, (0.0, 1.0), ny, FieldArray(np.array([1.0, 0.0]), "1", ("z",)), 1,
                    horizontal_boundary_type="dirichlet", nb=nb, horizontal_boundary_kwargs={"core": zsf})
    grid = domain.numerical_grid
    state = ZhaoStateFactory(itime, eps, storage_options=so)(itime, grid)
    domain.horizontal_boundary.reference_state = state
    diffusion = BurgersHorizontalDiffusion(domain, "numerical", "second_order",
                                           FieldArray(np.asarray(eps), "m^2 s^-1", ()), storage_options=so)
    dycore = BurgersDynamicalCore(domain, fast_tendency_component=diffusion,
                                  time_integration_scheme="rk3ws", flux_scheme="third_order",
                                  storage_options=so)
    dx = float(np.asarray(grid.dx.to_units("m").data))
    dt = drv.DIFFUSION_NUMBER * dx * dx / eps
    t0 = time.perf_counter()
    for _ in range(1 + steps):
        state = dycore(state, {}, dt)
    elapsed = time.perf_counter() - t0
    fields = {}
    for name in drv.UV:
        u = np.asarray(state[name].data)
        assert u.dtype == np.float32, u.dtype
        fields[name] = PortFieldArray(torch.as_tensor(u), "m s^-1")
    end = itime + (1 + steps) * timedelta(seconds=dt)
    assert state["time"] == end
    # the exact solution from the port's factory on the port's grid (the JAX
    # factory's values within a few float64 ulps)
    pdomain, pzsf, _, _, pdt = drv.build_zhao(nx, ny, nb, PortStorageOptions(dtype=torch.float32, device="cpu"))
    assert pdt == dt
    ref = drv.validation(fields, pzsf, pdomain.numerical_grid, end)
    ref["config"] = {"driver": "tasmania_tpu_torch/drivers/driver_burgers.py --case zhao", **CASE,
                     "eps": eps, "dt": dt, "time_integration": "rk3ws", "flux": "third_order",
                     "diffusion": "second_order", "dtype": "float32", "backend": "jax (CPU)"}
    ref["command"] = "python tests/make_torch_burgers_reference.py"
    OUT.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


if __name__ == "__main__":
    main()
