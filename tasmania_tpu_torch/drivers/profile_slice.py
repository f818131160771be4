"""Where a step of the flagship run spends its time on the GPU.

Builds the flagship configuration (``namelist_sus``, 161x161x120, float32)
with the full physics chain (or, with ``--slice``, the port's first slice:
dycore -> diagnostics -> smoothing -> velocities), runs a few steps
untraced, then traces ``--steps`` steps with ``torch.profiler`` and prints
the device time per kernel, the host-clock time per step and the device's
busy share of that window.  Before the trace it times ``--steps`` steps
without the profiler (host clock around steps that end in a synchronize).

Usage: ``python -m tasmania_tpu_torch.drivers.profile_slice [--steps N]
[--slice]`` (needs a CUDA device).
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--slice", action="store_true", help="profile the first slice's chain")
    cli = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA device")
    nl = load_namelist()
    domain, state, pt = drv.build_domain_and_state(nl)
    dycore, physics = drv.build_model(nl, domain, pt, nl.slice_skip if cli.slice else ())
    names = sorted(k for k in state if k != "time")
    step = drv.make_step(dycore, physics, names, nl.timestep.total_seconds())
    fields = {k: state[k] for k in names}
    hs = dycore.topography_steady
    for _ in range(3):
        fields = step(fields, hs)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(cli.steps):
        fields = step(fields, hs)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / cli.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cli.steps):
            fields = step(fields, hs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels and copies on the device, by name (host-side operator rows
    # would count the same device time twice)
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy_us = sum(t for t, _ in per_name.values())
    calls = sum(n for _, n in per_name.values())
    chain = "slice" if cli.slice else "full chain"
    print(f"{chain}, {cli.steps} steps: {plain_ms:.3f} ms/step without the profiler; "
          f"{1e3 * wall / cli.steps:.3f} ms/step (host clock) under it, device busy "
          f"{1e-3 * busy_us / cli.steps:.3f} ms/step ({100.0 * busy_us * 1e-6 / wall:.1f}% of the "
          f"window, {100.0 * busy_us * 1e-3 / cli.steps / plain_ms:.1f}% of an unprofiled step), "
          f"{calls / cli.steps:.0f} device operations/step")
    print(f"{'kernel':<70} {'ms/step':>9} {'calls/step':>10}")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"{name[:70]:<70} {1e-3 * t / cli.steps:9.3f} {n / cli.steps:10.1f}")


if __name__ == "__main__":
    main()
