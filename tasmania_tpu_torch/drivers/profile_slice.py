"""Where a step of the flagship run spends its time on the GPU.

Builds the flagship configuration (``namelist_sus``, 161x161x120, float32)
with the full physics chain (or, with ``--slice``, the port's first slice:
dycore -> diagnostics -> smoothing -> velocities; with ``--coupling C``, the
same model under coupling C of ``driver_isentropic_moist``; with
``--mountain-wave``, the deep-domain mountain wave of ``driver_mountain_wave``,
161x1x120 float32), runs a few steps untraced, then traces ``--steps`` steps
with ``torch.profiler`` and prints the device time per kernel, the
host-clock time per step and the device's busy share of that window.
Before the trace it times ``--steps`` steps without the profiler (host
clock around steps that end in a synchronize).

Usage: ``python -m tasmania_tpu_torch.drivers.profile_slice [--steps N]
[--slice | --coupling C | --mountain-wave]`` (needs a CUDA device).
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.framework.options import StorageOptions


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--slice", action="store_true", help="profile the first slice's chain")
    parser.add_argument("--coupling", choices=moist.COUPLINGS, default="sus")
    parser.add_argument("--mountain-wave", action="store_true",
                        help="profile the deep-domain mountain wave (the unfused dry stage)")
    cli = parser.parse_args(argv)
    if not torch.cuda.is_available():
        parser.error("needs a CUDA device")
    if (cli.slice or cli.mountain_wave) and cli.coupling != "sus" or cli.slice and cli.mountain_wave:
        parser.error("--slice, --coupling and --mountain-wave exclude each other")
    if cli.mountain_wave:
        _, state, dycore, diagnostics, pt = mw.build(
            161, 120, theta_top=420.0, damp_depth=60, damp_max=5e-4,
            so=StorageOptions(dtype=torch.float32, device="cuda"))
        names, step = mw.make_step(dycore, diagnostics, pt, state, 20.0)
    else:
        nl = moist.load_namelist(cli.coupling)
        if cli.slice:
            domain, state, pt = drv.build_domain_and_state(nl)
            dycore, physics = drv.build_model(nl, domain, pt, nl.slice_skip)
            step_impl = lambda st, dt: physics(dycore(st, {}, dt), dt)  # noqa: E731
        else:
            _, state, dycore, step_impl = moist.build_variant(nl, cli.coupling)
        names = sorted(k for k in state if k != "time")
        step = drv.fields_step(step_impl, names, nl.timestep.total_seconds())
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
    chain = ("mountain wave" if cli.mountain_wave else "slice" if cli.slice
             else f"full chain, {cli.coupling}")
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
