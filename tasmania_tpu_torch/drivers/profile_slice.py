"""Where a step of the flagship run spends its time on the GPU.

Builds the flagship configuration (``namelist_sus``, 161x161x120, float32)
with the full physics chain (or, with ``--slice``, the port's first slice:
dycore -> diagnostics -> smoothing -> velocities; with ``--coupling C``, the
same model under coupling C of ``driver_isentropic_moist``; with
``--mountain-wave``, the deep-domain mountain wave of ``driver_mountain_wave``,
161x1x120 float32; with ``--burgers CASE``, a case of ``driver_burgers`` at
2048x2048 float32, the zhao step at the initial time), runs a few steps untraced, then traces ``--steps`` steps
with ``torch.profiler`` and prints the device time per kernel, the
host-clock time per step and the device's busy share of that window.
Before the trace it times ``--steps`` steps without the profiler (host
clock around steps that end in a synchronize).

``--merge NAME`` (repeatable: ``smooth_smag``, ``vadv_sed``) sets the
namelist's ``process_merges`` for the full chain under sus or ssus.

``--boundary periodic`` sets the namelist's lateral boundary to the
periodic one (``hb_type="periodic"``, ``hb_kwargs={}``; the grid gains the
boundary's ring of cells, 167x167x120): the dycore then takes the generic
stage (the advection of the fields and the momentum step, the boundary's
enforcement in PyTorch) in place of the whole-stage kernel, as
``chip_smoke.py``'s ``sus_periodic`` runs it.

``--yz`` runs the namelist on a y-z slice, as ``chip_smoke.py``'s
``sus_yz``: one cell in x (``nx = 1``; the relaxed boundary makes the grid
7x161x120, and the dycore takes the generic stage), the flagship's 22.5 m/s
wind along y.  ``--topography schaer`` puts the Schaer mountain in place of
the namelist's Gaussian one (its ``topo_kwargs`` unchanged), as
``sus_schaer``.

``--coriolis F`` sets the namelist's Coriolis parameter (rad s^-1) and
``--implicit-vadv`` its implicit vertical advection (the SUS chain only);
with the latter the script also profiles the implicit process alone on the
step's fields: its device time and device operations a call under the
profiler, and the time of one call replayed as a CUDA graph by CUDA events.

Without ``--fused-loop`` the script profiles eager steps, as the drivers
step with ``--no-jit``.  ``--fused-loop`` profiles the step as the drivers
run it on the card by default: after the untraced steps (the last of them
traced for the fields it reads, ``utils/jitx.py``), one CUDA graph of the
step is captured and replayed once a step, in the unprofiled window and
under the profiler alike; it also prints the device time of the replays by
CUDA events around them.

Usage: ``python -m tasmania_tpu_torch.drivers.profile_slice [--steps N]
[--slice | --coupling C | --mountain-wave | --burgers CASE] [--merge NAME]
[--boundary periodic] [--yz] [--topography schaer] [--coriolis F]
[--implicit-vadv] [--fused-loop]`` (needs a CUDA device).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from tasmania_tpu_torch.drivers import driver_burgers as burgers
from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
)
from tasmania_tpu_torch.utils.jitx import StepBody, StepGraph, traced_step


# the namelist overrides of --boundary and --topography
BOUNDARIES = {"periodic": {"hb_type": "periodic", "hb_kwargs": {}}}
TOPOGRAPHIES = ("schaer",)


def yz_overrides() -> dict:
    """The namelist overrides of --yz: one cell in x, the wind along y."""
    return {"nx": 1, "x_velocity": FieldArray(np.asarray(0.0), "m s^-1", ()),
            "y_velocity": FieldArray(np.asarray(22.5), "m s^-1", ())}


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--slice", action="store_true", help="profile the first slice's chain")
    parser.add_argument("--coupling", choices=moist.COUPLINGS, default="sus")
    parser.add_argument("--mountain-wave", action="store_true",
                        help="profile the deep-domain mountain wave (the unfused dry stage)")
    parser.add_argument("--burgers", choices=burgers.CASES,
                        help="profile a case of the Burgers driver at 2048x2048")
    parser.add_argument("--merge", action="append", default=[], metavar="NAME",
                        help="a SUS process merge of the full chain (repeatable)")
    parser.add_argument("--boundary", choices=sorted(BOUNDARIES),
                        help="the isentropic model's lateral boundary in place of the namelist's")
    parser.add_argument("--yz", action="store_true",
                        help="the namelist on a y-z slice (nx = 1, the wind along y)")
    parser.add_argument("--topography", choices=TOPOGRAPHIES,
                        help="the isentropic model's mountain in place of the namelist's")
    parser.add_argument("--coriolis", type=float, default=None, metavar="F",
                        help="the Coriolis parameter in rad s^-1 (the f-plane process)")
    parser.add_argument("--implicit-vadv", action="store_true",
                        help="implicit vertical advection in the SUS chain; also profile it alone")
    parser.add_argument("--fused-loop", action="store_true",
                        help="profile replays of one CUDA graph of the step")
    cli = parser.parse_args(argv)
    if sum((cli.slice, cli.mountain_wave, cli.burgers is not None, cli.coupling != "sus")) > 1:
        parser.error("--slice, --coupling, --mountain-wave and --burgers exclude each other")
    if cli.merge and (cli.slice or cli.mountain_wave or cli.burgers):
        parser.error("--merge applies to the full chain")
    if ((cli.boundary or cli.yz or cli.topography or cli.coriolis is not None)
            and (cli.mountain_wave or cli.burgers)):
        parser.error("--boundary, --yz, --topography and --coriolis apply to the isentropic model's "
                     "namelist")
    if cli.implicit_vadv and (cli.slice or cli.mountain_wave or cli.burgers or cli.coupling != "sus"):
        parser.error("--implicit-vadv applies to the full SUS chain")
    return cli


def namelist(cli: argparse.Namespace):
    """The isentropic run's namelist: coupling C's, with the merges, the
    boundary, the slice and the mountain of the command line."""
    physics = {"implicit_vertical_advection": cli.implicit_vadv}
    if cli.coriolis is not None:
        physics["coriolis_parameter"] = cli.coriolis
    if cli.yz:
        physics.update(yz_overrides())
    if cli.topography:
        physics["topo_type"] = cli.topography
    return moist.load_namelist(cli.coupling, process_merges=tuple(cli.merge),
                               **BOUNDARIES.get(cli.boundary, {}), **physics)


def device_operations(prof) -> dict:
    """``{name: (us, count)}`` of the device's kernels and copies in a
    profile (host-side operator rows would count the same time twice)."""
    per_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    return per_name


def profile_implicit(domain, fields, dt: float, calls: int) -> str:
    """The implicit vertical advection alone on ``fields``: device time and
    operations a call under the profiler, and a call replayed as a CUDA
    graph, timed by CUDA events."""
    ivf = IsentropicImplicitVerticalAdvectionDiagnostic(
        domain, moist=True, storage_options=StorageOptions(dtype=torch.float32, device="cuda"))
    st = {k: fields[k] for k in ivf.input_properties}
    for _ in range(2):
        ivf(st, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            ivf(st, dt)
        torch.cuda.synchronize()
    per_name = device_operations(prof)
    busy = 1e-3 * sum(t for t, _ in per_name.values()) / calls
    ops = sum(n for _, n in per_name.values()) / calls
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ivf(st, dt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ivf(st, dt)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    end.synchronize()
    return (f"implicit vertical advection alone ({'x'.join(map(str, st['air_isentropic_density'].data.shape))}, "
            f"six fields, {calls} calls): device busy {busy:.3f} ms a call, {ops:.0f} device operations a "
            f"call; as a CUDA graph {start.elapsed_time(end) / calls:.3f} ms a call by CUDA events")


def main(argv=None) -> None:
    cli = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice: needs a CUDA device")
    f32 = StorageOptions(dtype=torch.float32, device="cuda")
    if cli.burgers:
        step, fields, _, _, _ = burgers.make_case(cli.burgers, 2048, 2048, 3, 1, 0, f32)
        names = sorted(fields)
        # the step's start time, in the place of the isentropic steps' topography
        hs = torch.zeros((), dtype=torch.float64, device="cuda")
    elif cli.mountain_wave:
        _, state, dycore, diagnostics, pt = mw.build(
            161, 120, theta_top=420.0, damp_depth=60, damp_max=5e-4, so=f32)
        names, step = mw.make_step(dycore, diagnostics, pt, state, 20.0)
    else:
        nl = namelist(cli)
        if cli.slice:
            domain, state, pt = drv.build_domain_and_state(nl)
            dycore, physics = drv.build_model(nl, domain, pt, nl.slice_skip)
            step_impl = lambda st, dt: physics(dycore(st, {}, dt), dt)  # noqa: E731
        else:
            domain, state, dycore, step_impl = moist.build_variant(nl, cli.coupling)
        names = sorted(k for k in state if k != "time")
        step = drv.fields_step(step_impl, names, nl.timestep.total_seconds())
    if not cli.burgers:
        fields = {k: state[k] for k in names}
        hs = dycore.topography_steady
    for _ in range(2 if cli.fused_loop else 3):
        fields = step(fields, hs)
    graph = None
    if cli.fused_loop:
        fields, carried = traced_step(step, fields, hs)
        torch.cuda.synchronize()
        graph = StepGraph(StepBody(step, fields, carried, hs, [1.0]))
    torch.cuda.synchronize()

    def advance(n: int) -> None:
        nonlocal fields
        if graph is not None:
            graph.replay(n)
            return
        for _ in range(n):
            fields = step(fields, hs)

    t0 = time.perf_counter()
    advance(cli.steps)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0) / cli.steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(cli.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_name = device_operations(prof)
    busy_us = sum(t for t, _ in per_name.values())
    calls = sum(n for _, n in per_name.values())
    chain = (f"burgers {cli.burgers}" if cli.burgers else "mountain wave" if cli.mountain_wave
             else "slice" if cli.slice
             else f"full chain, {cli.coupling}" + "".join(f", merge {m}" for m in cli.merge))
    if cli.boundary:
        chain += f", {cli.boundary} boundary"
    if cli.yz:
        chain += ", y-z slice"
    if cli.topography:
        chain += f", {cli.topography} mountain"
    if cli.coriolis is not None:
        chain += f", Coriolis f = {cli.coriolis:g} rad/s"
    if cli.implicit_vadv:
        chain += ", implicit vertical advection"
    if graph is not None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        advance(cli.steps)
        end.record()
        end.synchronize()
        chain += (f", fused loop (a CUDA graph of the step, {len(carried)}/{len(names)} fields "
                  f"carried; replays {start.elapsed_time(end) / cli.steps:.3f} ms/step by CUDA events)")
    print(f"{chain}, {cli.steps} steps: {plain_ms:.3f} ms/step without the profiler; "
          f"{1e3 * wall / cli.steps:.3f} ms/step (host clock) under it, device busy "
          f"{1e-3 * busy_us / cli.steps:.3f} ms/step ({100.0 * busy_us * 1e-6 / wall:.1f}% of the "
          f"window, {100.0 * busy_us * 1e-3 / cli.steps / plain_ms:.1f}% of an unprofiled step), "
          f"{calls / cli.steps:.0f} device operations/step")
    print(f"{'kernel':<70} {'ms/step':>9} {'calls/step':>10}")
    for name, (t, n) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:30]:
        print(f"{name[:70]:<70} {1e-3 * t / cli.steps:9.3f} {n / cli.steps:10.1f}")
    if cli.implicit_vadv:
        print(profile_implicit(domain, fields, nl.timestep.total_seconds(), cli.steps))


if __name__ == "__main__":
    main()
