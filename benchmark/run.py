"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  The system under
test is the PyTorch and CUDA port, ``tasmania_tpu_torch``, on one NVIDIA
card; the run fails, and prints no result, without one.

1. Set-up: the configuration's model through the port's builders, the
   drivers' eager warm-up step and the capture of the step as a CUDA graph
   (``program.py``); the first forecast's initial state made once, the
   buffers of the checked forecasts, and with ``--trace 1`` a first
   profiler session.  ``setup_s`` runs from the process's start to the
   window's.
2. The window: forecasts back to back, one at a time (``traffic.py``): the
   initial state of forecast i from the seed, then ``StepBody.load``, the
   configuration's ``niter`` replays and a synchronize; the next starts
   when it ends.  Forecasts start until ``--seconds`` have passed, and the
   last one finishes.  Forecasts drawn from the seed keep their final
   fields on the host.  With ``--trace 1`` the profiler records whole
   forecasts from the second on, until ``trace_min_seconds`` of them
   (``tracing.py``).
3. The peak device memory is read; the program is freed; the reference
   reruns each checked forecast and the comparison decides ``correct``
   (``check.py``).
4. The metrics of ``BENCHMARK.json`` for this cell, each by its reader
   (``metrics/<name>.py``), and the result as the last line of standard
   output; the compared numbers and their limits also as the last lines of
   standard error.

The run exits nonzero, with no result, if a module of JAX or of the JAX
package has been loaded by the time the window closes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark import check, spec, traffic as traffic_gen, yardstick
from benchmark.reference.model import Reference
from benchmark.tracing import Trace, span

#: top-level module names the run must not load
FORBIDDEN = ("jax", "jaxlib", "flax", "tasmania_tpu")


def process_age_s() -> Optional[float]:
    """Seconds since this process started (``/proc``), or None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


IMPORTED_AT = time.perf_counter()


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Record:
    """What a run measured; the metric readers read it."""

    cell: str
    grid: tuple
    itemsize: int
    steps: int  # a forecast's
    setup_s: float = 0.0
    forecast_s: List[float] = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes: int = 0
    launches: Dict[str, int] = field(default_factory=dict)
    trace: Optional[Trace] = None

    @property
    def points(self) -> int:
        return math.prod(self.grid)


def run_window(program, nl: dict, pert: dict, seed: int, seconds: float, sample, slots, device,
               trace_min_s: Optional[float] = None):
    """The window (module docstring, 2).  Returns the forecasts' seconds,
    the window's, and the traced profiler session (None without one)."""
    grid, steps = (nl["nx"], nl["ny"], nl["nz"]), nl["niter"]
    times, prof, traced_from, done = [], None, None, False
    t0 = time.perf_counter()
    index = 0
    while True:
        tracing = trace_min_s is not None and index >= 1 and not done
        if tracing and prof is None:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            traced_from = time.perf_counter()
        with span("forecast", tracing):
            with span("forecast.init", tracing):
                initial = program.initial(traffic_gen.perturbation(grid, pert, seed, index, device))
            ts = time.perf_counter()
            with span("forecast.load", tracing):
                program.load(initial)
            with span("forecast.replay", tracing):
                program.advance(steps)
            with span("forecast.sync", tracing):
                sync(device)
            te = time.perf_counter()
        times.append(te - ts)
        if tracing and te - traced_from >= trace_min_s:
            prof.__exit__(None, None, None)
            done = True
        slot = sample.offer(index)
        if slot is not None:
            for k, t in program.outputs().items():
                slots[slot][k].copy_(t)
        index += 1
        if te - t0 >= seconds:
            break
    if prof is not None and not done:
        prof.__exit__(None, None, None)
    return times, te - t0, prof


def measure(cell_name: str, config: dict, traffic: dict, limits: Optional[dict], seed: int,
            seconds: float, trace: bool, device, make_program=None):
    """One run of a cell on ``device`` (module docstring, 1-3): the record
    and the comparison's numbers.  ``make_program(nl, device)`` builds the
    system under test (default ``program.Program``)."""
    from benchmark.program import FIELDS, Program

    device = torch.device(device)
    traffic_gen.check_traffic(traffic)
    nl = config["namelist"]
    pert = config["assumed"]["perturbation"]
    grid = (nl["nx"], nl["ny"], nl["nz"])
    program = (make_program or Program)(nl, device)
    itemsize = program.base[FIELDS["s"]].data.element_size()
    rec = Record(cell_name, grid, itemsize, nl["niter"], launches=dict(program.launches))
    # the first forecast's initial state once, and the checked forecasts' buffers
    program.initial(traffic_gen.perturbation(grid, pert, seed, 0, device))
    pin = device.type == "cuda"
    slots = [{k: torch.empty(t.shape, dtype=t.dtype, pin_memory=pin) for k, t in program.outputs().items()}
             for _ in range(traffic["checked_forecasts"])]
    if trace:  # the profiler's first session starts its tracer: set-up
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1.0)
            sync(device)
    sync(device)
    age = process_age_s()
    rec.setup_s = age if age is not None else time.perf_counter() - IMPORTED_AT
    sample = traffic_gen.Sample(traffic["checked_forecasts"], seed)
    rec.forecast_s, rec.window_s, prof = run_window(
        program, nl, pert, seed, seconds, sample, slots, device,
        trace_min_s=traffic["trace_min_seconds"] if trace else None)
    sync(device)
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    if prof is not None:
        rec.trace = Trace.from_profile(prof, nl["niter"])
        del prof
    del program
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # the checks, after the window
    t0 = time.perf_counter()
    reference = Reference(nl, device)
    readings = []
    for slot, index in enumerate(sample.chosen):
        ref = check.reference_forecast(reference, traffic_gen.perturbation(grid, pert, seed, index, device),
                                       nl["niter"])
        readings.append(check.numbers(slots[slot], ref))
    print(f"window: {len(rec.forecast_s)} forecasts in {rec.window_s:.3f} s; the reference checked "
          f"forecasts {sample.chosen} in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    values = check.worst(readings)
    failed = sum(1 for r in readings if limits is None or not check.within(r, limits))
    return rec, values, failed


def result(bench: dict, rec: Record, values: dict, limits: Optional[dict], failed: int, trace: bool,
           device) -> dict:
    """The result line (module docstring, 4)."""
    metrics = {}
    for m in spec.metrics_of(bench, trace):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = torch.device(device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": rec.peak_bytes}
    out = {"correct": limits is not None and check.within(values, limits),
           "attempted": len(rec.forecast_s), "failed": failed, "metrics": metrics, "device": dev}
    if trace and rec.trace is not None:
        dev.update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        out["breakdown"] = rec.trace.breakdown()
    out["checks"] = {k: {"value": finite_or_text(values.get(k, math.inf)), "limit": lim}
                     for k, lim in (limits or {k: None for k in check.COMPARED}).items()}
    return out


def finite_or_text(x: float):
    """``x``, or its text where JSON has no number for it (inf, nan)."""
    return x if math.isfinite(x) else str(x)


def card_info() -> str:
    """The card's name and power limit, from ``nvidia-smi`` where it runs."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    cli = parser.parse_args(argv)
    root = Path.cwd()
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cli.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: the cell {cli.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = spec.load_json("configs", cell["config"])
    traffic = spec.load_json("traffic", cell["traffic"])
    limits_path = spec.HERE / "limits" / f"{cli.workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.is_file() else None
    print(f"card: {card_info()}; the shares' peak: {yardstick.HBM_BYTES_PER_S / 1e12} TB/s (data sheet)",
          file=sys.stderr)
    rec, values, failed = measure(cli.workload, config, traffic, limits, cli.seed, cli.seconds,
                                  bool(cli.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or of the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    out = result(bench, rec, values, limits, failed, bool(cli.trace), "cuda")
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # the boundary of the run: report, print no result
        traceback.print_exc()
        sys.exit(1)
