"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over whole
forecasts of the window, read from its Chrome trace.

The harness marks each forecast with ``record_function`` spans (``SPANS``:
the whole closed-loop turn, the making of its initial state, the load, the
replays and the synchronize).  Every device operation of the trace is then
sorted two ways:

* its phase: an operation whose launching runtime call (matched by the
  trace's correlation id) is a ``cudaGraphLaunch`` belongs to the replays,
  the step of the model; any other by the harness span its runtime call lies
  in (``init``, ``load``, ``sync``), else ``other``;
* its kind: a ``copy`` (a device-to-device memcpy, which a graph runs as a
  ``memcpy...`` kernel), one of PyTorch's own kernels (``torch``: ATen's,
  its libraries', memsets), or else one of the port's kernels (``port``).

:class:`Trace` holds the window (the traced forecasts' span on the host
clock of the trace), the operations and the host spans; the metric readers
take their numbers from it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from benchmark import yardstick

FORECAST = "forecast"
SPANS = ("forecast", "forecast.init", "forecast.load", "forecast.replay", "forecast.sync")
TORCH_NAME = re.compile(r"\b(?:at|c10|cub|thrust|cutlass|flash|cudnn)::|^(?:sm\d+_|ampere_|nvjet|cutlass|gemm|gemv|elementwise)")
GRAPH_COPY = re.compile(r"memcpy\w*")


def span(name: str, on: bool):
    """A ``record_function`` span where ``on``, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)


def kind(cat: str, name: str) -> str:
    if cat == "gpu_memcpy" or (cat == "kernel" and GRAPH_COPY.fullmatch(name)):
        return "copy"
    if cat == "gpu_memset" or TORCH_NAME.search(name.removeprefix("void ")):
        return "torch"
    return "port"


def short_name(name: str, limit: int = 120) -> str:
    """A device operation's name without its return type and parameter
    list."""
    s = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    return s.split("(", 1)[0][:limit] if "(" in s else s[:limit]


@dataclass
class DeviceOp:
    name: str
    kind: str
    phase: str
    start: float  # s, on the trace's clock
    end: float


class Trace:
    """The device operations and harness spans of ``forecasts`` traced
    forecasts of ``steps`` steps each."""

    def __init__(self, events: List[dict], steps: int) -> None:
        spans = defaultdict(list)
        runtime: Dict[int, Tuple[str, float, float]] = {}
        calls: List[Tuple[float, float, str]] = []
        device = []
        for e in events:
            cat, name = e.get("cat"), e.get("name", "")
            args = e.get("args") or {}
            if cat == "user_annotation" and name in SPANS:
                spans[name].append((1e-6 * e["ts"], 1e-6 * (e["ts"] + e.get("dur", 0.0))))
            elif cat in ("cuda_runtime", "cuda_driver"):
                t0, t1 = 1e-6 * e["ts"], 1e-6 * (e["ts"] + e.get("dur", 0.0))
                if "correlation" in args:
                    runtime[args["correlation"]] = (name, t0, t1)
                calls.append((t0, t1, name))
            elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append((cat, name, args.get("correlation"), 1e-6 * e["ts"],
                               1e-6 * (e["ts"] + e.get("dur", 0.0))))
        self.spans = dict(spans)
        self.calls = sorted(calls)
        turns = sorted(self.spans.get(FORECAST, []))
        self.forecasts = len(turns)
        self.steps = steps * self.forecasts
        self.lo, self.hi = (turns[0][0], turns[-1][1]) if turns else (0.0, 0.0)
        self.ops: List[DeviceOp] = []
        for cat, name, corr, t0, t1 in device:
            call = runtime.get(corr)
            if call is not None and call[0].startswith("cudaGraphLaunch"):
                phase = "replay"
            else:
                phase = self._phase(call[1]) if call is not None else "other"
            self.ops.append(DeviceOp(name, kind(cat, name), phase, t0, t1))

    def _phase(self, t: float) -> str:
        for name in SPANS[1:]:
            if any(a <= t <= b for a, b in self.spans.get(name, ())):
                return name.split(".", 1)[1]
        return "other"

    @classmethod
    def from_profile(cls, prof, steps: int) -> "Trace":
        """Read a finished ``torch.profiler.profile`` through its Chrome
        trace, written to a temporary file and deleted."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events, steps)

    # -- what the readers take ---------------------------------------------------

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def in_window(self) -> List[DeviceOp]:
        return [op for op in self.ops if op.end > self.lo and op.start < self.hi]

    @property
    def busy_s(self) -> float:
        return yardstick.union_s(((op.start, op.end) for op in self.ops), self.lo, self.hi)

    def seconds(self, phase: str, kind: Optional[str] = None) -> float:
        return sum(op.end - op.start for op in self.in_window()
                   if op.phase == phase and (kind is None or op.kind == kind))

    def count(self, phase: str, kind: Optional[str] = None) -> int:
        return sum(1 for op in self.in_window() if op.phase == phase and (kind is None or op.kind == kind))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time in the window, and the
        longest idle gaps with what the host was doing."""
        by_name: Dict[str, float] = defaultdict(float)
        for op in self.in_window():
            by_name[f"{op.kind}:{short_name(op.name)}"] += min(op.end, self.hi) - max(op.start, self.lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = yardstick.gaps(((op.start, op.end) for op in self.ops), self.lo, self.hi)
        idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_doing(0.5 * (a + b)), b - a] for a, b in idle]}

    def host_doing(self, t: float) -> str:
        """The innermost harness span at host time ``t``, and the runtime
        call in flight then, if any."""
        inner = [(b - a, name) for name in SPANS for a, b in self.spans.get(name, ()) if a <= t <= b]
        label = min(inner)[1] if inner else "between forecasts"
        call = [name for a, b, name in self.calls if a <= t <= b]
        return label + (f"/{call[-1]}" if call else "")
