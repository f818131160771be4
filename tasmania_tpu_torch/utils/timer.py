"""Hierarchical timer and profiler trace (counterpart of
``tasmania_tpu/utils/timer.py``).

``Timer`` keeps one class-level tree of labelled nodes: ``Timer.start(label)``
opens a child of the innermost open node, ``Timer.stop()`` closes it and adds
the seconds to it.  It is off by default (``Timer.enabled``); the components
and the dycore label their calls (``framework/core_components.py``,
``framework/dycore.py``), and those labels cost nothing while it is off.

CUDA launches return before the device finishes, so with ``Timer.sync`` set
(the default) the timer synchronizes the device at every start and stop, as
the reference's timer does at each tic and toc: ``stop(sync_on=t)`` waits for
``t``'s device, and without ``sync_on`` the current CUDA device is waited for
once CUDA is in use.  Nothing is synchronized while a CUDA graph is being
captured (a synchronize inside a capture is an error), so a step captured
with the timer on records only the host's seconds of the capture.

``profile_trace(log_dir)`` records a ``torch.profiler`` trace of the CPU and
CUDA activities of a block and writes it into ``log_dir`` as a Chrome trace
(``*.json``).
"""

from __future__ import annotations

import contextlib
import csv
import os
import time
from typing import Dict, List, Optional

import torch

_UNITS = {"s": 1.0, "ms": 1e3, "us": 1e6}


class _Node:
    __slots__ = ("label", "children", "total", "count", "_tic")

    def __init__(self, label: str) -> None:
        self.label = label
        self.children: Dict[str, "_Node"] = {}
        self.total = 0.0
        self.count = 0
        self._tic: Optional[float] = None


def _synchronize(sync_on) -> None:
    """Wait for ``sync_on``'s CUDA device, or for the current CUDA device
    when ``sync_on`` is None and CUDA is in use; never during a capture."""
    if isinstance(sync_on, torch.Tensor):
        if sync_on.device.type != "cuda":
            return
        device = sync_on.device
    elif sync_on is None and torch.cuda.is_initialized():
        device = None
    else:
        return
    if not torch.cuda.is_current_stream_capturing():
        torch.cuda.synchronize(device)


class Timer:
    """Class-level hierarchical timer: ``Timer.start(label)`` /
    ``Timer.stop()``, or ``with Timer.timing(label):``."""

    enabled: bool = False
    sync: bool = True  # synchronize the CUDA device at every start and stop
    _root: _Node = _Node("root")
    _stack: List[_Node] = [_root]

    # -- control ------------------------------------------------------------- #
    @classmethod
    def reset(cls) -> None:
        cls._root = _Node("root")
        cls._stack = [cls._root]

    @classmethod
    def start(cls, label: str) -> None:
        if not cls.enabled:
            return
        if cls.sync:
            _synchronize(None)
        parent = cls._stack[-1]
        node = parent.children.get(label)
        if node is None:
            node = _Node(label)
            parent.children[label] = node
        node._tic = time.perf_counter()
        cls._stack.append(node)

    @classmethod
    def stop(cls, sync_on=None) -> None:
        if not cls.enabled:
            return
        if cls.sync:
            _synchronize(sync_on)
        node = cls._stack.pop()
        node.total += time.perf_counter() - node._tic
        node.count += 1

    @classmethod
    @contextlib.contextmanager
    def timing(cls, label: str, sync_on=None):
        cls.start(label)
        try:
            yield
        finally:
            cls.stop(sync_on)

    # -- reporting ----------------------------------------------------------- #
    @classmethod
    def get_time(cls, label: str, units: str = "s") -> float:
        """The total of every node of the tree that carries ``label``."""
        factor = _UNITS[units]

        def walk(node: _Node) -> float:
            acc = node.total if node.label == label else 0.0
            return acc + sum(walk(c) for c in node.children.values())

        return walk(cls._root) * factor

    @classmethod
    def to_csv(cls, path: str, run_label: str = "", backend: str = "torch") -> None:
        """Append a row per node (``run, backend, label, total_s, calls``;
        the label is the node's path in the tree) to the CSV file ``path``,
        writing the header first if the file is new."""
        rows = []

        def walk(node: _Node, prefix: str) -> None:
            label = f"{prefix}/{node.label}" if prefix else node.label
            if node.count:
                rows.append((run_label, backend, label, node.total, node.count))
            for c in node.children.values():
                walk(c, label)

        for c in cls._root.children.values():
            walk(c, "")
        write_header = not os.path.exists(path)
        with open(path, "a", newline="") as f:
            w = csv.writer(f)
            if write_header:
                w.writerow(["run", "backend", "label", "total_s", "calls"])
            w.writerows(rows)

    @classmethod
    def log(cls, out=None, units: str = "s") -> str:
        """The tree as indented ``label: total units (n calls)`` lines, also
        written to the file ``out`` if given."""
        factor = _UNITS[units]
        lines: List[str] = []

        def walk(node: _Node, depth: int) -> None:
            if depth >= 0:
                lines.append(
                    f"{'  ' * depth}{node.label}: "
                    f"{node.total * factor:.3f} {units} ({node.count} calls)"
                )
            for c in node.children.values():
                walk(c, depth + 1)

        walk(cls._root, -1)
        text = "\n".join(lines)
        if out is not None:
            with open(out, "w") as f:
                f.write(text + "\n")
        return text


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Record the block under ``torch.profiler`` (CPU and, where CUDA is
    available, CUDA activities) and write the trace into ``log_dir``
    (created if missing) as ``trace_<pid>_<ns>.json``, a Chrome trace.
    Yields the profiler; its trace is written when the block ends, also if
    it raises."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
