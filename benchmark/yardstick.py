"""The benchmark's frozen yardstick: the chip's published peak, the unique
bytes of each of the port's kernel operations (``kernels/<op>.json``), the
least work of a step, and the arithmetic of idle shares and
roofline shares.  Nothing here reads the program.

A kernel operation's bytes are counted as ``kernel_timing.Case`` counts them
in the port: each distinct input array once, then the outputs.  An entry
gives its arrays by shape class (:func:`shapes`), so the bytes follow the
configuration's grid.  ``reads`` and ``writes`` are the least a launch of
the operation moves in the configurations here (the first RK stage, whose
stage inputs are the "now" arrays; the least mode); a bound from them can
read low, never high.  ``table``, where given, is the case of the port's
kernel table (``PERF.md``), every input distinct.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

#: NVIDIA H100 SXM data sheet: HBM3 bytes a second, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
KERNELS = Path(__file__).resolve().parent / "kernels"


def shapes(nx: int, ny: int, nz: int) -> Dict[str, Tuple[int, ...]]:
    """The shape classes of the model's arrays."""
    return {
        "cell": (nx, ny, nz), "u": (nx + 1, ny, nz), "v": (nx, ny + 1, nz),
        "interfaces": (nx, ny, nz + 1), "plane": (nx, ny), "interface_levels": (nz + 1,),
        "levels": (nz,),
    }


def class_bytes(counts: Dict[str, int], grid: Sequence[int], itemsize: int) -> int:
    sh = shapes(*grid)
    return sum(n * math.prod(sh[k]) * itemsize for k, n in counts.items())


def load_op(op: str, directory: Path = KERNELS) -> Optional[dict]:
    """The entry of ``op``, or None where the table has none."""
    path = directory / f"{op}.json"
    return json.loads(path.read_text()) if path.is_file() else None


def op_bytes(entry: dict, grid: Sequence[int], itemsize: int, table: bool = False) -> int:
    """The unique bytes of one launch: the bound's (least) count, or with
    ``table`` the kernel table's case."""
    form = entry.get("table", entry) if table else entry
    return class_bytes(form["reads"], grid, itemsize) + class_bytes(form["writes"], grid, itemsize)


def step_bound_s(launches: Dict[str, int], grid, itemsize: int,
                 directory: Path = KERNELS) -> Tuple[float, Dict[str, float]]:
    """The least device time of a step's kernel launches at the peak
    bandwidth, and each operation's part; raises ``KeyError`` naming an
    operation the table lacks."""
    parts = {}
    for op, n in sorted(launches.items()):
        entry = load_op(op, directory)
        if entry is None:
            raise KeyError(f"no byte count for the kernel operation {op!r} in {directory}")
        parts[op] = n * op_bytes(entry, grid, itemsize) / HBM_BYTES_PER_S
    return sum(parts.values()), parts


#: the fields a step has to read and write at least once: the isentropic
#: density, both momenta and the three water mass fractions
PROGNOSTIC_FIELDS = 6


def least_step_bytes(grid: Sequence[int], itemsize: int) -> int:
    """The least bytes a step moves: each prognostic field read once and
    written once."""
    return 2 * PROGNOSTIC_FIELDS * math.prod(grid) * itemsize


def union_s(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> float:
    """The length of the union of ``(start, end)`` intervals clipped to
    [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The ``(start, end)`` stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def idle_pct(busy_s: float, window_s: float) -> float:
    return 100.0 * (window_s - busy_s) / window_s


def share_pct(least_s: float, measured_s: float) -> float:
    """The least time over the measured time, in percent."""
    return 100.0 * least_s / measured_s
