"""The timing harness of ``bench_kernels.py`` and ``driver_roofline.py``:
a kernel wrapper's device time a call, the card's practical copy rate, and
a case's achieved GB/s and share of that rate.

* :func:`device_ms`: after a warm-up, ``reps`` calls under
  ``torch.profiler``, the device operations' time a call, taken from a
  session whose operations a call agree with the previous session's; if no
  two of ``attempts`` sessions agree (a session has been seen to lose
  launches), CUDA events around ``reps`` back-to-back calls.  On the CPU,
  the host clock around ``reps`` calls.  It says which it used.
* :func:`copy_rate`: ``x + 1.0`` over one float32 buffer of
  ``COPY_FACTOR``·nx × ny × nz (at the flagship 199 MB, four times the
  H100's 50 MB L2, as the JAX roofline sizes its denominator to get past
  the TPU's VMEM), bytes read and written over the device time, the median
  of ``COPY_RUNS`` runs and their range; a run above the data sheet's rate
  is a timing fault of the profiler (one read 6.3 TB/s on an H100), listed
  as ``above_spec``, which the median of five outlasts.
* :class:`Case`: one wrapper's call on fixed inputs and its unique bytes,
  counted as the JAX drivers' ``_bytes`` counts them (each distinct input
  array once, then the outputs).  :func:`measure` times it.  A case whose
  inputs and outputs together fit in twice the L2 would read from the L2
  when called back to back on the same inputs, so it is called in turn on
  enough copies of its inputs to fill twice the L2 (``copies`` in the row);
  a share above 100% of the measured copy rate is still flagged as a
  timing fault of the tool (``fault``), never a result.

The shares of the data sheet's 3.35 TB/s (H100 SXM, ``HBM_SPEC_BYTES_PER_S``)
are labelled as a spec.  Nothing here is imported by the model.
"""

from __future__ import annotations

import math
import statistics
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from tasmania_tpu_torch.ops import _lib

HBM_SPEC_BYTES_PER_S = 3.35e12  # the H100 SXM data sheet's HBM3 rate: a spec
L2_FALLBACK_BYTES = 50 * 2**20  # the H100's L2, where the device does not say
COPY_FACTOR = 16
COPY_RUNS = 5
REPS = 20


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def synchronize(device) -> None:
    if on_card(device):
        torch.cuda.synchronize()


def device_ms(fn: Callable[[], Any], device, reps: int = REPS, warmup: int = 3,
              attempts: int = 4, sessions: Optional[Dict[str, int]] = None) -> Tuple[float, str]:
    """The time of one ``fn()`` in ms and how it was taken: ``"profiler"``
    (device operations only), ``"cuda events"`` or, on the CPU, ``"host
    clock"`` (module docstring).  ``sessions``, if given, counts the
    profiler sessions run (``"sessions"``), those that recorded nothing
    (``"empty"``) and the times taken from them (``"measurements"``)."""
    sessions = {"sessions": 0, "empty": 0, "measurements": 0} if sessions is None else sessions
    for _ in range(warmup):
        fn()
    synchronize(device)
    if not on_card(device):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps, "host clock"
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    previous = None
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per_name: Dict[str, Tuple[float, int]] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, n = per_name.get(e.name, (0.0, 0))
                per_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        sessions["sessions"] += 1
        if not per_name:
            sessions["empty"] += 1
            continue
        a_call = {name: round(n / reps) for name, (_, n) in per_name.items()}
        if a_call == previous:
            sessions["measurements"] += 1
            return 1e-3 * sum(t / n * a_call[name] for name, (t, n) in per_name.items()), "profiler"
        previous = a_call
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "cuda events"


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def unique_bytes(*tensors: torch.Tensor) -> int:
    """The JAX drivers' ``_bytes``: each distinct array once."""
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += nbytes(t)
    return total


def l2_bytes(device) -> int:
    if not on_card(device):
        return 0
    props = torch.cuda.get_device_properties(torch.device(device))
    return int(getattr(props, "L2_cache_size", 0) or L2_FALLBACK_BYTES)


def copy_rate(shape: Sequence[int], device, runs: int = COPY_RUNS, seed: int = 99) -> Dict[str, Any]:
    """The practical copy rate: ``x + 1.0`` over one float32 buffer of
    ``COPY_FACTOR·shape[0]`` × the rest of ``shape``, read once and written
    once a call; the median GB/s of ``runs`` runs, their range, the runs
    above the data sheet's rate, the bytes and how each run was timed."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    big = torch.rand((COPY_FACTOR * shape[0], *shape[1:]), generator=gen, device=device)
    moved = 2 * nbytes(big)
    samples, how = [], set()
    for _ in range(runs):
        ms, by = device_ms(lambda: big + 1.0, device)
        samples.append(moved / (ms * 1e-3) / 1e9)
        how.add(by)
    return dict(gbs=statistics.median(samples), runs=samples, spread=[min(samples), max(samples)],
                above_spec=[g for g in samples if on_card(device) and g * 1e9 > HBM_SPEC_BYTES_PER_S],
                bytes_read=nbytes(big), bytes_written=nbytes(big), shape=list(big.shape),
                timed_by=sorted(how))


@dataclass
class Case:
    """One kernel wrapper's call: ``call(inputs)`` on the named input
    tensors, the wrapper's launch-count key ``kernel``, its row of the
    kernel table (``number``), the JAX driver's name of the case and the
    unique bytes the JAX rule counts (``bytes``)."""

    name: str
    kernel: str
    number: int
    jax_case: str
    inputs: Dict[str, torch.Tensor]
    call: Callable[[Dict[str, torch.Tensor]], Any]
    bytes: int


def flat_outputs(outs) -> list:
    return [outs] if isinstance(outs, torch.Tensor) else [t for t in outs]


def measure(case: Case, device, copy_gbs: float, reps: int = REPS) -> Dict[str, Any]:
    """Time ``case`` (module docstring): its first call's outputs must be
    finite, and on the card each timed call must count one launch of its
    kernel.  Returns its row."""
    outs = flat_outputs(case.call(case.inputs))
    bad = [i for i, t in enumerate(outs) if not bool(torch.isfinite(t).all())]
    if bad:
        raise AssertionError(f"{case.name}: outputs {bad} not finite")
    working = unique_bytes(*case.inputs.values()) + sum(nbytes(t) for t in outs)
    del outs
    l2 = l2_bytes(device)
    copies = 1 if working >= 2 * l2 else math.ceil(2 * l2 / working)
    sets = [case.inputs] + [{k: t.clone() for k, t in case.inputs.items()} for _ in range(copies - 1)]
    calls = [0]

    def fn():
        case.call(sets[calls[0] % copies])
        calls[0] += 1

    before = _lib.launch_counts[case.kernel]
    ms, how = device_ms(fn, device, reps)
    launches = _lib.launch_counts[case.kernel] - before
    if on_card(device) and launches != calls[0]:
        raise AssertionError(f"{case.name}: {launches} launches of {case.kernel} in {calls[0]} calls")
    gbs = case.bytes / (ms * 1e-3) / 1e9
    share = 100.0 * gbs / copy_gbs
    return dict(name=case.name, number=case.number, kernel=case.kernel, jax_case=case.jax_case, ms=ms,
                timed_by=how, bytes=case.bytes, gbs=gbs, share_of_copy_pct=share,
                share_of_spec_pct=100.0 * case.bytes / HBM_SPEC_BYTES_PER_S / (ms * 1e-3),
                ideal_ms=1e3 * case.bytes / (copy_gbs * 1e9), working_set_bytes=working, copies=copies,
                calls=calls[0], launches=launches, fault=on_card(device) and share > 100.0)


def report(title: str, copy: Dict[str, Any], rows: Sequence[Dict[str, Any]]) -> str:
    """The copy rate and the table as text."""
    lines = [title,
             f"practical copy rate: median {copy['gbs']:.1f} GB/s of {len(copy['runs'])} runs, spread "
             f"[{copy['spread'][0]:.1f}, {copy['spread'][1]:.1f}] (read {copy['bytes_read'] / 1e6:.0f} MB "
             f"and write {copy['bytes_written'] / 1e6:.0f} MB a call; {', '.join(copy['timed_by'])})"
             + "".join(f"; TIMING FAULT: a run read {g:.1f} GB/s, above the spec" for g in copy["above_spec"]),
             f"{'#':>3s} {'case':44s} {'ms':>8s} {'MB':>7s} {'set MB':>7s} {'copies':>6s} {'GB/s':>7s} "
             f"{'%copy':>6s} {'%spec':>6s}  timed by"]
    for r in rows:
        lines.append(f"{r['number']:3d} {r['name']:44s} {r['ms']:8.4f} {r['bytes'] / 1e6:7.1f} "
                     f"{r['working_set_bytes'] / 1e6:7.1f} {r['copies']:6d} {r['gbs']:7.1f} "
                     f"{r['share_of_copy_pct']:6.1f} {r['share_of_spec_pct']:6.1f}  {r['timed_by']}"
                     + ("  TIMING FAULT: above the copy rate" if r["fault"] else ""))
    lines.append(f"(%spec: of the H100 SXM data sheet's {HBM_SPEC_BYTES_PER_S / 1e12:.2f} TB/s, a spec)")
    return "\n".join(lines)
