"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one line; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``); a CUDA device is required;
2. build the hand-written CUDA kernels from ``tasmania_tpu_torch/csrc``;
3. each of the fifteen kernels at the flagship shapes (161x161x120 float32) on
   perturbed real states against its plain PyTorch version on the same
   inputs, with the device time of one call of each (``device_ms``: the
   device operations' time over 20 calls under ``torch.profiler``, so ``ms``
   is device time and not the wrapper's host time; a session that records
   no device time is repeated, and after three such the time is taken with
   CUDA events and the kernel's ``timed_by`` says so),
   the bytes it must move and its bound at 3.35 TB/s.  Tolerances, as a share
   of the largest magnitude of the plain output (su and sv both of the
   momentum vector's): paste bitwise (N arrays, and one); smoothing 1e-6;
   each of the three RK3WS stages of si_stage (damping on the last) 1e-5
   (FMA contraction in the
   stencils moves the float32 Montgomery potential by a few units of its
   last place, which reaches the momenta through the pressure gradient);
   Kessler + saturation adjustment, Kessler alone, saturation adjustment
   alone and sedimentation 1e-5 (the same algebra;
   FMA contraction, and PyTorch dividing by a scalar as a product with the
   reciprocal on the card, move the last bits of each stage, and the powers
   and exponentials come from the same CUDA math library in both); the
   momentum epilogue of the tendency-carrying stage and the momentum step of
   the unfused stage (fifth order, without and with tendencies) 1e-5 on su
   and sv, as si_stage's; the isentropic diagnostics in their three modes
   (p, exn, mtg, h, rho, T) 1e-5 of each output (the kernel sums level by
   level, the plain version's cumulative sums on the card in another order),
   rho 4e-5 (``DIAG_RHO_TOL``: it divides by a difference of two summed
   heights).  Smagorinsky (both stages, and each stage alone) and vertical
   advection add small updates to large momenta, so each of their outputs
   is held to 1e-5 of its largest update plus 4 float32
   ulps of its magnitude (the rounding of the result; su's ulp is 4.9e-4,
   about 0.1% of its Smagorinsky update here); so are the advection of the
   density and water of the tendency-carrying stage, and the epilogue's s
   and q (updates against the "now" values).  The unfused stage's kernels
   are also held at the mountain wave's shapes (161x7x120: one interior row
   in y), as phase 8 runs them: the advection of s at third order (its
   increment, as above), the Montgomery potential and the momentum step at
   third order (1e-5), each timed there too (``also`` in the summary);
4. the port's first slice (dycore -> diagnostics -> smoothing -> velocities,
   ``namelist_sus.slice_skip``), 1 + 100 steps, with its launch counts and
   agreement with ``tasmania_tpu_torch/drivers/slice_reference.json`` to 1e-4
   relative;
5. the full flagship step (dycore -> diagnostics -> smoothing -> Smagorinsky
   -> velocities -> Kessler + saturation adjustment -> vertical advection ->
   sedimentation -> precipitation), 1 + 100 steps through the entry point
   ``driver_namelist_sus.run``: the launch counts of all seven kernels,
   finiteness, and agreement with the JAX package's float32 result
   (``tasmania_tpu_torch/drivers/flagship_reference.json``).  Limits: 1e-4
   relative on every number but qc's, and exactly zero where the reference
   is zero (no rain forms in this run: qc stays below the autoconversion
   threshold); qc_max and qc_mean_abs 1e-3, because
   saturation adjustment switches on the sign of (qvs - qv) / denom - qc, so
   float32 differences in the dynamics move where cloud forms.  The port on
   the CPU in float32 came within 1.5e-5 (vmax) and 6.9e-5 (qc_mean_abs) of
   that reference.  umax and vmax are printed beside the TPU's validation
   values for information;
6. the full step on rain: the same chain from a supersaturated start
   (relative humidity 1.05, 1 + 30 steps), in which cloud water passes the
   autoconversion threshold and autoconversion, accretion, evaporation,
   sedimentation and precipitation all act on rain, with the same launch and
   finiteness checks, against the JAX package's float32 result
   (``tasmania_tpu_torch/drivers/flagship_rain_reference.json``) to 1e-3
   relative on every number.  Condensation there feeds back on the dynamics,
   so float32 differences grow faster than in phase 5: the port on the CPU in
   float32 came within 2.8e-4 (qc_max), 2.2e-4 (sv_max) and 1.9e-4 (su_max)
   of that reference, and within 4.2e-5 on every rain and precipitation
   number;
7. the five other couplings through ``driver_isentropic_moist.run``, each
   at 161x161x120 from relative humidity 1.05 (the supersaturated start of
   phase 6), 1 + 20 steps: the exact launch counts of its path
   (``LAUNCHES_PER_STEP``), finiteness, its step time, and agreement with
   the JAX package's float32 result at the same configuration
   (``tasmania_tpu_torch/drivers/variant_<coupling>_reference.json``).
   Limits: the flagship's, 1e-4 relative and 1e-3 on qc_max and
   qc_mean_abs, and exactly zero where the reference is zero (ps's
   precipitation); 3e-4 on the vmax of ps and sts (``VARIANT_LOOSER``).
   The port on the CPU in float32 came within 7.2e-5 (ps's vmax) and
   6.2e-5 (sts's vmax), and within 4.4e-5 on every other number but qc
   (1.1e-4, sts's qc_max).

8. the deep-domain mountain wave (BASELINE config 3) through
   ``driver_mountain_wave.run_case``: 161x1x120 (the numerical grid
   161x7x120), θ at the top 420 K, damping depth 60, 10 h at dt 20 s (1800
   steps, the first a warm-up), float32: the exact launch counts of the
   unfused dry stage, finiteness, its ms/step, the analytic gate of
   ``tests/test_mountain_wave_validation.py:146-151`` (correlation >= 0.95
   over |x| <= 2a and >= 0.93 over 4a, amplitude ratio in (0.7, 1.2)), and
   agreement with the JAX package's float32 result
   (``tasmania_tpu_torch/drivers/mountain_wave_reference.json``): ``MW_ABS_TOL``
   on the correlations, ``MW_REL_TOL`` on the amplitude ratios and umax.
   Float32 rounding of the Montgomery potential (a last digit of 0.03 m2/s2,
   1e-4 m/s a step through the pressure gradient) moves the wave's extremes:
   the port's float32 run on the CPU came within 7.1e-3 (corr), 2.2e-3 (the
   window correlations), 5.6e-2 (the amplitude ratio) and 1.0e-4 (umax) of
   that reference.

The isentropic diagnostics kernel serves every diagnostics call, so phases
4-7 count it too (``LAUNCHES_PER_STEP``).  Every phase checks the launch
counts exactly: each kernel of the path as often as its path launches it a
step, and no other kernel.  The last two
lines are the card's name and power limit, then ``{"ok": true, "device":
{...}}``; the line before them is a JSON summary of the kernels, their
launches in the full-size run of the first path that runs them (``path``:
the flagship, phase 5, for the seven of the SUS chain and the diagnostics;
fc for the two stage kernels, ps for Kessler and saturation adjustment
alone, the mountain wave for the momentum step; none for the single paste
and the Smagorinsky stage alone, which no path runs), their launches a step
on every path, and their times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

SLICE_TOL = 1e-4
FLAGSHIP_TOL = 1e-4
FLAGSHIP_QC_TOL = 1e-3
RAIN_TOL = 1e-3
KERNEL_TOL = 1e-5
# the density of the isentropic diagnostics, rho = s·dθ/(h[k] - h[k+1]),
# divides by the difference of two heights summed over up to 120 levels:
# at 161x161x120 the heights reach 1.2e4 m (a float32 ulp of 1e-3 m) and
# differ by about 100 m, so summing in another order (the kernel level by
# level, the plain version's cumulative sum on the card in blocks) moves rho
# by about 1e-5 of its value per ulp of h (1.2e-5 of its largest magnitude
# on an H100 80GB HBM3)
DIAG_RHO_TOL = 4e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TPU_VALIDATION = {"umax": 23.62408, "vmax": 1.07557}  # BENCH_NOTES.json "current"
VARIANT_TOL = 1e-4
VARIANT_QC_TOL = 1e-3
# the numbers on which the port's float32 run on the CPU came within half of
# VARIANT_TOL of the reference (make_torch_flagship_reference.py --coupling C
# --check-port): vmax, the smallest velocity, moves most with rounding
VARIANT_LOOSER = {
    ("ps", "vmax"): 3e-4,  # CPU reading 7.2e-5
    ("sts", "vmax"): 3e-4,  # CPU reading 6.2e-5
}
VARIANTS = ("fc", "lfc", "ps", "sts", "ssus")
# kernel launches per step of each path, as the code routes it: with
# tendencies (fc, lfc) each dycore stage is the two-kernel stage and the
# physics chain is plain PyTorch; ps runs the SUS chain's kernels but for the
# pair, whose processes step apart; sts's steppers never fuse
# the isentropic diagnostics (fused_isentropic_diagnostics) serve every
# diagnostics call: the physics chain's diagnostics once a step on every
# path; with tendencies also the Montgomery potential of each stage (3 a
# step) and, in fc, the dycore's fast diagnostics after each stage (3 more)
_SUS = {"si_stage": 3, "paste_x_edges_multi": 4, "fused_smoothing": 1, "fused_smagorinsky_rk2": 2,
        "fused_kessler_satadj_rk2": 1, "fused_vertical_advection_rk3ws": 1,
        "fused_sedimentation_rk3ws": 1, "fused_isentropic_diagnostics": 1}
_TWO_KERNEL = {"fused_advection_fields": 3, "fused_momentum_epilogue": 3, "fused_smoothing": 1,
               "paste_x_edges_multi": 1}
LAUNCHES_PER_STEP = {
    "slice": {"si_stage": 3, "paste_x_edges_multi": 4, "fused_smoothing": 1,
              "fused_isentropic_diagnostics": 1},
    "sus": _SUS,
    "ssus": _SUS,
    "fc": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 6},
    "lfc": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 4},
    "ps": {**{k: n for k, n in _SUS.items() if k != "fused_kessler_satadj_rk2"},
           "fused_kessler_rk2": 1, "fused_satadj_rk2": 1},
    "sts": {"si_stage": 3, "paste_x_edges_multi": 4, "fused_smoothing": 1,
            "fused_isentropic_diagnostics": 1},
    # the unfused dry stage: advection of s, the Montgomery potential of the
    # stepped density and the momentum step, thrice, and the driver's
    # Montgomery refresh after the step
    "mountain_wave": {"fused_advection_fields": 3, "fused_momentum_step": 3,
                      "fused_isentropic_diagnostics": 4},
}
# phase 8, the deep-domain mountain wave (tests/test_mountain_wave_validation.py:115-151)
MOUNTAIN_WAVE = dict(nx=161, nz=120, hours=10.0, dt=20.0, theta_top=420.0, damp_depth=60,
                     damp_max=5e-4)
# the analytic gate: correlation over |x| <= 2a and 4a, the 2a amplitude ratio
MW_GATE = {"corr_2a": 0.95, "corr_4a": 0.93, "amplitude_ratio_2a": (0.7, 1.2)}
# agreement with the JAX float32 result (mountain_wave_reference.json):
# absolute on the correlations, relative on the amplitude ratios and umax
# (make_torch_mountain_wave_reference.py --check-port: the port's float32 run
# on the CPU came within 7.1e-3 on corr, 2.2e-3 on the other correlations,
# 5.6e-2 on the amplitude ratios and 1.0e-4 on umax; the limits are about
# twice those readings)
MW_ABS_TOL = {"corr": 1.5e-2, "corr_focused": 5e-3, "corr_2a": 5e-3, "corr_3a": 5e-3,
              "corr_4a": 5e-3}
MW_REL_TOL = {"amplitude_ratio": 0.1, "amplitude_ratio_2a": 0.1, "umax": 2e-4}


def variant_tol(coupling: str, key: str) -> float:
    default = VARIANT_QC_TOL if key.startswith("qc_") else VARIANT_TOL
    return VARIANT_LOOSER.get((coupling, key), default)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


profiler_sessions = {"recorded": 0, "empty": 0}


def device_ms(fn, reps: int = 20, warmup: int = 3, attempts: int = 3) -> tuple[float, str]:
    """Device time of one ``fn()`` and how it was taken.  After warm-up,
    ``reps`` calls under ``torch.profiler``: the sum of the device
    operations' times (kernels and copies) over ``reps``.  The host's work
    per call (the ctypes call, argument checks, allocation, PyTorch's
    dispatch) and the device's idle gaps between launches do not count.

    A profiler session has been seen to record no device operation at all
    (once, on an H100, for the 4 us paste kernel).  Such a session is
    counted in ``profiler_sessions`` and repeated, up to ``attempts``
    sessions; if none records device time, the time is taken with CUDA
    events around ``reps`` back-to-back calls, an upper bound that holds
    the host's work wherever it is longer than the device's.  Returns (ms, "profiler" or "cuda events")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
        if busy_us > 0:
            profiler_sessions["recorded"] += 1
            return 1e-3 * busy_us / reps, "profiler"
        profiler_sessions["empty"] += 1
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, "cuda events"


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float) -> dict:
    """The least time of the work: bytes at the memory rate or operations at
    the float32 rate, whichever is larger."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return dict(bytes=bytes_moved, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_outputs(name, got, ref, scales, tol):
    """max|got - ref| <= tol * scale per output; returns (worst abs error,
    the relative errors as text)."""
    worst, rels = 0.0, []
    for k, (a, b, m) in enumerate(zip(got, ref, scales)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} output {k} is not finite")
        e = float((a - b).abs().max())
        rels.append(f"{e / m if m else e:.1e}")
        if not e <= tol * m:
            raise AssertionError(f"{name} output {k}: max|d|={e} > {tol}*{m}")
        worst = max(worst, e)
    return worst, " ".join(rels)


def check_increments(name, got, ref, base, tol, ulps=4):
    """Per output, max|got - ref| <= tol * max|ref - base| plus ``ulps``
    units in the last place of max|ref|: a gate on the update a kernel adds
    to ``base``, beside the rounding of the result, which no kernel avoids
    (su ~ 4.5e3 has a float32 ulp of 4.9e-4).  Returns (worst abs error, the
    errors as shares of the largest increment as text)."""
    worst, shares = 0.0, []
    for k, (a, r, b) in enumerate(zip(got, ref, base)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} output {k} is not finite")
        e = float((a - r).abs().max())
        inc = float((r - b).abs().max())
        limit = tol * inc + ulps * torch.finfo(r.dtype).eps * float(r.abs().max())
        shares.append(f"{e / inc if inc else e:.1e}")
        if not e <= limit:
            raise AssertionError(f"{name} output {k}: max|d|={e} > {limit} "
                                 f"(largest increment {inc})")
        worst = max(worst, e)
    return worst, " ".join(shares)


def amax(*tensors) -> float:
    return max(float(t.abs().max()) for t in tensors)


def compare_reference(tag, got, ref, tol_of, zero_tol):
    """Relative agreement of validation numbers with a reference file's;
    where the reference is zero, the number itself is held to ``zero_tol``."""
    diffs = []
    for key, r in ref.items():
        if not isinstance(r, (int, float)):
            continue
        val = got[key]
        if r:
            rel, tol = abs(val - r) / abs(r), tol_of(key)
        else:
            rel, tol = abs(val), zero_tol
        diffs.append(f"{key}={val:.7g}({rel:.1e})")
        if not rel <= tol:
            raise AssertionError(f"{tag} {key}: {val} vs reference {r} (deviation {rel:.2e} > {tol})")
    return " ".join(diffs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{card} | torch {torch.__version__} CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    import numpy as np

    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.framework.steppers import TendencyStepper
    from tasmania_tpu_torch.isentropic.physics.turbulence import IsentropicSmagorinsky
    from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
    from tasmania_tpu_torch.isentropic.utils import AirPotentialTemperatureToTendency
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.ops.advection_step import (
        fused_advection_fields,
        fused_advection_fields_plain,
        fused_momentum_epilogue,
        fused_momentum_epilogue_plain,
        fused_momentum_step,
        fused_momentum_step_plain,
    )
    from tasmania_tpu_torch.ops.diagnostics_step import (
        fused_isentropic_diagnostics,
        fused_isentropic_diagnostics_plain,
    )
    from tasmania_tpu_torch.ops.kessler_step import (
        KesslerConstants,
        fused_kessler_rk2,
        fused_kessler_rk2_plain,
        fused_kessler_satadj_rk2,
        fused_kessler_satadj_rk2_plain,
        fused_satadj_rk2,
        fused_satadj_rk2_plain,
    )
    from tasmania_tpu_torch.ops.paste import (
        paste_x_edges,
        paste_x_edges_multi,
        paste_x_edges_multi_plain,
    )
    from tasmania_tpu_torch.ops.sedimentation_step import (
        fused_sedimentation_rk3ws,
        fused_sedimentation_rk3ws_plain,
    )
    from tasmania_tpu_torch.ops.si_stage import StageConstants, clip_pos, si_stage, si_stage_plain
    from tasmania_tpu_torch.ops.smagorinsky_step import (
        fused_smagorinsky_rk2,
        fused_smagorinsky_rk2_plain,
        smag_stage,
        smagorinsky_stage_plain,
    )
    from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
    from tasmania_tpu_torch.ops.vertical_advection_step import (
        fused_vertical_advection_rk3ws,
        fused_vertical_advection_rk3ws_plain,
    )
    from tasmania_tpu_torch.physics.microphysics.kessler import (
        KesslerMicrophysics,
        KesslerSedimentation,
    )

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _lib.lib()
    info = _lib.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", f"{time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s, "
          f"cached={info['cached']}) -> {info['path']}; ptxas: {' | '.join(ptxas)}")

    # -- 3. kernels against their plain versions at the flagship shapes --------
    nl = load_namelist()
    domain, state, pt = drv.build_domain_and_state(nl)
    dycore, physics = drv.build_model(nl, domain, pt)
    prog = dycore.prognostic
    rng = np.random.default_rng(1234)

    def noise(shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(tuple(shape)) * scale, dtype=torch.float32, device=device)

    def uniform(shape, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, tuple(shape)), dtype=torch.float32, device=device)

    def perturbed(t, rel=1e-3):
        return t * (1.0 + noise(t.shape, rel))

    def stepper_of(component_type):
        for p in physics.components:
            if isinstance(p, TendencyStepper) and any(
                isinstance(c, component_type) for c in p.coupling.components
            ):
                return p
        raise LookupError(component_type.__name__)

    raw = {k: v.data for k, v in state.items() if k != "time"}
    qn = list(prog.q_names)
    hb = domain.horizontal_boundary
    cell = raw["air_isentropic_density"].shape
    s_now, su_now, sv_now = (raw[n] for n in ("air_isentropic_density",
                                               "x_momentum_isentropic", "y_momentum_isentropic"))
    kernels = {}

    def record(name, source, replaces, worst, kernel_fn, plain_fn, b, library_fn=None, unit=""):
        """Time the kernel's wrapper, its plain version and the one PyTorch
        call (if any) with ``device_ms`` and keep the kernel's entry."""
        timed = {"ms": device_ms(kernel_fn), "plain_ms": device_ms(plain_fn),
                 "library_ms": device_ms(library_fn) if library_fn else (None, None)}
        ms, plain_ms, library_ms = (timed[k][0] for k in ("ms", "plain_ms", "library_ms"))
        by_events = [k for k, (_, how) in timed.items() if how == "cuda events"]
        kernels[name] = dict(route="cuda", source=f"tasmania_tpu_torch/csrc/{source}",
                             replaces=replaces, max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                             bound_ms=b["bound_ms"], bound_by=b["bound_by"], library_ms=library_ms,
                             timed_by="profiler" if not by_events else
                             f"cuda events for {', '.join(by_events)}")
        lib = f", one PyTorch call {library_ms:.3f} ms" if library_ms is not None else ""
        phase("kernel", f"{name}: {ms:.3f} ms{unit} (plain {plain_ms:.3f} ms{lib}); "
              f"{b['bytes'] / 1e6:.1f} MB, bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
              f"timed by {kernels[name]['timed_by']}")

    def record_also(name, label, kernel_fn, plain_fn, b):
        """Time a recorded kernel at other shapes or in another mode, kept
        under its ``also`` entry, ``label``."""
        (ms, how), (plain_ms, plain_how) = device_ms(kernel_fn), device_ms(plain_fn)
        kernels[name].setdefault("also", {})[label] = dict(
            ms=ms, plain_ms=plain_ms, bytes=b["bytes"], bound_ms=b["bound_ms"], bound_by=b["bound_by"],
            timed_by="profiler" if how == plain_how == "profiler" else "cuda events for one or both")
        phase("kernel", f"{name} {label}: {ms:.3f} ms (plain {plain_ms:.3f} ms); "
              f"{b['bytes'] / 1e6:.2f} MB, bound {b['bound_ms']:.4f} ms by {b['bound_by']}")

    # si_stage: the three stages, damping on the last
    stage_in = dict(
        u=perturbed(raw["x_velocity_at_u_locations"]),
        v=perturbed(raw["y_velocity_at_v_locations"]) + 0.5,
        s_now=s_now, s_int=perturbed(s_now),
        q_now=[raw[q] for q in qn], q_int=[perturbed(raw[q]) for q in qn],
        su_now=su_now, sv_now=sv_now, su_int=perturbed(su_now), sv_int=perturbed(sv_now) + 1.0,
        mtg_now=raw["montgomery_potential"],
        hs=dycore.topography_steady, theta=prog.diagnostics.theta, gamma=prog.gamma,
        s_ref=hb.ref_field("air_isentropic_density"), su_ref=hb.ref_field("x_momentum_isentropic"),
        sv_ref=hb.ref_field("y_momentum_isentropic"), q_refs=[hb.ref_field(q) for q in qn],
    )
    dia = prog.diagnostics
    worst, errs = 0.0, []
    for stage, frac in enumerate(prog.substep_fractions):
        last = stage == 2
        c = StageConstants(
            dt=frac * 5.0, dtf=5.0, dx=prog.dx, dy=prog.dy, eps=prog.eps, pt=prog.pt, dz=dia.dz,
            g=dia.rpc["gravitational_acceleration"],
            cp=dia.rpc["specific_heat_of_dry_air_at_constant_pressure"],
            rd=dia.rpc["gas_constant_of_dry_air"], pref=dia.rpc["air_pressure_at_sea_level"],
        )
        rmat = dycore.damper.rmat if last else None
        dd = dycore.damper.dd if last else 0
        args = list(stage_in.values()) + [rmat]
        got = si_stage(*args, nb=nl.nb, c=c, dd=dd)
        ref = si_stage_plain(*args, nb=nl.nb, c=c, dd=dd)
        torch.cuda.synchronize()
        momentum = amax(ref[1], ref[2])
        scales = [amax(ref[0]), momentum, momentum] + [amax(r) for r in ref[3:]]
        w, rel = check_outputs(f"si_stage stage {stage}", got, ref, scales, KERNEL_TOL)
        worst = max(worst, w)
        errs.append(f"s{stage}: {rel}")
    flat_in = [a for v in stage_in.values() for a in (v if isinstance(v, list) else [v])] + [rmat]
    # about 700 flops a cell: fifth-order fluxes of 7 fields on 4 faces, the
    # momentum and pressure-gradient terms
    b = bound(nbytes(flat_in) + nbytes(ref), 700.0 * s_now.numel())
    phase("check", f"si_stage relative errors {' | '.join(errs)}")
    record("si_stage", "si_stage.cu", "tasmania_tpu/ops/si_stage.py:146", worst,
           lambda: si_stage(*args, nb=nl.nb, c=c, dd=dd),
           lambda: si_stage_plain(*args, nb=nl.nb, c=c, dd=dd), b, unit=" per stage")

    # smoothing on the six smoothed fields
    smoother = physics.components[1]
    names = list(smoother.input_properties)
    fields = [perturbed(raw[n]) for n in names]
    sm = dict(order=smoother.order, nb=smoother.nb)
    got = fused_smoothing(fields, smoother.gamma, **sm)
    ref = fused_smoothing_plain(fields, smoother.gamma, **sm)
    worst, rel = check_outputs("fused_smoothing", got, ref, [amax(r) for r in ref], 1e-6)
    phase("check", f"fused_smoothing relative errors {rel}")
    # 2 x 2n taps of 3 operations and the centre, a cell of each field
    b = bound(nbytes(fields) + nbytes(ref), (12.0 * smoother.order + 3.0) * len(fields) * s_now.numel())
    record("fused_smoothing", "smoothing.cu", "tasmania_tpu/ops/smoothing_step.py:44", worst,
           lambda: fused_smoothing(fields, smoother.gamma, **sm),
           lambda: fused_smoothing_plain(fields, smoother.gamma, **sm), b)

    # paste: six arrays, nb-wide strips, bitwise
    nb = nl.nb
    fulls = [f.clone() for f in fields]
    lo = [perturbed(f[:nb].contiguous()) for f in fields]
    hi = [perturbed(f[-nb:].contiguous()) for f in fields]
    got = paste_x_edges_multi([f.clone() for f in fulls], lo, hi)
    ref = paste_x_edges_multi_plain([f.clone() for f in fulls], lo, hi)
    for a, r in zip(got, ref):
        if not torch.equal(a, r):
            raise AssertionError("paste_x_edges_multi differs from its plain version")
    views = [f[:nb] for f in fulls] + [f[-nb:] for f in fulls]
    b = bound(2 * nbytes(lo + hi), 0.0)
    record("paste_x_edges_multi", "paste.cu", "tasmania_tpu/ops/paste.py:67", 0.0,
           lambda: paste_x_edges_multi(fulls, lo, hi),
           lambda: paste_x_edges_multi_plain(fulls, lo, hi), b,
           library_fn=lambda: torch._foreach_copy_(views, lo + hi))

    # the single-array paste: the same kernel with one array, bitwise
    full1, lo1, hi1 = fulls[0].clone(), lo[0], hi[0]
    got = paste_x_edges(full1.clone(), lo1, hi1)
    ref = paste_x_edges_multi_plain([full1.clone()], [lo1], [hi1])[0]
    if not torch.equal(got, ref):
        raise AssertionError("paste_x_edges differs from its plain version")
    record("paste_x_edges", "paste.cu", "tasmania_tpu/ops/paste.py:23", 0.0,
           lambda: paste_x_edges(full1, lo1, hi1),
           lambda: paste_x_edges_multi_plain([full1], [lo1], [hi1]), bound(2 * nbytes([lo1, hi1]), 0.0),
           library_fn=lambda: torch._foreach_copy_([full1[:nb], full1[-nb:]], [lo1, hi1]))

    # Kessler + saturation adjustment: the initial thermodynamics, qv near
    # saturation, qc on both sides of the autoconversion threshold, qr with zeros
    ke = stepper_of(KesslerMicrophysics).coupling.components[0]
    sa = stepper_of(AirPotentialTemperatureToTendency).coupling.components[1]
    rv = ke.rpc["gas_constant_of_water_vapor"]
    kc = KesslerConstants(
        a=ke.a, k1=ke.k1, k2=ke.k2, sr=sa.sr, beta=ke.rpc["gas_constant_of_dry_air"] / rv,
        lhvw=ke.rpc["latent_heat_of_vaporization_of_water"],
        cp=sa.rpc["specific_heat_of_dry_air_at_constant_pressure"], rv=rv, dt=5.0,
    )
    qc = uniform(cell, 0.0, 2.0 * ke.a)
    qr = uniform(cell, 0.0, ke.a) * (uniform(cell, 0.0, 1.0) > 0.3)
    kin = (raw["air_density"], raw["air_temperature"], raw["air_pressure_on_interface_levels"],
           raw["exner_function_on_interface_levels"], perturbed(raw[qn[0]], 0.05), qc, qr)
    got = fused_kessler_satadj_rk2(*kin, kc)
    ref = fused_kessler_satadj_rk2_plain(*kin, kc)
    worst, rel = check_outputs("fused_kessler_satadj_rk2", got, ref, [amax(r) for r in ref], KERNEL_TOL)
    phase("check", f"fused_kessler_satadj_rk2 relative errors (qv qc qr theta) {rel}")
    # about 150 flops a cell: three powers, one exponential, two RK2 pairs
    b = bound(nbytes(kin) + nbytes(ref), 150.0 * s_now.numel())
    record("fused_kessler_satadj_rk2", "kessler.cu", "tasmania_tpu/ops/kessler_step.py:111", worst,
           lambda: fused_kessler_satadj_rk2(*kin, kc),
           lambda: fused_kessler_satadj_rk2_plain(*kin, kc), b)

    # Smagorinsky RK2: both stages
    smag = stepper_of(IsentropicSmagorinsky).coupling.components[0]
    dx, dy = smag.spacings()
    skw = dict(dx=dx, dy=dy, cs=smag.cs, nb=smag.nb, dt=5.0)
    # velocity noise of a few m/s, so that the closure's increments are large
    sin = (s_now, perturbed(su_now, 0.05), s_now * noise(cell, 2.0))
    got = fused_smagorinsky_rk2(*sin, **skw)
    ref = fused_smagorinsky_rk2_plain(*sin, **skw)
    worst, inc = check_increments("fused_smagorinsky_rk2", got, ref, sin[1:], KERNEL_TOL)
    phase("check", f"fused_smagorinsky_rk2 errors as a share of the largest increment (su sv) {inc}")
    # about 100 flops a cell and stage: 4 strains and viscosities, the divergence
    b = bound(nbytes(sin) + nbytes(ref), 2 * 100.0 * s_now.numel())
    record("fused_smagorinsky_rk2", "smagorinsky.cu", "tasmania_tpu/ops/smagorinsky_step.py:149",
           worst, lambda: fused_smagorinsky_rk2(*sin, **skw),
           lambda: fused_smagorinsky_rk2_plain(*sin, **skw), b, unit=" (both stages)")

    # one Smagorinsky stage alone: the RK2's first on the base state, then its
    # second from the first's output, each against the plain stage
    k1 = {k: skw[k] for k in ("dx", "dy", "cs", "nb")}
    st1 = (s_now, sin[1], sin[2], sin[1], sin[2])
    got1 = smag_stage(*st1, c=0.5 * skw["dt"], **k1)
    ref1 = smagorinsky_stage_plain(*st1, c=0.5 * skw["dt"], **k1)
    w1, inc1 = check_increments("smag_stage (stage 1)", got1, ref1, sin[1:], KERNEL_TOL)
    st2 = (s_now, *ref1, sin[1], sin[2])
    got = smag_stage(*st2, c=skw["dt"], **k1)
    ref = smagorinsky_stage_plain(*st2, c=skw["dt"], **k1)
    w2, inc2 = check_increments("smag_stage (stage 2)", got, ref, sin[1:], KERNEL_TOL)
    phase("check", f"smag_stage errors as a share of the largest increment (su sv), stage 1 {inc1}, "
          f"stage 2 {inc2}")
    record("smag_stage", "smagorinsky.cu", "tasmania_tpu/ops/smagorinsky_step.py:33", max(w1, w2),
           lambda: smag_stage(*st2, c=skw["dt"], **k1),
           lambda: smagorinsky_stage_plain(*st2, c=skw["dt"], **k1),
           bound(nbytes(st2) + nbytes(ref), 100.0 * s_now.numel()))

    # vertical advection RK3WS: a θ-tendency of a few hundredths of K/s
    va = stepper_of(IsentropicVerticalAdvection).coupling.components[0]
    vkw = dict(order=va.vflux.order, dt=5.0, dz=va.dz)
    vin = (noise(cell, 0.02), perturbed(s_now), perturbed(su_now), perturbed(sv_now) + 1.0)
    vq = (perturbed(raw[qn[0]]), qc, qr)
    got = fused_vertical_advection_rk3ws(*vin, vq, **vkw)
    ref = fused_vertical_advection_rk3ws_plain(*vin, vq, **vkw)
    worst, inc = check_increments("fused_vertical_advection_rk3ws", got, ref, vin[1:] + vq, KERNEL_TOL)
    phase("check", "fused_vertical_advection_rk3ws errors as a share of the largest increment "
          f"(s su sv qv qc qr) {inc}")
    # 18 tendency evaluations of about 22 flops a level
    b = bound(nbytes(vin + vq) + nbytes(ref), 18 * 22.0 * s_now.numel())
    record("fused_vertical_advection_rk3ws", "vertical_advection.cu",
           "tasmania_tpu/ops/vertical_advection_step.py:158", worst,
           lambda: fused_vertical_advection_rk3ws(*vin, vq, **vkw),
           lambda: fused_vertical_advection_rk3ws_plain(*vin, vq, **vkw), b)

    # sedimentation RK3WS, the flagship's vt_mode
    sed = stepper_of(KesslerSedimentation).coupling.components[1]
    dkw = dict(order=sed.sflux.nb, dt=5.0, vt_mode=sed.vt_mode)
    din = (raw["air_density"], raw["height_on_interface_levels"], qr)
    got = fused_sedimentation_rk3ws(*din, **dkw)
    ref = fused_sedimentation_rk3ws_plain(*din, **dkw)
    worst, rel = check_outputs("fused_sedimentation_rk3ws", got, ref, [amax(r) for r in ref], KERNEL_TOL)
    phase("check", f"fused_sedimentation_rk3ws ({sed.vt_mode}) relative errors (qr vt) {rel}")
    # one power (vt_mode step) or three, and about 30 flops a stage
    powers = 1 if sed.vt_mode == "step" else 3
    b = bound(nbytes(din) + nbytes(ref), (powers * 20.0 + 90.0) * s_now.numel())
    record("fused_sedimentation_rk3ws", "sedimentation.cu",
           "tasmania_tpu/ops/sedimentation_step.py:123", worst,
           lambda: fused_sedimentation_rk3ws(*din, **dkw),
           lambda: fused_sedimentation_rk3ws_plain(*din, **dkw), b)
    # Kessler alone and saturation adjustment alone (the parallel splitting's
    # chains): the pair's inputs, and a θ-tendency for the adjustment to add to
    for name, wrapper, plain, kargs, flops, replaces in (
        ("fused_kessler_rk2", fused_kessler_rk2, fused_kessler_rk2_plain, kin, 120.0,
         "tasmania_tpu/ops/kessler_step.py:39"),
        ("fused_satadj_rk2", fused_satadj_rk2, fused_satadj_rk2_plain,
         kin[1:4] + kin[4:6] + (noise(cell, 1e-3),), 60.0, "tasmania_tpu/ops/kessler_step.py:204"),
    ):
        got = wrapper(*kargs, kc)
        ref = plain(*kargs, kc)
        worst, rel = check_outputs(name, got, ref, [amax(r) for r in ref], KERNEL_TOL)
        phase("check", f"{name} relative errors {rel}")
        record(name, "kessler.cu", replaces, worst,
               lambda w=wrapper, a=kargs: w(*a, kc), lambda p=plain, a=kargs: p(*a, kc),
               bound(nbytes(kargs) + nbytes(ref), flops * s_now.numel()))

    # the tendency-carrying stage (fc, lfc), its last stage (c, rmat of the
    # si_stage loop): tendencies of the size the physics chain gives
    q_now = [raw[q] for q in qn]
    s_int = stage_in["s_int"]
    adv_args = (
        stage_in["u"], stage_in["v"], [s_now] + q_now, [s_int] + stage_in["q_int"],
        [noise(cell, 1e-3)] + [s_int * noise(cell, 1e-7) for _ in qn],
        prog.gamma, stage_in["s_ref"],
    )
    akw = dict(nb=nl.nb, dt=c.dt, dx=prog.dx, dy=prog.dy, q_product=(False,) + (True,) * len(qn))
    got = fused_advection_fields(*adv_args, **akw)
    adv = fused_advection_fields_plain(*adv_args, **akw)
    base = [s_now] + [clip_pos(s_now * q) for q in q_now]
    worst, inc = check_increments("fused_advection_fields", got, adv, base, KERNEL_TOL)
    phase("check", f"fused_advection_fields errors as a share of the largest increment (s sqv sqc sqr) {inc}")
    # per field and cell: a fifth-order flux at one x and one y face (about
    # 20 operations each), the divergence, the tendency and the s·q product
    flat = [a for v in adv_args for a in (v if isinstance(v, list) else [v])]
    record("fused_advection_fields", "advection.cu", "tasmania_tpu/ops/advection_step.py:140", worst,
           lambda: fused_advection_fields(*adv_args, **akw),
           lambda: fused_advection_fields_plain(*adv_args, **akw),
           bound(nbytes(flat) + nbytes(adv), 50.0 * len(adv) * s_now.numel()))

    mtg_e = prog.diagnostics.get_montgomery_potential(adv[0], prog.pt, dycore.topography_steady)
    mom_args = (
        stage_in["u"], stage_in["v"], su_now, sv_now, stage_in["su_int"], stage_in["sv_int"],
        s_now, raw["montgomery_potential"], adv[0], mtg_e, list(adv[1:]), prog.gamma,
        stage_in["s_ref"], stage_in["su_ref"], stage_in["sv_ref"], stage_in["q_refs"], rmat,
        noise(cell, 0.05), noise(cell, 0.05),
    )
    got = fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c)
    ref = fused_momentum_epilogue_plain(*mom_args, nb=nl.nb, c=c)
    momentum = amax(ref[1], ref[2])
    w1, rel = check_outputs("fused_momentum_epilogue (su sv)", got[1:3], ref[1:3], [momentum] * 2, KERNEL_TOL)
    w2, inc = check_increments("fused_momentum_epilogue (s q)", [got[0], *got[3:]], [ref[0], *ref[3:]],
                               [s_now, *q_now], KERNEL_TOL)
    phase("check", f"fused_momentum_epilogue relative errors (su sv) {rel}; errors as a share of "
          f"the largest increment (s qv qc qr) {inc}")
    # per cell: two momentum divergences (2 fluxes each), the pressure
    # gradient, and the epilogue of six outputs
    flat = [a for v in mom_args for a in (v if isinstance(v, list) else [v])]
    record("fused_momentum_epilogue", "advection.cu", "tasmania_tpu/ops/advection_step.py:422",
           max(w1, w2), lambda: fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c),
           lambda: fused_momentum_epilogue_plain(*mom_args, nb=nl.nb, c=c),
           bound(nbytes(flat) + nbytes(ref), 160.0 * s_now.numel()))
    # the momentum step of the unfused stage at the flagship shapes, fifth
    # order, without and with momentum tendencies: from the stepped density
    # of the tendency-carrying stage and its Montgomery potential
    ms_args = (stage_in["u"], stage_in["v"], su_now, sv_now, stage_in["su_int"], stage_in["sv_int"],
               s_now, raw["montgomery_potential"], adv[0], mtg_e)
    mkw = dict(order=5, nb=nl.nb, dt=c.dt, dx=prog.dx, dy=prog.dy, eps=prog.eps)
    worst, rels = 0.0, []
    for tnd in ((None, None), (noise(cell, 0.05), noise(cell, 0.05))):
        got = fused_momentum_step(*ms_args, *tnd, **mkw)
        ref = fused_momentum_step_plain(*ms_args, *tnd, **mkw)
        momentum = amax(*ref)
        w, rel = check_outputs("fused_momentum_step", got, ref, [momentum] * 2, KERNEL_TOL)
        worst, rels = max(worst, w), rels + [rel]
    phase("check", "fused_momentum_step (order 5) relative errors (su sv), without | with tendencies "
          f"{' | '.join(rels)}")
    # per cell: two fifth-order divergences (4 fluxes each) and the pressure gradient
    record("fused_momentum_step", "advection.cu", "tasmania_tpu/ops/advection_step.py:282", worst,
           lambda: fused_momentum_step(*ms_args, **mkw),
           lambda: fused_momentum_step_plain(*ms_args, **mkw),
           bound(nbytes(ms_args) + nbytes(ref), 200.0 * s_now.numel()))

    # the isentropic diagnostics at the flagship shapes, in its three modes
    dkw = dict(pt=prog.pt, dz=dia.dz, g=dia.rpc["gravitational_acceleration"],
               cp=dia.rpc["specific_heat_of_dry_air_at_constant_pressure"],
               rd=dia.rpc["gas_constant_of_dry_air"], pref=dia.rpc["air_pressure_at_sea_level"])
    d_in = (perturbed(s_now), dycore.topography_steady, dia.theta)
    worst, rels, diag_b = 0.0, [], {}
    for mode in ("mtg", "dry", "moist"):
        got = fused_isentropic_diagnostics(*d_in, mode=mode, **dkw)
        ref = fused_isentropic_diagnostics_plain(*d_in, mode=mode, **dkw)
        got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
        tols = [DIAG_RHO_TOL if k == 4 else KERNEL_TOL for k in range(len(ref))]
        w, rel = 0.0, []
        for k, (a, r, tol) in enumerate(zip(got, ref, tols)):
            wk, rk = check_outputs(f"fused_isentropic_diagnostics ({mode}) output {k}", [a], [r],
                                   [amax(r)], tol)
            w, rel = max(w, wk), rel + [rk]
        worst, rels = max(worst, w), rels + [f"{mode}: {' '.join(rel)}"]
        # per level: one power, the scans, the height increment, rho and T
        diag_b[mode] = bound(nbytes(d_in) + nbytes(ref), {"mtg": 30.0, "dry": 45.0, "moist": 55.0}[mode]
                             * s_now.numel())
    phase("check", f"fused_isentropic_diagnostics relative errors (p exn mtg h rho T) {' | '.join(rels)}")
    record("fused_isentropic_diagnostics", "diagnostics.cu", "tasmania_tpu/ops/diagnostics_step.py:103",
           worst, lambda: fused_isentropic_diagnostics(*d_in, mode="moist", **dkw),
           lambda: fused_isentropic_diagnostics_plain(*d_in, mode="moist", **dkw), diag_b["moist"],
           unit=" (moist)")
    for mode in ("mtg", "dry"):
        record_also("fused_isentropic_diagnostics", f"{mode}, 161x161x120",
                    lambda m=mode: fused_isentropic_diagnostics(*d_in, mode=m, **dkw),
                    lambda m=mode: fused_isentropic_diagnostics_plain(*d_in, mode=m, **dkw), diag_b[mode])

    # the unfused stage's three kernels at the mountain wave's shapes
    # (161x7x120: one interior row in y, v zero), third order, as phase 8
    # runs them
    mdom, mstate, mcore, mdiag, mpt = mw.build(
        MOUNTAIN_WAVE["nx"], MOUNTAIN_WAVE["nz"], theta_top=MOUNTAIN_WAVE["theta_top"],
        damp_depth=MOUNTAIN_WAVE["damp_depth"], damp_max=MOUNTAIN_WAVE["damp_max"],
        so=StorageOptions(dtype=torch.float32, device=device))
    mraw = {k: v.data for k, v in mstate.items() if k != "time"}
    mprog, mhb = mcore.prognostic, mdom.horizontal_boundary
    mcell = mraw["air_isentropic_density"].shape
    ms_now = mraw["air_isentropic_density"]
    mu, mv = perturbed(mraw["x_velocity_at_u_locations"], 0.05), mraw["y_velocity_at_v_locations"]
    ms_int = perturbed(ms_now)
    akw3 = dict(nb=mprog.nb, dt=MOUNTAIN_WAVE["dt"], dx=mprog.dx, dy=mprog.dy, order=3)
    a3 = (mu, mv, [ms_now], [ms_int])
    got = fused_advection_fields(*a3, **akw3)
    madv = fused_advection_fields_plain(*a3, **akw3)
    w, inc = check_increments("fused_advection_fields (order 3)", got, madv, [ms_now], KERNEL_TOL)
    phase("check", f"fused_advection_fields (order 3, {tuple(mcell)}) error as a share of the largest "
          f"increment {inc}")
    kernels["fused_advection_fields"]["max_abs_err"] = max(kernels["fused_advection_fields"]["max_abs_err"], w)
    record_also("fused_advection_fields", "order 3, s alone, 161x7x120",
                lambda: fused_advection_fields(*a3, **akw3), lambda: fused_advection_fields_plain(*a3, **akw3),
                bound(nbytes([mu, mv, ms_now, ms_int]) + nbytes(madv), 40.0 * ms_now.numel()))
    ms_e = mhb.enforce_field(madv[0], "air_isentropic_density")
    mhs = mcore.topography_steady
    mkw3 = dict(order=3, nb=mprog.nb, dt=MOUNTAIN_WAVE["dt"], dx=mprog.dx, dy=mprog.dy, eps=mprog.eps)
    mtg_args = (ms_e, mhs, mdiag.theta)
    mkd = dict(pt=mpt, dz=mdiag.dz, g=dkw["g"], cp=dkw["cp"], rd=dkw["rd"], pref=dkw["pref"], mode="mtg")
    got = fused_isentropic_diagnostics(*mtg_args, **mkd)
    mmtg = fused_isentropic_diagnostics_plain(*mtg_args, **mkd)
    w, rel = check_outputs("fused_isentropic_diagnostics (mtg, 161x7x120)", [got], [mmtg], [amax(mmtg)],
                           KERNEL_TOL)
    kernels["fused_isentropic_diagnostics"]["max_abs_err"] = max(
        kernels["fused_isentropic_diagnostics"]["max_abs_err"], w)
    record_also("fused_isentropic_diagnostics", "mtg, 161x7x120",
                lambda: fused_isentropic_diagnostics(*mtg_args, **mkd),
                lambda: fused_isentropic_diagnostics_plain(*mtg_args, **mkd),
                bound(nbytes(mtg_args) + nbytes([mmtg]), 30.0 * ms_now.numel()))
    m3 = (mu, mv, mraw["x_momentum_isentropic"], mraw["y_momentum_isentropic"],
          perturbed(mraw["x_momentum_isentropic"]), mraw["y_momentum_isentropic"],
          ms_now, mraw["montgomery_potential"], ms_e, mmtg)
    got = fused_momentum_step(*m3, **mkw3)
    ref = fused_momentum_step_plain(*m3, **mkw3)
    w, rel2 = check_outputs("fused_momentum_step (order 3, 161x7x120)", got, ref, [amax(*ref)] * 2,
                            KERNEL_TOL)
    kernels["fused_momentum_step"]["max_abs_err"] = max(kernels["fused_momentum_step"]["max_abs_err"], w)
    phase("check", f"at 161x7x120: fused_isentropic_diagnostics (mtg) relative error {rel}; "
          f"fused_momentum_step (order 3) relative errors (su sv) {rel2}")
    record_also("fused_momentum_step", "order 3, 161x7x120", lambda: fused_momentum_step(*m3, **mkw3),
                lambda: fused_momentum_step_plain(*m3, **mkw3),
                bound(nbytes(m3) + nbytes(ref), 150.0 * ms_now.numel()))
    phase("timing", f"profiler sessions with device time {profiler_sessions['recorded']}, "
          f"without {profiler_sessions['empty']}")
    del (fields, fulls, lo, hi, views, got, ref, stage_in, args, flat_in, kin, sin, vin, vq, din,
         adv_args, adv, mtg_e, mom_args, flat, base, q_now, s_int, state, raw, dycore, physics, domain,
         full1, lo1, hi1, st1, st2, got1, ref1, ms_args, d_in, mdom, mstate, mcore, mdiag, mraw, mu,
         mv, ms_int, a3, madv, ms_e, mhs, mtg_args, mmtg, m3)

    def drive(tag, run, nl_run, per_step, reference, tol_of, zero_tol):
        """One ``run(nl_run)`` from zeroed launch counts: every kernel
        launched exactly ``per_step`` times a step (none other), every field
        finite, and the validation numbers within the limits of the
        reference file's.  Returns the run's result and
        launch counts."""
        steps = 1 + nl_run.niter
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        res = run(nl_run)
        counts = dict(_lib.launch_counts)
        for name in sorted(set(per_step) | set(counts)):
            if counts.get(name, 0) != steps * per_step.get(name, 0):
                raise AssertionError(f"{tag}: {name} launched {counts.get(name, 0)} times, "
                                     f"expected {steps * per_step.get(name, 0)}")
        out = {k: fa.data.float().cpu().numpy() for k, fa in res["fields"].items()}
        bad = [k for k, a in out.items() if not np.isfinite(a).all()]
        if bad:
            raise AssertionError(f"{tag}: non-finite fields: {bad}")
        ref = json.loads(Path(drv.__file__).with_name(reference).read_text())
        diffs = compare_reference(tag, drv.validation_summary(out), ref, tol_of, zero_tol)
        phase(tag, f"{nl_run.nx}x{nl_run.ny}x{nl_run.nz}, 1+{nl_run.niter} steps: "
              f"{res['ms_per_step']:.3f} ms/step, {res['gps']:.4e} gridpoints/s on {card}; "
              f"launches {counts}")
        phase(f"{tag}-reference", diffs)
        return res, counts

    def sus(skip):
        return lambda n: drv.run(n, skip=skip, verbose=False)

    # -- 4. the first slice through its kernels --------------------------------
    drive("slice", sus(nl.slice_skip), nl, LAUNCHES_PER_STEP["slice"], "slice_reference.json",
          lambda key: SLICE_TOL, SLICE_TOL)

    # -- 5. the full flagship step through all seven kernels (the main path) ----
    res, counts = drive(
        "flagship", sus(()), nl, LAUNCHES_PER_STEP["sus"], "flagship_reference.json",
        lambda key: FLAGSHIP_QC_TOL if key.startswith("qc_") else FLAGSHIP_TOL, 0.0,
    )
    path_counts, path_steps = {"sus": counts}, {"sus": 1 + nl.niter}
    phase("validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} "
          f"(the TPU's: umax = {TPU_VALIDATION['umax']:.5f}, vmax = {TPU_VALIDATION['vmax']:.5f}; "
          "for information)")
    del res

    # -- 6. the full step on rain ----------------------------------------------
    rain_cfg = json.loads(Path(drv.__file__).with_name("flagship_rain_reference.json").read_text())["config"]
    nl_rain = load_namelist(relative_humidity=rain_cfg["relative_humidity"], niter=rain_cfg["niter"])
    drive("rain", sus(()), nl_rain, LAUNCHES_PER_STEP["sus"], "flagship_rain_reference.json",
          lambda key: RAIN_TOL, 0.0)

    # -- 7. the five other couplings (driver_isentropic_moist) ----------------
    for coupling in VARIANTS:
        reference = f"variant_{coupling}_reference.json"
        cfg = json.loads(Path(drv.__file__).with_name(reference).read_text())["config"]
        nl_v = moist.load_namelist(coupling, niter=cfg["niter"], relative_humidity=cfg["relative_humidity"])
        if (nl_v.nx, nl_v.ny, nl_v.nz) != (cfg["nx"], cfg["ny"], cfg["nz"]):
            raise AssertionError(f"{reference} is not at the flagship's size")
        res, counts = drive(
            coupling, lambda n, c=coupling: moist.run(n, c, verbose=False), nl_v,
            LAUNCHES_PER_STEP[coupling], reference, lambda key, c=coupling: variant_tol(c, key), 0.0,
        )
        path_counts[coupling], path_steps[coupling] = counts, 1 + nl_v.niter
        phase(f"{coupling}-validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} "
              "(for information)")
        del res

    # -- 8. the deep-domain mountain wave (the unfused dry stage) --------------
    mwc = MOUNTAIN_WAVE
    steps = int(round(mwc["hours"] * 3600.0 / mwc["dt"]))
    mref = json.loads(Path(mw.__file__).with_name("mountain_wave_reference.json").read_text())
    if (mref["config"]["nx"], mref["config"]["nz"], mref["config"]["steps"]) != (mwc["nx"], mwc["nz"], steps):
        raise AssertionError("mountain_wave_reference.json is not at phase 8's configuration")
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    res = mw.run_case(mwc["nx"], mwc["nz"], mwc["hours"], mwc["dt"], theta_top=mwc["theta_top"],
                      damp_depth=mwc["damp_depth"], damp_max=mwc["damp_max"],
                      so=StorageOptions(dtype=torch.float32, device=device), verbose=False)
    counts = dict(_lib.launch_counts)
    per_step = LAUNCHES_PER_STEP["mountain_wave"]
    for name in sorted(set(per_step) | set(counts)):
        if counts.get(name, 0) != steps * per_step.get(name, 0):
            raise AssertionError(f"mountain wave: {name} launched {counts.get(name, 0)} times, "
                                 f"expected {steps * per_step.get(name, 0)}")
    bad = [k for k, fa in res["fields"].items() if not bool(torch.isfinite(fa.data).all())]
    if bad:
        raise AssertionError(f"mountain wave: non-finite fields: {bad}")
    lo_amp, hi_amp = MW_GATE["amplitude_ratio_2a"]
    if not (res["corr_2a"] >= MW_GATE["corr_2a"] and res["corr_4a"] >= MW_GATE["corr_4a"]
            and lo_amp < res["amplitude_ratio_2a"] < hi_amp):
        raise AssertionError(f"mountain wave: analytic gate failed: corr_2a {res['corr_2a']}, "
                             f"corr_4a {res['corr_4a']}, amplitude ratio {res['amplitude_ratio_2a']}")
    diffs = []
    for key, tol in {**MW_ABS_TOL, **MW_REL_TOL}.items():
        dev = abs(res[key] - mref[key]) / (abs(mref[key]) if key in MW_REL_TOL else 1.0)
        diffs.append(f"{key}={res[key]:.7g}({dev:.1e})")
        if not dev <= tol:
            raise AssertionError(f"mountain wave {key}: {res[key]} vs reference {mref[key]} "
                                 f"(deviation {dev:.2e} > {tol})")
    phase("mountain-wave", f"{mwc['nx']}x1x{mwc['nz']} (numerical {mwc['nx']}x7x{mwc['nz']}), "
          f"theta top {mwc['theta_top']} K, damping depth {mwc['damp_depth']}, {steps} steps of "
          f"{mwc['dt']} s: {res['ms_per_step']:.3f} ms/step on {card}; launches {counts}")
    phase("mountain-wave-gate", f"corr_2a {res['corr_2a']:.4f} (>= {MW_GATE['corr_2a']}), corr_3a "
          f"{res['corr_3a']:.4f}, corr_4a {res['corr_4a']:.4f} (>= {MW_GATE['corr_4a']}), amplitude "
          f"ratio {res['amplitude_ratio_2a']:.4f} in ({lo_amp}, {hi_amp}); corr_focused "
          f"{res['corr_focused']:.4f}, rms_err_focused {res['rms_err_focused']:.4g}")
    phase("mountain-wave-reference", " ".join(diffs))
    path_counts["mountain_wave"], path_steps["mountain_wave"] = counts, steps
    del res

    # each kernel's launches in the full-size run of the first path that runs
    # it (the flagship for the seven of the SUS chain), and in every path; the
    # single paste and the Smagorinsky stage alone are on no path
    for name, entry in kernels.items():
        entry["path"] = next((p for p, n in path_counts.items() if n.get(name, 0)), None)
        entry["launches"] = path_counts[entry["path"]][name] if entry["path"] else 0
        entry["launches_per_step_by_path"] = {
            p: n.get(name, 0) / path_steps[p] for p, n in path_counts.items()
        }
    print(json.dumps({"kernels": [{"name": n, **e} for n, e in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
