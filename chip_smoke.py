"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one line; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``); a CUDA device is required;
2. build the hand-written CUDA kernels from ``tasmania_tpu_torch/csrc``;
3. each of the seven kernels at the flagship shapes (161x161x120 float32) on
   perturbed real states against its plain PyTorch version on the same
   inputs, with the device time of one call of each (``device_ms``: the
   device operations' time over 20 calls under ``torch.profiler``, so ``ms``
   is device time and not the wrapper's host time; a session that records
   no device time is repeated, and after three such the time is taken with
   CUDA events and the kernel's ``timed_by`` says so),
   the bytes it must move and its bound at 3.35 TB/s.  Tolerances, as a share
   of the largest magnitude of the plain output (su and sv both of the
   momentum vector's): paste bitwise; smoothing 1e-6; each of the three RK3WS
   stages of si_stage (damping on the last) 1e-5 (FMA contraction in the
   stencils moves the float32 Montgomery potential by a few units of its
   last place, which reaches the momenta through the pressure gradient);
   Kessler + saturation adjustment and sedimentation 1e-5 (the same algebra;
   FMA contraction, and PyTorch dividing by a scalar as a product with the
   reciprocal on the card, move the last bits of each stage, and the powers
   and exponentials come from the same CUDA math library in both).
   Smagorinsky and vertical advection add small updates to large momenta, so
   each of their outputs is held to 1e-5 of its largest update plus 4 float32
   ulps of its magnitude (the rounding of the result; su's ulp is 4.9e-4,
   about 0.1% of its Smagorinsky update here);
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
   number.

The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them is a JSON summary of
the kernels, their launches in phase 5 (the main path) and their times.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TPU_VALIDATION = {"umax": 23.62408, "vmax": 1.07557}  # BENCH_NOTES.json "current"


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

    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.steppers import TendencyStepper
    from tasmania_tpu_torch.isentropic.physics.turbulence import IsentropicSmagorinsky
    from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
    from tasmania_tpu_torch.isentropic.utils import AirPotentialTemperatureToTendency
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.ops.kessler_step import (
        KesslerConstants,
        fused_kessler_satadj_rk2,
        fused_kessler_satadj_rk2_plain,
    )
    from tasmania_tpu_torch.ops.paste import paste_x_edges_multi, paste_x_edges_multi_plain
    from tasmania_tpu_torch.ops.sedimentation_step import (
        fused_sedimentation_rk3ws,
        fused_sedimentation_rk3ws_plain,
    )
    from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage, si_stage_plain
    from tasmania_tpu_torch.ops.smagorinsky_step import (
        fused_smagorinsky_rk2,
        fused_smagorinsky_rk2_plain,
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
    phase("timing", f"profiler sessions with device time {profiler_sessions['recorded']}, "
          f"without {profiler_sessions['empty']}")
    del (fields, fulls, lo, hi, views, got, ref, stage_in, args, flat_in, kin, sin, vin, vq, din,
         state, raw, dycore, physics, domain)

    def drive(tag, nl_run, skip, expected, reference, tol_of, zero_tol):
        """One ``drv.run`` from zeroed launch counts: each kernel in
        ``expected`` launched exactly that often and paste at least once,
        every field finite, and the validation numbers within the limits of
        the reference file's.  Returns the run's result and launch counts."""
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        res = drv.run(nl_run, skip=skip, verbose=False)
        counts = dict(_lib.launch_counts)
        for name, n in expected.items():
            if counts.get(name, 0) != n:
                raise AssertionError(f"{tag}: {name} launched {counts.get(name, 0)} times, expected {n}")
        if counts.get("paste_x_edges_multi", 0) <= 0:
            raise AssertionError(f"{tag}: paste_x_edges_multi was never launched")
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

    def full_chain_launches(steps):
        return {
            "si_stage": 3 * steps, "fused_smoothing": steps, "fused_smagorinsky_rk2": 2 * steps,
            "fused_kessler_satadj_rk2": steps, "fused_vertical_advection_rk3ws": steps,
            "fused_sedimentation_rk3ws": steps,
        }

    # -- 4. the first slice through its kernels --------------------------------
    steps = 1 + nl.niter
    drive("slice", nl, nl.slice_skip, {"si_stage": 3 * steps, "fused_smoothing": steps},
          "slice_reference.json", lambda key: SLICE_TOL, SLICE_TOL)

    # -- 5. the full flagship step through all seven kernels (the main path) ----
    res, counts = drive(
        "flagship", nl, (), full_chain_launches(steps), "flagship_reference.json",
        lambda key: FLAGSHIP_QC_TOL if key.startswith("qc_") else FLAGSHIP_TOL, 0.0,
    )
    phase("validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} "
          f"(the TPU's: umax = {TPU_VALIDATION['umax']:.5f}, vmax = {TPU_VALIDATION['vmax']:.5f}; "
          "for information)")
    del res

    # -- 6. the full step on rain ----------------------------------------------
    rain_cfg = json.loads(Path(drv.__file__).with_name("flagship_rain_reference.json").read_text())["config"]
    nl_rain = load_namelist(relative_humidity=rain_cfg["relative_humidity"], niter=rain_cfg["niter"])
    drive("rain", nl_rain, (), full_chain_launches(1 + nl_rain.niter), "flagship_rain_reference.json",
          lambda key: RAIN_TOL, 0.0)

    for name, entry in kernels.items():
        entry["launches"] = counts.get(name, 0)
    print(json.dumps({"kernels": [{"name": n, **e} for n, e in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
