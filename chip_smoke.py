"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one line; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``); a CUDA device is required;
2. build the hand-written CUDA kernels from ``tasmania_tpu_torch/csrc``;
3. each kernel at the slice's shapes in float32 against its plain PyTorch
   version on the same inputs: paste bitwise, smoothing within
   1e-6·max|plain|, each of the three RK3WS stages (damping on the last)
   within 1e-5·max|plain| per output, su and sv both against the larger of
   the two (FMA contraction in the stencils moves the float32 Montgomery
   potential by a few units of its last place, which reaches the momentum
   vector through the pressure gradient); median times by CUDA events;
4. the slice at the flagship configuration (161x161x120, 1 + 100 steps of
   dycore -> diagnostics -> smoothing -> velocities) through the kernels:
   launch counts, finiteness, and agreement with the JAX package's result
   (``tasmania_tpu_torch/drivers/slice_reference.json``) to 1e-4 relative.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REF_TOL = 1e-4


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` by CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, ref):
    """(max|got-ref|, max|ref|) over matching tensors."""
    return float((got - ref).abs().max()), float(ref.abs().max())


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
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.ops.paste import paste_x_edges_multi, paste_x_edges_multi_plain
    from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage, si_stage_plain
    from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _lib.lib()
    info = _lib.build_info
    ptxas = [ln.strip() for ln in info["log"].splitlines() if "registers" in ln]
    phase("build", f"{time.perf_counter() - t0:.1f} s (nvcc {info['seconds']:.1f} s, "
          f"cached={info['cached']}) -> {info['path']}; ptxas: {' | '.join(ptxas)}")

    # -- 3. kernels against their plain versions at the slice's shapes ---------
    nl = load_namelist(so=StorageOptions(dtype=torch.float32, device=device))
    domain, state, pt = drv.build_domain_and_state(nl)
    dycore, physics = drv.build_model(nl, domain, pt, nl.slice_skip)
    smoother = physics.components[1]
    prog = dycore.prognostic
    rng = np.random.default_rng(1234)

    def perturbed(t, rel=1e-3):
        noise = torch.as_tensor(rng.standard_normal(tuple(t.shape)), dtype=t.dtype, device=device)
        return t * (1.0 + rel * noise)

    raw = {k: v.data for k, v in state.items() if k != "time"}
    qn = list(prog.q_names)
    hb = domain.horizontal_boundary
    s_now, su_now, sv_now = (raw[n] for n in ("air_isentropic_density",
                                               "x_momentum_isentropic", "y_momentum_isentropic"))
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
    kernels = {}

    # si_stage: the three stages, damping on the last
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
        # su and sv are the components of one momentum vector: both are held
        # to the vector's scale (the f32 rounding of the Montgomery potential,
        # ~0.03 at 3.7e5, enters both through the pressure gradient, and sv
        # alone is small in a flow along x)
        momentum = max(float(ref[1].abs().max()), float(ref[2].abs().max()))
        for k, (a, b) in enumerate(zip(got, ref)):
            e, m = max_err(a, b)
            if k in (1, 2):
                m = momentum
            errs.append(f"s{stage}o{k}={e / m if m else e:.1e}")
            if not (e <= 1e-5 * m) or not torch.isfinite(a).all():
                raise AssertionError(f"si_stage stage {stage} output {k}: max|d|={e} > 1e-5*{m}")
            worst = max(worst, e)
    kernels["si_stage"] = dict(
        route="cuda", source="tasmania_tpu_torch/csrc/si_stage.cu",
        replaces="tasmania_tpu/ops/si_stage.py:146", max_abs_err=worst,
        ms=median_ms(lambda: si_stage(*args, nb=nl.nb, c=c, dd=dd)),
        plain_ms=median_ms(lambda: si_stage_plain(*args, nb=nl.nb, c=c, dd=dd)),
    )
    phase("kernel", f"si_stage rel errors {' '.join(errs)}; {kernels['si_stage']['ms']:.3f} ms "
          f"(plain {kernels['si_stage']['plain_ms']:.3f} ms) per stage")

    # smoothing on the six smoothed fields
    names = list(smoother.input_properties)
    fields = [perturbed(raw[n]) for n in names]
    got = fused_smoothing(fields, smoother.gamma, order=smoother.order, nb=smoother.nb)
    ref = fused_smoothing_plain(fields, smoother.gamma, order=smoother.order, nb=smoother.nb)
    worst = 0.0
    for n, a, b in zip(names, got, ref):
        e, m = max_err(a, b)
        if not e <= 1e-6 * m:
            raise AssertionError(f"fused_smoothing {n}: max|d|={e} > 1e-6*{m}")
        worst = max(worst, e)
    kernels["fused_smoothing"] = dict(
        route="cuda", source="tasmania_tpu_torch/csrc/smoothing.cu",
        replaces="tasmania_tpu/ops/smoothing_step.py:44", max_abs_err=worst,
        ms=median_ms(lambda: fused_smoothing(fields, smoother.gamma, order=smoother.order, nb=smoother.nb)),
        plain_ms=median_ms(lambda: fused_smoothing_plain(fields, smoother.gamma, order=smoother.order, nb=smoother.nb)),
    )
    phase("kernel", f"fused_smoothing max|d| {worst:.3e}; {kernels['fused_smoothing']['ms']:.3f} ms "
          f"(plain {kernels['fused_smoothing']['plain_ms']:.3f} ms)")

    # paste: six arrays, nb-wide strips, bitwise
    nb = nl.nb
    fulls = [f.clone() for f in fields]
    lo = [perturbed(f[:nb].contiguous()) for f in fields]
    hi = [perturbed(f[-nb:].contiguous()) for f in fields]
    got = paste_x_edges_multi([f.clone() for f in fulls], lo, hi)
    ref = paste_x_edges_multi_plain([f.clone() for f in fulls], lo, hi)
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            raise AssertionError("paste_x_edges_multi differs from its plain version")
    kernels["paste_x_edges_multi"] = dict(
        route="cuda", source="tasmania_tpu_torch/csrc/paste.cu",
        replaces="tasmania_tpu/ops/paste.py:67", max_abs_err=0.0,
        ms=median_ms(lambda: paste_x_edges_multi(fulls, lo, hi)),
        plain_ms=median_ms(lambda: paste_x_edges_multi_plain(fulls, lo, hi)),
    )
    phase("kernel", f"paste_x_edges_multi bitwise; {kernels['paste_x_edges_multi']['ms']:.3f} ms "
          f"(plain {kernels['paste_x_edges_multi']['plain_ms']:.3f} ms)")
    del fields, fulls, lo, hi, got, ref, stage_in, args, state, raw, dycore, physics, domain

    # -- 4. the slice through the kernels ---------------------------------------
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    res = drv.run(nl, verbose=False)
    counts = dict(_lib.launch_counts)
    steps = 1 + nl.niter
    expected = {"si_stage": 3 * steps, "fused_smoothing": steps}
    for name, n in expected.items():
        if counts.get(name, 0) != n:
            raise AssertionError(f"{name} launched {counts.get(name, 0)} times, expected {n}")
    if counts.get("paste_x_edges_multi", 0) <= 0:
        raise AssertionError("paste_x_edges_multi was never launched")
    out = {k: fa.data.float().cpu().numpy() for k, fa in res["fields"].items()}
    bad = [k for k, a in out.items() if not np.isfinite(a).all()]
    if bad:
        raise AssertionError(f"non-finite fields: {bad}")
    ref = json.loads(Path(drv.__file__).with_name("slice_reference.json").read_text())
    got = drv.validation_summary(out)
    diffs = []
    for key, val in got.items():
        rel = abs(val - ref[key]) / abs(ref[key]) if ref[key] else abs(val)
        diffs.append(f"{key}={val:.7g}({rel:.1e})")
        if rel > REF_TOL:
            raise AssertionError(f"{key}: {val} vs reference {ref[key]} (relative {rel:.2e})")
    phase("slice", f"{nl.nx}x{nl.ny}x{nl.nz}, 1+{nl.niter} steps: {res['ms_per_step']:.3f} ms/step, "
          f"{res['gps']:.4e} gridpoints/s on {card}; launches {counts}")
    phase("reference", " ".join(diffs))

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
