"""Each flagship kernel's achieved bandwidth against the card's practical
copy rate (counterpart of ``drivers/driver_roofline.py``).

The eleven cases of the JAX roofline (``drivers/driver_roofline.py:80-257``)
on the port's wrappers (``tasmania_tpu_torch/ops/``), at 161x161x120
float32 by default, on seeded inputs in the JAX driver's ranges (the
sedimentation's density and interface heights a stable column instead of
sorted noise): the advection of s and water (#5), the momentum epilogue
(#7), the isentropic diagnostics in the moist and Montgomery modes (#16),
the whole semi-implicit stage (#1), vertical advection (#14), smoothing
(#3), sedimentation (#17), Smagorinsky RK2 (#12), Kessler (#8) and
saturation adjustment (#10).  Each row: the device time of a call
(``kernel_timing.device_ms``: the profiler's device time, else CUDA
events, which the row says), the unique bytes the JAX rule counts, GB/s,
the ideal time at the copy rate, the share of the copy rate and of the
data sheet's 3.35 TB/s (a spec), the working set and the input copies
called in turn (``kernel_timing.measure``).  The copy rate is
``kernel_timing.copy_rate``: the median of 5 runs of ``x + 1.0`` over a
buffer of sixteen times a field, with its range.  The JAX driver's
slope-timed ``fori_loop`` cancels a remote call's fixed cost and its
16·nx buffer gets past the TPU's VMEM; here the card's own device time
serves, and the same buffer is four times the H100's L2.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_roofline [--nx 161] [--nz 120] [--out PATH]
        [--device cuda|cpu]

``--out`` writes the copy rate and the rows as JSON to PATH.  The device
defaults to ``cuda``; without a GPU the tool exits unless ``--device cpu``
is given (the wrappers then run their plain versions, timed on the host
clock).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device
from tasmania_tpu_torch.drivers.kernel_timing import (
    REPS,
    Case,
    copy_rate,
    measure,
    nbytes,
    report,
    unique_bytes,
)
from tasmania_tpu_torch.ops.advection_step import fused_advection_fields, fused_momentum_epilogue
from tasmania_tpu_torch.ops.diagnostics_step import fused_isentropic_diagnostics
from tasmania_tpu_torch.ops.kessler_step import KesslerConstants, fused_kessler_rk2, fused_satadj_rk2
from tasmania_tpu_torch.ops.sedimentation_step import fused_sedimentation_rk3ws
from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage
from tasmania_tpu_torch.ops.smagorinsky_step import fused_smagorinsky_rk2
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing
from tasmania_tpu_torch.ops.vertical_advection_step import fused_vertical_advection_rk3ws

NX = NY = 161
NZ = 120
NB = 3
DT = 5.0
DX = DY = 2200.0
DD = 15  # si_stage's damping depth
SEED = 0
DIAG = dict(pt=2000.0, dz=1.0, g=9.80665, cp=1004.0, rd=287.05, pref=1.0e5)


def inputs(device, nx: int = NX, ny: int = NY, nz: int = NZ, seed: int = SEED) -> Dict[str, torch.Tensor]:
    """The cases' operands (``drivers/driver_roofline.py:110-134``), float32
    on ``device``, from one seeded generator."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def mk(*shape, lo=0.5, hi=1.5):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    f3 = (nx, ny, nz)
    t = dict(u=mk(nx + 1, ny, nz), v=mk(nx, ny + 1, nz), s=mk(*f3, lo=5.0, hi=10.0),
             si=mk(*f3, lo=5.0, hi=10.0))
    for tag in ("qn", "qi"):
        for i in range(3):
            t[f"{tag}{i}"] = mk(*f3, lo=0.0, hi=1e-3)
    t.update(su=mk(*f3), sv=mk(*f3), sui=mk(*f3), svi=mk(*f3), mtg=mk(*f3, lo=1e5, hi=3e5),
             mtg2=mk(*f3, lo=1e5, hi=3e5))
    gamma = torch.zeros(nx, ny, device=device)
    gamma[:NB] = 0.5
    gamma[-NB:] = 0.5
    t["gamma"] = gamma
    t["rmat"] = mk(nz, lo=0.0, hi=0.1)
    rmat_dd = t["rmat"].clone()
    rmat_dd[DD:] = 0.0  # the stage damps the top DD levels only
    t["rmat_dd"] = rmat_dd
    t["hs"] = mk(nx, ny, lo=0.0, hi=500.0)
    t["theta"] = torch.linspace(400.0, 280.0, nz + 1, device=device)
    t.update(t_air=mk(*f3, lo=230.0, hi=300.0), p_if=mk(nx, ny, nz + 1, lo=2e4, hi=1e5),
             exn_if=mk(nx, ny, nz + 1, lo=700.0, hi=1004.0), rho_k=mk(*f3, lo=0.1, hi=1.2))
    # a stable column for the sedimentation: interface heights from 12 km
    # down to 0 with a jitter of a quarter spacing, the density falling
    # with height by a scale of 8 km
    dh = 1.2e4 / nz
    h_if = torch.linspace(1.2e4, 0.0, nz + 1, device=device).expand(nx, ny, nz + 1).clone()
    h_if[..., 1:-1] += mk(nx, ny, nz - 1, lo=-0.25 * dh, hi=0.25 * dh)
    t["h_if"] = h_if
    t["rho"] = 1.2 * torch.exp(-0.5 * (h_if[..., :-1] + h_if[..., 1:]) / 8000.0) * mk(*f3, lo=0.99, hi=1.01)
    t["w"] = mk(*f3, lo=-0.01, hi=0.01)
    t["gsm"] = mk(6, nz, lo=0.0, hi=0.5)
    return t


def pick(t: Dict[str, torch.Tensor], *names: str) -> Dict[str, torch.Tensor]:
    return {n: t[n] for n in names}


def build_cases(device, nx: int = NX, ny: int = NY, nz: int = NZ, seed: int = SEED) -> List[Case]:
    """The eleven cases, each with its unique bytes as
    ``drivers/driver_roofline.py`` counts them."""
    t = inputs(device, nx, ny, nz, seed)
    s = t["s"]
    cell = nbytes(s)
    q = ("qn0", "qn1", "qn2")
    qi = ("qi0", "qi1", "qi2")
    stage = StageConstants(dt=DT, dtf=DT, dx=DX, dy=DY, eps=0.5, **DIAG)
    kc = KesslerConstants(beta=0.622, lhvw=2.5e6, cp=1004.0, rv=461.5, dt=DT, a=5e-4, k1=1e-3, k2=2.2)
    sc = KesslerConstants(beta=0.622, lhvw=2.5e6, cp=1004.0, rv=461.5, dt=DT, sr=0.5)

    def qs(a, names):
        return [a[n] for n in names]

    cases = [
        Case("advection_fields (4 fields, q product, boundary)", "fused_advection_fields", 5,
             "advection_fields(4f,q_product,bc)", pick(t, "u", "v", "s", "si", "gamma", *q, *qi),
             lambda a: fused_advection_fields(
                 a["u"], a["v"], [a["s"], *qs(a, q)], [a["si"], *qs(a, qi)], None, a["gamma"], a["s"],
                 nb=NB, dt=DT, dx=DX, dy=DY, q_product=(False, True, True, True), order=5),
             unique_bytes(t["u"], t["v"], s, t["si"], *qs(t, q), *qs(t, qi), s) + 4 * cell),
        Case("momentum_epilogue (6 fields out)", "fused_momentum_epilogue", 7, "momentum_epilogue(6f out)",
             pick(t, "u", "v", "su", "sv", "sui", "svi", "s", "mtg", "si", "mtg2", "gamma", "rmat", *q, *qi),
             lambda a: fused_momentum_epilogue(
                 a["u"], a["v"], a["su"], a["sv"], a["sui"], a["svi"], a["s"], a["mtg"], a["si"], a["mtg2"],
                 qs(a, q), a["gamma"], a["s"], a["su"], a["sv"], qs(a, qi), a["rmat"], nb=NB, c=stage,
                 order=5),
             unique_bytes(*(t[n] for n in ("u", "v", "su", "sv", "sui", "svi", "s", "mtg", "si", "mtg2")),
                          *qs(t, q), *qs(t, qi)) + 6 * cell),
        Case("isentropic_diagnostics (moist)", "fused_isentropic_diagnostics", 16,
             "diagnostics(moist,MXU scans)", pick(t, "s", "hs", "theta"),
             lambda a: fused_isentropic_diagnostics(a["s"], a["hs"], a["theta"], mode="moist", **DIAG),
             unique_bytes(s, t["hs"]) + 4 * cell + 2 * nx * ny * (nz + 1) * s.element_size()),
        Case("si_stage (whole stage, 6 fields out)", "si_stage", 1, "si_stage(whole stage, 6f out)",
             pick(t, "u", "v", "s", "si", "su", "sv", "sui", "svi", "mtg", "hs", "theta", "gamma",
                  "rmat_dd", *q, *qi),
             lambda a: si_stage(
                 a["u"], a["v"], a["s"], a["si"], qs(a, q), qs(a, qi), a["su"], a["sv"], a["sui"],
                 a["svi"], a["mtg"], a["hs"], a["theta"], a["gamma"], a["si"], a["su"], a["sv"], qs(a, q),
                 a["rmat_dd"], nb=NB, c=stage, dd=DD, order=5),
             unique_bytes(*(t[n] for n in ("u", "v", "s", "si")), *qs(t, q), *qs(t, qi),
                          *(t[n] for n in ("su", "sv", "sui", "svi", "mtg")))
             + int(0.2 * cell) + 6 * cell),
        Case("isentropic_diagnostics (Montgomery only)", "fused_isentropic_diagnostics", 16,
             "montgomery(per-stage scan)", pick(t, "s", "hs", "theta"),
             lambda a: fused_isentropic_diagnostics(a["s"], a["hs"], a["theta"], mode="mtg", **DIAG),
             unique_bytes(s, t["hs"]) + cell),
        Case("vertical_advection_rk3ws (6 fields)", "fused_vertical_advection_rk3ws", 14,
             "vertical_advection_rk3ws(6f)", pick(t, "w", "s", "su", "sv", *q),
             lambda a: fused_vertical_advection_rk3ws(a["w"], a["s"], a["su"], a["sv"], qs(a, q), order=3,
                                                      dt=DT, dz=1.0),
             unique_bytes(t["w"], s, t["su"], t["sv"], *qs(t, q)) + 6 * cell),
        Case("smoothing (6 fields, order 2)", "fused_smoothing", 3, "smoothing(6f,order2)",
             pick(t, "s", "su", "sv", "gsm", *q),
             lambda a: fused_smoothing([a["s"], a["su"], a["sv"], *qs(a, q)], a["gsm"], order=2, nb=NB),
             unique_bytes(s, t["su"], t["sv"], *qs(t, q)) + 6 * cell),
        Case("sedimentation_rk3ws", "fused_sedimentation_rk3ws", 17, "sedimentation_rk3ws",
             pick(t, "rho", "h_if", "qn2"),
             lambda a: fused_sedimentation_rk3ws(a["rho"], a["h_if"], a["qn2"], order=2, dt=DT),
             unique_bytes(t["rho"], t["h_if"], t["qn2"]) + 2 * cell),
        # two stages, each counted as reading (s, su_st, sv_st, su, sv) and
        # writing 2 (the JAX driver's honest denominator of the wrapper)
        Case("smagorinsky_rk2 (2 stages)", "fused_smagorinsky_rk2", 12, "smagorinsky_rk2(2 stages)",
             pick(t, "s", "su", "sv"),
             lambda a: fused_smagorinsky_rk2(a["s"], a["su"], a["sv"], dx=DX, dy=DY, cs=0.18, nb=NB, dt=DT),
             2 * (5 * cell + 2 * cell)),
        Case("kessler_rk2", "fused_kessler_rk2", 8, "kessler_rk2",
             pick(t, "rho_k", "t_air", "p_if", "exn_if", *q),
             lambda a: fused_kessler_rk2(a["rho_k"], a["t_air"], a["p_if"], a["exn_if"], *qs(a, q), kc),
             unique_bytes(t["rho_k"], t["t_air"], t["p_if"], t["exn_if"], *qs(t, q)) + 4 * cell),
        Case("satadj_rk2", "fused_satadj_rk2", 10, "satadj_rk2",
             pick(t, "t_air", "p_if", "exn_if", "qn0", "qn1", "w"),
             lambda a: fused_satadj_rk2(a["t_air"], a["p_if"], a["exn_if"], a["qn0"], a["qn1"], a["w"], sc),
             unique_bytes(t["t_air"], t["p_if"], t["exn_if"], t["qn0"], t["qn1"], t["w"]) + 3 * cell),
    ]
    return cases


def roofline(device="cuda", nx: int = NX, ny: int = NY, nz: int = NZ, reps: int = REPS) -> Dict[str, Any]:
    """The copy rate and a row for each case, the case furthest below the
    copy rate (``worst``) and the largest share (``largest_share_pct``)."""
    check_device(device)
    copy = copy_rate((nx, ny, nz), device)
    rows = [measure(c, device, copy["gbs"], reps) for c in build_cases(device, nx, ny, nz)]
    worst = min(rows, key=lambda r: r["share_of_copy_pct"])
    return dict(grid=[nx, ny, nz], copy=copy, rows=rows, worst=worst["name"],
                largest_share_pct=max(r["share_of_copy_pct"] for r in rows))


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0],
                                     epilog=f"The JAX driver's --nt (its loop's length) has no counterpart: "
                                            f"each case is timed over {REPS} calls.")
    parser.add_argument("--nx", type=int, default=NX, help="nx and ny")
    parser.add_argument("--nz", type=int, default=NZ)
    parser.add_argument("--out", type=str, default=None, metavar="PATH",
                        help="write the copy rate and the rows as JSON to PATH")
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    res = roofline(cli.device, cli.nx, cli.nx, cli.nz)
    where = torch.cuda.get_device_name(0) if torch.device(cli.device).type == "cuda" else "cpu"
    print(report(f"roofline on {where}, {cli.nx}x{cli.nx}x{cli.nz} float32", res["copy"], res["rows"]))
    print(f"furthest below the copy rate: {res['worst']}")
    if cli.out:
        Path(cli.out).write_text(json.dumps({**res, "device": where}, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()
