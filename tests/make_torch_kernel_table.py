"""The table of the JAX package's 17 TPU kernels for ``PERF.md``.

For each function that reaches ``pl.pallas_call`` in ``tasmania_tpu/ops/``:
the bytes it must move at the flagship shapes (161x161x120 float32; each
input read once, each output written once, from the arrays of its signature
as the flagship or its nearest caller passes them; the two kernels of the
tendency-carrying stage with the tendencies the fc and lfc couplings pass)
and that traffic's time at the H100's 3.35 TB/s.  Given the log of a
``chip_smoke.py`` run, it adds for each ported kernel its route and source,
its launches per step on each path that runs it (the full-size runs of
phases 5, 7 and 8: the flagship's SUS chain, the five other couplings and
the mountain wave) and the times that run measured on the card: kernel,
plain version and, where one exists, the single PyTorch call computing the
same function; a kernel timed also at other shapes or in other modes
(``also`` in the log: the mountain wave's 161x7x120, the diagnostics'
modes) gets a row for each, with the bytes and bound of those shapes.

Usage: ``python tests/make_torch_kernel_table.py [CHIP_SMOKE_LOG]``
"""

from __future__ import annotations

import json
import sys

NX, NY, NZ, NB = 161, 161, 120, 3
F32 = 4
CELL = NX * NY * NZ * F32
IFACE = NX * NY * (NZ + 1) * F32
U = (NX + 1) * NY * NZ * F32
V = NX * (NY + 1) * NZ * F32
PLANE = NX * NY * F32
STRIP = NB * NY * NZ * F32
HBM = 3.35e12

# (number, def, name in chip_smoke or None while not ported, bytes read,
#  bytes written, what the arrays are)
KERNELS = [
    (1, "ops/si_stage.py:146 fused_si_stage", "si_stage",
     19 * CELL + U + V + 2 * PLANE + (NZ + 1) * F32 + NZ * F32, 6 * CELL,
     "u, v, 19 cell fields (now, int, refs, mtg), hs, gamma, theta, rmat -> s, su, sv, 3 q"),
    (2, "ops/paste.py:67 paste_x_edges_multi", "paste_x_edges_multi",
     12 * STRIP, 12 * STRIP, "6 arrays: 2 nb-wide strips each in, the same out"),
    (3, "ops/smoothing_step.py:44 fused_smoothing", "fused_smoothing",
     6 * CELL, 6 * CELL, "6 fields in, 6 out"),
    (4, "ops/paste.py:23 paste_x_edges", "paste_x_edges", 2 * STRIP, 2 * STRIP,
     "1 array: 2 strips in, 2 out"),
    (5, "ops/advection_step.py:140 fused_advection_fields", "fused_advection_fields",
     13 * CELL + U + V + PLANE, 4 * CELL,
     "u, v, s and 3 q now, int and tendency, gamma, ref -> 4 fields"),
    (6, "ops/advection_step.py:282 fused_momentum_step", "fused_momentum_step",
     8 * CELL + U + V, 2 * CELL, "u, v, su/sv now and int, s and mtg now and new -> su, sv"),
    (7, "ops/advection_step.py:422 fused_momentum_epilogue", "fused_momentum_epilogue",
     19 * CELL + U + V + PLANE + NZ * F32, 6 * CELL,
     "u, v, 8 momentum-step fields, 3 sq, 6 refs, su and sv tendencies, gamma, rmat "
     "-> su, sv, s, 3 q"),
    (8, "ops/kessler_step.py:39 fused_kessler_rk2", "fused_kessler_rk2",
     5 * CELL + 2 * IFACE, 4 * CELL, "rho, T, qv, qc, qr, p_if, exn_if -> qv, qc, qr, theta tendency"),
    (9, "ops/kessler_step.py:111 fused_kessler_satadj_rk2", "fused_kessler_satadj_rk2",
     5 * CELL + 2 * IFACE, 4 * CELL, "rho, T, qv, qc, qr, p_if, exn_if -> qv, qc, qr, theta tendency"),
    (10, "ops/kessler_step.py:204 fused_satadj_rk2", "fused_satadj_rk2",
     4 * CELL + 2 * IFACE, 3 * CELL, "T, qv, qc, theta tendency, p_if, exn_if -> qv, qc, theta tendency"),
    (11, "ops/smagorinsky_step.py:33 _smag_stage", "smag_stage",
     5 * CELL, 2 * CELL, "s, su and sv of the stage and the base -> su, sv"),
    (12, "ops/smagorinsky_step.py:149 _smag_rk2_fused", "fused_smagorinsky_rk2",
     3 * CELL, 2 * CELL, "s, su, sv -> su, sv"),
    (13, "ops/smagorinsky_step.py:303 fused_smoothing_smagorinsky_rk2", None,
     6 * CELL, 6 * CELL, "6 fields in, 6 out"),
    (14, "ops/vertical_advection_step.py:158 fused_vertical_advection_rk3ws",
     "fused_vertical_advection_rk3ws", 7 * CELL, 6 * CELL,
     "w, s, su, sv, qv, qc, qr -> 6 fields"),
    (15, "ops/vertical_advection_step.py:242 fused_vadv_sedimentation_rk3ws", None,
     8 * CELL + IFACE, 7 * CELL, "w, s, su, sv, 3 q, rho, h_if -> 6 fields, vt"),
    (16, "ops/diagnostics_step.py:103 fused_isentropic_diagnostics", "fused_isentropic_diagnostics",
     CELL + PLANE + (NZ + 1) * F32, 3 * IFACE + 3 * CELL, "s, hs, theta -> p, exn, h, mtg, rho, T"),
    (17, "ops/sedimentation_step.py:123 fused_sedimentation_rk3ws", "fused_sedimentation_rk3ws",
     2 * CELL + IFACE, 2 * CELL, "rho, qr, h_if -> qr, vt"),
]


def chip_kernels(log_path):
    """The ``{"kernels": [...]}`` line of a chip_smoke.py log, by name."""
    with open(log_path) as f:
        for line in f:
            if line.startswith('{"kernels"'):
                return {k["name"]: k for k in json.loads(line)["kernels"]}
    raise ValueError(f"no kernels line in {log_path}")


def fmt(x, digits=3):
    return "—" if x is None else f"{x:.{digits}f}"


def launches(k) -> str:
    """Launches per step on each path that runs the kernel."""
    per_step = k["launches_per_step_by_path"]
    return " · ".join(f"{p} {n:g}" for p, n in per_step.items() if n) or "0"


def main(argv) -> None:
    chip = chip_kernels(argv[1]) if len(argv) > 1 else {}
    print("| # | TPU kernel (def) | Status | Route → file | Launches/step by path | MB | Bound ms "
          "| Kernel ms | Plain ms | One PyTorch call ms |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for num, name, key, rd, wr, _ in KERNELS:
        status = "ported" if key else "to port"
        mb = (rd + wr) / 1e6
        bound = 1e3 * (rd + wr) / HBM
        k = chip.get(key) if key else None
        route = f"{k['route'].upper()} → `{k['source'].split('/')[-1]}`" if k else "—"
        ms, plain, lib = (k["ms"], k["plain_ms"], k["library_ms"]) if k else (None, None, None)
        print(f"| {num} | `{name}` | {status} | {route} | {launches(k) if k else '0'} | {mb:.1f} "
              f"| {bound:.4f} | {fmt(ms)} | {fmt(plain)} | {'none' if lib is None else fmt(lib)} |")
        for label, a in (k or {}).get("also", {}).items():
            print(f"| {num} | ↳ {label} | | | | {a['bytes'] / 1e6:.2f} | {a['bound_ms']:.4f} "
                  f"| {fmt(a['ms'])} | {fmt(a['plain_ms'])} | none |")


if __name__ == "__main__":
    main(sys.argv)
