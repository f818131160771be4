"""The table of the JAX package's 17 TPU kernels for ``PERF.md``.

For each function that reaches ``pl.pallas_call`` in ``tasmania_tpu/ops/``:
the bytes it must move at the flagship shapes (161x161x120 float32; each
input read once, each output written once, from the arrays of its signature
as the flagship or its nearest caller passes them; the two kernels of the
tendency-carrying stage with the tendencies the fc and lfc couplings pass)
and that traffic's time at the H100's 3.35 TB/s.  Given the log of a
``chip_smoke.py`` run, it adds for each ported kernel the PR that ported
it (and the PR that redesigned it for Hopper), its route and source,
its launches per step on each path that runs it (the full-size runs of
phases 5, 7, 8, 9 and 13: the flagship's SUS chain, the five other
couplings, the mountain wave, the SUS chain with both process merges,
sus_merged, and the surface paths sus_third, fc_third, sus_periodic,
sus_coriolis_implicit and fc_coriolis;
phase 12's one call of each dwarf, ``dwarfs``; phase 14's rank of the
decomposed run, ``sharded``; the later phases' paths, among them phase
19's ``sweep`` and ``diagnose`` (graphs: the warm-up and the capture of
each case), ``bench_variants``, whose step is the six couplings' steps
together, and phase 20's ``sus_default``, ``sus_graph_io`` and
``spmd_default``, the drivers' default graphs)
and the times that run measured on the card: kernel, plain version and,
where one exists, the single PyTorch call computing the same function; a
kernel timed also at other shapes or in other modes (``also`` in the log:
the mountain wave's 161x7x120, the diagnostics' modes, the third order of
#1 and #7, #1's distributed mode on the shards' blocks) gets a row for each,
with the bytes and bound of those shapes (a merge's pair run apart with the
merge's), a kernel timed also as bare launches between CUDA events
(``bare_launch_ms``: sedimentation) a row with those rounds; after the
table, each redesigned kernel's reading before its redesign
(``EARLIER``).

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
    (13, "ops/smagorinsky_step.py:303 fused_smoothing_smagorinsky_rk2", "fused_smoothing_smagorinsky_rk2",
     6 * CELL, 6 * CELL, "6 fields in, 6 out"),
    (14, "ops/vertical_advection_step.py:158 fused_vertical_advection_rk3ws",
     "fused_vertical_advection_rk3ws", 7 * CELL, 6 * CELL,
     "w, s, su, sv, qv, qc, qr -> 6 fields"),
    (15, "ops/vertical_advection_step.py:242 fused_vadv_sedimentation_rk3ws",
     "fused_vadv_sedimentation_rk3ws",
     8 * CELL + IFACE, 7 * CELL, "w, s, su, sv, 3 q, rho, h_if -> 6 fields, vt"),
    (16, "ops/diagnostics_step.py:103 fused_isentropic_diagnostics", "fused_isentropic_diagnostics",
     CELL + PLANE + (NZ + 1) * F32, 3 * IFACE + 3 * CELL, "s, hs, theta -> p, exn, h, mtg, rho, T"),
    (17, "ops/sedimentation_step.py:123 fused_sedimentation_rk3ws", "fused_sedimentation_rk3ws",
     2 * CELL + IFACE, 2 * CELL, "rho, qr, h_if -> qr, vt"),
]

# the one PyTorch call timed beside a kernel
LIBRARY_CALL = {2: "torch._foreach_copy_", 4: "torch._foreach_copy_"}

# the PR that ported each kernel, and the PR that redesigned it for Hopper
PORTED_IN = {1: 1, 2: 1, 3: 1, 9: 2, 12: 2, 14: 2, 17: 2, 5: 3, 7: 3, 8: 3, 10: 3,
             4: 4, 6: 4, 11: 4, 16: 4, 13: 5, 15: 5}
REDESIGNED_IN = {1: 6, 3: 6, 11: 7, 12: 7, 14: 7, 16: 8, 17: 8, 5: 9, 7: 9, 13: 10, 15: 10, 6: 15}

# what a launch is, where a call's time covers more than one step of work
LAUNCH_NOTE = {12: "one launch a call, both stages"}

# a redesigned kernel's reading before its redesign, kept beside its new
# time: (label, kernel ms, plain ms, MB moved or None for the kernel's own),
# from chip_smoke.py's last log before its code changed (H100 80GB HBM3,
# 700 W)
_DIAG = "the design before the redesign (a warp of 32 columns, 31-level chunks, p and exn read back)"
_CELL = "the design before the redesign (a thread a cell from device memory, each face flux twice)"
_MERGE13 = ("the design before the redesign (a thread a cell and level, the filter's taps from device "
            "memory, each strain formed four times)")
_FLAT = "the design before the redesign (a thread a cell over the flat array, each face flux twice)"
EARLIER = {
    1: [("the design before the redesign (three launches, the frame composed and pasted)",
         1.038, 4.585, None)],
    3: [("the design before the redesign (a thread a cell from device memory, the frame pasted)",
         0.745, 1.200, None)],
    5: [(_CELL, 0.455, 2.033, None), (f"{_CELL}, order 3, s alone, 161x7x120", 0.005, 0.051, 2.79)],
    6: [(_FLAT, 0.225, 1.075, None), (f"{_FLAT}, order 5, 167x167x120", 0.242, 1.159, 160.80),
        (f"{_FLAT}, order 3, 161x7x120", 0.007, 0.128, 6.57)],
    7: [(_CELL, 0.299, 1.630, None)],
    11: [("the design before the redesign (a thread a cell, one launch a stage)", 0.281, 0.436, None)],
    12: [("the design before the redesign (a thread a cell, one launch a stage, the stage-1 pair "
          "through device memory)", 0.549, 0.873, None)],
    13: [(f"{_MERGE13}", 0.450, 2.081, None), (f"{_MERGE13}, the unperturbed initial state", 0.711, 2.081, None)],
    14: [("the design before the redesign (a warp a column, its loads in series)", 0.368, 2.798, None)],
    15: [("the design before the redesign (a warp a column, its levels in series, the inputs read at "
          "every stage)", 0.381, 3.405, None)],
    16: [(f"{_DIAG}, moist", 0.147, 0.342, None),
         (f"{_DIAG}, mtg, 161x7x120", 0.044, 0.038, 1.09)],
    17: [("the design before the redesign (a warp a column in phases, coefficients from device "
          "memory)", 0.066, 0.617, None)],
}


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
        status = f"ported (PR {PORTED_IN[num]}" if key else "to port"
        if key:
            status += f"; redesigned PR {REDESIGNED_IN[num]})" if num in REDESIGNED_IN else ")"
        mb = (rd + wr) / 1e6
        bound = 1e3 * (rd + wr) / HBM
        k = chip.get(key) if key else None
        route = f"{k['route'].upper()} → `{k['source'].split('/')[-1]}`" if k else "—"
        ms, plain, lib = (k["ms"], k["plain_ms"], k["library_ms"]) if k else (None, None, None)
        note = f" ({LAUNCH_NOTE[num]})" if num in LAUNCH_NOTE else ""
        print(f"| {num} | `{name}` | {status} | {route} | {launches(k) if k else '0'}{note} | {mb:.1f} "
              f"| {bound:.4f} | {fmt(ms)} | {fmt(plain)} "
              f"| {'none' if lib is None else f'{fmt(lib)} (`{LIBRARY_CALL[num]}`)'} |")
        if k and "bare_launch_ms" in k:
            bare = k["bare_launch_ms"]
            print(f"| {num} | ↳ bare launches between CUDA events, rounds "
                  f"{', '.join(f'{t:.4f}' for t in bare)} ms (median below) | | | | {mb:.1f} | {bound:.4f} "
                  f"| {fmt(sorted(bare)[len(bare) // 2], 4)} | — | none |")
        for label, a in (k or {}).get("also", {}).items():
            print(f"| {num} | ↳ {label} | | | | {a['bytes'] / 1e6:.2f} | {a['bound_ms']:.4f} "
                  f"| {fmt(a['ms'])} | {fmt(a['plain_ms'])} | none |")
    print()
    print("Before the redesigns, kernel ms (plain ms), at the row's shape unless named: " + "; ".join(
        f"#{num} {label.removeprefix('the design before the redesign ')} {fmt(ms)} ({fmt(plain)})"
        for num, rows in EARLIER.items() for label, ms, plain, _ in rows) + ".")


if __name__ == "__main__":
    main(sys.argv)
