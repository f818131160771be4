"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  Phases, each
printing one line; any failure raises and exits non-zero:

1. the card's name and power limit (``nvidia-smi``); a CUDA device is required;
2. build the hand-written CUDA kernels from ``tasmania_tpu_torch/csrc``;
3. each of the seventeen kernels at the flagship shapes (161x161x120 float32) on
   perturbed real states against its plain PyTorch version on the same
   inputs, with the device time of one call of each (``device_ms``: the
   device operations' time over 20 calls under ``torch.profiler``, so ``ms``
   is device time and not the wrapper's host time; taken from two sessions
   that record the same operations a call, else with CUDA events, which the
   kernel's ``timed_by`` then says),
   the bytes it must move and its bound at 3.35 TB/s.  Tolerances, as a share
   of the largest magnitude of the plain output (su and sv both of the
   momentum vector's; the sedimentation kernel also timed as bare
   launches of its entry point between CUDA events, ``bare_launch_ms``):
   paste bitwise (N arrays, and one); smoothing 1e-6;
   each of the three RK3WS stages of si_stage (damping on the last) 1e-5
   (every cell: the stage and the smoothing write their x-frames
   themselves, so no paste follows either), the three stages again
   with third-order fluxes (``also``), and the last stage in the
   distributed mode on the 136x136x64 blocks of phase 14's shards (ring
   nb + 1; here a corner, an edge and an interior shard of a 3x3 grid of
   ranks over the namelist at 384x384x64), each timed (``also``)
   (FMA contraction in the
   stencils moves the float32 Montgomery potential by a few units of its
   last place, which reaches the momenta through the pressure gradient);
   Kessler + saturation adjustment, Kessler alone, saturation adjustment
   alone and sedimentation 1e-5 (the same algebra;
   FMA contraction, and PyTorch dividing by a scalar as a product with the
   reciprocal on the card, move the last bits of each stage, and the powers
   and exponentials come from the same CUDA math library in both); the
   momentum epilogue of the tendency-carrying stage (at fifth and, as an
   ``also`` entry, third order) and the momentum step of
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
   density and water of the tendency-carrying stage (at fifth and, as an
   ``also`` entry, third order), and the epilogue's s and q (updates against
   the "now" values).  The generic stage's two kernels are also held as the
   periodic boundary runs them (sus_periodic, phase 13), on its numerical
   grid (167x167x120), fifth order: the advection of s and the water
   densities without the boundary (increments, as above) and the momentum
   step (1e-5), each timed there too (``also``).  The unfused stage's kernels
   are also held at the mountain wave's shapes (161x7x120: one interior row
   in y), as phase 8 runs them: the advection of s at third order (its
   increment, as above), the Montgomery potential and the momentum step at
   third order (1e-5), each timed there too (``also`` in the summary).
   The two process merges: smoothing + Smagorinsky RK2 (its smoothed fields
   1e-6 as the smoothing's, its momenta as Smagorinsky's against the
   smoothed momenta) and vertical advection + sedimentation (the advected
   fields as vertical advection's, qr and the fall velocity 1e-5 as
   sedimentation's; rain everywhere, since where an advected qr lands
   within rounding of zero the power 0.1346 of max(qr, 0) tells two
   roundings apart).  Each merge is also run as its pair apart (the
   smoothing kernel then Smagorinsky's; vertical advection's then
   sedimentation's), timed the same way (``also``), and the merge's largest
   difference from the pair is printed: the merges share their parts'
   device code, so it should be zero.  Last, the tall path of the three
   column kernels (``csrc/tall_column.cu``, which takes the columns above
   the fused kernels' 1024 levels, 2048 for sedimentation): against the
   fused kernels on the flagship's inputs (the largest difference printed),
   then on 41x41 of the flagship's columns interpolated to 1100 levels (2100
   for sedimentation), rain everywhere, against the plain versions with the
   fused kernels' gates, each tall helper counted under its own name
   (``vertical_advection_tall``, ``sedimentation_tall``; the merge's tall
   path counts both) and each call timed as an ``also`` entry of its kernel.
   Then the kernels of ``sus_yz`` (phase 13) at its shapes, numerically
   7x161x120 (fewer columns than one x-tile of any kernel): the smoothing,
   Smagorinsky, Kessler with saturation adjustment, vertical advection,
   sedimentation, the diagnostics (Montgomery and moist), the generic
   stage's advection of s and the water densities and its momentum step, on
   the slice's initial state perturbed with every column equal to column nb
   (as on the path), each with its gate above and timed (``also``);
4. the port's first slice (dycore -> diagnostics -> smoothing -> velocities,
   ``namelist_sus.slice_skip``), 1 + 100 steps, with its launch counts and
   agreement with ``tasmania_tpu_torch/drivers/slice_reference.json`` to 1e-4
   relative;
5. the full flagship step (dycore -> diagnostics -> smoothing -> Smagorinsky
   -> velocities -> Kessler + saturation adjustment -> vertical advection ->
   sedimentation -> precipitation), 1 + 100 steps through the entry point
   ``driver_namelist_sus.run``: the launch counts of its seven kernels,
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
   that reference;
9. the raining run of phase 6 with both process merges
   (``process_merges=("smooth_smag", "vadv_sed")``) through
   ``driver_namelist_sus.run``, 1 + 30 steps at 161x161x120: the exact
   launch counts (``LAUNCHES_PER_STEP["sus_merged"]``: the merged kernels
   once a step each in place of the smoothing, the two Smagorinsky stages,
   vertical advection and sedimentation), finiteness,
   its step time, and agreement with the JAX package's float32 run with its
   two merge switches on (``tasmania_tpu_torch/drivers/flagship_merged_reference.json``)
   to ``MERGED_TOL`` = 6e-4 relative on every number, about twice the
   port's float32 CPU reading (2.8e-4 on qc_max);
10. the fused loop (``--fused-loop``): the runs of phases 5 (the flagship,
   1 + 100 steps), 9 (sus_merged, 1 + 30), 7 (fc, lfc, ps, sts and ssus,
   1 + 20 each), 8 (the mountain wave, 1800 steps) and 13 (sus_third,
   fc_third, sus_periodic, sus_coriolis_implicit, fc_coriolis, 1 + 20
   each; run before this phase) again with
   ``fused_loop=True``, their timed
   steps replays of one CUDA graph of the step: each final field equal to
   the eager run's bit for bit, and the launch counts exact per capture (a
   replay counts nothing, so each kernel twice its launches a step: the
   eager warm-up step and the capture; ``launches_per_step`` of the
   captured step equal to ``LAUNCHES_PER_STEP``).  Then the ms/step of
   eager and graph runs, in ``FUSED_PAIRS`` alternating pairs in this call
   (eager, graph, graph, eager, ...), of ``FUSED_TIMED_STEPS`` timed steps
   a run (the mountain wave ``FUSED_TIMED_MW``), each model built once, as
   a phase line each and one JSON line (``fused_loop_timing``);
11. the Burgers model (BASELINE config 1) through
   ``driver_burgers.run_case`` at 2048x2048, float32: the ``bench`` case
   (``bench.py::bench_burgers``, 1 + 50 steps) and the ``zhao`` case (the
   dycore with diffusion and the Dirichlet boundary of the exact solution,
   1 + 100 steps), each eager and as a CUDA graph: the graph's u and v
   equal the eager run's bit for bit, no kernel launched (plain PyTorch),
   every value finite, and zhao's numbers within ``BURGERS_TOL`` of the
   JAX package's float32 result
   (``tasmania_tpu_torch/drivers/burgers_reference.json``).  Then eager and
   graph in ``FUSED_PAIRS`` alternating pairs, ms/step and gridpoints/s
   beside the step's bound (``burgers_bound``), as phase lines and one JSON
   line (``burgers_timing``);
12. the dwarfs (BASELINE config 2): each of the six diffusion, nine
   hyperdiffusion and nine smoothing names once on a seeded float32 field of
   ``DWARF_SHAPE`` on the card, the two-dimensional smoothing filters
   through ``fused_smoothing`` (launched exactly once each, nothing else),
   each output within ``DWARF_TOL`` of the largest magnitude of the port's
   float64 CPU result of the same call, and each call's device time
   (``device_ms``) beside its bound (the field read once and the result
   written once), as phase lines and one JSON line (``dwarfs``);
13. the isentropic core's surface (run after phase 9, before phase 10, whose
   graphs need its eager runs): ``SURFACE_PATHS`` through
   ``driver_isentropic_moist.run`` at 161x161x120 from relative humidity
   1.05, 1 + 20 steps each: ``sus_third`` (SUS with third-order fluxes: the
   whole-stage kernel at order 3), ``fc_third`` (fc at third order: the
   two-kernel stage at order 3) and ``sus_periodic`` (SUS on the periodic
   boundary: the generic stage, #5 with the water densities and #6 at full
   width, no si_stage), ``sus_coriolis_implicit`` (SUS with the f-plane
   Coriolis process, f = 1e-4 rad/s, and the implicit vertical advection:
   the Crank-Nicolson column solve, plain PyTorch, in place of the RK3WS
   vertical-advection kernel), ``fc_coriolis`` (fc with Coriolis first
   in its chain), ``sus_yz`` (SUS on a y-z slice, 1x161x120, numerically
   7x161x120: the relaxed boundary with nx == 1, the flagship's wind along y,
   from the flagship's own relative humidity 0.95, since from 1.05 the
   slice blows up within five steps in both packages; the generic stage, as
   on the periodic boundary) and ``sus_schaer`` (SUS over the Schaer
   mountain: the main path's kernels), each with the exact launch counts
   of its path, finiteness and agreement with the JAX package's float32 result at the
   same configuration (the reference file of ``SURFACE_PATHS``), with phase
   7's limits (``VARIANT_LOOSER`` holds each path's looser numbers); then
   ``sus_periodic`` again in float64, with the same launch counts, within
   ``WITNESS_TOL`` of the port's float64 CPU run (``WITNESS_REFERENCE``):
   the witness that the float32 limits of that path cover rounding;
14. the decomposed run (BASELINE config 5, run after phase 12) through
   ``driver_sharded.run``: the flagship namelist at 256x256x64 with the
   whole SUS chain, 1 + 50 steps, float32, on four gloo ranks of a 2x2
   grid sharing the card (each rank a process; halos through host
   memory): each rank's launches exact (``LAUNCHES_PER_STEP["sharded"]``:
   si_stage three times a step in its distributed mode), no JAX in any
   rank, the gathered state finite and within ``SHARDED_FIELD_TOL`` of the
   port's single-device run of the same sequence (the cells that differ
   counted), its validation numbers within phase 13's limits of the JAX
   ``DistributedModel``'s float32 run (``SHARDED_REFERENCE``); the same
   pair in float64 within ``WITNESS_TOL``; then one NCCL rank on the
   degenerate 1x1 mesh, which must give the single device's bits (NCCL
   refuses two ranks on one card).  Its ms/step is four ranks
   time-sharing one card, not a scaling figure;
15. the physics surface's plain components (run after phase 12, before
   phase 14): Coriolis, the implicit vertical advection (its Diagnostic and
   Prognostic) and its sequential-tendency stepper, saturation adjustment
   in one go alone and under ``rk2sa``, clipping, the prescribed surface
   heating, the dry and moist static energies, the state from a
   temperature, Goff-Gratch, the velocity and water-constituent
   diagnostics and vertical damping, each once on the flagship's state
   (161x161x120, relative humidity 1.05, seeded perturbations, float32) on
   the card, none launching a kernel, each output within
   ``COMPONENT_TOL`` (1e-6) of the largest magnitude of the port's float64
   CPU result of the same call (the exceptions beside the constant), with
   its device time a call (``device_ms``), as phase lines and one JSON line
   (``components``); with them the rest of the domain and framework: the
   three terrain-following grids (σ, Gal-Chen, SLEVE) over the Schaer
   mountain with storage on the card, bit for bit their float32 CPU build
   (host numpy), the diagnostic composite of the isentropic diagnostics and
   the velocity components under ``"serial"`` and ``"as_parallel"`` (one
   launch of the diagnostics kernel each), and RMSD, RRMSD and the column
   sum of the two card states;
16. I/O and recovery (run after phase 15, before phase 14; ``io_phase``),
   the flagship eager in float32 at 161x161x120 with files in a temporary
   directory: 1 + ``IO_STEPS`` steps checkpointed every ``IO_EVERY`` with
   the NaN guard (its launches exact, path ``sus_io``), then a run resumed
   from step ``IO_RESUME`` whose fields must equal the uninterrupted run's
   bit for bit; the same checkpoint restored onto the CPU equal to its
   restore on the card bit for bit; a step wrapper that writes a NaN at step
   ``IO_POISON`` must trip the guard at the next boundary, naming the last
   good checkpoint, with no checkpoint after it; 3 eager steps under
   ``utils/timer.profile_trace`` in a process of its own (``TRACE_RUN``, as
   a user's ``--profile`` run), whose Chrome trace must hold each SUS
   kernel's CUDA functions (``TRACE_KERNELS``) exactly launches a step
   times 3 (up to ``TRACE_ATTEMPTS`` traces: a profiler session can lose
   an operation), beside 3 unprofiled steps; one step with ``Timer`` on
   (synchronised), whose labels must name every component of the chain and
   ``"stage"``; the initial and final states through ``NetCDFMonitor`` and
   back (all fields but ``NETCDF_SKIP``), equal to their host copies, the rebuilt domain's grid and
   topography the original's.  Save, restore, NetCDF write and load ms,
   the checkpoint's and the trace's MB, as phase lines and one JSON line
   (``io``);
17. the registry (run after phase 12, before phase 15; ``registry_phase``):
   (a) a topography that copies ``Gaussian`` and a subclass of ``Relaxed``,
   registered in the phase under names of their own
   (``register_user_flavours``), build the flagship by name; 1 +
   ``REGISTRY_STEPS`` steps eager and as a CUDA graph, whose fields must
   equal the eager run built through ``"gaussian"`` and ``"relaxed"`` bit
   for bit, with sus's exact launches (path ``sus_registry``); the graph
   step of both in ``REGISTRY_PAIRS`` alternating pairs of
   ``FUSED_TIMED_STEPS`` steps; (b) the same run under the backend names
   ``"jax"`` and ``"pallas"``, eager and as a graph, with the same launches
   and bits; (c) every registered stencil and subroutine through
   ``compile_stencil`` (backend ``"jax"``) on seeded float32 card tensors at
   161x161x120, within ``COMPONENT_TOL`` of the port's float64 CPU result,
   no kernel launched, with its device time a call; (d) phase 12's 24
   dwarfs built through their factories, each with phase 12's bits and #3's
   launch count; (e) the allocators and the factory mixin's, which must
   return float32 tensors on the card; phase lines and one JSON line
   (``registry``);
18. distribution and tools (run after phase 14; ``distribution_phase``),
   float32: (a) the SUS driver's ``--spmd`` on four gloo ranks (2x2)
   sharing the card at phase 14's grid (256x256x64), 1 + ``DIST_STEPS``
   steps checkpointed every ``DIST_EVERY`` (each rank its blocks of a
   sharded step), then resumed from step ``DIST_RESUME`` on 2x2 (bit for
   bit the uninterrupted run), on 4x1 and on the single device (within
   ``SHARDED_FIELD_TOL``, ρ within ``DIAG_RHO_TOL``), and the single
   device's checkpoint restored onto each rank of 2x2 bit for bit; the
   checkpoint's MB, its saves', restores' and assembly's ms; (c) the same
   run on the hybrid grid of two nodes of two ranks (``LOCAL_WORLD_SIZE=2``,
   the nodes tiled 2x1 and 1x2), each node's ranks one block, bit for bit
   the plain 2x2 run; (b) ``--spmd`` on the card's one NCCL rank at the
   flagship with ``--fused-loop``: the degenerate grid, sus's graph bits and
   launches; (d) ``driver_dist_bench --mesh 1,1`` at the flagship: the
   single device's bits, ``DIST_BENCH_PAIRS`` alternating pairs of graph
   steps and their ratio (no gate on time); (e) ``driver_weak_scaling``
   on 1 and 4 gloo ranks of ``WEAK_BLOCK`` x ``WEAK_BLOCK`` x ``WEAK_NZ``
   with ``--analyze`` at ``NVLINK_GBS`` (a data-sheet figure): each rank's
   counted exchange bytes equal to the ring's; (f) every ``driver_profile``
   variant at the flagship, 1 + ``DIST_STEPS`` graph steps, launching
   exactly the kernels its skip set leaves (``expected_launches``), and
   ``full`` beside sus's graph step in ``PROFILE_PAIRS`` alternating pairs,
   each full run's fields equal to sus's bit for bit and its launches
   ``expected_launches("full")`` (the times printed, not gated: the range of
   a few samples of a heavy-tailed step time bounds no difference of
   medians); phase lines and one JSON line (``distribution``).  Phase 3
   also times a one-element PyTorch fill with ``device_ms``, the launch
   floor beside the pastes, which the ``kernels`` line carries as
   ``launch_floor_ms``;
19. the last one-card tools (run after phase 18; ``tools_phase``), float32,
   no check against time: (a) the mountain wave's ``--sweep`` (the three
   cases of ``driver_mountain_wave.SWEEP_CASES``, 5 h, each as a CUDA
   graph): each case's launches a step exactly
   ``LAUNCHES_PER_STEP["mountain_wave"]``, finite fields, and corr,
   corr_focused, rms_err_focused and the amplitude ratio within
   ``SWEEP_ABS_TOL`` and ``SWEEP_REL_TOL`` of ``SWEEP_REFERENCE`` (the JAX
   package's float32 run); the convergence orders printed beside the
   reference's, not gated; (b) ``--diagnose`` at the first case: its 18
   rows and its localisation within ``DIAGNOSE_TOL`` and
   ``LOCALISATION_TOL`` of the reference, the profiles written to an
   ``.npz`` under a temporary directory and read back; (c)
   ``bench_variants`` at the flagship, ``TOOLS_NT`` steps a round: each
   coupling's launches a step its ``LAUNCHES_PER_STEP`` entry, its fields
   after the first round equal bit for bit to an eager
   ``driver_isentropic_moist.run`` of 1 + ``TOOLS_NT`` steps, its ms/step
   and gridpoints/s printed; (d) ``bench_kernels`` and ``driver_roofline``:
   every case's outputs finite and its launches equal to its timed calls,
   the copy rate, each row and the largest share printed; phase lines and
   one JSON line (``tools``);
20. the graph by default (``graph_default``, run after phase 11, and
   ``graph_recovery``, after phase 19), float32, gated on bits and launches
   only: (a) each driver's entry point with no mode given (sus, sus_merged,
   fc, lfc, ps, sts, ssus, the mountain wave and both Burgers cases, at the
   step counts of phases 5, 7, 8, 9 and 11) must capture a CUDA graph
   (``capture_s``), launch each kernel twice its launches a step (the
   eager warm-up step and the capture), capture ``LAUNCHES_PER_STEP`` and
   give the explicit eager run of its phase bit for bit; its ms/step
   printed beside the eager run's; (b) the flagship, 1 + ``IO_STEPS``
   default (graph) steps checkpointed every ``IO_EVERY`` with the NaN
   guard: each checkpoint and the final fields bit for bit those of the
   same run with ``fused_loop=False``; resumed from ``IO_RESUME`` under the
   graph, the uninterrupted graph run's bits; a NaN written at
   ``IO_POISON`` through a device counter the step reads (a graph freezes a
   Python counter) trips the guard at the next boundary with the eager
   run's message and checkpoints; ``--profile``'s trace of
   ``TRACE_STEPS`` replays (``TRACE_GRAPH_RUN``, a process of its own) in
   two sessions that agree, each holding every SUS kernel's CUDA functions
   launches a step times ``TRACE_STEPS``; (c) ``--spmd`` on the card's one
   NCCL rank with no mode given: a graph, phase 18's one-rank bits, sus's
   launches.  Phase lines and two JSON lines.

The runs of phases 4-9, 13 and 16, the single device's resume of phase 18
(a) and the eager runs of phase 19 (c) ask for eager steps
(``fused_loop=False``): the drivers step through a CUDA graph by default on
the card, and these runs' launches are counted a step and their fields are
the graph runs' references.  The isentropic diagnostics kernel serves
every diagnostics call, so phases 4-7, 9, 10, 13, 14 and 17-20 count it
too (``LAUNCHES_PER_STEP``); phase 12 counts the smoothing kernel under the
path ``dwarfs``.  Every phase checks the launch counts exactly: each kernel
of the path as often as its path launches it a step (phases 10 and 20: a
step's launches twice), and no other kernel.  The last two
lines are the card's name and power limit, then ``{"ok": true, "device":
{...}}``; the line before them is a JSON summary of the kernels, their
launches in the full-size run of the first path that runs them (``path``:
the flagship, phase 5, for the six of the SUS chain and the diagnostics;
fc for the two stage kernels, ps for Kessler and saturation adjustment
alone, the mountain wave for the momentum step, sus_merged for the two
merges; none for the two pastes and the Smagorinsky stage alone, which no
path runs), their launches a step on every path, and their times.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import torch

SLICE_TOL = 1e-4
FLAGSHIP_TOL = 1e-4
FLAGSHIP_QC_TOL = 1e-3
RAIN_TOL = 1e-3
# phase 9, the rain run with both merges, against flagship_merged_reference.json:
# about twice the port's float32 CPU reading (make_torch_flagship_reference.py
# --merges --check-port: 2.8e-4 on qc_max, 2.1e-4 on sv_max, 1.9e-4 on su_max,
# 4.1e-5 or less on every rain and precipitation number)
MERGED_TOL = 6e-4
MERGES = ("smooth_smag", "vadv_sed")
# phase 10's paired timing of eager and graph runs in this call
FUSED_PAIRS = 5
FUSED_TIMED_STEPS = 50
FUSED_TIMED_MW = 200
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
    # phase 13 (make_torch_flagship_reference.py --flux / --boundary
    # --check-port; every other number within 5e-5, qc within 3.6e-4)
    ("sus_third", "vmax"): 1.5e-4,  # CPU reading 7.5e-5
    ("sus_periodic", "sv_mean_abs"): 1.5e-4,  # CPU reading 6.1e-5
    ("sus_periodic", "qr_max"): 1.5e-4,  # CPU reading 6.4e-5
    # sus_periodic's two smallest velocities (vmax 0.21 m/s, sv_max 40):
    # on an H100 80GB HBM3 the float32 run read 1.8e-4 and 2.0e-4 (CPU
    # readings 4.8e-5 and 5.7e-7), while the same run in float64 on the card
    # came within 1.7e-13 of the float64 CPU run on every number: float32
    # rounding, grown by condensation over 21 steps, not a fault.  The limits
    # are about twice the card's readings, and phase 13 keeps the float64
    # run in the gate (WITNESS_TOL)
    ("sus_periodic", "vmax"): 4e-4,
    ("sus_periodic", "sv_max"): 4e-4,
    # sus_schaer (make_torch_flagship_reference.py --topography schaer
    # --check-port: every other number within 4.8e-5, qc within 4.8e-5);
    # sus_yz's readings are within 1.4e-6, under the defaults
    ("sus_schaer", "vmax"): 2e-4,  # CPU reading 9.3e-5
    # sus_coriolis_implicit and fc_coriolis: the port's float32 CPU run came
    # within 2.6e-5 (vmax) and 3.2e-5 (accprec_mean_abs) of their references
    # on every number (make_torch_flagship_reference.py --coriolis 1e-4
    # [--implicit-vadv | --coupling fc] --check-port; qc within 4.4e-6), so
    # the defaults, 1e-4 and 1e-3 on qc, are their limits
}
# phase 13's float64 witness: sus_periodic in float64 on the card, held to the
# port's float64 CPU run of the same configuration
# (make_torch_flagship_reference.py --boundary periodic --float64); the two
# read 1.7e-13 apart on an H100 80GB HBM3
WITNESS_REFERENCE = "flagship_periodic_float64.json"
WITNESS_TOL = 1e-10
VARIANTS = ("fc", "lfc", "ps", "sts", "ssus")
# kernel launches per step of each path, as the code routes it: with
# tendencies (fc, lfc) each dycore stage is the two-kernel stage and the
# physics chain is plain PyTorch; ps runs the SUS chain's kernels but for the
# pair, whose processes step apart; sts's steppers never fuse
# the isentropic diagnostics (fused_isentropic_diagnostics) serve every
# diagnostics call: the physics chain's diagnostics once a step on every
# path; with tendencies also the Montgomery potential of each stage (3 a
# step) and, in fc, the dycore's fast diagnostics after each stage (3 more)
# no path pastes: the stage and the smoothing write their frames themselves;
# Smagorinsky RK2 runs both its stages in one launch
_SUS = {"si_stage": 3, "fused_smoothing": 1, "fused_smagorinsky_rk2": 1,
        "fused_kessler_satadj_rk2": 1, "fused_vertical_advection_rk3ws": 1,
        "fused_sedimentation_rk3ws": 1, "fused_isentropic_diagnostics": 1}
_TWO_KERNEL = {"fused_advection_fields": 3, "fused_momentum_epilogue": 3, "fused_smoothing": 1}
# both process merges: one kernel each in place of smoothing with Smagorinsky
# RK2, and of vertical advection with sedimentation
_MERGED = {"fused_smoothing": 0, "fused_smagorinsky_rk2": 0, "fused_vertical_advection_rk3ws": 0,
           "fused_sedimentation_rk3ws": 0, "fused_smoothing_smagorinsky_rk2": 1,
           "fused_vadv_sedimentation_rk3ws": 1}
LAUNCHES_PER_STEP = {
    "slice": {"si_stage": 3, "fused_smoothing": 1, "fused_isentropic_diagnostics": 1},
    "sus": _SUS,
    "sus_merged": {k: n for k, n in {**_SUS, **_MERGED}.items() if n},
    "ssus": _SUS,
    "fc": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 6},
    "lfc": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 4},
    "ps": {**{k: n for k, n in _SUS.items() if k != "fused_kessler_satadj_rk2"},
           "fused_kessler_rk2": 1, "fused_satadj_rk2": 1},
    "sts": {"si_stage": 3, "fused_smoothing": 1, "fused_isentropic_diagnostics": 1},
    # the unfused dry stage: advection of s, the Montgomery potential of the
    # stepped density and the momentum step, thrice, and the driver's
    # Montgomery refresh after the step
    "mountain_wave": {"fused_advection_fields": 3, "fused_momentum_step": 3,
                      "fused_isentropic_diagnostics": 4},
    # third order takes the same kernels a step as fifth
    "sus_third": _SUS,
    "fc_third": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 6},
    # the periodic boundary takes the generic stage: the advection of s and
    # the water densities, the Montgomery potential of the stepped density
    # and the momentum step, thrice
    "sus_periodic": {**{k: n for k, n in _SUS.items() if k != "si_stage"}, "fused_advection_fields": 3,
                     "fused_momentum_step": 3, "fused_isentropic_diagnostics": 4},
    # a rank of the decomposed run: the SUS chain's kernels, si_stage in its
    # distributed mode; Smagorinsky declines its fused RK2 kernel there (its
    # frame is local) and steps its plain tendency, as the JAX package does
    "sharded": {k: n for k, n in _SUS.items() if k != "fused_smagorinsky_rk2"},
    # Coriolis is plain PyTorch on every path; the implicit vertical
    # advection's column solve too, in place of the explicit RK3WS kernel
    "sus_coriolis_implicit": {k: n for k, n in _SUS.items() if k != "fused_vertical_advection_rk3ws"},
    "fc_coriolis": {**_TWO_KERNEL, "fused_isentropic_diagnostics": 6},
    # the relaxed boundary with nx == 1 takes the generic stage, as the
    # periodic boundary does (the JAX package routes a one-dimensional
    # relaxed boundary there too); the Schaer mountain changes no route
    "sus_yz": {**{k: n for k, n in _SUS.items() if k != "si_stage"}, "fused_advection_fields": 3,
               "fused_momentum_step": 3, "fused_isentropic_diagnostics": 4},
    "sus_schaer": _SUS,
    # phase 17: the flagship built through a user's registered topography and
    # boundary (and under the JAX backend names) runs sus's kernels
    "sus_registry": _SUS,
}
# phase 13, the isentropic core's surface at full size: a coupling, its
# namelist overrides and the reference file (the JAX package's float32
# result, make_torch_flagship_reference.py --flux / --boundary); each run
# from the couplings' supersaturated start, 1 + 20 steps
THIRD = {"horizontal_flux_scheme": "third_order_upwind"}
# the flagship on a y-z slice: one cell in x (numerically 2 nb + 1 = 7
# columns), the flagship's 22.5 m/s wind along y (velocities in m s^-1)
YZ = {"nx": 1, "x_velocity": 0.0, "y_velocity": 22.5}
CORIOLIS = {"coriolis_parameter": 1e-4}  # rad s^-1
SURFACE_PATHS = {
    "sus_third": ("sus", THIRD, "flagship_third_reference.json"),
    "fc_third": ("fc", THIRD, "variant_fc_third_reference.json"),
    "sus_periodic": ("sus", {"hb_type": "periodic", "hb_kwargs": {}}, "flagship_periodic_reference.json"),
    # the f-plane and the implicit (Crank-Nicolson) vertical advection
    # (make_torch_flagship_reference.py --coriolis 1e-4 [--implicit-vadv])
    "sus_coriolis_implicit": ("sus", {**CORIOLIS, "implicit_vertical_advection": True},
                              "flagship_coriolis_implicit_reference.json"),
    "fc_coriolis": ("fc", CORIOLIS, "variant_fc_coriolis_reference.json"),
    # the y-z slice (make_torch_flagship_reference.py --yz; the reference's
    # relative humidity is the flagship's own 0.95) and the Schaer mountain
    # (--topography schaer)
    "sus_yz": ("sus", YZ, "flagship_yz_reference.json"),
    "sus_schaer": ("sus", {"topo_type": "schaer"}, "flagship_schaer_reference.json"),
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
# phase 11, Burgers through driver_burgers: the size, and the limits against
# burgers_reference.json (the JAX package's float32 zhao run on the CPU),
# relative (u_sum and v_sum relative to the sums of |u| and |v|).  The port's
# float32 CPU run reads 0 on every number (make_torch_burgers_reference.py
# --check-port: bit for bit the JAX run), so the limits are about twice the
# size of float32 rounding itself, the port's float64 CPU run against the
# same file: 1.1e-7 (umax), 3.6e-7 (vmax), 1.4e-8 and 1.3e-8 (the sums of
# magnitudes), 4.1e-9 and 4.7e-11 (the sums), 7.4e-3 (err_u) and 4.9e-3
# (err_v); below 5e-7 a limit is 5e-7, four float32 ulps
BURGERS_NX = 2048
BURGERS_TOL = {"umax": 5e-7, "vmax": 7e-7, "u_abs_sum": 5e-7, "v_abs_sum": 5e-7, "u_sum": 5e-7,
               "v_sum": 5e-7, "err_u": 1.5e-2, "err_v": 1e-2}
# phase 12, the dwarfs on a seeded float32 field, held to the port's own
# float64 CPU result of the same call: the flagship's horizontal size and
# levels, its nb, a sin² ramp of the coefficient over the top 15 levels.
# On an H100 80GB HBM3 the 24 calls came within 0.9e-7 to 3.2e-7 of the
# largest magnitude (the third-order smoothing): the limit is about three
# times the largest reading
DWARF_SHAPE = (161, 161, 120)
DWARF_NB = 3
DWARF_SEED = 12
DWARF_DIFFUSION = (1e3, 8e3, 15)  # m^2/s: coefficient, maximum, ramp depth
DWARF_SMOOTH = (0.03, 0.24, 15)
DWARF_TOL = 1e-6
# phase 14, the decomposed run (BASELINE config 5, driver_sharded): its
# reference (the JAX DistributedModel's float32 run on four virtual CPU
# devices, make_torch_flagship_reference.py --sharded), four gloo ranks
# sharing the card; the gathered state against the port's single-device run
# of the same sequence within SHARDED_FIELD_TOL of each field's largest
# magnitude (the momenta's and the velocities' of their vector's; the air
# density DIAG_RHO_TOL, as phase 3 holds the diagnostics: it divides by a
# difference of summed heights), and against the reference with phase 13's
# limits: 1e-4 relative, about twice the port's float32 CPU reading where
# that exceeds half of it (--sharded --check-port: 2.2e-4 on sv_mean_abs,
# 2.2e-5 on vmax, 3.9e-6 or less on every other number), exactly zero where
# the reference is.  The two runs are not bitwise on the card: decomposed,
# Smagorinsky steps its plain tendency (its fused kernel's frame is local,
# and the JAX package declines it too), so float32 rounding parts them from
# the first step (on an H100 80GB HBM3: 4.9e-7 on u, 3.1e-6 on the air
# density, 1.6e-7 or less on the prognostic fields); the same pair in
# float64 on the card, held to WITNESS_TOL, is the witness that this is
# rounding
SHARDED_REFERENCE = "sharded_reference.json"
SHARDED_FIELD_TOL = 1e-6
SHARDED_TOL = 1e-4
SHARDED_LOOSER = {"sv_mean_abs": 4.5e-4}
SHARDED_TIMEOUT_S = 600.0
# phase 3, si_stage's distributed mode: the 136x136x64 blocks (ring nb + 1)
# of phase 14's 2x2 grid at 256x256x64, here of the shards of a 3x3 grid of
# ranks over the same namelist at 384x384x64, so that a corner, an edge and
# an interior shard each appear
DIST_GLOBAL = (384, 384, 64)
DIST_GRID = (3, 3)
DIST_BLOCK = (136, 136, 64)
DIST_SHARDS = {"corner": 0, "edge": 1, "interior": 4}
# phase 3: #17's bare launches between CUDA events, launches a round and rounds
BARE_LAUNCHES = 200
BARE_ROUNDS = 3
# phase 3's tall columns: the column kernels' tall path above their fused
# kernels' heights (1024 levels; 2048 for sedimentation)
TALL_COLUMNS = (41, 41)
TALL_NZ = 1100
TALL_SED_NZ = 2100


def namelist_overrides(overrides: dict) -> dict:
    """``overrides`` as namelist values: the velocities (floats in m s^-1)
    as the namelist's scalar fields."""
    import numpy as np

    from tasmania_tpu_torch.framework.field import FieldArray

    return {k: FieldArray(np.asarray(v), "m s^-1", ()) if k.endswith("_velocity") else v
            for k, v in overrides.items()}


def variant_tol(coupling: str, key: str) -> float:
    default = VARIANT_QC_TOL if key.startswith("qc_") else VARIANT_TOL
    return VARIANT_LOOSER.get((coupling, key), default)


def stack_frames(log: str) -> str:
    """The kernels of an ``nvcc -Xptxas=-v`` log with a stack frame or
    spills (a local-memory array, such as a parameter struct indexed at run
    time), or that there are none."""
    nonzero, current = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif "bytes stack frame" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"):
            nonzero.append(f"{current}: {line.strip()}")
    return "; ".join(nonzero) if nonzero else "none in any kernel"


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


profiler_sessions = {"sessions": 0, "empty": 0, "measurements": 0}


def device_ms(fn, reps: int = 20, warmup: int = 3, attempts: int = 4) -> tuple[float, str]:
    """Device time of one ``fn()`` and how it was taken.  After warm-up,
    ``reps`` calls under ``torch.profiler``: the device operations' times
    (kernels and copies) per call.  The host's work per call (the ctypes
    call, argument checks, allocation, PyTorch's dispatch) and the device's
    idle gaps between launches do not count.

    A profiler session has been seen to record no device operation at all
    (once, on an H100, for the 4 us paste kernel), and, after a session of
    many thousands of operations, to lose one launch of the twenty in every
    later session (on an H100 80GB HBM3).  So each operation's time is the
    mean of its name's recorded times, counted round(count / reps) times a
    call, and a time is taken only from a session whose operations a call
    agree with the previous session's; up to ``attempts`` sessions are run
    (counted in ``profiler_sessions``).  If no two agree, the time is taken
    with CUDA events around ``reps`` back-to-back calls, an upper bound that
    holds the host's work wherever it is longer than the device's.  Returns
    (ms, "profiler" or "cuda events")."""
    from tasmania_tpu_torch.drivers.kernel_timing import device_ms as timed

    return timed(fn, "cuda", reps, warmup, attempts, sessions=profiler_sessions)


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(bytes_moved: int, flops: float) -> dict:
    """The least time of the work: bytes at the memory rate or operations at
    the float32 rate, whichever is larger."""
    t_bytes = 1e3 * bytes_moved / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS
    return dict(bytes=bytes_moved, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def burgers_bound(cells: int, itemsize: int, case: str) -> dict:
    """The least time of a Burgers step: each of the three RK3WS stages
    reads u, v and the step's u0, v0 and writes u, v once, and does about
    66 operations a cell for the third-order advection and the update (86
    with zhao's diffusion)."""
    flops = (66.0 if case == "bench" else 86.0) * cells
    return bound(3 * 6 * cells * itemsize, 3 * flops)


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


VECTORS = (("x_momentum_isentropic", "y_momentum_isentropic"),
           ("x_velocity_at_u_locations", "y_velocity_at_v_locations"))


def field_differences(got, ref):
    """Per field of ``ref`` (numpy): the largest difference as a share of
    its largest magnitude (the momenta's and the velocities' of their
    vector's) and the number of cells that differ at all."""
    import numpy as np

    out = {}
    for name, r in ref.items():
        pair = next((p for p in VECTORS if name in p), (name,))
        scale = max(float(np.abs(ref[m]).max()) for m in pair) or 1.0
        out[name] = (float(np.abs(got[name] - r).max()) / scale, int(np.count_nonzero(got[name] != r)))
    return out


def check_differences(tag, diffs, tol_of):
    """Raise unless each field's difference is within ``tol_of(name)``."""
    for name, (err, _) in diffs.items():
        if not err <= tol_of(name):
            raise AssertionError(f"{tag}: {name} {err} > {tol_of(name)}")


def sharded_phase(card, path_counts, path_steps, device="cuda", ranks_mesh=None, size=None):
    """Phase 14: the decomposed run at the reference's configuration on four
    gloo ranks sharing the card, the port's single-device run of the same
    sequence, and one NCCL rank on the degenerate 1x1 mesh.  ``device``,
    ``ranks_mesh`` and ``size`` (nx, ny, nz, niter) let the phase be
    rehearsed on the CPU at a small size."""
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers import driver_sharded as shd
    from tasmania_tpu_torch.ops import _lib

    sref = json.loads(Path(drv.__file__).with_name(SHARDED_REFERENCE).read_text())
    cfg = sref["config"]
    mesh = ranks_mesh or tuple(cfg["mesh"])
    nx, ny, nz, niter = size or (cfg["nx"], cfg["ny"], cfg["nz"], cfg["niter"])
    steps = 1 + niter
    run = dict(nx=nx, ny=ny, nz=nz, niter=niter, physics=True, verbose=False,
               timeout_s=SHARDED_TIMEOUT_S)
    ranks = mesh[0] * mesh[1]

    def check_counts(tag, counts, per_step):
        for name in sorted(set(per_step) | set(counts)):
            if counts.get(name, 0) != steps * per_step.get(name, 0):
                raise AssertionError(f"{tag}: {name} launched {counts.get(name, 0)} times, "
                                     f"expected {steps * per_step.get(name, 0)}")

    # the decomposed run: the ranks count their own launches from zero, and
    # the parent launches nothing
    _lib.reset_launch_counts()
    t0 = time.perf_counter()
    dec = shd.run(ranks=ranks, comm="gloo", device=device, mesh=mesh, **run)
    wall = time.perf_counter() - t0
    if dict(_lib.launch_counts):
        raise AssertionError(f"sharded: the parent launched {dict(_lib.launch_counts)}")
    for r, counts in enumerate(dec["launches_by_rank"]):
        check_counts(f"sharded rank {r}", counts, LAUNCHES_PER_STEP["sharded"])
    if any(dec["imported_by_rank"]):
        raise AssertionError(f"sharded: ranks imported {dec['imported_by_rank']}")
    fields = dec["fields"]
    import numpy as np

    bad = [k for k, a in fields.items() if not np.isfinite(a).all()]
    if bad:
        raise AssertionError(f"sharded: non-finite fields: {bad}")
    # the port's single-device run of the same sequence, on this process
    nl_sd = shd.namelist(device, nx=nx, ny=ny, nz=nz, niter=niter)
    _lib.reset_launch_counts()
    sd = shd.single_device_run(nl_sd, physics=True)
    check_counts("sharded, the single device", dict(_lib.launch_counts), LAUNCHES_PER_STEP["sus"])
    diffs = field_differences(fields, sd["fields"])
    phase("sharded", f"{nx}x{ny}x{nz}, mesh {mesh[0]}x{mesh[1]} (pads {dec['pads']}), 1+{niter} steps, "
          f"--physics, float32: {mesh[0] * mesh[1]} gloo ranks time-sharing one card through "
          f"host-staged halos (not a scaling figure): {dec['ms_per_step']:.3f} ms/step on rank 0's "
          f"clock ({dec['gps']:.4e} gridpoints/s), {wall:.1f} s with the ranks' start; the single "
          f"device {sd['ms_per_step']:.3f} ms/step on {card}; si_stage launches a step a rank "
          f"{[c.get('si_stage', 0) / steps for c in dec['launches_by_rank']]}; rank launches "
          f"{dec['launches_by_rank'][0]}")
    phase("sharded-vs-single-device", " ".join(f"{k}={e:.1e}({n} cells differ)" for k, (e, n) in diffs.items()))
    check_differences("sharded vs the single device", diffs,
                      lambda name: DIAG_RHO_TOL if name == "air_density" else SHARDED_FIELD_TOL)
    # the float64 witness: the same pair in float64, the decomposed run's
    # launches as above
    dec64 = shd.run(ranks=ranks, comm="gloo", device=device, mesh=mesh, f64=True, **run)
    for r, counts in enumerate(dec64["launches_by_rank"]):
        check_counts(f"sharded float64 rank {r}", counts, LAUNCHES_PER_STEP["sharded"])
    sd64 = shd.single_device_run(shd.namelist(device, f64=True, nx=nx, ny=ny, nz=nz, niter=niter),
                                 physics=True)
    diffs64 = field_differences(dec64["fields"], sd64["fields"])
    phase("sharded-float64-witness", " ".join(f"{k}={e:.1e}" for k, (e, _) in diffs64.items()))
    check_differences("sharded vs the single device, float64", diffs64, lambda name: WITNESS_TOL)
    del dec64, sd64
    if size is None:
        summary = drv.validation_summary(fields)
        phase("sharded-reference", compare_reference(
            "sharded", summary, sref, lambda key: SHARDED_LOOSER.get(key, SHARDED_TOL), 0.0))
        phase("sharded-validation", f"umax = {dec['umax']:.5f} (the largest cell-anchored u)")
    # one NCCL rank on the degenerate 1x1 mesh: the single-device program
    if device == "cuda":
        _lib.reset_launch_counts()
        one = shd.run(ranks=1, comm="nccl", device=device, mesh=(1, 1), **run)
        if not one["degenerate"]:
            raise AssertionError("sharded, one NCCL rank: the 1x1 mesh did not take the degenerate route")
        check_counts("sharded, one NCCL rank", one["launches_by_rank"][0], LAUNCHES_PER_STEP["sus"])
        unequal = sorted(k for k, a in sd["fields"].items() if not np.array_equal(one["fields"][k], a))
        if unequal:
            raise AssertionError(f"sharded, one NCCL rank: {unequal} differ from the single device's")
        phase("sharded-nccl", f"one NCCL rank, mesh 1x1 (degenerate): {one['ms_per_step']:.3f} ms/step; "
              f"every field equal to the single device's bit for bit")
    path_counts["sharded"], path_steps["sharded"] = dec["launches_by_rank"][0], steps
    return dec, sd


# phase 15, the physics surface's plain components (Coriolis, the implicit
# vertical advection, its STS stepper, saturation adjustment in one go and
# under RK2SA, clipping, the prescribed heating, the static energies, the
# state from a temperature, Goff-Gratch, the velocity and water diagnostics,
# vertical damping): each called once on the card at the flagship's size on
# its initial state from relative humidity 1.05 with seeded perturbations
# (float32), held to the port's float64 CPU result of the same call on the
# same float32 inputs within COMPONENT_TOL of each output's largest
# magnitude (the implicit Prognostic's tendencies, small updates (new -
# old)/dt of large fields, within COMPONENT_TOL of their largest update plus
# 4 float32 ulps of the field over dt, as phase 3 holds small updates), its
# device time a call; none launches a kernel.  The state from a temperature
# is built on the host in the storage type, as in the JAX package, and
# placed on the card: its float32 numbers carry the host's float32
# rounding (s is a difference of pressures), so it is held bit for bit to
# the port's float32 CPU build, its distance from the float64 build printed
# the distance from the float64 build printed.  The same phase holds the
# rest of the domain and framework (queue 1 items 5 and 6): the three
# terrain-following grids over the Schaer mountain at the flagship's size
# and levels, grown to its full height (update_topography), their metric
# terms host numpy, so each is held bit for bit to its float32 CPU build
# like the state from a temperature (timed by the host's clock, one build);
# the diagnostic composite of the isentropic diagnostics and the velocity
# components under each execution policy (each one launch of the
# diagnostics kernel, COMPONENT_LAUNCHES); and the offline diagnostics
# (RMSD, RRMSD and the column sum) of the two states, numpy on their host
# copies, against the same numpy on the float64 states
HOST_BUILT = ("state_from_temperature", "sigma_grid", "gal_chen_grid", "sleve_grid")
COMPONENT_SEED = 16
COMPONENT_TOL = 1e-6
COMPONENT_DT = 5.0
COMPONENT_LAUNCHES = {"fused_isentropic_diagnostics": 2}
# the composites' air density divides by a difference of two summed heights
# (DIAG_RHO_TOL, as phase 3 holds it): in float32 on the CPU it reads 6e-6
# of its largest magnitude from the float64 result (41x41x120)
COMPONENT_LOOSER = {(f"composite_{p}", "air_density"): DIAG_RHO_TOL for p in ("serial", "as_parallel")}
# the grids' vertical coordinates: σ from 0.2 to 1, heights from 20 km to 0
GRID_Z = {"sigma_grid": ((0.2, 1.0), "1"), "gal_chen_grid": ((2e4, 0.0), "m"),
          "sleve_grid": ((2e4, 0.0), "m")}


def component_calls(domain, so, f, pt):
    """``{name: call(state, prv) -> {output: tensor}}`` on ``domain`` with
    storage ``so``; ``f`` the Coriolis parameter in rad s^-1, ``pt`` the
    top pressure in Pa."""
    from datetime import datetime, timedelta

    import numpy as np

    from tasmania_tpu_torch.domain.grids import GalChen3d, Sigma3d, SLEVE3d
    from tasmania_tpu_torch.framework.composite import POLICIES, DiagnosticComponentComposite
    from tasmania_tpu_torch.framework.offline_diagnostics import RMSD, RRMSD, ColumnSum
    from tasmania_tpu_torch.isentropic.physics.diagnostics import (
        IsentropicDiagnostics,
        IsentropicVelocityComponents,
    )

    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.dwarfs import HorizontalVelocity, VerticalDamping, WaterConstituent
    from tasmania_tpu_torch.framework.field import FieldArray
    from tasmania_tpu_torch.framework.steppers import SequentialTendencyStepper, TendencyStepper
    from tasmania_tpu_torch.isentropic import get_isentropic_state_from_temperature
    from tasmania_tpu_torch.isentropic.physics import (
        IsentropicConservativeCoriolis,
        IsentropicImplicitVerticalAdvectionDiagnostic,
        IsentropicImplicitVerticalAdvectionPrognostic,
        PrescribedSurfaceHeating,
    )
    from tasmania_tpu_torch.physics import (
        Clipping,
        DryStaticEnergy,
        KesslerSaturationAdjustmentDiagnostic,
        MoistStaticEnergy,
    )
    from tasmania_tpu_torch.utils.meteo import convert_relative_humidity_to_water_vapor

    grid, dt = domain.numerical_grid, COMPONENT_DT
    kw = dict(storage_options=so)
    qc = "mass_fraction_of_cloud_liquid_water_in_air"
    cf = IsentropicConservativeCoriolis(domain, "numerical", FieldArray(f, "rad s^-1", ()), **kw)
    ivd = IsentropicImplicitVerticalAdvectionDiagnostic(domain, moist=True, **kw)
    ivp = IsentropicImplicitVerticalAdvectionPrognostic(domain, moist=True, **kw)
    sts = SequentialTendencyStepper.factory("isentropic_vertical_advection",
                                            IsentropicImplicitVerticalAdvectionDiagnostic(domain, moist=True, **kw))
    sad = KesslerSaturationAdjustmentDiagnostic(domain, "numerical", **kw)
    rk2sa = TendencyStepper.factory("rk2sa", KesslerSaturationAdjustmentDiagnostic(domain, "numerical", **kw))
    clip = Clipping(domain, "numerical", **kw)
    heat = PrescribedSurfaceHeating(domain, characteristic_length=6e4, frequency_sw=0.1, frequency_fw=0.3, **kw)
    dse, mse = DryStaticEnergy(domain, "numerical", **kw), MoistStaticEnergy(domain, "numerical", **kw)
    hv, wc = HorizontalVelocity(grid, **kw), WaterConstituent(grid, clipping=True, **kw)
    damp = VerticalDamping.factory("rayleigh", grid, 15, 5e-4, **kw)
    nl = load_namelist()

    def flat(*dicts):
        return {k: (fa.data if isinstance(fa, FieldArray) else fa) for d in dicts for k, fa in d.items()
                if k != "time"}

    def raw(st, *names):
        return [st[n].data for n in names]

    def velocity(st):
        s, u, v, su, sv = raw(st, "air_isentropic_density", "x_velocity_at_u_locations",
                              "y_velocity_at_v_locations", "x_momentum_isentropic", "y_momentum_isentropic")
        mu, mv = hv.get_momenta(s, u, v)
        vu, vv = hv.get_velocity_components(s, su, sv)
        return {"su": mu, "sv": mv, "u": vu, "v": vv}

    def water(st):
        s, q = raw(st, "air_isentropic_density", qc)
        sq = wc.get_density_of_water_constituent(s, q - 1e-3)
        return {"sqc": sq, "qc": wc.get_mass_fraction_of_water_constituent_in_air(s, sq)}

    def goff_gratch(st):
        # in float64: the formula raises 10 to a sum of terms, and in float32
        # its result moves by 1.3e-6 of its largest value (the port on the
        # CPU at 41x41x120), past COMPONENT_TOL whatever the device
        p_if, t = (a.double() for a in raw(st, "air_pressure_on_interface_levels", "air_temperature"))
        p = 0.5 * (p_if[:, :, :-1] + p_if[:, :, 1:])
        return {"qv": convert_relative_humidity_to_water_vapor("goff_gratch", p, t, torch.full_like(t, 1.05))}

    def damping(st, prv):
        s, p = raw(st, "air_isentropic_density", "air_pressure_on_interface_levels")
        s1, p1 = raw(prv, "air_isentropic_density", "air_pressure_on_interface_levels")
        return {"s": damp(dt, s, s1, 0.5 * (s + s1)), "p": damp(dt, p, p1, 0.5 * (p + p1))}

    composites = {p: DiagnosticComponentComposite(
        IsentropicDiagnostics(domain, "numerical", moist=True, pt=FieldArray(np.asarray(pt), "Pa", ()), **kw),
        IsentropicVelocityComponents(domain, **kw), execution_policy=p) for p in POLICIES}
    hs = torch.as_tensor(np.asarray(grid.topography.steady_profile.to_units("m").data), dtype=so.dtype,
                         device=so.device)

    def composite(policy, st):
        return flat(composites[policy]({**st, "topography_height": FieldArray(hs, "m", ("x", "y"))}))

    offline_fields = {n: {"units": u} for n, u in (("air_isentropic_density", "kg m^-2 K^-1"),
                                                     ("y_momentum_isentropic", "kg m^-1 K^-1 s^-1"),
                                                     ("mass_fraction_of_water_vapor_in_air", "g kg^-1"))}

    def offline(st, prv):
        """The metrics of the two states, each a float64 tensor."""
        out = {}
        for metric in (RMSD(grid, offline_fields), RRMSD(grid, offline_fields, z=slice(15, None))):
            out.update({f"{type(metric).__name__} {k}": torch.tensor(v, dtype=torch.float64)
                        for k, v in metric(st, prv).items()})
        out["column sum qv"] = torch.as_tensor(
            ColumnSum(grid, "mass_fraction_of_water_vapor_in_air", "g kg^-1")(st))
        return out

    pg = domain.physical_grid

    def terrain_grid(name):
        """The grid over the namelist's Schaer mountain, grown to its
        height; its four metric fields."""
        cls = {"sigma_grid": Sigma3d, "gal_chen_grid": GalChen3d, "sleve_grid": SLEVE3d}[name]
        zv, zu = GRID_Z[name]
        g = cls(nl.domain_x, pg.nx, nl.domain_y, pg.ny, FieldArray(np.array(zv), zu, ("z",)), pg.nz,
                topography_type="schaer", topography_kwargs=nl.topo_kwargs, storage_options=so)
        g.update_topography(timedelta(seconds=1800))
        return {n: getattr(g, n).data for n in ("height", "height_on_interface_levels", "reference_pressure",
                                                 "reference_pressure_on_interface_levels")}

    def from_temperature():
        st = get_isentropic_state_from_temperature(
            grid, datetime(1992, 2, 20), nl.x_velocity, nl.y_velocity, 250.0, bubble_center_x=2e4,
            bubble_center_y=-1e4, bubble_center_height=3e3, bubble_radius=5e4,
            bubble_maximum_perturbation=2.0, moist=True, precipitation=True, relative_humidity=0.9,
            storage_options=so)
        return flat(st)

    return {
        "coriolis": lambda st, prv: flat(cf(st)[0]),
        "implicit_vertical_advection_diagnostic": lambda st, prv: flat(ivd(st, dt)[1]),
        "implicit_vertical_advection_prognostic": lambda st, prv: flat(ivp(st, dt)[0]),
        "isentropic_vertical_advection_sts": lambda st, prv: flat(sts(st, prv, dt)[1]),
        "kessler_saturation_adjustment_diagnostic": lambda st, prv: flat(*sad(st, dt)),
        "rk2sa": lambda st, prv: {f"stage2 {k}" if i == 0 else k: a for i, d in enumerate(rk2sa(st, dt))
                                  for k, a in flat(d).items()},
        "clipping": lambda st, prv: flat(clip({**st, qc: FieldArray(st[qc].data - 1e-3, "g g^-1")})),
        "prescribed_surface_heating": lambda st, prv: flat(heat(st)[0]),
        "static_energy": lambda st, prv: (lambda d: flat(d, mse({**st, **d})))(dse(st)),
        "state_from_temperature": lambda st, prv: from_temperature(),
        "goff_gratch": lambda st, prv: goff_gratch(st),
        "horizontal_velocity": lambda st, prv: velocity(st),
        "water_constituent": lambda st, prv: water(st),
        "vertical_damping": damping,
        **{f"composite_{p}": (lambda st, prv, p=p: composite(p, st)) for p in POLICIES},
        "offline_diagnostics": offline,
        **{name: (lambda st, prv, name=name: terrain_grid(name)) for name in GRID_Z},
    }


def component_states(state, theta, device, dtype, seed):
    """The float64 ``state`` with seeded perturbations (momenta, vapour,
    cloud and rain water, the θ-tendency, the potential temperature from the
    levels' ``theta``), and a second, provisional one, rounded to float32
    and placed in ``dtype`` on ``device``: so a float64 state holds the
    float32 state's numbers."""
    import numpy as np

    from tasmania_tpu_torch.framework.field import FieldArray

    shape = tuple(state["air_isentropic_density"].data.shape)
    scales = {"x_momentum_isentropic": 0.1, "y_momentum_isentropic": 0.1,
              "mass_fraction_of_water_vapor_in_air": 0.3, "air_isentropic_density": 0.02}

    def build(gen):
        arrays = {k: (fa.data.cpu().double().numpy(), fa.units, fa.dims) for k, fa in state.items()
                  if k != "time"}
        for k, scale in scales.items():
            a, u, d = arrays[k]
            arrays[k] = (a * (1.0 + scale * gen.standard_normal(shape)) + (
                0.1 if k == "y_momentum_isentropic" else 0.0), u, d)
        cell = ("x", "y", "z")
        arrays["mass_fraction_of_cloud_liquid_water_in_air"] = (gen.uniform(0.0, 2e-3, shape), "g g^-1", cell)
        arrays["mass_fraction_of_precipitation_water_in_air"] = (gen.uniform(0.0, 1e-3, shape), "g g^-1", cell)
        arrays["tendency_of_air_potential_temperature"] = (0.05 * gen.standard_normal(shape), "K s^-1", cell)
        arrays["air_potential_temperature"] = (np.broadcast_to(theta, shape), "K", cell)
        out = {k: FieldArray(torch.as_tensor(np.asarray(a, dtype=np.float32)).to(device=device, dtype=dtype),
                             u, d) for k, (a, u, d) in arrays.items()}
        out["time"] = state["time"]
        return out

    return build(np.random.default_rng(seed)), build(np.random.default_rng(seed + 1))


# phase 16, I/O and recovery on the flagship: the checkpointed run, the step
# it resumes from, the step a wrapper poisons, and the CUDA functions each
# SUS wrapper launches a call (si_stage: its two launches, A and B)
IO_STEPS = 30
IO_EVERY = 10
IO_RESUME = 20
IO_POISON = 15
IO_REPEATS = 3
TRACE_STEPS = 3
TRACE_ATTEMPTS = 3
TRACE_KERNELS = {
    "si_stage": ("stage_density_montgomery", "stage_momenta_epilogue"),
    "fused_smoothing": ("smoothing_kernel",),
    "fused_smagorinsky_rk2": ("smagorinsky_kernel",),
    "fused_kessler_satadj_rk2": ("kessler_kernel",),
    "fused_vertical_advection_rk3ws": ("vertical_advection_kernel",),
    "fused_sedimentation_rk3ws": ("sedimentation_kernel",),
    "fused_isentropic_diagnostics": ("diagnostics_kernel",),
}
# fields the NetCDF layout cannot hold beside the 3-D fields: the two
# precipitation fields declare the dims ("x", "y", "z") at one level, so "z"
# would take two sizes (the JAX package's monitor refuses them alike)
NETCDF_SKIP = ("precipitation", "accumulated_precipitation")
# the SUS chain's components: each names a Timer label, alone or in a fused
# operation's "A+B" label
CHAIN_COMPONENTS = ("IsentropicDiagnostics", "IsentropicHorizontalSmoothing", "IsentropicSmagorinsky",
                    "IsentropicVelocityComponents", "KesslerMicrophysics",
                    "KesslerSaturationAdjustmentPrognostic", "IsentropicVerticalAdvection",
                    "KesslerFallVelocity", "KesslerSedimentation", "Precipitation")


# phase 16's traced run, in a process of its own: 3 steps unprofiled, then 3
# under --profile's trace; prints their ms a step
TRACE_RUN = """
import json, torch
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.options import StorageOptions
nl = load_namelist(niter={steps}, so=StorageOptions(dtype=torch.float32, device={device!r}), **{grid!r})
plain = drv.run(nl, verbose=False, fused_loop=False)
profiled = drv.run(nl, verbose=False, fused_loop=False, profile={trace_dir!r})
print(json.dumps({{"plain": plain["ms_per_step"], "profiled": profiled["ms_per_step"]}}))
"""


def trace_counts(path) -> dict:
    """The device kernels of a Chrome trace, counted by each CUDA function
    of ``TRACE_KERNELS``."""
    import re

    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return {fn: sum(1 for n in names if re.search(rf"\b{fn}\b", n))
            for fns in TRACE_KERNELS.values() for fn in fns}


def io_phase(card, path_counts, path_steps, device="cuda", size=None):
    """Phase 16: checkpoints, resume, the NaN guard, the profiler trace, the
    Timer and the NetCDF round trip on the flagship (module docstring).
    ``size`` (nx, ny, nz) rehearses it on the CPU at a small size, where no
    kernel is launched and the trace holds no device kernel.  Adds the
    checkpointed run's launches to ``path_counts`` (``sus_io``) and returns
    the JSON numbers."""
    import statistics
    import tempfile

    import numpy as np

    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.field import FieldArray
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager
    from tasmania_tpu_torch.utils.iox import NetCDFMonitor, load_netcdf_dataset
    from tasmania_tpu_torch.utils.timer import Timer

    on_card = torch.device(device).type == "cuda"
    grid = dict(zip(("nx", "ny", "nz"), size)) if size else {}
    so = StorageOptions(dtype=torch.float32, device=device)
    nl = load_namelist(niter=IO_STEPS, so=so, **grid)
    per_step = LAUNCHES_PER_STEP["sus"] if on_card else {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the checkpointed run, the phase's path
        sync()
        _lib.reset_launch_counts()
        full = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp / "ck"),
                       checkpoint_every=IO_EVERY, nan_guard=True)
        counts = dict(_lib.launch_counts)
        expected = {k: (1 + IO_STEPS) * n for k, n in per_step.items()}
        if counts != expected:
            raise AssertionError(f"sus_io: launched {counts}, expected {expected}")
        path_counts["sus_io"], path_steps["sus_io"] = counts, 1 + IO_STEPS
        mgr = CheckpointManager(str(tmp / "ck"))
        steps = list(range(IO_EVERY, IO_STEPS + 1, IO_EVERY))[-3:]
        if mgr.all_steps() != steps:
            raise AssertionError(f"sus_io: checkpoints {mgr.all_steps()}, expected {steps}")
        mb = mgr.nbytes(IO_RESUME) / 1e6
        # resume from IO_RESUME: the last steps again, bit for bit
        resumed = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp / "ck"),
                          checkpoint_every=IO_EVERY, resume=IO_RESUME, nan_guard=True)
        if resumed["start"] != IO_RESUME:
            raise AssertionError(f"resume: started after step {resumed['start']}, not {IO_RESUME}")
        differ = sorted(k for k, fa in full["fields"].items()
                        if not torch.equal(resumed["fields"][k].data, fa.data))
        if differ or set(resumed["fields"]) != set(full["fields"]):
            raise AssertionError(f"resume: fields differ from the uninterrupted run: {differ}")
        phase("io-resume", f"{len(full['fields'])} fields bit for bit the uninterrupted run's after "
              f"{IO_STEPS - IO_RESUME} steps from checkpoint {IO_RESUME}; checkpointed run "
              f"{full['ms_per_step']:.3f} ms/step over 1+{IO_STEPS} steps ({len(steps)} saves, the guard "
              f"at each), resumed {resumed['ms_per_step']:.3f} ms/step on {card}")
        # save and restore times, and the restore onto the CPU
        timed_mgr = CheckpointManager(str(tmp / "timed"))
        save_ms = [timed(lambda i=i: timed_mgr.save(i, full["fields"]))[1] for i in range(IO_REPEATS)]
        card_state, restore_ms = None, []
        for _ in range(IO_REPEATS):
            card_state, ms = timed(lambda: mgr.restore(IO_RESUME))
            restore_ms.append(ms)
        cpu_state, cpu_restore_ms = timed(lambda: mgr.restore(IO_RESUME, device="cpu"))
        for k, fa in card_state.items():
            if fa.data.device.type != torch.device(device).type or cpu_state[k].data.device.type != "cpu":
                raise AssertionError(f"restore: {k} on {fa.data.device} and {cpu_state[k].data.device}")
            if not torch.equal(cpu_state[k].data, fa.data.cpu()):
                raise AssertionError(f"restore: {k} on the CPU differs from the card's")
        out.update(checkpoint_mb=mb, save_ms=statistics.median(save_ms),
                   restore_ms=statistics.median(restore_ms), restore_cpu_ms=cpu_restore_ms)
        phase("io-checkpoint", f"{mb:.1f} MB a checkpoint ({len(card_state)} fields); save "
              f"{out['save_ms']:.1f} ms, restore {out['restore_ms']:.1f} ms (medians of {IO_REPEATS}), "
              f"restore onto the CPU {cpu_restore_ms:.1f} ms, bit for bit the card's, on {card}")
        del card_state, cpu_state, resumed

        # the NaN guard: a NaN written at IO_POISON trips it at the next boundary
        domain, state, pt = drv.build_domain_and_state(nl)
        dycore, physics = drv.build_model(nl, domain, pt)
        calls = [0]

        def poisoned(st, dt):
            new = physics(dycore(st, {}, dt), dt)
            calls[0] += 1
            if calls[0] == 1 + IO_POISON:  # the warm-up step, then IO_POISON
                new["air_isentropic_density"].data[5, 7, 11] = float("nan")
            return new

        boundary = -(-IO_POISON // IO_EVERY) * IO_EVERY
        last = boundary - IO_EVERY
        want = f"at step {boundary}; last good checkpoint: step {last}"
        try:
            drv.run_steps(nl, state, poisoned, dycore.topography_steady, verbose=False, fused_loop=False,
                          checkpoint_dir=str(tmp / "nan"), checkpoint_every=IO_EVERY, nan_guard=True)
        except RuntimeError as err:
            if want not in str(err):
                raise AssertionError(f"nan guard: {err!r} does not say {want!r}") from err
            message = str(err)
        else:
            raise AssertionError("nan guard: the poisoned run did not raise")
        if CheckpointManager(str(tmp / "nan")).all_steps() != list(range(IO_EVERY, last + 1, IO_EVERY)):
            raise AssertionError(f"nan guard: checkpoints {CheckpointManager(str(tmp / 'nan')).all_steps()}")
        phase("io-nan-guard", f"NaN written at step {IO_POISON}: {message}; checkpoints "
              f"{CheckpointManager(str(tmp / 'nan')).all_steps()}")
        del dycore, physics, state

        # the profiler: each SUS kernel in the trace as often as it launched,
        # in a process of its own, as a user's run with --profile: in this
        # one, after phase 3's hundreds of profiler sessions, a trace loses
        # the first launches it should hold
        want_trace = {fn: per_step.get(w, 0) * TRACE_STEPS
                      for w, fns in TRACE_KERNELS.items() for fn in fns}
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            trace_dir = tmp / f"trace{attempt}"
            code = TRACE_RUN.format(steps=TRACE_STEPS, device=str(device), grid=grid, trace_dir=str(trace_dir))
            run = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode:
                raise AssertionError(f"profile: the traced run failed:\n{run.stderr[-4000:]}")
            ms = json.loads(run.stdout.strip().splitlines()[-1])
            (trace,) = trace_dir.glob("*.json")
            got = trace_counts(trace)
            if not on_card or got == want_trace:
                break
            phase("io-profile", f"trace {attempt}: {got}, expected {want_trace}")
        else:
            raise AssertionError(f"profile: no trace of {TRACE_ATTEMPTS} holds the launches {want_trace}")
        out.update(trace_mb=trace.stat().st_size / 1e6, trace_attempts=attempt,
                   profiled_ms_per_step=ms["profiled"], unprofiled_ms_per_step=ms["plain"])
        phase("io-profile", f"{TRACE_STEPS} steps: {ms['profiled']:.3f} ms/step profiled, "
              f"{ms['plain']:.3f} unprofiled (one process); trace {out['trace_mb']:.1f} MB (attempt "
              f"{attempt}), CUDA functions {got} on {card}")

        # the Timer, synchronised, over one eager step
        domain, state, pt = drv.build_domain_and_state(nl)
        dycore, physics = drv.build_model(nl, domain, pt)
        st = {k: v for k, v in state.items() if k != "time"}
        st["topography_height"] = FieldArray(dycore.topography_steady * 0.0, "m", ("x", "y"))
        physics(dycore(dict(st), {}, 5.0), 5.0)  # warm-up, untimed
        Timer.reset()
        Timer.enabled = True
        try:
            with Timer.timing("step"):
                physics(dycore(dict(st), {}, 5.0), 5.0)
        finally:
            Timer.enabled = False
        log = Timer.log(units="ms")
        labels = {ln.strip().split(": ")[0] for ln in log.splitlines()}
        out["timer_ms"] = {label: Timer.get_time(label, "ms") for label in sorted(labels)}
        Timer.reset()
        missing = sorted(set(CHAIN_COMPONENTS + ("stage",)) - {p for label in labels for p in label.split("+")})
        if missing:
            raise AssertionError(f"timer: no label for {missing}")
        phase("io-timer", f"one step, synchronised, on {card}: " + " | ".join(ln.strip() for ln in log.splitlines()))
        del dycore, physics

        # NetCDF: the initial and the final state, written and loaded back
        final = {"time": nl.init_time + (1 + IO_STEPS) * nl.timestep, **full["fields"]}
        names = tuple(k for k in final if k not in NETCDF_SKIP + ("time",))
        mon = NetCDFMonitor(str(tmp / "states.nc"), domain, store_names=names)
        mon.store(state)
        mon.store(final)
        _, write_ms = timed(mon.write)
        (loaded_domain, _, loaded), load_ms = timed(lambda: load_netcdf_dataset(str(tmp / "states.nc")))
        for orig, back in zip((state, final), loaded):
            if back["time"] != orig["time"] or set(back) != set(names) | {"time"}:
                raise AssertionError("netcdf: times or field names differ")
            for k in names:
                if not torch.equal(back[k].data, orig[k].data.cpu()):
                    raise AssertionError(f"netcdf: {k} differs from its host copy")
        for axis in ("x", "y", "z", "z_on_interface_levels", "x_at_u_locations", "y_at_v_locations"):
            a = np.asarray(getattr(loaded_domain.physical_grid, axis).data)
            if not np.array_equal(a, np.asarray(getattr(domain.physical_grid, axis).data)):
                raise AssertionError(f"netcdf: the rebuilt grid's {axis} differs")
        if not np.array_equal(np.asarray(loaded_domain.numerical_grid.topography.steady_profile.data),
                              np.asarray(domain.numerical_grid.topography.steady_profile.data)):
            raise AssertionError("netcdf: the rebuilt topography differs")
        nc_mb = (tmp / "states.nc").stat().st_size / 1e6
        out.update(netcdf_mb=nc_mb, netcdf_write_ms=write_ms, netcdf_load_ms=load_ms)
        phase("io-netcdf", f"2 states of {len(names)} fields (not {', '.join(NETCDF_SKIP)}), {nc_mb:.1f} MB: write {write_ms:.1f} ms, load {load_ms:.1f} ms; "
              "fields equal to their host copies, the grid and topography rebuilt equal")
    return out


def components_phase(card, device="cuda", size=None, timer=None):
    """Phase 15: each component of ``component_calls`` once on the card in
    float32 against the port's float64 CPU result of the same call; ``size``
    (nx, ny, nz) and ``timer`` let the phase be rehearsed on the CPU at a
    small size.  Returns the JSON rows."""
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib

    timer = timer or device_ms
    grid = dict(zip(("nx", "ny", "nz"), size)) if size else {}
    f32 = StorageOptions(dtype=torch.float32, device=device)
    cpu64 = StorageOptions(dtype=torch.float64, device="cpu")
    import numpy as np

    domain, _, _ = drv.build_domain_and_state(load_namelist(relative_humidity=1.05, so=f32, **grid))
    domain64, state64, pt64 = drv.build_domain_and_state(load_namelist(relative_humidity=1.05, so=cpu64, **grid))
    pt = float(np.asarray(pt64.to_units("Pa").data))
    theta = np.asarray(domain64.numerical_grid.z.to_units("K").data)
    st, prv = component_states(state64, theta, device, torch.float32, COMPONENT_SEED)
    st64, prv64 = component_states(state64, theta, "cpu", torch.float64, COMPONENT_SEED)
    calls, calls64 = component_calls(domain, f32, 1e-4, pt), component_calls(domain64, cpu64, 1e-4, pt)
    cpu32 = StorageOptions(dtype=torch.float32, device="cpu")
    domain_cpu32, _, _ = drv.build_domain_and_state(load_namelist(relative_humidity=1.05, so=cpu32, **grid))
    calls_cpu32 = component_calls(domain_cpu32, cpu32, 1e-4, pt)
    # the path: each component once, no kernel launched (plain PyTorch) but
    # the composites' diagnostics
    if device == "cuda":
        torch.cuda.synchronize()
    _lib.reset_launch_counts()
    outs = {name: call(st, prv) for name, call in calls.items()}
    on_card = torch.device(device).type == "cuda"
    expected = COMPONENT_LAUNCHES if on_card else {}
    if dict(_lib.launch_counts) != expected:
        raise AssertionError(f"components: launched {dict(_lib.launch_counts)}, expected {expected}")
    rows = []
    for name, out in outs.items():
        ref = calls64[name](st64, prv64)
        if set(out) != set(ref):
            raise AssertionError(f"component {name}: outputs {sorted(out)} vs {sorted(ref)}")
        errs = []
        host = calls_cpu32[name](None, None) if name in HOST_BUILT else {}
        for key, r in ref.items():
            g = out[key].double().cpu()
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"component {name} {key} is not finite")
            e = float((g - r).abs().max())
            if name in HOST_BUILT:
                if not torch.equal(out[key].cpu(), host[key]):
                    raise AssertionError(f"component {name} {key}: the card's differs from the host's build")
                scale = limit = float(r.abs().max())
            elif name == "implicit_vertical_advection_prognostic":
                # (new - old)/dt: the update, beside the float32 rounding of the field
                base = st64[key].data
                scale = float(r.abs().max())
                limit = COMPONENT_TOL * scale + 4 * torch.finfo(torch.float32).eps * float(
                    base.abs().max()) / COMPONENT_DT
            else:
                scale = float(r.abs().max())
                limit = COMPONENT_LOOSER.get((name, key), COMPONENT_TOL) * scale
            if not e <= limit:
                raise AssertionError(f"component {name} {key}: max|d| = {e} > {limit} (scale {scale})")
            errs.append((key, e / scale if scale else e))
        call = calls[name]
        if name in GRID_Z:
            t0 = time.perf_counter()
            call(st, prv)
            ms, how = 1e3 * (time.perf_counter() - t0), "host clock, one build"
        else:
            ms, how = timer(lambda: call(st, prv))
        worst = max(e for _, e in errs)
        rows.append(dict(name=name, outputs=len(errs), rel_err=worst, device_ms=ms, timed_by=how))
        held = ("built on the host, equal to the float32 CPU build bit for bit; its distance"
                if name in HOST_BUILT else "largest error")
        dtype = str(next(iter(out.values())).dtype).replace("torch.", "")
        launched = ("one launch of the diagnostics kernel" if name.startswith("composite_") and on_card
                    else "no kernel launched")
        phase("component", f"{name} at {'x'.join(map(str, st['air_isentropic_density'].data.shape))} "
              f"{dtype}: {ms:.4f} ms a call ({how}); {len(errs)} outputs, {held} {worst:.1e} of "
              f"the largest magnitude of the float64 CPU result; {launched}")
    return rows


# phase 12's and phase 17's dwarfs: each family's module and base class
DWARF_FAMILIES = {"diffusion": ("horizontal_diffusion", "HorizontalDiffusion"),
                  "hyperdiffusion": ("horizontal_hyperdiffusion", "HorizontalHyperDiffusion"),
                  "smoothing": ("horizontal_smoothing", "HorizontalSmoothing")}


def dwarf_family(kind):
    import importlib

    module, name = DWARF_FAMILIES[kind]
    return getattr(importlib.import_module(f"tasmania_tpu_torch.dwarfs.{module}"), name)


def build_dwarf(kind, name, so, backend=None):
    """Phase 12's dwarf ``name`` of ``kind`` (the flagship's spacing), built
    by its registered class, or with ``backend`` through the family's
    factory."""
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

    nl = load_namelist()
    ddx = (nl.domain_x[1] - nl.domain_x[0]) / (DWARF_SHAPE[0] - 1)
    ddy = (nl.domain_y[1] - nl.domain_y[0]) / (DWARF_SHAPE[1] - 1)
    args = ((DWARF_SHAPE, *DWARF_SMOOTH, DWARF_NB) if kind == "smoothing"
            else (DWARF_SHAPE, ddx, ddy, *DWARF_DIFFUSION, DWARF_NB))
    family = dwarf_family(kind)
    if backend is None:
        return family.registry[name](*args, storage_options=so)
    return family.factory(name, *args, backend=backend, storage_options=so)


# phase 17, the registry: the flagship built by name through a user's
# registrations and under the JAX backend names, every registered stencil on
# the card against the port's float64 CPU result (COMPONENT_TOL), phase 12's
# dwarfs through their factories and the allocators
USER_TOPOGRAPHY = "user_gaussian"
USER_BOUNDARY = "user_relaxed"
REGISTRY_BACKENDS = ("jax", "pallas")
REGISTRY_STEPS = 20
# the graph step of the built-in and the user's names: pairs in this call
REGISTRY_PAIRS = 10
STENCIL_SEED = 17
STENCIL_SHAPE = (161, 161, 120)
# f and dt of the algebra, dx and dy of the Laplacian (the flagship's spacing)
STENCIL_EXTERNALS = {"f": 0.7, "dt": 5.0, "dx": 2.2e3, "dy": 2.2e3}


def register_user_flavours():
    """Register, as a user would, a topography that copies ``Gaussian`` and
    a subclass of ``Relaxed``, under names of their own (once); returns the
    names and a function that removes the two registrations."""
    from tasmania_tpu_torch.domain.boundaries.relaxed import Relaxed
    from tasmania_tpu_torch.domain.horizontal_boundary import HorizontalBoundary
    from tasmania_tpu_torch.domain.topography import Gaussian, PhysicalTopography
    from tasmania_tpu_torch.framework.registry import factor_register

    if USER_TOPOGRAPHY not in PhysicalTopography.registry:
        @factor_register(USER_TOPOGRAPHY)
        class UserGaussian(Gaussian):
            """Gaussian's mountain under the user's name."""

    if USER_BOUNDARY not in HorizontalBoundary.registry:
        @factor_register(USER_BOUNDARY)
        class UserRelaxed(Relaxed):
            """The relaxed boundary under the user's name."""

    def unregister():
        PhysicalTopography.registry.pop(USER_TOPOGRAPHY, None)
        HorizontalBoundary.registry.pop(USER_BOUNDARY, None)

    return {"topography": USER_TOPOGRAPHY, "boundary": USER_BOUNDARY, "unregister": unregister}


def stencil_inputs(name, fn, shape, seed):
    """Seeded float64 host inputs of a registered definition: its positional
    arrays (a diagonally dominant system for the Thomas solve)."""
    import inspect

    import numpy as np

    rng = np.random.default_rng(seed)
    if name == "thomas":
        return (rng.uniform(-1.0, 1.0, shape), 2.5 + rng.uniform(0.0, 1.0, shape),
                rng.uniform(-1.0, 1.0, shape), rng.standard_normal(shape))
    arity = sum(p.kind == p.POSITIONAL_OR_KEYWORD for p in inspect.signature(fn).parameters.values())
    return tuple(rng.standard_normal(shape) for _ in range(arity))


def registry_phase(card, path_counts, path_steps, dwarf_outs, dwarf_phi, device="cuda", size=None,
                   timer=None, graphs=True):
    """Phase 17 (module docstring).  ``dwarf_outs`` are phase 12's outputs
    of ``dwarf_phi``, keyed by (kind, name).  ``size`` (nx, ny, nz) and
    ``timer`` rehearse it on the CPU at a small size, without the graphs
    (``graphs``) and with no kernel launched.  Adds the user-registered
    run's launches to ``path_counts`` (``sus_registry``) and returns the
    JSON numbers."""
    import numpy as np

    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework import allocators
    from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions
    from tasmania_tpu_torch.framework.registry import registered_names
    from tasmania_tpu_torch.framework.stencil import (
        STENCIL_REGISTRY,
        SUBROUTINE_REGISTRY,
        StencilFactory,
        compile_stencil,
        compile_subroutine,
    )
    from tasmania_tpu_torch.ops import _lib

    timer = timer or device_ms
    on_card = torch.device(device).type == "cuda"
    grid = dict(zip(("nx", "ny", "nz"), size)) if size else {}
    so = StorageOptions(dtype=torch.float32, device=device)
    per_step = LAUNCHES_PER_STEP["sus_registry"] if on_card else {}
    user = register_user_flavours()
    by_name = dict(topo_type=user["topography"], hb_type=user["boundary"])
    common = dict(so=so, niter=REGISTRY_STEPS, **grid)
    namelists = {"built_in": load_namelist(**common), "user": load_namelist(**common, **by_name),
                 **{b: load_namelist(**common, backend=b, **by_name) for b in REGISTRY_BACKENDS}}
    out = {"user_names": {k: user[k] for k in ("topography", "boundary")}, "runs": {}}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # (a), (b): each run eager and as a graph, from zeroed counts; every
    # run's fields equal the built-in names' eager run's bit for bit
    base = None
    for tag, nl in namelists.items():
        for fused in (False, True) if graphs else (False,):
            sync()
            _lib.reset_launch_counts()
            res = drv.run(nl, verbose=False, fused_loop=fused)
            sync()
            counts = dict(_lib.launch_counts)
            steps = 2 if fused else 1 + nl.niter
            for name in sorted(set(per_step) | set(counts)):
                if counts.get(name, 0) != steps * per_step.get(name, 0):
                    raise AssertionError(f"registry {tag} ({'graph' if fused else 'eager'}): {name} launched "
                                         f"{counts.get(name, 0)} times, expected {steps * per_step.get(name, 0)}")
            if res["launches_per_step"] != per_step:
                raise AssertionError(f"registry {tag}: a step launched {res['launches_per_step']}")
            if base is None:
                base = res["fields"]
                bad = [k for k, fa in base.items() if not bool(torch.isfinite(fa.data).all())]
                if bad:
                    raise AssertionError(f"registry: non-finite fields {bad}")
            unequal = sorted(k for k, fa in base.items() if not torch.equal(res["fields"][k].data, fa.data))
            if set(res["fields"]) != set(base) or unequal:
                raise AssertionError(f"registry {tag} ({'graph' if fused else 'eager'}): fields {unequal} "
                                     f"differ from the built-in names' eager run")
            if tag == "user" and not fused:
                path_counts["sus_registry"], path_steps["sus_registry"] = counts, 1 + nl.niter
            out["runs"][f"{tag}_{'graph' if fused else 'eager'}"] = dict(
                launches=counts, ms_per_step=res["ms_per_step"])
            phase("registry", f"{tag} ({nl.topo_type}, {nl.hb_type}, backend {nl.backend}), "
                  f"{'graph' if fused else 'eager'}, {nl.nx}x{nl.ny}x{nl.nz}, 1+{nl.niter} steps: "
                  f"{res['ms_per_step']:.3f} ms/step; its {len(base)} fields equal the built-in names' "
                  f"eager run's bit for bit; launches {counts}")
            del res
    del base

    # the graph step of the built-in and the user's names in alternating pairs
    if graphs:
        runs = {"built_in": [], "user": []}
        built = {}
        for tag in runs:
            nl_t = load_namelist(so=so, niter=FUSED_TIMED_STEPS, **grid,
                                 **(by_name if tag == "user" else {}))
            _, t_state, t_dycore, t_step = moist.build_variant(nl_t, "sus")
            built[tag] = (nl_t, t_state, t_step, t_dycore.topography_steady)
        for i in range(REGISTRY_PAIRS):
            for tag in (("built_in", "user") if i % 2 == 0 else ("user", "built_in")):
                nl_t, t_state, t_step, hs = built[tag]
                runs[tag].append(drv.run_steps(nl_t, t_state, t_step, hs, verbose=False,
                                               fused_loop=True)["ms_per_step"])
        del built
        med = {tag: sorted(r)[len(r) // 2] for tag, r in runs.items()}
        out["graph_ms_per_step"] = runs
        phase("registry-timing", f"graph step, {FUSED_TIMED_STEPS} timed steps a run, {REGISTRY_PAIRS} pairs on "
              f"{card}: built-in names {' '.join(f'{t:.3f}' for t in runs['built_in'])} (median "
              f"{med['built_in']:.3f}); the user's {' '.join(f'{t:.3f}' for t in runs['user'])} (median "
              f"{med['user']:.3f}) ms/step")

    # (c) every registered stencil and subroutine on seeded float32 tensors
    bo = BackendOptions(externals=STENCIL_EXTERNALS)
    shape = STENCIL_SHAPE if size is None else tuple(size)
    rows = []
    sync()
    _lib.reset_launch_counts()
    for kind, reg, compile_ in (("stencil", STENCIL_REGISTRY, compile_stencil),
                                ("subroutine", SUBROUTINE_REGISTRY, compile_subroutine)):
        for name in reg.names():
            host = [np.asarray(a, dtype=np.float32) for a in
                    stencil_inputs(name, reg.query(name, "torch"), shape, STENCIL_SEED)]
            fn, fn64 = compile_(name, "jax", bo), compile_(name, "torch", bo)
            args = [torch.as_tensor(a, device=device) for a in host]
            got = fn(*args)
            ref = fn64(*(torch.as_tensor(a, dtype=torch.float64) for a in host))
            g = got.double().cpu()
            scale = float(ref.abs().max())
            err = float((g - ref).abs().max())
            if not (got.device.type == torch.device(device).type and got.dtype == torch.float32
                    and bool(torch.isfinite(g).all()) and err <= COMPONENT_TOL * scale):
                raise AssertionError(f"{kind} {name}: max|d| = {err} > {COMPONENT_TOL} * {scale} "
                                     f"({got.dtype} on {got.device})")
            ms, how = timer(lambda: fn(*args))
            b = bound(nbytes(args) + got.numel() * got.element_size(), 0.0)
            rows.append(dict(kind=kind, name=name, rel_err=err / scale, device_ms=ms, timed_by=how,
                             bound_ms=b["bound_ms"], bound_by=b["bound_by"]))
            phase("registry-stencil", f"{kind} {name} (backend jax) at {'x'.join(map(str, shape))} "
                  f"float32: {ms:.4f} ms a call ({how}), bound {b['bound_ms']:.4f} ms by {b['bound_by']}; "
                  f"error {err / scale:.1e} of the largest magnitude of the float64 CPU result")
            del args, got, g, ref
    sync()
    if dict(_lib.launch_counts):
        raise AssertionError(f"registry stencils: launched {dict(_lib.launch_counts)}, expected none")
    out["stencils"] = rows

    # (d) phase 12's dwarfs through their factories, under a JAX backend name
    sync()
    _lib.reset_launch_counts()
    built = {(k, n): build_dwarf(k, n, so, backend="jax") for k, n in dwarf_outs}
    outs = {key: d(dwarf_phi) for key, d in built.items()}
    sync()
    counts = dict(_lib.launch_counts)
    expected = ({"fused_smoothing": sum(d.axes == "xy" for (k, _), d in built.items() if k == "smoothing")}
                if on_card else {})
    if counts != expected:
        raise AssertionError(f"registry dwarfs: launched {counts}, expected {expected}")
    for key, got in outs.items():
        if type(built[key]) is not dwarf_family(key[0]).registry[key[1]] or not torch.equal(got, dwarf_outs[key]):
            raise AssertionError(f"registry dwarf {key}: differs from phase 12's")
    names = {k: list(registered_names(dwarf_family(k))) for k in DWARF_FAMILIES}
    if sorted(outs) != sorted((k, n) for k, ns in names.items() for n in ns):
        raise AssertionError(f"registry dwarfs: built {sorted(outs)}, registered {names}")
    out["dwarfs"] = dict(count=len(outs), launches=counts)
    phase("registry-dwarfs", f"{len(outs)} dwarfs built through their factories (backend jax) give "
          f"phase 12's bits; launches {counts}")
    del built, outs

    # (e) the allocators and the factory mixin on the card
    placed = []
    for backend in ("torch", *REGISTRY_BACKENDS):
        sf = StencilFactory(backend, storage_options=so)
        for t in (allocators.zeros(backend, (4, 3), storage_options=so),
                  allocators.ones(backend, (4, 3), storage_options=so),
                  allocators.empty(backend, (4, 3), storage_options=so),
                  allocators.as_storage(backend, np.arange(12.0).reshape(4, 3), storage_options=so),
                  sf.zeros((4, 3)), sf.ones((4, 3)), sf.empty((4, 3)), sf.as_storage([1.0, 2.0])):
            if t.device.type != torch.device(device).type or t.dtype != torch.float32:
                raise AssertionError(f"allocator under {backend}: {t.dtype} on {t.device}")
            placed.append(str(t.device))
    out["allocators"] = dict(tensors=len(placed), devices=sorted(set(placed)))
    phase("registry-allocators", f"{len(placed)} tensors from zeros, ones, empty and as_storage (and the "
          f"factory mixin's) under torch, jax and pallas: float32 on {sorted(set(placed))}")
    user["unregister"]()
    return out


# phase 18, distribution and tools: the sharded checkpoints at phase 14's
# configuration (SHARDED_REFERENCE's grid, float32, four gloo ranks sharing
# the card), 1 + DIST_STEPS steps checkpointed every DIST_EVERY and resumed
# from step DIST_RESUME; --spmd on the card's one rank and driver_profile's
# variants at the flagship, 1 + DIST_STEPS graph steps; driver_dist_bench's
# 1x1 mesh at the flagship, DIST_BENCH_PAIRS alternating pairs of
# FUSED_TIMED_STEPS graph steps; driver_weak_scaling at WEAK_BLOCK x
# WEAK_BLOCK x WEAK_NZ a rank on 1 and 4 ranks, WEAK_STEPS steps
DIST_STEPS = 20
DIST_EVERY = 10
DIST_RESUME = 10
DIST_BENCH_PAIRS = 5
PROFILE_PAIRS = 5
WEAK_BLOCK = 128
WEAK_NZ = 64
WEAK_STEPS = 10
# the H100 SXM data sheet's NVLink (fourth generation): 900 GB/s a GPU, both
# directions together; a spec, not a measurement
NVLINK_GBS = 450.0
NODE_GRIDS = ((2, 1), (1, 2))


def node_blocks(coords, local_world):
    """Raise unless each node's ranks (``local_world`` consecutive ranks)
    sit in one contiguous rectangle of the grid; returns the rectangles."""
    rects = []
    for first in range(0, len(coords), local_world):
        pts = coords[first : first + local_world]
        xs, ys = [p[0] for p in pts], [p[1] for p in pts]
        rect = (min(xs), max(xs), min(ys), max(ys))
        if (rect[1] - rect[0] + 1) * (rect[3] - rect[2] + 1) != len(set(pts)) or len(set(pts)) != len(pts):
            raise AssertionError(f"hybrid grid: node of ranks {first}..{first + local_world - 1} holds "
                                 f"{pts}, not a contiguous block")
        rects.append(rect)
    return rects


def distribution_phase(card, path_counts, path_steps, device="cuda", size=None, flagship=None, keep=None):
    """Phase 18 (module docstring).  ``size`` (nx, ny, nz) replaces phase
    14's grid and ``flagship`` (nx, ny, nz) the flagship's, so that the
    phase can be rehearsed on the CPU (no graph, no launch counted there).
    ``keep`` (a dict) receives the one-rank run's fields (numpy) of (b)
    under ``spmd_one_rank``, which phase 20 (c) compares."""
    import statistics
    import tempfile

    import numpy as np

    from tasmania_tpu_torch.drivers import driver_dist_bench as ddb
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers import driver_profile as dprof
    from tasmania_tpu_torch.drivers import driver_weak_scaling as dws
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.parallel.mesh import RankGrid
    from tasmania_tpu_torch.parallel.runner import ShardLayout
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

    on_card = torch.device(device).type == "cuda"
    so = StorageOptions(dtype=torch.float32, device=device)
    sref = json.loads(Path(drv.__file__).with_name(SHARDED_REFERENCE).read_text())["config"]
    nx, ny, nz = size or (sref["nx"], sref["ny"], sref["nz"])
    grid = dict(nx=nx, ny=ny, nz=nz)
    flag = dict(zip(("nx", "ny", "nz"), flagship)) if flagship else {}
    sharded = LAUNCHES_PER_STEP["sharded"] if on_card else {}
    sus = LAUNCHES_PER_STEP["sus"] if on_card else {}
    out = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts_equal(tag, counts, per_step, steps):
        want = {k: n * steps for k, n in per_step.items() if n}
        if {k: n for k, n in counts.items() if n} != want:
            raise AssertionError(f"{tag}: launched {counts}, expected {want}")

    def tol_of(name):
        return DIAG_RHO_TOL if name == "air_density" else SHARDED_FIELD_TOL

    def bitwise(tag, got, ref):
        unequal = sorted(k for k, a in ref.items() if not np.array_equal(got[k], a))
        if unequal or set(got) != set(ref):
            raise AssertionError(f"{tag}: {unequal or sorted(set(got) ^ set(ref))} differ")

    def spmd(ranks, mesh, steps, **job):
        _lib.reset_launch_counts()
        t0 = time.perf_counter()
        res = drv.run_spmd(dict(grid, niter=steps, so=so), ranks=ranks, comm="gloo", device=device,
                           mesh=mesh, verbose=False, timeout_s=SHARDED_TIMEOUT_S, **job)
        res["wall_s"] = time.perf_counter() - t0
        if dict(_lib.launch_counts):
            raise AssertionError(f"spmd: the parent launched {dict(_lib.launch_counts)}")
        if any(res["imported_by_rank"]):
            raise AssertionError(f"spmd: ranks imported {res['imported_by_rank']}")
        return res

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = str(tmp / "sharded")
        # (a) the uninterrupted run on 2x2, checkpointed; the resumes
        full = spmd(4, (2, 2), DIST_STEPS, checkpoint_dir=ck, checkpoint_every=DIST_EVERY)
        for r, counts in enumerate(full["launches_by_rank"]):
            counts_equal(f"spmd 2x2 rank {r}", counts, sharded, 1 + DIST_STEPS)
        mgr = CheckpointManager(ck)
        if mgr.all_steps() != list(range(DIST_EVERY, DIST_STEPS + 1, DIST_EVERY)):
            raise AssertionError(f"spmd: checkpoint steps {mgr.all_steps()}")
        mb = mgr.nbytes(DIST_RESUME) / 1e6
        save_ms = [1e3 * t for t in full["checkpoint_save_s"]]
        sync()
        t0 = time.perf_counter()
        assembled = mgr.restore(DIST_RESUME, device=device)
        sync()
        assemble_ms = 1e3 * (time.perf_counter() - t0)
        del assembled
        fields = full["fields"]
        same = spmd(4, (2, 2), DIST_STEPS, checkpoint_dir=ck, resume=DIST_RESUME)
        bitwise("spmd resumed on 2x2", same["fields"], fields)
        for r, counts in enumerate(same["launches_by_rank"]):
            counts_equal(f"spmd resumed 2x2 rank {r}", counts, sharded, 1 + DIST_STEPS - DIST_RESUME)
        tall = spmd(4, (4, 1), DIST_STEPS, checkpoint_dir=ck, resume=DIST_RESUME)
        for r, counts in enumerate(tall["launches_by_rank"]):
            counts_equal(f"spmd resumed 4x1 rank {r}", counts, sharded, 1 + DIST_STEPS - DIST_RESUME)
        d41 = field_differences(tall["fields"], fields)
        check_differences("spmd resumed on 4x1", d41, tol_of)
        nl = load_namelist(niter=DIST_STEPS, so=so, **grid)
        _lib.reset_launch_counts()
        one = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=ck, resume=DIST_RESUME)
        counts_equal("single device resumed", dict(_lib.launch_counts), sus, 1 + DIST_STEPS - DIST_RESUME)
        single = {k: fa.data.cpu().numpy() for k, fa in one["fields"].items()}
        d11 = field_differences(single, fields)
        check_differences("single device resumed from the sharded checkpoint", d11, tol_of)
        # the single device's checkpoint of step DIST_STEPS (its final save,
        # over the sharded one) restored onto each rank of 2x2
        if mgr.meta(DIST_STEPS).get("sharded"):
            raise AssertionError("the single device's run did not write a single-process step")
        domain, state, _ = drv.build_domain_and_state(nl)
        restore_ms = []
        for r in range(4):
            layout = ShardLayout(domain, RankGrid(2, 2), r, halo=nl.nb + 1)
            layout.set_fields(state)
            sync()
            t0 = time.perf_counter()
            restored = mgr.restore(DIST_STEPS, model=layout, device=device)
            sync()
            restore_ms.append(1e3 * (time.perf_counter() - t0))
            ref, _ = layout.scatter_state(one["fields"])
            for k, block in ref.items():
                if not torch.equal(restored[k].data, block):
                    raise AssertionError(f"single-device checkpoint onto 2x2 rank {r}: {k} differs")
        del one, domain, state
        path_counts["spmd"], path_steps["spmd"] = full["launches_by_rank"][0], 1 + DIST_STEPS
        out["checkpoint"] = dict(
            mb=mb, save_ms_by_rank0=save_ms, restore_ms_by_rank=[
                1e3 * t for t in [same["restore_s"], tall["restore_s"]]],
            assemble_ms=assemble_ms, single_to_2x2_restore_ms=restore_ms,
            resume_4x1={k: e for k, (e, _) in d41.items()},
            resume_single={k: e for k, (e, _) in d11.items()},
            wall_s=[full["wall_s"], same["wall_s"], tall["wall_s"]])
        phase("dist-checkpoint", f"{nx}x{ny}x{nz} float32, 1+{DIST_STEPS} steps on 2x2 gloo ranks sharing "
              f"{card}, checkpointed every {DIST_EVERY}: {mb:.1f} MB a step; rank 0's saves "
              f"{' '.join(f'{t:.1f}' for t in save_ms)} ms (the ranks' barriers included); the "
              f"restore of step {DIST_RESUME} on the ranks of 2x2 {1e3 * same['restore_s']:.1f} ms "
              f"and 4x1 {1e3 * tall['restore_s']:.1f} ms (rank 0), assembled whole on one process "
              f"{assemble_ms:.1f} ms; the single device's step onto 2x2 "
              f"{' '.join(f'{t:.1f}' for t in restore_ms)} ms a rank, bit for bit")
        phase("dist-resume", f"from step {DIST_RESUME}: on 2x2 bit for bit the uninterrupted run; on 4x1 "
              f"{' '.join(f'{k}={e:.1e}' for k, (e, _) in d41.items())}; on the single device "
              f"{' '.join(f'{k}={e:.1e}' for k, (e, _) in d11.items())}")
        del same, tall, single

        # (c) the hybrid grid: two nodes of two ranks, the nodes tiled 2x1 and 1x2
        hybrid = {}
        for node_grid in NODE_GRIDS:
            res = spmd(4, (2, 2), DIST_STEPS, local_world=2, node_grid=node_grid)
            rects = node_blocks(res["coords_by_rank"], 2)
            bitwise(f"hybrid grid, nodes {node_grid}", res["fields"], fields)
            for r, counts in enumerate(res["launches_by_rank"]):
                counts_equal(f"hybrid {node_grid} rank {r}", counts, sharded, 1 + DIST_STEPS)
            hybrid[f"{node_grid[0]}x{node_grid[1]}"] = dict(coords=res["coords_by_rank"], wall_s=res["wall_s"])
            phase("dist-hybrid", f"nodes {node_grid[0]}x{node_grid[1]} of two ranks (LOCAL_WORLD_SIZE=2): rank "
                  f"coordinates {res['coords_by_rank']}, each node one block {rects}; every field equal "
                  f"to the plain 2x2 run's bit for bit")
        out["hybrid"] = hybrid
        del fields, full

    # (b) --spmd on the card's one rank at the flagship, as a CUDA graph
    fl = load_namelist(niter=DIST_STEPS, so=so, **flag)
    _lib.reset_launch_counts()
    ref = drv.run(fl, verbose=False, fused_loop=on_card)
    counts_equal("sus graph", dict(_lib.launch_counts), sus, 2 if on_card else 1 + DIST_STEPS)
    ref_fields = {k: fa.data.cpu().numpy() for k, fa in ref["fields"].items()}
    _lib.reset_launch_counts()
    one = drv.run_spmd(dict(flag, niter=DIST_STEPS, so=so), ranks=1, comm="nccl" if on_card else "gloo",
                       device=device, fused_loop=on_card, verbose=False)
    if not one["degenerate"] or any(one["imported_by_rank"]):
        raise AssertionError(f"spmd on one rank: degenerate {one['degenerate']}, imported {one['imported_by_rank']}")
    counts_equal("spmd on one rank", one["launches_by_rank"][0], sus, 2 if on_card else 1 + DIST_STEPS)
    if on_card and one["launches_per_step"] != sus:
        raise AssertionError(f"spmd on one rank: {one['launches_per_step']} a step, expected {sus}")
    bitwise("spmd on one rank against sus's graph run", one["fields"], ref_fields)
    if keep is not None:
        keep["spmd_one_rank"] = one["fields"]
    path_counts["spmd_one_rank"], path_steps["spmd_one_rank"] = one["launches_by_rank"][0], 2 if on_card else 1 + DIST_STEPS
    out["spmd_one_rank"] = dict(ms_per_step=one["ms_per_step"], sus_graph_ms_per_step=ref["ms_per_step"])
    phase("dist-spmd", f"--spmd on one {'NCCL' if on_card else 'gloo'} rank, {fl.nx}x{fl.ny}x{fl.nz}, 1+{DIST_STEPS} "
          f"{'graph' if on_card else 'eager'} steps: the degenerate grid, every field equal to sus's "
          f"{'graph' if on_card else 'eager'} run bit for bit, launches a step {one['launches_per_step']}; "
          f"{one['ms_per_step']:.3f} ms/step beside sus's {ref['ms_per_step']:.3f} on {card}")
    del one, ref, ref_fields

    # (d) driver_dist_bench on 1x1 at the flagship
    _lib.reset_launch_counts()
    bench = ddb.bench(mesh=(1, 1), comm="nccl" if on_card else "gloo", device=device,
                      niter=FUSED_TIMED_STEPS if on_card else 2, pairs=DIST_BENCH_PAIRS, **flag)
    bench_counts = dict(_lib.launch_counts)
    counts_equal("dist bench", bench_counts, sus, 4 if on_card else 2 * (1 + DIST_BENCH_PAIRS * 2))
    if not (bench["degenerate"] and bench["bitwise"]):
        raise AssertionError(f"dist bench 1x1: degenerate {bench['degenerate']}, unequal {bench['unequal']}")
    path_counts["dist_bench"], path_steps["dist_bench"] = bench_counts, 4 if on_card else 1
    out["dist_bench"] = {k: v for k, v in bench.items() if k not in ("fields", "single_fields", "unequal")}
    phase("dist-bench", f"driver_dist_bench --mesh 1,1 ({'graph' if bench['graph'] else 'eager'}): degenerate, "
          f"pads {bench['pads']}, every field the single device's bit for bit after {bench['niter']} steps; "
          f"{DIST_BENCH_PAIRS} alternating pairs of {bench['niter']} steps: runner "
          f"{' '.join(f'{t:.4f}' for t in bench['dist_ms_per_step_runs'])} ms/step (median "
          f"{bench['ms_per_step']:.4f}), single device "
          f"{' '.join(f'{t:.4f}' for t in bench['single_ms_per_step_runs'])} (median "
          f"{bench['single_device_ms_per_step']:.4f}), ratio {bench['ratio']:.4f} on {card}")
    del bench

    # (e) driver_weak_scaling: the counted exchange bytes against the ring
    block = WEAK_BLOCK if size is None else nx // 2
    wnz = WEAK_NZ if size is None else nz
    table = dws.weak_scaling([1, 4], block=block, nz=wnz, niter=WEAK_STEPS, comm="gloo", device=device,
                             analyze_comm=True, link_gbs=NVLINK_GBS, verbose=False)
    for row in table["rows"]:
        if any(row["imported_by_rank"]):
            raise AssertionError(f"weak scaling: ranks imported {row['imported_by_rank']}")
        for r in row["by_rank"]:
            if r["exchange_bytes_per_step"] != r["ring_bytes_per_step"]:
                raise AssertionError(f"weak scaling, {row['n']} ranks, rank {r['rank']}: counted "
                                     f"{r['exchange_bytes_per_step']} bytes a step, the ring "
                                     f"{r['ring_bytes_per_step']}")
        if row["n"] == 1 and row["exchange_bytes_per_step"]:
            raise AssertionError("weak scaling: one rank sent halo bytes")
        phase("dist-weak-scaling", f"{row['n']} gloo rank(s) sharing {card}, mesh {row['mesh']}, "
              f"{row['nx']}x{row['ny']}x{row['nz']}: {row['gps']:.4e} gridpoints/s, {row['gps_per_rank']:.4e} a "
              f"rank, efficiency {row['weak_scaling_efficiency']:.4f}; exchange bytes a step a rank "
              f"{[r['exchange_bytes_per_step'] for r in row['by_rank']]} = the ring's")
    a = table["analysis"]
    phase("dist-weak-analysis", f"{a['n']} ranks: {a['exchanges_per_step']:.0f} exchanges, "
          f"{a['messages_per_step']:.0f} messages and {a['exchange_bytes_per_step_per_rank']:.0f} bytes a step a "
          f"rank; compute {a['t_compute_s'] * 1e3:.3f} ms a {block}x{block}x{wnz} block from the single rank's "
          f"measured {a['gps_single_rank_measured']:.4e} gridpoints/s; at {NVLINK_GBS} GB/s a direction (the "
          f"H100 SXM data sheet's NVLink, a spec) {a['t_comm_s'] * 1e3:.4f} ms, projected efficiency "
          f"overlapped {a['projected_efficiency_overlapped']:.4f}, serial {a['projected_efficiency_serial']:.4f}; "
          f"operations {a['flops']}; {table['note']}")
    out["weak_scaling"] = {k: v for k, v in table.items()}

    # (f) driver_profile at the flagship: each variant's launches, and full
    # beside sus's graph step in alternating pairs
    rows = {}
    for name in dprof.VARIANTS:
        res = dprof.run_variant(fl, name, fused_loop=on_card)
        want = dprof.expected_launches(name) if on_card else {}
        if on_card and res["launches_per_step"] != want:
            raise AssertionError(f"driver_profile {name}: {res['launches_per_step']} a step, expected {want}")
        rows[name] = res["ms_per_step"]
        phase("dist-profile", f"{name:24s} {res['ms_per_step']:8.3f} ms/step"
              + (f"  (full - this = {rows['full'] - res['ms_per_step']:+.3f} ms)" if name != "full" else "")
              + f"; launches a step {res['launches_per_step']}")
        del res
    # full beside sus in alternating pairs: the times are printed, not
    # gated; every full run must end on sus's fields bit for bit with the
    # launches expected_launches("full") gives
    times = {"full": [], "sus": []}
    sus_fields = None
    for i in range(PROFILE_PAIRS):
        for which in (("sus", "full") if i % 2 == 0 else ("full", "sus")):
            if which == "sus":
                res = drv.run(fl, verbose=False, fused_loop=on_card)
                if sus_fields is None:
                    sus_fields = {k: fa.data.cpu().numpy() for k, fa in res["fields"].items()}
            else:
                res = dprof.run_variant(fl, "full", fused_loop=on_card)
                if on_card and res["launches_per_step"] != dprof.expected_launches("full"):
                    raise AssertionError(f"driver_profile full: {res['launches_per_step']} a step, expected "
                                         f"{dprof.expected_launches('full')}")
                full_fields = {k: fa.data.cpu().numpy() for k, fa in res["fields"].items()}
            times[which].append(res["ms_per_step"])
            del res
        bitwise(f"driver_profile full (pair {i}) against sus", full_fields, sus_fields)
    med = {k: statistics.median(v) for k, v in times.items()}
    out["profile"] = dict(ms_per_step=rows, full_runs=times["full"], sus_runs=times["sus"])
    phase("dist-profile-full", f"every full run's fields equal to sus's bit for bit after 1+{DIST_STEPS} "
          f"steps, launches expected_launches('full'); full {' '.join(f'{t:.4f}' for t in times['full'])} "
          f"ms/step (median {med['full']:.4f}) beside sus's graph steps "
          f"{' '.join(f'{t:.4f}' for t in times['sus'])} (median {med['sus']:.4f}) on {card} (not gated)")
    out["seconds"] = time.perf_counter() - t_phase
    phase("dist", f"phase 18 took {out['seconds']:.1f} s")
    return out


# phase 19, the last one-card tools: the mountain wave's --sweep (each case
# as a CUDA graph) and --diagnose against SWEEP_REFERENCE (the JAX package's
# float32 runs on the CPU, make_torch_mountain_wave_reference.py --sweep
# --diagnose), bench_variants at the flagship with TOOLS_NT steps a round,
# bench_kernels and driver_roofline; no check compares times
SWEEP_REFERENCE = "mountain_wave_sweep_reference.json"
TOOLS_NT = 20
# agreement with SWEEP_REFERENCE, absolute on the correlations and relative
# on the rest: about twice the port's float32 CPU reading
# (make_torch_mountain_wave_reference.py --sweep --diagnose --check-port:
# corr 1.78e-2 (321x120), corr_focused 5.8e-3, rms_err_focused 1.76e-2,
# amplitude_ratio 3.73e-2 (81x60); the diagnose rows' corr 7.6e-3 and
# rms_error 2.0e-2, the localisation 2.5e-2).  rms_analytic is the analytic
# solution's, float64 numpy on the host on both sides: it read 0.  The
# sweep's orders are log2 of a ratio of two nearly equal errors (the
# shallow sponge's reflection sets the error, docs/mountain_wave_validation.md):
# printed beside the reference's, not gated
SWEEP_ABS_TOL = {"corr": 4e-2, "corr_focused": 1.2e-2}
SWEEP_REL_TOL = {"rms_err_focused": 4e-2, "amplitude_ratio": 8e-2}
DIAGNOSE_TOL = {"corr": 1.6e-2, "rms_analytic": 1e-12, "rms_error": 4e-2}
LOCALISATION_TOL = 5e-2


def tools_phase(card, path_counts, path_steps, device="cuda", sweep_cases=None, hours=None,
                flagship=None, kernel_size=None):
    """Phase 19 (module docstring).  ``sweep_cases`` ((nx, nz, dt), ...,
    the first also the diagnose's case), ``hours``, ``flagship`` (nx, ny,
    nz) and ``kernel_size`` (nx, nz) let the phase be rehearsed on the CPU
    at small sizes (no graph, no launch counted, no reference compared)."""
    import tempfile

    import numpy as np

    from tasmania_tpu_torch.drivers import bench_kernels as bk
    from tasmania_tpu_torch.drivers import bench_variants as bvar
    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
    from tasmania_tpu_torch.drivers import driver_roofline as roof
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib

    on_card = torch.device(device).type == "cuda"
    so = StorageOptions(dtype=torch.float32, device=device)
    mw_per_step = LAUNCHES_PER_STEP["mountain_wave"] if on_card else {}
    ref = json.loads(Path(mw.__file__).with_name(SWEEP_REFERENCE).read_text())
    compare = sweep_cases is None
    if compare and ([tuple(c) for c in ref["sweep"]["config"]["cases"]] != list(mw.SWEEP_CASES)
                    or (ref["diagnose"]["config"]["nx"], ref["diagnose"]["config"]["nz"],
                        ref["diagnose"]["config"]["dt"]) != mw.SWEEP_CASES[0]):
        raise AssertionError(f"{SWEEP_REFERENCE} is not at the sweep's and the diagnose's cases")
    cases = list(sweep_cases or mw.SWEEP_CASES)
    hours = hours or ref["sweep"]["config"]["hours"]
    out = {}

    def launched(tag, counts, per_step, times):
        want = {k: n * times for k, n in per_step.items() if n}
        if {k: n for k, n in counts.items() if n} != want:
            raise AssertionError(f"{tag}: launched {counts}, expected {want}")

    def deviation(tag, got, want, key, absolute, tol):
        dev = abs(got - want) / (1.0 if absolute else abs(want))
        if compare and not dev <= tol:
            raise AssertionError(f"{tag} {key}: {got} against the reference's {want} (deviation {dev:.2e} > {tol})")
        return dev

    t_phase = time.perf_counter()
    # (a) --sweep, each case as a graph
    _lib.reset_launch_counts()
    sw = mw.sweep(cases, hours, so=so, fused_loop=on_card, verbose=False)
    counts = dict(_lib.launch_counts)
    launched("sweep", counts, mw_per_step, 2 * len(cases) if on_card else 0)
    path_counts["sweep"], path_steps["sweep"] = counts, 2 * len(cases)
    out["sweep"] = []
    for i, res in enumerate(sw["results"]):
        if on_card and res["launches_per_step"] != mw_per_step:
            raise AssertionError(f"sweep {res['nx']}x{res['nz']}: {res['launches_per_step']} a step")
        bad = [k for k, fa in res["fields"].items() if not bool(torch.isfinite(fa.data).all())]
        if bad:
            raise AssertionError(f"sweep {res['nx']}x{res['nz']}: non-finite fields {bad}")
        want = ref["sweep"]["rows"][i] if compare else res
        devs = {k: deviation(f"sweep {res['nx']}x{res['nz']}", res[k], want[k], k, k in SWEEP_ABS_TOL,
                             {**SWEEP_ABS_TOL, **SWEEP_REL_TOL}[k]) for k in (*SWEEP_ABS_TOL, *SWEEP_REL_TOL)}
        out["sweep"].append({**mw.row(res), "deviations": devs})
        phase("tools-sweep", f"{res['nx']}x1x{res['nz']}, {res['steps']} steps of {res['dt']} s "
              f"({'graph' if on_card else 'eager'}): {res['ms_per_step']:.4f} ms/step on {card}; "
              + " ".join(f"{k} {res[k]:.6g} (reference {want[k]:.6g}, {d:.1e})" for k, d in devs.items()))
    out["orders"] = sw["orders"]
    phase("tools-sweep-orders", " | ".join(
        f"{o['from_nx']}->{o['to_nx']}: {o['convergence_order']:.4f}"
        + (f" (JAX float32 {r['convergence_order']:.4f})" if compare else "")
        for o, r in zip(sw["orders"], ref["sweep"]["orders"])) + " (not gated: about zero by design)")
    del sw

    # (b) --diagnose at the first case, its profiles written under a
    # temporary directory
    nx, nz, dt = cases[0]
    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "mw_fields.npz"
        _lib.reset_launch_counts()
        d = mw.diagnose(nx, nz, hours, dt, out=str(npz), so=so, fused_loop=on_card, verbose=False)
        counts = dict(_lib.launch_counts)
        launched("diagnose", counts, mw_per_step, 2 if on_card else 0)
        path_counts["diagnose"], path_steps["diagnose"] = counts, 2
        saved = np.load(npz)
        prof = d["result"]["profiles"]
        if sorted(saved.files) != ["kd", "u_an", "u_num", "xs"] or not all(
                np.array_equal(saved[k], prof[k]) for k in saved.files):
            raise AssertionError(f"diagnose: {npz.name} holds {saved.files}, not the run's profiles")
    dref = ref["diagnose"] if compare else {"rows": d["rows"], "localisation": d["localisation"]}
    worst = dict.fromkeys(DIAGNOSE_TOL, 0.0)
    for got, want in zip(d["rows"], dref["rows"]):
        if (got["window_halfwidths"], got["sponge_clearance"]) != (want["window_halfwidths"], want["sponge_clearance"]):
            raise AssertionError(f"diagnose: row {got} is not the reference's {want}")
        for k, tol in DIAGNOSE_TOL.items():
            worst[k] = max(worst[k], deviation(f"diagnose window {got['window_halfwidths']} clearance "
                                               f"{got['sponge_clearance']}", got[k], want[k], k, k == "corr", tol))
    loc, lref = d["localisation"], dref["localisation"]
    pairs = [(k, loc[k], lref[k]) for k in loc if not isinstance(loc[k], list)]
    pairs += [(f"quartile {q}", g, w) for q, (g, w) in enumerate(zip(loc["rms_by_k_quartile_top_to_sfc"],
                                                                   lref["rms_by_k_quartile_top_to_sfc"]))]
    loc_dev = max(deviation("diagnose localisation", g, w, k, False, LOCALISATION_TOL) for k, g, w in pairs)
    out["diagnose"] = dict(rows=d["rows"], localisation=loc, largest_deviation={**worst, "localisation": loc_dev})
    phase("tools-diagnose", f"{nx}x1x{nz}, {d['result']['steps']} steps of {dt} s: 18 rows, the largest "
          f"deviations from the reference corr {worst['corr']:.1e} (<= {DIAGNOSE_TOL['corr']}), rms_analytic "
          f"{worst['rms_analytic']:.1e}, rms_error {worst['rms_error']:.1e} (<= {DIAGNOSE_TOL['rms_error']}); "
          f"localisation {loc_dev:.1e} (<= {LOCALISATION_TOL}): " + json.dumps(loc)
          + f"; the profiles written to a temporary .npz and read back equal")
    del d

    # (c) bench_variants at the flagship: exact launches, the eager bits
    flag = dict(zip(("nx", "ny", "nz"), flagship)) if flagship else {}
    _lib.reset_launch_counts()
    bv = bvar.bench_variants(bvar.VARIANTS, TOOLS_NT, device=device, verbose=False, **flag)
    counts = dict(_lib.launch_counts)
    total: dict = {}
    for c in bvar.VARIANTS:
        for k, n in (LAUNCHES_PER_STEP[c] if on_card else {}).items():
            total[k] = total.get(k, 0) + n
    launched("bench_variants", counts, total, 2 if on_card else 0)
    path_counts["bench_variants"], path_steps["bench_variants"] = counts, 2
    for c, r in bv["rows"].items():
        if on_card and r["launches_per_step"] != LAUNCHES_PER_STEP[c]:
            raise AssertionError(f"bench_variants {c}: {r['launches_per_step']} a step, expected "
                                 f"{LAUNCHES_PER_STEP[c]}")
        nl = moist.load_namelist(c, niter=TOOLS_NT, so=so, **flag)
        _lib.reset_launch_counts()
        eager = moist.run(nl, c, verbose=False, fused_loop=False)["fields"]
        launched(f"bench_variants {c}, the eager run", dict(_lib.launch_counts),
                 LAUNCHES_PER_STEP[c] if on_card else {}, 1 + TOOLS_NT)
        unequal = sorted(k for k, fa in eager.items() if not torch.equal(bv["fields"][c][k].data, fa.data))
        if unequal or set(eager) != set(bv["fields"][c]):
            raise AssertionError(f"bench_variants {c}: {unequal} differ from the eager run's")
        del eager
        phase("tools-bench-variants", f"{c}: 1+{TOOLS_NT} steps, every field the eager run's bit for bit, "
              f"launches a step {r['launches_per_step']}; {r['ms_per_step']:.4f} ms/step (median of "
              f"{len(r['ms_per_step_runs'])}, range {r['ms_per_step_range'][0]:.4f}-{r['ms_per_step_range'][1]:.4f}), "
              f"{r['gridpoints_per_s']:.4e} gridpoints/s, umax {r['umax']:.5f}, vmax {r['vmax']:.5f}, build and "
              f"capture {r['build_capture_s']:.2f} s on {card}")
    out["bench_variants"] = bv["rows"]
    del bv

    # (d) bench_kernels and driver_roofline: finite outputs, a launch a
    # timed call (both checked in kernel_timing.measure); nothing gated
    kx, kz = kernel_size or (bk.NX, bk.NZ)
    tables = {"bench_kernels": bk.bench(device, kx, kz),
              "roofline": roof.roofline(device, kx, kx, kz)}
    for tool, table in tables.items():
        c = table["copy"]
        phase(f"tools-{tool}", f"copy rate {c['gbs']:.1f} GB/s (median of {len(c['runs'])}, range "
              f"{c['spread'][0]:.1f}-{c['spread'][1]:.1f}, {c['bytes_read'] / 1e6:.0f} MB read and written a call) "
              f"on {card}" + "".join(f"; TIMING FAULT: a run read {g:.1f} GB/s, above the 3.35 TB/s spec"
                                     for g in c["above_spec"]))
        for r in table["rows"]:
            phase(f"tools-{tool}", f"#{r['number']} {r['name']}: {r['ms']:.4f} ms ({r['timed_by']}), "
                  f"{r['bytes'] / 1e6:.1f} MB, {r['gbs']:.1f} GB/s, {r['share_of_copy_pct']:.1f}% of the copy "
                  f"rate, {r['share_of_spec_pct']:.1f}% of 3.35 TB/s (a spec); working set "
                  f"{r['working_set_bytes'] / 1e6:.1f} MB in {r['copies']} copies; {r['launches']} launches in "
                  f"{r['calls']} timed calls" + ("; TIMING FAULT: above the copy rate" if r["fault"] else ""))
        largest = max(table["rows"], key=lambda r: r["share_of_copy_pct"])
        phase(f"tools-{tool}", f"largest share {largest['share_of_copy_pct']:.1f}% ({largest['name']})")
    out.update(tables)
    out["seconds"] = time.perf_counter() - t_phase
    phase("tools", f"phase 19 took {out['seconds']:.1f} s")
    return out


# phase 20, the graph by default: each driver's entry point with no mode
# given against its explicit eager run (a), and the recovery flags and
# --profile between graph replays (b): the flagship 1 + IO_STEPS steps
# checkpointed every IO_EVERY with the NaN guard, resumed from IO_RESUME,
# poisoned at IO_POISON through a device counter the step reads (a graph
# freezes a Python counter), traced for TRACE_STEPS replays
TRACE_GRAPH_RUN = """
import json, torch
from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.options import StorageOptions
nl = load_namelist(niter={steps}, so=StorageOptions(dtype=torch.float32, device={device!r}), **{grid!r})
plain = drv.run(nl, verbose=False)
runs = [drv.run(nl, verbose=False, profile=d) for d in {trace_dirs!r}]
print(json.dumps({{"plain": plain["ms_per_step"], "profiled": [r["ms_per_step"] for r in runs],
                  "capture_s": [plain["capture_s"]] + [r["capture_s"] for r in runs]}}))
"""


def default_phase(card, runs, eager, path_counts, path_steps, device="cuda"):
    """Phase 20 (a): each path of ``runs`` (a call of its driver's entry
    point with no mode given) from zeroed launch counts, against ``eager``
    (the path's explicit eager run in its own phase: ``fields``,
    ``ms_per_step``, ``steps``).  On the card a graph must be captured
    (``capture_s``), each kernel launched twice its launches a step (the
    eager warm-up step and the capture; a replay counts nothing), the
    captured step's launches ``LAUNCHES_PER_STEP`` (Burgers none), and
    every field the eager run's bit for bit; the default's and the eager
    ms/step, and the default run's peak device memory (above what was
    allocated before it) beside its fields' (the graph's buffers and pool
    besides the model), are printed, not gated.  Adds the flagship's default run to
    ``path_counts`` (``sus_default``).  On the CPU (a rehearsal) the
    default steps eagerly and no kernel is counted."""
    from tasmania_tpu_torch.ops import _lib

    on_card = torch.device(device).type == "cuda"
    out = {}
    for path, run in runs.items():
        per_step = LAUNCHES_PER_STEP.get(path, {}) if on_card else {}
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        _lib.reset_launch_counts()
        res = run()
        # the run's own peak: above what the earlier phases hold (their eager fields)
        peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6 if on_card else None
        counts = {k: n for k, n in _lib.launch_counts.items() if n}
        want = {k: 2 * n for k, n in per_step.items() if n}
        if on_card and res["capture_s"] is None:
            raise AssertionError(f"graph default, {path}: the default captured no graph on the card")
        if counts != want:
            raise AssertionError(f"graph default, {path}: launched {counts} in the warm-up and the capture, "
                                 f"expected {want}")
        if on_card and res["launches_per_step"] != per_step:
            raise AssertionError(f"graph default, {path}: the captured step launched {res['launches_per_step']}")
        ref = eager[path]
        if set(res["fields"]) != set(ref["fields"]):
            raise AssertionError(f"graph default, {path}: fields {sorted(res['fields'])} vs {sorted(ref['fields'])}")
        unequal = sorted(k for k, fa in ref["fields"].items() if not torch.equal(res["fields"][k].data, fa.data))
        if unequal:
            diff = max(float((res["fields"][k].data - ref["fields"][k].data).abs().max()) for k in unequal)
            raise AssertionError(f"graph default, {path}: {unequal} differ from the eager run's (largest "
                                 f"difference {diff})")
        if path == "sus":
            path_counts["sus_default"], path_steps["sus_default"] = counts, 2
        fields_mb = nbytes(fa.data for fa in res["fields"].values()) / 1e6
        out[path] = dict(steps=ref["steps"], default_ms_per_step=res["ms_per_step"],
                         eager_ms_per_step=ref["ms_per_step"], capture_s=res["capture_s"],
                         fields_mb=fields_mb, peak_mb=peak_mb)
        capture = "no graph" if res["capture_s"] is None else f"capture {res['capture_s']:.3f} s"
        if peak_mb is not None:
            capture += f", the run's peak device memory {peak_mb:.1f} MB (its fields {fields_mb:.1f} MB)"
        phase("graph-default", f"{path}: {ref['steps']} steps, {len(ref['fields'])} fields bit for bit the "
              f"eager run's; {capture}, launches {counts} (the warm-up step and the capture); default "
              f"{res['ms_per_step']:.4f} ms/step, eager {ref['ms_per_step']:.4f} (its own phase's run) on {card}")
        del res
    return out


def graph_recovery_phase(card, path_counts, path_steps, one_rank=None, device="cuda", size=None,
                         flagship=None):
    """Phase 20 (b) and (c) (module docstring).  ``one_rank`` holds phase
    18's one-rank fields (numpy) at the flagship, 1 + ``DIST_STEPS``
    steps.  ``size`` (nx, ny, nz) replaces the flagship's grid of (b) and
    ``flagship`` that of (c), so that the phase can be rehearsed on the CPU,
    where the default steps eagerly (no graph, no launch counted, no trace
    kernel, one gloo rank)."""
    import tempfile

    import numpy as np

    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.options import StorageOptions
    from tasmania_tpu_torch.ops import _lib
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

    on_card = torch.device(device).type == "cuda"
    grid = dict(zip(("nx", "ny", "nz"), size)) if size else {}
    so = StorageOptions(dtype=torch.float32, device=device)
    nl = load_namelist(niter=IO_STEPS, so=so, **grid)
    per_step = LAUNCHES_PER_STEP["sus"] if on_card else {}
    rec = dict(checkpoint_every=IO_EVERY, nan_guard=True)
    out = {}
    t_phase = time.perf_counter()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def capture_note(res):
        return "no graph" if res["capture_s"] is None else f"capture {res['capture_s']:.3f} s"

    def graphed(tag, res):
        if on_card and res["capture_s"] is None:
            raise AssertionError(f"graph recovery, {tag}: the default captured no graph on the card")

    def bitwise(tag, got, ref):
        unequal = sorted(k for k, fa in ref.items() if not torch.equal(got[k].data, fa.data))
        if unequal or set(got) != set(ref):
            raise AssertionError(f"graph recovery, {tag}: {unequal or sorted(set(got) ^ set(ref))} differ")

    def poisoned_run(mode, directory):
        """The flagship with a NaN written at IO_POISON through a device
        counter the step reads (the same tensor operations eager and in a
        graph); returns the guard's message."""
        domain, state, pt = drv.build_domain_and_state(nl)
        dycore, physics = drv.build_model(nl, domain, pt)
        calls = torch.zeros((), dtype=torch.long, device=device)

        def step_impl(st, dt):
            new = physics(dycore(st, {}, dt), dt)
            calls.add_(1)
            s = new["air_isentropic_density"].data
            s[5, 7, 11] = torch.where(calls == 1 + IO_POISON, float("nan"), s[5, 7, 11])
            return new

        try:
            drv.run_steps(nl, state, step_impl, dycore.topography_steady, verbose=False, fused_loop=mode,
                          checkpoint_dir=str(directory), **rec)
        except RuntimeError as err:
            return str(err)
        raise AssertionError(f"graph recovery: the poisoned {'eager' if mode is False else 'default'} run "
                             "did not raise")

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) the eager and the default checkpointed runs: every checkpoint bit for bit
        eager = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp / "eager"), **rec)
        sync()
        _lib.reset_launch_counts()
        graph = drv.run(nl, verbose=False, checkpoint_dir=str(tmp / "graph"), **rec)
        counts = {k: n for k, n in _lib.launch_counts.items() if n}
        if counts != {k: 2 * n for k, n in per_step.items()}:
            raise AssertionError(f"graph recovery: launched {counts}, expected twice {per_step}")
        graphed("checkpointed run", graph)
        path_counts["sus_graph_io"], path_steps["sus_graph_io"] = counts, 2
        steps = list(range(IO_EVERY, IO_STEPS + 1, IO_EVERY))
        mgr, eager_mgr = CheckpointManager(str(tmp / "graph")), CheckpointManager(str(tmp / "eager"))
        if mgr.all_steps() != steps or eager_mgr.all_steps() != steps:
            raise AssertionError(f"graph recovery: checkpoints {mgr.all_steps()} and {eager_mgr.all_steps()}, "
                                 f"expected {steps}")
        for n in steps:
            got, ref = mgr.restore(n), eager_mgr.restore(n)
            bitwise(f"checkpoint {n}", {k: v for k, v in got.items() if k != "time"},
                    {k: v for k, v in ref.items() if k != "time"})
        bitwise("final fields", graph["fields"], eager["fields"])
        # the resume: the checkpoint into the graph's buffers, its counter at IO_RESUME
        resumed = drv.run(nl, verbose=False, checkpoint_dir=str(tmp / "graph"), resume=IO_RESUME, **rec)
        graphed("resumed run", resumed)
        if resumed["start"] != IO_RESUME:
            raise AssertionError(f"graph recovery: resumed after step {resumed['start']}, not {IO_RESUME}")
        bitwise(f"resumed from {IO_RESUME}", resumed["fields"], graph["fields"])
        out.update(checkpointed_ms_per_step=graph["ms_per_step"], eager_checkpointed_ms_per_step=eager["ms_per_step"],
                   resumed_ms_per_step=resumed["ms_per_step"], capture_s=graph["capture_s"])
        phase("graph-recovery", f"{nl.nx}x{nl.ny}x{nl.nz}, 1+{IO_STEPS} {'graph' if on_card else 'eager'} "
              f"steps checkpointed every {IO_EVERY} with the NaN guard: checkpoints {steps} and the final "
              f"fields bit for bit the eager run's; resumed from {IO_RESUME}, the uninterrupted run's bits; "
              f"{capture_note(graph)}; {graph['ms_per_step']:.3f} ms/step (eager "
              f"{eager['ms_per_step']:.3f}), resumed {resumed['ms_per_step']:.3f}, the saves included, on {card}")
        del eager, graph, resumed
        # the NaN guard, eager and default
        boundary = -(-IO_POISON // IO_EVERY) * IO_EVERY
        want = f"at step {boundary}; last good checkpoint: step {boundary - IO_EVERY}"
        messages = [poisoned_run(mode, tmp / f"nan_{mode}") for mode in (False, None)]
        left = [CheckpointManager(str(tmp / f"nan_{mode}")).all_steps() for mode in (False, None)]
        if messages[0] != messages[1] or want not in messages[1]:
            raise AssertionError(f"graph recovery, NaN guard: {messages} (expected both to say {want!r})")
        if left != [list(range(IO_EVERY, boundary, IO_EVERY))] * 2:
            raise AssertionError(f"graph recovery, NaN guard: checkpoints left {left}")
        phase("graph-nan-guard", f"NaN written at step {IO_POISON} through a device counter: the default "
              f"and the eager run both say {messages[1]!r}; checkpoints {left[1]}")
        # --profile under the graph, in a process of its own (phase 16):
        # two sessions a process, each to hold every kernel launches a step
        # times TRACE_STEPS, and to agree
        want_trace = {fn: per_step.get(w, 0) * TRACE_STEPS for w, fns in TRACE_KERNELS.items() for fn in fns}
        for attempt in range(1, TRACE_ATTEMPTS + 1):
            dirs = [str(tmp / f"graph_trace{attempt}_{k}") for k in range(2)]
            code = TRACE_GRAPH_RUN.format(steps=TRACE_STEPS, device=str(device), grid=grid, trace_dirs=dirs)
            run = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent,
                                 capture_output=True, text=True, timeout=600)
            if run.returncode:
                raise AssertionError(f"graph profile: the traced run failed:\n{run.stderr[-4000:]}")
            ms = json.loads(run.stdout.strip().splitlines()[-1])
            if on_card and None in ms["capture_s"]:
                raise AssertionError(f"graph profile: captures {ms['capture_s']}")
            got = [trace_counts(next(Path(d).glob("*.json"))) for d in dirs]
            if got[0] == got[1] == want_trace:
                break
            phase("graph-profile", f"attempt {attempt}: {got}, expected {want_trace} twice")
        else:
            raise AssertionError(f"graph profile: no two sessions of {TRACE_ATTEMPTS} processes held {want_trace}")
        out.update(profiled_ms_per_step=ms["profiled"], unprofiled_ms_per_step=ms["plain"], trace_attempts=attempt)
        phase("graph-profile", f"{TRACE_STEPS} {'graph replays' if on_card else 'eager steps'} under --profile, "
              f"two sessions agreeing on CUDA functions {got[0]}: profiled "
              f"{' '.join(f'{t:.3f}' for t in ms['profiled'])} ms/step, unprofiled {ms['plain']:.3f} (one "
              f"process, attempt {attempt}) on {card}")

    # (c) --spmd on the card's one NCCL rank with no mode given: the graph,
    # phase 18's one-rank bits
    flag = dict(zip(("nx", "ny", "nz"), flagship)) if flagship else {}
    sus = LAUNCHES_PER_STEP["sus"] if on_card else {}
    _lib.reset_launch_counts()
    one = drv.run_spmd(dict(flag, niter=DIST_STEPS, so=so), ranks=1, comm="nccl" if on_card else "gloo",
                       device=device, verbose=False)
    counts = {k: n for k, n in one["launches_by_rank"][0].items() if n}
    if not one["degenerate"] or any(one["imported_by_rank"]) or dict(_lib.launch_counts):
        raise AssertionError(f"graph spmd: degenerate {one['degenerate']}, imported {one['imported_by_rank']}, "
                             f"the parent launched {dict(_lib.launch_counts)}")
    graphed("one spmd rank", one)
    if counts != {k: 2 * n for k, n in sus.items()} or (on_card and one["launches_per_step"] != sus):
        raise AssertionError(f"graph spmd: launched {counts}, {one['launches_per_step']} a step")
    if one_rank is not None:
        unequal = sorted(k for k, a in one_rank.items() if not np.array_equal(one["fields"][k], a))
        if unequal or set(one["fields"]) != set(one_rank):
            raise AssertionError(f"graph spmd: {unequal} differ from phase 18's one-rank run")
    path_counts["spmd_default"], path_steps["spmd_default"] = counts, 2
    out["spmd_default"] = dict(ms_per_step=one["ms_per_step"], capture_s=one["capture_s"])
    compared = "phase 18's one-rank bits" if one_rank is not None else "not compared"
    phase("graph-spmd", f"--spmd on one {'NCCL' if on_card else 'gloo'} rank with no mode given, "
          f"{'x'.join(map(str, one['grid']))}, 1+{DIST_STEPS} steps: "
          f"{'a graph' if one['capture_s'] is not None else 'eager'}, {compared}, launches {counts}; "
          f"{one['ms_per_step']:.3f} ms/step on {card}")
    out["seconds"] = time.perf_counter() - t_phase
    phase("graph", f"phase 20 (b), (c) took {out['seconds']:.1f} s")
    return out


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

    from tasmania_tpu_torch.drivers import driver_burgers as burgers
    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.framework.registry import registered_names
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
        sedimentation_tall,
    )
    from tasmania_tpu_torch.ops.si_stage import StageConstants, clip_pos, si_stage, si_stage_plain
    from tasmania_tpu_torch.ops.smagorinsky_step import (
        fused_smagorinsky_rk2,
        fused_smagorinsky_rk2_plain,
        fused_smoothing_smagorinsky_rk2,
        fused_smoothing_smagorinsky_rk2_plain,
        smag_stage,
        smagorinsky_stage_plain,
    )
    from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
    from tasmania_tpu_torch.ops.vertical_advection_step import (
        fused_vadv_sedimentation_rk3ws,
        fused_vadv_sedimentation_rk3ws_plain,
        fused_vertical_advection_rk3ws,
        fused_vertical_advection_rk3ws_plain,
        vertical_advection_tall,
    )
    from tasmania_tpu_torch.parallel.distributed import window
    from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition, RankGrid
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
    phase("build", f"stack frames and spills: {stack_frames(info['log'])}")

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
    # the same three stages with third-order fluxes (sus_third, phase 13)
    worst3, errs = 0.0, []
    for stage, frac in enumerate(prog.substep_fractions):
        c3 = replace(c, dt=frac * 5.0)
        rmat3, dd3 = (dycore.damper.rmat, dycore.damper.dd) if stage == 2 else (None, 0)
        args3 = list(stage_in.values()) + [rmat3]
        got = si_stage(*args3, nb=nl.nb, c=c3, dd=dd3, order=3)
        ref = si_stage_plain(*args3, nb=nl.nb, c=c3, dd=dd3, order=3)
        torch.cuda.synchronize()
        momentum = amax(ref[1], ref[2])
        scales = [amax(ref[0]), momentum, momentum] + [amax(r) for r in ref[3:]]
        w, rel = check_outputs(f"si_stage (order 3) stage {stage}", got, ref, scales, KERNEL_TOL)
        worst3 = max(worst3, w)
        errs.append(f"s{stage}: {rel}")
    phase("check", f"si_stage (order 3) relative errors {' | '.join(errs)}")
    kernels["si_stage"]["max_abs_err"] = max(kernels["si_stage"]["max_abs_err"], worst3)
    # third-order fluxes of 7 fields on 4 faces (about 12 operations each)
    record_also("si_stage", "order 3, 161x161x120, per stage",
                lambda: si_stage(*args3, nb=nl.nb, c=c3, dd=dd3, order=3),
                lambda: si_stage_plain(*args3, nb=nl.nb, c=c3, dd=dd3, order=3),
                bound(nbytes(flat_in) + nbytes(ref), 480.0 * s_now.numel()))
    # the distributed mode (phase 14's stage): the halo-extended blocks of
    # phase 14's shards (DIST_BLOCK, the ring nb + 1 deep), here of a corner,
    # an edge and an interior shard of a 3x3 grid of ranks over the flagship
    # namelist at DIST_GLOBAL, the last stage with damping, fifth order
    nl_d = load_namelist(nx=DIST_GLOBAL[0], ny=DIST_GLOBAL[1], nz=DIST_GLOBAL[2])
    d_domain, d_state, d_pt = drv.build_domain_and_state(nl_d)
    d_core = drv.make_dycore(nl_d, d_domain, d_pt)
    d_prog, d_hb = d_core.prognostic, d_domain.horizontal_boundary
    d_raw = {k: v.data for k, v in d_state.items() if k != "time"}
    d_s, d_su, d_sv = (d_raw[n] for n in ("air_isentropic_density", "x_momentum_isentropic",
                                          "y_momentum_isentropic"))
    d_global = dict(
        u=perturbed(d_raw["x_velocity_at_u_locations"]),
        v=perturbed(d_raw["y_velocity_at_v_locations"]) + 0.5,
        s_now=d_s, s_int=perturbed(d_s), q_now=[d_raw[q] for q in qn],
        q_int=[perturbed(d_raw[q]) for q in qn], su_now=d_su, sv_now=d_sv,
        su_int=perturbed(d_su), sv_int=perturbed(d_sv) + 1.0, mtg_now=d_raw["montgomery_potential"],
        hs=d_core.topography_steady, theta=d_prog.diagnostics.theta, gamma=d_prog.gamma,
        s_ref=d_hb.ref_field("air_isentropic_density"), su_ref=d_hb.ref_field("x_momentum_isentropic"),
        sv_ref=d_hb.ref_field("y_momentum_isentropic"), q_refs=[d_hb.ref_field(q) for q in qn],
    )
    d_grid = RankGrid(*DIST_GRID)
    d_pad = nl.nb + 1
    decomp = CartesianDecomposition(nl_d.nx, nl_d.ny, d_grid, nl.nb, d_pad, d_pad)
    if decomp.local_shape_with_halo + (nl_d.nz,) != DIST_BLOCK:
        raise AssertionError(f"the distributed blocks are {decomp.local_shape_with_halo}, not {DIST_BLOCK}")
    c_last = replace(c, dt=5.0)
    rmat_d, dd_d = d_core.damper.rmat, d_core.damper.dd
    worst_d, errs = 0.0, []
    for shard, rank in DIST_SHARDS.items():
        def cut(t, name=""):
            st = (name == "u", name == "v")
            mode = "constant" if name == "gamma" else "edge"
            if t.dim() == 1:  # theta
                return t
            return torch.as_tensor(window(t.cpu().numpy(), decomp, rank, st, pad_mode=mode), device=device)

        w_args = [[cut(a) for a in v] if isinstance(v, list) else cut(v, k) for k, v in d_global.items()]
        w_args.append(rmat_d)
        dist_kw = dict(dist=True, goff=decomp.offset(rank), gnx=nl_d.nx, gny=nl_d.ny)
        got = si_stage(*w_args, nb=nl.nb, c=c_last, dd=dd_d, **dist_kw)
        ref = si_stage_plain(*w_args, nb=nl.nb, c=c_last, dd=dd_d, **dist_kw)
        torch.cuda.synchronize()
        momentum = amax(ref[1], ref[2])
        scales = [amax(ref[0]), momentum, momentum] + [amax(r) for r in ref[3:]]
        w, rel = check_outputs(f"si_stage (dist, {shard} shard)", got, ref, scales, KERNEL_TOL)
        worst_d = max(worst_d, w)
        errs.append(f"{shard} (goff {decomp.offset(rank)}): {rel}")
        w_flat = [a for v in w_args for a in (v if isinstance(v, list) else [v])]
        record_also("si_stage", f"dist mode, {shard} shard, {'x'.join(map(str, DIST_BLOCK))} block, last stage",
                    lambda: si_stage(*w_args, nb=nl.nb, c=c_last, dd=dd_d, **dist_kw),
                    lambda: si_stage_plain(*w_args, nb=nl.nb, c=c_last, dd=dd_d, **dist_kw),
                    bound(nbytes(w_flat) + nbytes(ref), 700.0 * ref[0].numel()))
    phase("check", f"si_stage (dist) relative errors {' | '.join(errs)}")
    kernels["si_stage"]["max_abs_err"] = max(kernels["si_stage"]["max_abs_err"], worst_d)
    del d_domain, d_state, d_core, d_prog, d_hb, d_raw, d_s, d_su, d_sv, d_global, w_args, w_flat

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

    # the launch floor beside the pastes: one PyTorch fill of one element,
    # timed as the kernels are
    one = torch.empty(1, device=device)
    launch_floor_ms, how = device_ms(lambda: one.fill_(1.0))
    phase("kernel", f"launch floor: a one-element fill takes {launch_floor_ms:.4f} ms (timed by {how}), "
          f"beside paste_x_edges_multi {kernels['paste_x_edges_multi']['ms']:.4f} ms and paste_x_edges "
          f"{kernels['paste_x_edges']['ms']:.4f} ms")

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
    # the same kernel's bare launches: the library's entry point on fixed
    # arguments, BARE_LAUNCHES back to back between two CUDA events, in
    # BARE_ROUNDS rounds; no wrapper, no allocation, no argument check
    sed_outs = (torch.empty_like(qr), torch.empty_like(qr))
    sed_args = (_lib.DTYPE_CODES[qr.dtype], _lib.pointer_array(din), _lib.pointer_array(sed_outs),
                cell[0] * cell[1], cell[2], dkw["order"], int(dkw["vt_mode"] == "step"),
                float(dkw["dt"]), _lib.stream_handle())
    sed_entry = _lib.lib().tt_sedimentation_rk3ws
    for _ in range(3):
        _lib.check(sed_entry(*sed_args), "fused_sedimentation_rk3ws")
    bare = []
    for _ in range(BARE_ROUNDS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BARE_LAUNCHES):
            sed_entry(*sed_args)
        end.record()
        end.synchronize()
        bare.append(start.elapsed_time(end) / BARE_LAUNCHES)
    _lib.check(sed_entry(*sed_args), "fused_sedimentation_rk3ws")
    torch.cuda.synchronize()
    if not torch.equal(sed_outs[0], got[0]):
        raise AssertionError("fused_sedimentation_rk3ws: the bare launches differ from the wrapper's")
    kernels["fused_sedimentation_rk3ws"]["bare_launch_ms"] = bare
    phase("kernel", f"fused_sedimentation_rk3ws bare launches ({BARE_LAUNCHES} between CUDA events, "
          f"{BARE_ROUNDS} rounds): {' '.join(f'{t:.4f}' for t in bare)} ms a launch, beside device_ms "
          f"{kernels['fused_sedimentation_rk3ws']['ms']:.4f} ms")

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
    # the same stage at third order (fc_third, phase 13): a third-order flux
    # is about 12 operations
    fkw3 = {**akw, "order": 3}
    got = fused_advection_fields(*adv_args, **fkw3)
    adv3 = fused_advection_fields_plain(*adv_args, **fkw3)
    w, inc = check_increments("fused_advection_fields (order 3)", got, adv3, base, KERNEL_TOL)
    phase("check", "fused_advection_fields (order 3) errors as a share of the largest increment "
          f"(s sqv sqc sqr) {inc}")
    kernels["fused_advection_fields"]["max_abs_err"] = max(kernels["fused_advection_fields"]["max_abs_err"], w)
    record_also("fused_advection_fields", "order 3, with tendencies, 161x161x120",
                lambda: fused_advection_fields(*adv_args, **fkw3),
                lambda: fused_advection_fields_plain(*adv_args, **fkw3),
                bound(nbytes(flat) + nbytes(adv3), 34.0 * len(adv3) * s_now.numel()))

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
    # the epilogue's spread within one call: three more profiler
    # measurements and CUDA events around twenty back-to-back calls (two
    # calls of an earlier design read 0.145 and 0.289 ms)
    repeats = [device_ms(lambda: fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c)) for _ in range(3)]
    events = device_ms(lambda: fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c), attempts=0)[0]
    kernels["fused_momentum_epilogue"]["repeats_ms"] = [ms for ms, _ in repeats]
    kernels["fused_momentum_epilogue"]["events_ms"] = events
    phase("kernel", "fused_momentum_epilogue again: "
          f"{' '.join(f'{ms:.3f} ms ({how})' for ms, how in repeats)}; CUDA events {events:.3f} ms")
    # the epilogue with third-order fluxes (fc_third, phase 13), the same inputs
    got = fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c, order=3)
    ref = fused_momentum_epilogue_plain(*mom_args, nb=nl.nb, c=c, order=3)
    momentum = amax(ref[1], ref[2])
    w1, rel = check_outputs("fused_momentum_epilogue (order 3, su sv)", got[1:3], ref[1:3], [momentum] * 2,
                            KERNEL_TOL)
    w2, inc = check_increments("fused_momentum_epilogue (order 3, s q)", [got[0], *got[3:]],
                               [ref[0], *ref[3:]], [s_now, *q_now], KERNEL_TOL)
    phase("check", f"fused_momentum_epilogue (order 3) relative errors (su sv) {rel}; errors as a share "
          f"of the largest increment (s qv qc qr) {inc}")
    kernels["fused_momentum_epilogue"]["max_abs_err"] = max(
        kernels["fused_momentum_epilogue"]["max_abs_err"], w1, w2)
    record_also("fused_momentum_epilogue", "order 3, 161x161x120",
                lambda: fused_momentum_epilogue(*mom_args, nb=nl.nb, c=c, order=3),
                lambda: fused_momentum_epilogue_plain(*mom_args, nb=nl.nb, c=c, order=3),
                bound(nbytes(flat) + nbytes(ref), 130.0 * s_now.numel()))
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

    # the generic stage as the periodic boundary runs it (sus_periodic, phase
    # 13): its numerical grid, fifth order, the density and the water
    # densities advected without the boundary (no gamma, no reference) and
    # without tendencies, the stepped density enforced, its Montgomery
    # potential, the momentum step
    nl_p = load_namelist(**SURFACE_PATHS["sus_periodic"][1])
    pdomain, pstate, ppt = drv.build_domain_and_state(nl_p)
    pcore, _ = drv.build_model(nl_p, pdomain, ppt)
    praw = {k: v.data for k, v in pstate.items() if k != "time"}
    pprog, phb = pcore.prognostic, pdomain.horizontal_boundary
    pcell = praw["air_isentropic_density"].shape
    ps_now, pq_now = praw["air_isentropic_density"], [praw[q] for q in qn]
    pu, pv = perturbed(praw["x_velocity_at_u_locations"]), perturbed(praw["y_velocity_at_v_locations"]) + 0.5
    padv_args = (pu, pv, [ps_now] + pq_now, [perturbed(ps_now)] + [perturbed(q) for q in pq_now])
    pakw = dict(nb=nl_p.nb, dt=c.dt, dx=pprog.dx, dy=pprog.dy, q_product=(False,) + (True,) * len(qn))
    got = fused_advection_fields(*padv_args, **pakw)
    padv = fused_advection_fields_plain(*padv_args, **pakw)
    w, inc = check_increments("fused_advection_fields (periodic)", got, padv,
                              [ps_now] + [clip_pos(ps_now * q) for q in pq_now], KERNEL_TOL)
    phase("check", f"fused_advection_fields (no boundary, {tuple(pcell)}) errors as a share of the largest "
          f"increment (s sqv sqc sqr) {inc}")
    kernels["fused_advection_fields"]["max_abs_err"] = max(kernels["fused_advection_fields"]["max_abs_err"], w)
    pflat = [a for v in padv_args for a in (v if isinstance(v, list) else [v])]
    record_also("fused_advection_fields", "s and 3 water densities, no boundary, no tendencies, 167x167x120",
                lambda: fused_advection_fields(*padv_args, **pakw),
                lambda: fused_advection_fields_plain(*padv_args, **pakw),
                bound(nbytes(pflat) + nbytes(padv), 45.0 * len(padv) * ps_now.numel()))
    ps_new = phb.enforce_field(padv[0], "air_isentropic_density")
    pmtg = pprog.diagnostics.get_montgomery_potential(ps_new, pprog.pt, pcore.topography_steady)
    pms_args = (pu, pv, praw["x_momentum_isentropic"], praw["y_momentum_isentropic"],
                perturbed(praw["x_momentum_isentropic"]), perturbed(praw["y_momentum_isentropic"]) + 1.0,
                ps_now, praw["montgomery_potential"], ps_new, pmtg)
    pmkw = dict(order=5, nb=nl_p.nb, dt=c.dt, dx=pprog.dx, dy=pprog.dy, eps=pprog.eps)
    got = fused_momentum_step(*pms_args, **pmkw)
    pref = fused_momentum_step_plain(*pms_args, **pmkw)
    w, rel = check_outputs("fused_momentum_step (periodic)", got, pref, [amax(*pref)] * 2, KERNEL_TOL)
    phase("check", f"fused_momentum_step (order 5, {tuple(pcell)}) relative errors (su sv) {rel}")
    kernels["fused_momentum_step"]["max_abs_err"] = max(kernels["fused_momentum_step"]["max_abs_err"], w)
    record_also("fused_momentum_step", "order 5, 167x167x120",
                lambda: fused_momentum_step(*pms_args, **pmkw),
                lambda: fused_momentum_step_plain(*pms_args, **pmkw),
                bound(nbytes(pms_args) + nbytes(pref), 200.0 * ps_now.numel()))

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
    # the two process merges, last, so that the random inputs of the kernels
    # above are those of the runs before the merges existed
    # the merge smoothing + Smagorinsky RK2 on the six smoothed fields, with
    # the Smagorinsky check's velocity noise: the smoothed fields as the
    # smoothing kernel's, the momenta as Smagorinsky's (against the smoothed
    # momenta, the stages' base)
    mfields = [perturbed(s_now), perturbed(su_now, 0.05), s_now * noise(cell, 2.0)] + fields[3:]
    mkw = dict(order=smoother.order, **skw)  # the smoothing's nb is the boundary's, as Smagorinsky's
    got = fused_smoothing_smagorinsky_rk2(mfields, smoother.gamma, **mkw)
    ref = fused_smoothing_smagorinsky_rk2_plain(mfields, smoother.gamma, **mkw)
    msm = fused_smoothing_plain(mfields, smoother.gamma, **sm)
    w1, rel = check_outputs("fused_smoothing_smagorinsky_rk2 (smoothed)", [got[0], *got[3:]],
                            [ref[0], *ref[3:]], [amax(ref[0])] + [amax(r) for r in ref[3:]], 1e-6)
    w2, inc = check_increments("fused_smoothing_smagorinsky_rk2 (momenta)", got[1:3], ref[1:3], msm[1:3],
                               KERNEL_TOL)
    phase("check", f"fused_smoothing_smagorinsky_rk2 relative errors (s qv qc qr) {rel}; errors as a "
          f"share of the largest increment (su sv) {inc}")
    # the smoothing's taps on six fields and both Smagorinsky stages
    record("fused_smoothing_smagorinsky_rk2", "smooth_smag.cu", "tasmania_tpu/ops/smagorinsky_step.py:303",
           max(w1, w2), lambda: fused_smoothing_smagorinsky_rk2(mfields, smoother.gamma, **mkw),
           lambda: fused_smoothing_smagorinsky_rk2_plain(mfields, smoother.gamma, **mkw),
           bound(nbytes(mfields + [smoother.gamma]) + nbytes(ref),
                 ((12.0 * smoother.order + 3.0) * len(mfields) + 2 * 100.0) * s_now.numel()))
    # the pair run apart: the smoothing kernel, then Smagorinsky's on the
    # smoothed (s, su, sv); the merge shares their device code, so it should
    # give their bits
    def smooth_smag_apart(fs):
        smoothed = fused_smoothing(fs, smoother.gamma, **sm)
        return (smoothed[0], *fused_smagorinsky_rk2(*smoothed[:3], **skw), *smoothed[3:])

    apart = smooth_smag_apart(mfields)
    phase("check", "fused_smoothing_smagorinsky_rk2 against fused_smoothing then fused_smagorinsky_rk2: "
          f"largest difference {max(float((a - b).abs().max()) for a, b in zip(got, apart))}")
    record_also("fused_smoothing_smagorinsky_rk2", "the pair apart (fused_smoothing, then fused_smagorinsky_rk2)",
                lambda: smooth_smag_apart(mfields),
                lambda: fused_smoothing_smagorinsky_rk2_plain(mfields, smoother.gamma, **mkw),
                bound(nbytes(mfields + [smoother.gamma]) + nbytes(ref),
                      ((12.0 * smoother.order + 3.0) * len(mfields) + 2 * 100.0) * s_now.numel()))
    # the same on the unperturbed initial state, whose uniform flow has zero
    # strain almost everywhere
    ifields = [raw[n] for n in names]
    record_also("fused_smoothing_smagorinsky_rk2", "the unperturbed initial state",
                lambda: fused_smoothing_smagorinsky_rk2(ifields, smoother.gamma, **mkw),
                lambda: fused_smoothing_smagorinsky_rk2_plain(ifields, smoother.gamma, **mkw),
                bound(nbytes(ifields + [smoother.gamma]) + nbytes(ref),
                      ((12.0 * smoother.order + 3.0) * len(ifields) + 2 * 100.0) * s_now.numel()))

    # the merge vertical advection + sedimentation: vertical advection's
    # inputs with rain everywhere (where an advected qr lands within rounding
    # of zero, max(qr, 0)^0.1346 tells two roundings apart), the advected
    # fields as vertical advection's, qr and vt as sedimentation's
    rain = uniform(cell, 0.1 * ke.a, ke.a)
    vsin = vin + (vq[0], qc, rain, raw["air_density"], raw["height_on_interface_levels"])
    vskw = dict(vorder=va.vflux.order, sorder=sed.sflux.nb, dt=5.0, dz=va.dz, vt_mode=sed.vt_mode)
    got = fused_vadv_sedimentation_rk3ws(*vsin, **vskw)
    ref = fused_vadv_sedimentation_rk3ws_plain(*vsin, **vskw)
    w1, inc = check_increments("fused_vadv_sedimentation_rk3ws (advected)", got[:5], ref[:5], vsin[1:6],
                               KERNEL_TOL)
    w2, rel = check_outputs("fused_vadv_sedimentation_rk3ws (qr vt)", got[5:], ref[5:],
                            [amax(r) for r in ref[5:]], KERNEL_TOL)
    phase("check", "fused_vadv_sedimentation_rk3ws errors as a share of the largest increment "
          f"(s su sv qv qc) {inc}; relative errors (qr vt) {rel}")
    record("fused_vadv_sedimentation_rk3ws", "vadv_sed.cu", "tasmania_tpu/ops/vertical_advection_step.py:242",
           max(w1, w2), lambda: fused_vadv_sedimentation_rk3ws(*vsin, **vskw),
           lambda: fused_vadv_sedimentation_rk3ws_plain(*vsin, **vskw),
           bound(nbytes(vsin) + nbytes(ref), (18 * 22.0 + powers * 20.0 + 90.0) * s_now.numel()))
    # the pair run apart: vertical advection's kernel, then sedimentation's on
    # the advected qr, at the merge's vt_mode

    def vadv_sed_apart():
        adv = fused_vertical_advection_rk3ws(*vsin[:4], vsin[4:7], order=vskw["vorder"], dt=vskw["dt"],
                                             dz=vskw["dz"])
        return (*adv[:5], *fused_sedimentation_rk3ws(vsin[7], vsin[8], adv[5], order=vskw["sorder"],
                                                      dt=vskw["dt"], vt_mode=vskw["vt_mode"]))

    apart = vadv_sed_apart()
    phase("check", "fused_vadv_sedimentation_rk3ws against fused_vertical_advection_rk3ws then "
          f"fused_sedimentation_rk3ws: largest difference {max(float((a - b).abs().max()) for a, b in zip(got, apart))}")
    record_also("fused_vadv_sedimentation_rk3ws",
                "the pair apart (fused_vertical_advection_rk3ws, then fused_sedimentation_rk3ws)",
                vadv_sed_apart, lambda: fused_vadv_sedimentation_rk3ws_plain(*vsin, **vskw),
                bound(nbytes(vsin) + nbytes(ref), (18 * 22.0 + powers * 20.0 + 90.0) * s_now.numel()))

    # the tall path of the three column kernels (csrc/tall_column.cu, one
    # launch a stage): first against the fused kernels on the flagship's
    # inputs above (the tall functions called directly; the largest
    # difference printed, not gated: FMA contraction may differ),
    # then above the fused kernels' heights, on TALL_COLUMNS of the
    # flagship's columns interpolated linearly to TALL_NZ levels
    # (TALL_SED_NZ for sedimentation) with the inputs of the checks above
    # (w of a few hundredths of K/s, the mass fractions, rain everywhere),
    # against the plain versions with the fused kernels' gates; each tall
    # helper counted under its own name (vertical_advection_tall,
    # sedimentation_tall) and each call timed as an ``also`` entry of its kernel
    sedkw = dict(order=sed.sflux.nb, dt=5.0, vt_mode=sed.vt_mode)  # sedimentation's, as above
    tall_vs_fused = [
        (vertical_advection_tall(vin + vq, **vkw), fused_vertical_advection_rk3ws(*vin, vq, **vkw)),
        (sedimentation_tall(din, **sedkw), fused_sedimentation_rk3ws(*din, **sedkw)),
    ]
    tadv = vertical_advection_tall(vsin[:7], order=vskw["vorder"], dt=vskw["dt"], dz=vskw["dz"])
    tall_vs_fused.append((tadv[:5] + sedimentation_tall((vsin[7], vsin[8], tadv[5]), order=vskw["sorder"],
                                                        dt=vskw["dt"], vt_mode=vskw["vt_mode"]),
                          fused_vadv_sedimentation_rk3ws(*vsin, **vskw)))
    phase("check", "tall path against the fused kernels at 161x161x120, largest differences "
          "(vertical advection, sedimentation, their merge): " + " ".join(
              f"{max(float((a - b).abs().max()) for a, b in zip(t, f)):.3g}" for t, f in tall_vs_fused))
    del tall_vs_fused, tadv
    tcols = (slice(60, 60 + TALL_COLUMNS[0]), slice(60, 60 + TALL_COLUMNS[1]))

    def stretched(t, n):
        """The tall columns of ``t``: linear interpolation over its levels to n."""
        x = t[tcols].reshape(-1, 1, t.shape[-1])
        return torch.nn.functional.interpolate(x, size=n, mode="linear", align_corners=True).reshape(
            *TALL_COLUMNS, n).contiguous()

    def tall_column(nz):
        shape = (*TALL_COLUMNS, nz)
        return (noise(shape, 0.02), perturbed(stretched(s_now, nz)), perturbed(stretched(su_now, nz)),
                perturbed(stretched(sv_now, nz)) + 1.0, perturbed(stretched(raw[qn[0]], nz)),
                uniform(shape, 0.0, 2.0 * ke.a), uniform(shape, 0.1 * ke.a, ke.a),
                stretched(raw["air_density"], nz), stretched(raw["height_on_interface_levels"], nz + 1))

    def counted(fn, *names):
        """``fn()``, which must count each of ``names`` once and nothing else."""
        before = dict(_lib.launch_counts)
        out = fn()
        counts = {k: n - before.get(k, 0) for k, n in _lib.launch_counts.items() if n != before.get(k, 0)}
        if counts != dict.fromkeys(names, 1):
            raise AssertionError(f"{names}: the call launched {counts}")
        return out

    tv = tall_column(TALL_NZ)
    got = counted(lambda: fused_vertical_advection_rk3ws(*tv[:4], tv[4:7], **vkw),
                  "vertical_advection_tall")
    ref = fused_vertical_advection_rk3ws_plain(*tv[:4], tv[4:7], **vkw)
    _, inc = check_increments("fused_vertical_advection_rk3ws (tall)", got, ref, tv[1:7], KERNEL_TOL)
    record_also("fused_vertical_advection_rk3ws", f"tall path, {TALL_COLUMNS[0]}x{TALL_COLUMNS[1]}x{TALL_NZ}",
                lambda: fused_vertical_advection_rk3ws(*tv[:4], tv[4:7], **vkw),
                lambda: fused_vertical_advection_rk3ws_plain(*tv[:4], tv[4:7], **vkw),
                bound(nbytes(tv[:7]) + nbytes(ref), 18 * 22.0 * tv[1].numel()))
    got = counted(lambda: fused_vadv_sedimentation_rk3ws(*tv, **vskw), "vertical_advection_tall",
                  "sedimentation_tall")
    ref = fused_vadv_sedimentation_rk3ws_plain(*tv, **vskw)
    _, inc2 = check_increments("fused_vadv_sedimentation_rk3ws (tall, advected)", got[:5], ref[:5], tv[1:6],
                               KERNEL_TOL)
    _, rel2 = check_outputs("fused_vadv_sedimentation_rk3ws (tall, qr vt)", got[5:], ref[5:],
                            [amax(r) for r in ref[5:]], KERNEL_TOL)
    record_also("fused_vadv_sedimentation_rk3ws",
                f"tall path (the two tall paths in turn), {TALL_COLUMNS[0]}x{TALL_COLUMNS[1]}x{TALL_NZ}",
                lambda: fused_vadv_sedimentation_rk3ws(*tv, **vskw),
                lambda: fused_vadv_sedimentation_rk3ws_plain(*tv, **vskw),
                bound(nbytes(tv) + nbytes(ref), (18 * 22.0 + powers * 20.0 + 90.0) * tv[1].numel()))
    del tv
    ts = tall_column(TALL_SED_NZ)
    tdin = (ts[7], ts[8], ts[6])
    got = counted(lambda: fused_sedimentation_rk3ws(*tdin, **sedkw), "sedimentation_tall")
    ref = fused_sedimentation_rk3ws_plain(*tdin, **sedkw)
    _, rel3 = check_outputs("fused_sedimentation_rk3ws (tall)", got, ref, [amax(r) for r in ref], KERNEL_TOL)
    record_also("fused_sedimentation_rk3ws", f"tall path, {TALL_COLUMNS[0]}x{TALL_COLUMNS[1]}x{TALL_SED_NZ}",
                lambda: fused_sedimentation_rk3ws(*tdin, **sedkw),
                lambda: fused_sedimentation_rk3ws_plain(*tdin, **sedkw),
                bound(nbytes(tdin) + nbytes(ref), (powers * 20.0 + 90.0) * ts[6].numel()))
    phase("check", f"tall path: fused_vertical_advection_rk3ws errors as a share of the largest "
          f"increment {inc}; fused_vadv_sedimentation_rk3ws {inc2}, relative (qr vt) {rel2}; "
          f"fused_sedimentation_rk3ws relative (qr vt) {rel3}")
    del ts, tdin
    # the kernels of sus_yz (phase 13) at its shapes: the flagship on a y-z
    # slice, numerically 7x161x120 (the relaxed boundary with nx == 1: 2 nb +
    # 1 columns, fewer than one x-tile of each kernel), on the slice's
    # initial state perturbed as above, the perturbations shared by the
    # seven columns as the path's fields are (slab), each against its plain
    # version with its gate above, timed as an ``also`` entry
    ynl = load_namelist(**namelist_overrides(YZ))
    ydomain, ystate, ypt = drv.build_domain_and_state(ynl)
    ydycore, yphysics = drv.build_model(ynl, ydomain, ypt)
    yprog = ydycore.prognostic
    yraw = {k: v.data for k, v in ystate.items() if k != "time"}
    ycell = yraw["air_isentropic_density"].shape
    ylabel = f"{'x'.join(map(str, ycell))} (sus_yz)"

    def slab(t):
        """``t`` with every x-column equal to column nb, as on the slice."""
        return t[ynl.nb : ynl.nb + 1].expand_as(t).contiguous()

    ys, ysv = slab(perturbed(yraw["air_isentropic_density"])), slab(perturbed(yraw["y_momentum_isentropic"]))
    ysu = slab(ys * noise(ycell, 0.05))
    yq = [slab(perturbed(yraw[q])) for q in qn]
    yerrs = []

    def yz_check(name, got, ref, base=None, tol=KERNEL_TOL, scales=None):
        """The gate of the kernel's row above: increments against ``base``,
        else relative to each output's largest magnitude (``scales``)."""
        if base is not None:
            w, rel = check_increments(f"{name} ({ylabel})", got, ref, base, tol)
        else:
            w, rel = check_outputs(f"{name} ({ylabel})", got, ref, scales or [amax(r) for r in ref], tol)
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], w)
        yerrs.append(f"{name} {rel}")

    ysmoother = yphysics.components[1]
    yfields = [slab(perturbed(yraw[n])) for n in ysmoother.input_properties]
    ysm = dict(order=ysmoother.order, nb=ysmoother.nb)
    ref = fused_smoothing_plain(yfields, ysmoother.gamma, **ysm)
    yz_check("fused_smoothing", fused_smoothing(yfields, ysmoother.gamma, **ysm), ref, tol=1e-6)
    record_also("fused_smoothing", ylabel, lambda: fused_smoothing(yfields, ysmoother.gamma, **ysm),
                lambda: fused_smoothing_plain(yfields, ysmoother.gamma, **ysm),
                bound(nbytes(yfields) + nbytes(ref), (12.0 * ysmoother.order + 3.0) * len(yfields) * ys.numel()))
    ysmag = next(p for p in yphysics.components if isinstance(p, TendencyStepper) and any(
        isinstance(c, IsentropicSmagorinsky) for c in p.coupling.components)).coupling.components[0]
    ydx, ydy = ysmag.spacings()
    yskw = dict(dx=ydx, dy=ydy, cs=ysmag.cs, nb=ysmag.nb, dt=5.0)
    ysin = (ys, ysu, ysv)
    ref = fused_smagorinsky_rk2_plain(*ysin, **yskw)
    yz_check("fused_smagorinsky_rk2", fused_smagorinsky_rk2(*ysin, **yskw), ref, base=ysin[1:])
    record_also("fused_smagorinsky_rk2", ylabel, lambda: fused_smagorinsky_rk2(*ysin, **yskw),
                lambda: fused_smagorinsky_rk2_plain(*ysin, **yskw),
                bound(nbytes(ysin) + nbytes(ref), 2 * 100.0 * ys.numel()))
    yqc = slab(uniform(ycell, 0.0, 2.0 * ke.a))
    yqr = slab(uniform(ycell, 0.0, ke.a) * (uniform(ycell, 0.0, 1.0) > 0.3))
    ykin = (yraw["air_density"], yraw["air_temperature"], yraw["air_pressure_on_interface_levels"],
            yraw["exner_function_on_interface_levels"], slab(perturbed(yraw[qn[0]], 0.05)), yqc, yqr)
    ref = fused_kessler_satadj_rk2_plain(*ykin, kc)
    yz_check("fused_kessler_satadj_rk2", fused_kessler_satadj_rk2(*ykin, kc), ref)
    record_also("fused_kessler_satadj_rk2", ylabel, lambda: fused_kessler_satadj_rk2(*ykin, kc),
                lambda: fused_kessler_satadj_rk2_plain(*ykin, kc),
                bound(nbytes(ykin) + nbytes(ref), 150.0 * ys.numel()))
    yvin = (slab(noise(ycell, 0.02)), ys, ysu, ysv + 1.0)
    yvq = (yq[0], yqc, yqr)
    ref = fused_vertical_advection_rk3ws_plain(*yvin, yvq, **vkw)
    yz_check("fused_vertical_advection_rk3ws", fused_vertical_advection_rk3ws(*yvin, yvq, **vkw), ref,
             base=yvin[1:] + yvq)
    record_also("fused_vertical_advection_rk3ws", ylabel, lambda: fused_vertical_advection_rk3ws(*yvin, yvq, **vkw),
                lambda: fused_vertical_advection_rk3ws_plain(*yvin, yvq, **vkw),
                bound(nbytes(yvin + yvq) + nbytes(ref), 18 * 22.0 * ys.numel()))
    ydin = (yraw["air_density"], yraw["height_on_interface_levels"], yqr)
    ref = fused_sedimentation_rk3ws_plain(*ydin, **sedkw)
    yz_check("fused_sedimentation_rk3ws", fused_sedimentation_rk3ws(*ydin, **sedkw), ref)
    record_also("fused_sedimentation_rk3ws", ylabel, lambda: fused_sedimentation_rk3ws(*ydin, **sedkw),
                lambda: fused_sedimentation_rk3ws_plain(*ydin, **sedkw),
                bound(nbytes(ydin) + nbytes(ref), (powers * 20.0 + 90.0) * ys.numel()))
    ydia = yprog.diagnostics
    yd_in = (ys, ydycore.topography_steady, ydia.theta)
    ydkw = {**dkw, "pt": yprog.pt, "dz": ydia.dz}
    for mode, flops in (("mtg", 30.0), ("moist", 55.0)):
        ref = fused_isentropic_diagnostics_plain(*yd_in, mode=mode, **ydkw)
        got = fused_isentropic_diagnostics(*yd_in, mode=mode, **ydkw)
        got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
        for k, (a, r) in enumerate(zip(got, ref)):
            yz_check("fused_isentropic_diagnostics", [a], [r], tol=DIAG_RHO_TOL if k == 4 else KERNEL_TOL)
        record_also("fused_isentropic_diagnostics", f"{mode}, {ylabel}",
                    lambda m=mode: fused_isentropic_diagnostics(*yd_in, mode=m, **ydkw),
                    lambda m=mode: fused_isentropic_diagnostics_plain(*yd_in, mode=m, **ydkw),
                    bound(nbytes(yd_in) + nbytes(ref), flops * ys.numel()))
    yu = yraw["x_velocity_at_u_locations"]
    yv = slab(perturbed(yraw["y_velocity_at_v_locations"])) + 0.5
    yadv_args = (yu, yv, [ys] + yq, [slab(perturbed(ys))] + [slab(perturbed(q)) for q in yq])
    yakw = dict(nb=ynl.nb, dt=c.dt, dx=yprog.dx, dy=yprog.dy, q_product=(False,) + (True,) * len(qn))
    yadv = fused_advection_fields_plain(*yadv_args, **yakw)
    yz_check("fused_advection_fields", fused_advection_fields(*yadv_args, **yakw), yadv,
             base=[ys] + [clip_pos(ys * q) for q in yq])
    yflat = [a for v in yadv_args for a in (v if isinstance(v, list) else [v])]
    record_also("fused_advection_fields", f"s and 3 water densities, no boundary, no tendencies, {ylabel}",
                lambda: fused_advection_fields(*yadv_args, **yakw),
                lambda: fused_advection_fields_plain(*yadv_args, **yakw),
                bound(nbytes(yflat) + nbytes(yadv), 45.0 * len(yadv) * ys.numel()))
    ys_new = ydomain.horizontal_boundary.enforce_field(yadv[0], "air_isentropic_density")
    ymtg = ydia.get_montgomery_potential(ys_new, yprog.pt, ydycore.topography_steady)
    yms_args = (yu, yv, ysu, ysv, slab(perturbed(ysu)), slab(perturbed(ysv)) + 1.0, ys,
                yraw["montgomery_potential"], ys_new, ymtg)
    ymkw = dict(order=5, nb=ynl.nb, dt=c.dt, dx=yprog.dx, dy=yprog.dy, eps=yprog.eps)
    ref = fused_momentum_step_plain(*yms_args, **ymkw)
    yz_check("fused_momentum_step", fused_momentum_step(*yms_args, **ymkw), ref, scales=[amax(*ref)] * 2)
    record_also("fused_momentum_step", f"order 5, {ylabel}", lambda: fused_momentum_step(*yms_args, **ymkw),
                lambda: fused_momentum_step_plain(*yms_args, **ymkw),
                bound(nbytes(yms_args) + nbytes(ref), 200.0 * ys.numel()))
    phase("check", f"at {ylabel}, errors (relative, or as a share of the largest increment): "
          + " | ".join(yerrs))
    del (ydomain, ystate, ydycore, yphysics, yraw, ys, ysv, ysu, yq, yfields, ysin, ykin, yqc, yqr, yvin, yvq,
         ydin, yd_in, yu, yv, yadv_args, yadv, yflat, ys_new, ymtg, yms_args)
    phase("timing", f"{profiler_sessions['measurements']} times from pairs of profiler sessions that "
          f"agree on their device operations a call, in {profiler_sessions['sessions']} sessions "
          f"({profiler_sessions['empty']} without device time)")
    del (fields, fulls, lo, hi, views, got, ref, stage_in, args, flat_in, kin, sin, vin, vq, din,
         adv_args, adv, mtg_e, mom_args, flat, base, q_now, s_int, state, raw, dycore, physics, domain, args3,
         full1, lo1, hi1, st1, st2, got1, ref1, ms_args, d_in, mdom, mstate, mcore, mdiag, mraw, mu,
         mv, ms_int, a3, madv, ms_e, mhs, mtg_args, mmtg, m3, mfields, msm, ifields, rain, vsin, apart,
         adv3, pdomain, pstate, pcore, praw, ps_now, pq_now, pu, pv, padv_args, padv, pflat, ps_new, pmtg,
         pms_args, pref)

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
        out = {k: fa.data.cpu().numpy() for k, fa in res["fields"].items()}
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
        return lambda n: drv.run(n, skip=skip, verbose=False, fused_loop=False)

    # -- 4. the first slice through its kernels --------------------------------
    drive("slice", sus(nl.slice_skip), nl, LAUNCHES_PER_STEP["slice"], "slice_reference.json",
          lambda key: SLICE_TOL, SLICE_TOL)

    # -- 5. the full flagship step through its seven kernels (the main path) ----
    res, counts = drive(
        "flagship", sus(()), nl, LAUNCHES_PER_STEP["sus"], "flagship_reference.json",
        lambda key: FLAGSHIP_QC_TOL if key.startswith("qc_") else FLAGSHIP_TOL, 0.0,
    )
    path_counts, path_steps = {"sus": counts}, {"sus": 1 + nl.niter}
    phase("validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} "
          f"(the TPU's: umax = {TPU_VALIDATION['umax']:.5f}, vmax = {TPU_VALIDATION['vmax']:.5f}; "
          "for information)")
    # the eager runs' final fields, which the graph runs of phases 10 and 20
    # must equal, and their ms/step, beside which phase 20 prints the default's
    def eager_result(res, steps):
        return dict(fields=res["fields"], ms_per_step=res["ms_per_step"], steps=steps)

    eager_runs = {"sus": eager_result(res, 1 + nl.niter)}
    del res

    # -- 6. the full step on rain ----------------------------------------------
    rain_cfg = json.loads(Path(drv.__file__).with_name("flagship_rain_reference.json").read_text())["config"]
    nl_rain = load_namelist(relative_humidity=rain_cfg["relative_humidity"], niter=rain_cfg["niter"])
    drive("rain", sus(()), nl_rain, LAUNCHES_PER_STEP["sus"], "flagship_rain_reference.json",
          lambda key: RAIN_TOL, 0.0)

    # -- 7. the five other couplings (driver_isentropic_moist) ----------------
    nl_of = {}
    for coupling in VARIANTS:
        reference = f"variant_{coupling}_reference.json"
        cfg = json.loads(Path(drv.__file__).with_name(reference).read_text())["config"]
        nl_v = moist.load_namelist(coupling, niter=cfg["niter"], relative_humidity=cfg["relative_humidity"])
        if (nl_v.nx, nl_v.ny, nl_v.nz) != (cfg["nx"], cfg["ny"], cfg["nz"]):
            raise AssertionError(f"{reference} is not at the flagship's size")
        res, counts = drive(
            coupling, lambda n, c=coupling: moist.run(n, c, verbose=False, fused_loop=False), nl_v,
            LAUNCHES_PER_STEP[coupling], reference, lambda key, c=coupling: variant_tol(c, key), 0.0,
        )
        path_counts[coupling], path_steps[coupling] = counts, 1 + nl_v.niter
        phase(f"{coupling}-validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} "
              "(for information)")
        eager_runs[coupling], nl_of[coupling] = eager_result(res, 1 + nl_v.niter), nl_v
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
                      so=StorageOptions(dtype=torch.float32, device=device), verbose=False, fused_loop=False)
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
    eager_runs["mountain_wave"] = eager_result(res, steps)
    del res

    # -- 9. the rain run with both process merges (sus_merged) -----------------
    mcfg = json.loads(Path(drv.__file__).with_name("flagship_merged_reference.json").read_text())["config"]
    if tuple(mcfg["process_merges"]) != MERGES:
        raise AssertionError("flagship_merged_reference.json is not the run of both merges")
    nl_merged = load_namelist(relative_humidity=mcfg["relative_humidity"], niter=mcfg["niter"],
                              process_merges=MERGES)
    res, counts = drive("sus_merged", sus(()), nl_merged, LAUNCHES_PER_STEP["sus_merged"],
                        "flagship_merged_reference.json", lambda key: MERGED_TOL, 0.0)
    path_counts["sus_merged"], path_steps["sus_merged"] = counts, 1 + nl_merged.niter
    phase("sus_merged-validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} (for information)")
    eager_runs["sus_merged"] = eager_result(res, 1 + nl_merged.niter)
    del res

    # -- 13. the surface paths: third order (the whole-stage and the two-kernel
    # stage), the periodic boundary (the generic stage); before phase 10,
    # whose graphs they join
    for path, (coupling, overrides, reference) in SURFACE_PATHS.items():
        cfg = json.loads(Path(drv.__file__).with_name(reference).read_text())["config"]
        nl_s = moist.load_namelist(coupling, niter=cfg["niter"], relative_humidity=cfg["relative_humidity"],
                                   **namelist_overrides(overrides))
        if ((nl_s.nx, nl_s.ny, nl_s.nz, nl_s.horizontal_flux_scheme, nl_s.hb_type)
                != (cfg["nx"], cfg["ny"], cfg["nz"], cfg["horizontal_flux_scheme"], cfg["hb_type"])
                or any(cfg.get(k) != v for k, v in overrides.items() if k not in ("hb_type", "hb_kwargs"))):
            raise AssertionError(f"{reference} is not {path}'s configuration at the flagship's size")
        res, counts = drive(
            path, lambda n, c=coupling: moist.run(n, c, verbose=False, fused_loop=False), nl_s,
            LAUNCHES_PER_STEP[path],
            reference, lambda key, p=path: variant_tol(p, key), 0.0,
        )
        path_counts[path], path_steps[path] = counts, 1 + nl_s.niter
        phase(f"{path}-validation", f"umax = {res['umax']:.5f}, vmax = {res['vmax']:.5f} (for information)")
        eager_runs[path], nl_of[path] = eager_result(res, 1 + nl_s.niter), nl_s
        del res
    # the float64 witness: sus_periodic in float64, the same launches, held to
    # the port's float64 CPU run, so that the float32 limits above stand on
    # the algebra's agreement and not on one reading
    coupling, overrides, _ = SURFACE_PATHS["sus_periodic"]
    wcfg = json.loads(Path(drv.__file__).with_name(WITNESS_REFERENCE).read_text())["config"]
    nl_w = moist.load_namelist(coupling, niter=wcfg["niter"], relative_humidity=wcfg["relative_humidity"],
                               so=StorageOptions(dtype=torch.float64, device=device), **overrides)
    if ((wcfg["dtype"], wcfg["hb_type"], wcfg["nx"], wcfg["ny"], wcfg["nz"])
            != ("float64", nl_w.hb_type, nl_w.nx, nl_w.ny, nl_w.nz)):
        raise AssertionError(f"{WITNESS_REFERENCE} is not sus_periodic's configuration in float64")
    drive("sus_periodic-float64", lambda n: moist.run(n, coupling, verbose=False, fused_loop=False), nl_w,
          LAUNCHES_PER_STEP["sus_periodic"], WITNESS_REFERENCE, lambda key: WITNESS_TOL, WITNESS_TOL)
    del nl_w

    # -- 10. the fused loop: the runs of phases 5, 9, 7, 8 and 13 as CUDA graphs
    def mountain_wave(hours, fused):
        return mw.run_case(mwc["nx"], mwc["nz"], hours, mwc["dt"], theta_top=mwc["theta_top"],
                           damp_depth=mwc["damp_depth"], damp_max=mwc["damp_max"],
                           so=StorageOptions(dtype=torch.float32, device=device), verbose=False,
                           fused_loop=fused)

    graph_runs = {
        "sus": lambda: drv.run(nl, verbose=False, fused_loop=True),
        "sus_merged": lambda: drv.run(nl_merged, verbose=False, fused_loop=True),
        **{c: (lambda c=c: moist.run(nl_of[c], c, verbose=False, fused_loop=True)) for c in VARIANTS},
        "mountain_wave": lambda: mountain_wave(mwc["hours"], True),
        **{p: (lambda p=p: moist.run(nl_of[p], SURFACE_PATHS[p][0], verbose=False, fused_loop=True))
           for p in SURFACE_PATHS},
    }
    steps_of = {"sus": 1 + nl.niter, "sus_merged": 1 + nl_merged.niter, "mountain_wave": steps,
                **{c: 1 + nl_of[c].niter for c in (*VARIANTS, *SURFACE_PATHS)}}
    for path, run_graph in graph_runs.items():
        per_step = LAUNCHES_PER_STEP[path]
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        res = run_graph()
        counts = dict(_lib.launch_counts)
        # a replay counts nothing: the warm-up step and the capture, once each
        for name in sorted(set(per_step) | set(counts)):
            if counts.get(name, 0) != 2 * per_step.get(name, 0):
                raise AssertionError(f"fused loop, {path}: {name} launched {counts.get(name, 0)} times "
                                     f"in the warm-up and the capture, expected {2 * per_step.get(name, 0)}")
        if res["launches_per_step"] != per_step:
            raise AssertionError(f"fused loop, {path}: the captured step launched {res['launches_per_step']}")
        eager = (eager_runs.pop(path) if path in SURFACE_PATHS else eager_runs[path])["fields"]
        if set(res["fields"]) != set(eager):
            raise AssertionError(f"fused loop, {path}: fields {sorted(res['fields'])} vs {sorted(eager)}")
        diff = max(float((res["fields"][k].data - fa.data).abs().max()) for k, fa in eager.items())
        unequal = sorted(k for k, fa in eager.items() if not torch.equal(res["fields"][k].data, fa.data))
        if unequal:
            raise AssertionError(f"fused loop, {path}: {unequal} differ from the eager run's "
                                 f"(largest difference {diff})")
        phase("fused-loop", f"{path}: {steps_of[path]} steps, the "
              f"graph's final fields equal the eager run's bit for bit ({len(eager)} fields, largest "
              f"difference {diff}); capture {res['capture_s']:.3f} s, {res['ms_per_step']:.3f} ms/step; "
              f"launches {counts} (the warm-up step and the capture)")
        del res, eager

    # paired timing in this call: eager, graph, graph, eager, ... (FUSED_PAIRS
    # pairs), FUSED_TIMED_STEPS timed steps a run after the warm-up step (the
    # mountain wave FUSED_TIMED_MW of its 20 s steps), each model built once
    timing = {}
    models = {"sus": (nl, "sus"), "sus_merged": (nl_merged, "sus"), "fc": (nl_of["fc"], "fc")}
    for path in ("sus", "sus_merged", "fc", "mountain_wave"):
        if path == "mountain_wave":
            hours = (1 + FUSED_TIMED_MW) * mwc["dt"] / 3600.0

            def timed(fused):
                return mountain_wave(hours, fused)["ms_per_step"]
        else:
            nl_t, coupling = models[path]
            nl_t = SimpleNamespace(**{**vars(nl_t), "niter": FUSED_TIMED_STEPS})
            _, t_state, t_dycore, t_step = moist.build_variant(nl_t, coupling)

            def timed(fused):
                return drv.run_steps(nl_t, t_state, t_step, t_dycore.topography_steady, verbose=False,
                                     fused_loop=fused)["ms_per_step"]
        runs = {False: [], True: []}
        for i in range(FUSED_PAIRS):
            for fused in ((False, True) if i % 2 == 0 else (True, False)):
                runs[fused].append(timed(fused))
        timing[path] = {"eager_ms_per_step": runs[False], "graph_ms_per_step": runs[True]}
        med = {f: sorted(r)[len(r) // 2] for f, r in runs.items()}
        phase("fused-loop-timing", f"{path}, {FUSED_TIMED_MW if path == 'mountain_wave' else FUSED_TIMED_STEPS} "
              f"timed steps a run, {FUSED_PAIRS} pairs on {card}: eager ms/step "
              f"{' '.join(f'{t:.3f}' for t in runs[False])} (median {med[False]:.3f}); graph "
              f"{' '.join(f'{t:.3f}' for t in runs[True])} (median {med[True]:.3f})")
    print(json.dumps({"fused_loop_timing": timing, "card": card}))

    # -- 11. Burgers at 2048x2048 (BASELINE config 1) through driver_burgers --
    f32 = StorageOptions(dtype=torch.float32, device=device)
    bref = json.loads(Path(burgers.__file__).with_name("burgers_reference.json").read_text())
    burgers_timing = {}
    for case in burgers.CASES:
        runs = {}
        for fused in (False, True):
            torch.cuda.synchronize()
            _lib.reset_launch_counts()
            runs[fused] = burgers.run_case(case, BURGERS_NX, so=f32, verbose=False, fused_loop=fused)
            # plain PyTorch on the card: the path launches none of the kernels
            if dict(_lib.launch_counts) or runs[fused]["launches_per_step"]:
                raise AssertionError(f"burgers {case}: launched {dict(_lib.launch_counts)}")
        eager, graph = runs[False], runs[True]
        for name, fa in eager["fields"].items():
            if not bool(torch.isfinite(fa.data).all()):
                raise AssertionError(f"burgers {case}: {name} is not finite")
            if not torch.equal(graph["fields"][name].data, fa.data):
                raise AssertionError(f"burgers {case}: the graph's {name} differs from the eager run's "
                                     f"by {float((graph['fields'][name].data - fa.data).abs().max())}")
        nx = eager["nx"]
        cells = (nx + 2 * eager["nb"]) ** 2 if case == "bench" else nx * nx
        b = burgers_bound(cells, 4, case)
        phase(f"burgers-{case}", f"{nx}x{nx}, 1+{eager['steps']} steps: the graph's u and v equal the "
              f"eager run's bit for bit; no kernel launched; capture {graph['capture_s']:.3f} s; "
              f"bound {b['bound_ms']:.4f} ms a step by {b['bound_by']} ({b['bytes'] / 1e6:.1f} MB) on {card}")
        if case == "zhao":
            cfg = bref["config"]
            if (cfg["nx"], cfg["ny"], cfg["nb"], cfg["steps"]) != (nx, nx, eager["nb"], eager["steps"]):
                raise AssertionError("burgers_reference.json is not at phase 11's configuration")
            diffs = []
            for key, tol in BURGERS_TOL.items():
                scale = bref[key[0] + "_abs_sum"] if key in ("u_sum", "v_sum") else abs(bref[key])
                dev = abs(eager[key] - bref[key]) / scale
                diffs.append(f"{key}={eager[key]:.9g}({dev:.1e})")
                if not dev <= tol:
                    raise AssertionError(f"burgers zhao {key}: {eager[key]} vs reference {bref[key]} "
                                         f"(deviation {dev:.2e} > {tol})")
            phase("burgers-zhao-reference", " ".join(diffs))
        eager_runs[f"burgers_{case}"] = eager_result(eager, 1 + eager["steps"])
        del runs, eager, graph
        # paired timing: eager, graph, graph, eager, ... of the default steps
        times = {False: [], True: []}
        for i in range(FUSED_PAIRS):
            for fused in ((False, True) if i % 2 == 0 else (True, False)):
                r = burgers.run_case(case, BURGERS_NX, so=f32, verbose=False, fused_loop=fused)
                times[fused].append((r["ms_per_step"], r["gps"]))
                del r
        med = {f: sorted(t[0] for t in r)[len(r) // 2] for f, r in times.items()}
        burgers_timing[case] = {"eager_ms_per_step": [t[0] for t in times[False]],
                                "graph_ms_per_step": [t[0] for t in times[True]],
                                "graph_gps": [t[1] for t in times[True]],
                                "bound_ms_per_step": b["bound_ms"], "bound_by": b["bound_by"]}
        phase(f"burgers-{case}-timing", f"{FUSED_PAIRS} pairs on {card}: eager ms/step "
              f"{' '.join(f'{t[0]:.4f}' for t in times[False])} (median {med[False]:.4f}); graph "
              f"{' '.join(f'{t[0]:.4f}' for t in times[True])} (median {med[True]:.4f}, "
              f"{nx * nx / med[True] * 1e3:.4e} gridpoints/s); bound {b['bound_ms']:.4f} ms/step")
    print(json.dumps({"burgers_timing": burgers_timing, "card": card}))

    # -- 20 (a). the graph by default: each driver's entry point with no mode
    # given, against the explicit eager runs of phases 5, 7, 8, 9 and 11
    default_runs = {
        "sus": lambda: drv.run(nl, verbose=False),
        "sus_merged": lambda: drv.run(nl_merged, verbose=False),
        **{c: (lambda c=c: moist.run(nl_of[c], c, verbose=False)) for c in VARIANTS},
        "mountain_wave": lambda: mountain_wave(mwc["hours"], None),
        **{f"burgers_{c}": (lambda c=c: burgers.run_case(c, BURGERS_NX, so=f32, verbose=False))
           for c in burgers.CASES},
    }
    graph_default = default_phase(card, default_runs, eager_runs, path_counts, path_steps, device)
    del default_runs, eager_runs
    print(json.dumps({"graph_default": graph_default, "card": card}))

    # -- 12. the diffusion, hyperdiffusion and smoothing dwarfs (BASELINE config 2)
    phi64 = torch.as_tensor(np.random.default_rng(DWARF_SEED).standard_normal(DWARF_SHAPE),
                            dtype=torch.float32).double()
    phi = phi64.to(device=device, dtype=torch.float32)
    cpu64 = StorageOptions(dtype=torch.float64, device="cpu")
    dwarf = build_dwarf  # each by its registered class; phase 17 builds them through the factories
    dwarfs = {(k, n): dwarf(k, n, f32) for k in DWARF_FAMILIES
              for n in sorted(registered_names(dwarf_family(k)))}
    # the path: each dwarf once; the 2-D smoothing filters through #3, nothing else launched
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    outs = {key: d(phi) for key, d in dwarfs.items()}
    torch.cuda.synchronize()
    counts = dict(_lib.launch_counts)
    expected = {"fused_smoothing": sum(d.axes == "xy" for (k, _), d in dwarfs.items() if k == "smoothing")}
    if counts != expected:
        raise AssertionError(f"dwarfs: launched {counts}, expected {expected}")
    path_counts["dwarfs"], path_steps["dwarfs"] = counts, 1
    dwarf_rows = []
    for (kind, name), out in outs.items():
        ref = dwarf(kind, name, cpu64)(phi64)
        scale = float(ref.abs().max())
        err = float((out.double().cpu() - ref).abs().max())
        if not (bool(torch.isfinite(out).all()) and err <= DWARF_TOL * scale):
            raise AssertionError(f"dwarf {kind} {name}: max|d| = {err} > {DWARF_TOL} * {scale}")
        d = dwarfs[(kind, name)]
        ms, how = device_ms(lambda: d(phi))
        db = bound(2 * phi.numel() * phi.element_size(), 0.0)
        dwarf_rows.append(dict(kind=kind, name=name, rel_err=err / scale, device_ms=ms, timed_by=how,
                               bound_ms=db["bound_ms"], bound_by=db["bound_by"]))
        phase("dwarf", f"{kind} {name} at {'x'.join(map(str, DWARF_SHAPE))} float32: {ms:.4f} ms "
              f"({how}), bound {db['bound_ms']:.4f} ms by {db['bound_by']}; error {err / scale:.1e} of "
              f"the largest magnitude of the float64 CPU result")
    del dwarfs
    print(json.dumps({"dwarfs": dwarf_rows, "card": card}))

    # -- 17. the registry: the flagship built by name, the backend names, the
    # stencils, the dwarfs through their factories, the allocators ---------
    print(json.dumps({"registry": registry_phase(card, path_counts, path_steps, outs, phi, device),
                      "card": card}))
    del outs

    # -- 15. the physics surface's plain components ----------------------------
    print(json.dumps({"components": components_phase(card, device), "card": card}))

    # -- 16. I/O and recovery on the flagship ---------------------------------
    print(json.dumps({"io": io_phase(card, path_counts, path_steps, device), "card": card}))

    # -- 14. the decomposed run (BASELINE config 5) through driver_sharded ----
    sharded_phase(card, path_counts, path_steps)

    # -- 18. distribution and tools: sharded checkpoints, --spmd, the hybrid
    # grid, driver_dist_bench, driver_weak_scaling, driver_profile --------
    kept = {}
    print(json.dumps({"distribution": distribution_phase(card, path_counts, path_steps, device, keep=kept),
                      "card": card}))

    # -- 19. the last one-card tools: --sweep, --diagnose, bench_variants,
    # bench_kernels, driver_roofline --------------------------------------
    print(json.dumps({"tools": tools_phase(card, path_counts, path_steps, device), "card": card}))

    # -- 20 (b), (c). recovery and --profile between graph replays, and one
    # --spmd rank, with no mode given -------------------------------------
    print(json.dumps({"graph_recovery": graph_recovery_phase(card, path_counts, path_steps,
                                                             kept["spmd_one_rank"], device), "card": card}))

    # each kernel's launches in the full-size run of the first path that runs
    # it (the flagship for the six of the SUS chain, the merged run for the
    # two merges), and in every path; the two pastes and the Smagorinsky
    # stage alone are on no path
    for name, entry in kernels.items():
        entry["path"] = next((p for p, n in path_counts.items() if n.get(name, 0)), None)
        entry["launches"] = path_counts[entry["path"]][name] if entry["path"] else 0
        entry["launches_per_step_by_path"] = {
            p: n.get(name, 0) / path_steps[p] for p, n in path_counts.items()
        }
    print(json.dumps({"kernels": [{"name": n, **e} for n, e in kernels.items()],
                      "launch_floor_ms": launch_floor_ms}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
