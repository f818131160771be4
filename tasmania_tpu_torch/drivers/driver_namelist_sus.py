"""Moist isentropic benchmark driver, sequential-update splitting (counterpart
of ``drivers/driver_namelist_sus.py``).

The dycore steps the state, then the physics chain runs in sequence:
diagnostics -> [Coriolis (the physics scheme, RK2)] -> smoothing ->
Smagorinsky (RK2) -> velocities -> Kessler (RK2) -> saturation adjustment
(RK2) -> vertical advection (RK3WS; with ``implicit_vertical_advection``
the Crank–Nicolson column solve, a diagnostic process) -> fall velocity +
sedimentation (RK3WS) -> fall velocity + precipitation.  Coriolis runs when
the namelist's ``coriolis_parameter`` is set (``--coriolis F``, in rad
s^-1), the implicit vertical advection with ``--implicit-vadv``; both are
plain PyTorch, as in the JAX package.  Kessler and saturation adjustment run
as one fused pair; the namelist's ``process_merges`` (``--merge NAME``,
repeatable) also merge smoothing with Smagorinsky (``smooth_smag``) and
vertical advection with sedimentation (``vadv_sed``), one kernel each; the
latter declines an implicit vertical advection, and sedimentation then runs
alone, as in the JAX package.  ``skip`` leaves processes out
(``namelist_sus.slice_skip`` gives the port's first slice).  The step
sequence is the JAX driver's: one step at zero mountain height (the
warm-up), then ``niter`` timed steps with the mountain at
``min((i+1)·dt/1800 s, 1)`` of its height.

On a CUDA device the timed steps are replays of one CUDA graph of the step
(``utils/jitx.py``), captured after the eager warm-up step and timed apart,
as the JAX driver ``jax.jit``s every step by default; the graph copies back
only the fields the step reads and gives the eager run's bits.  On the CPU
the steps are eager, since a CUDA graph cannot run there.  ``--no-jit``
(``fused_loop=False``; the JAX flag) steps eagerly on the card too.
``--fused-loop`` (``fused_loop=True``; the JAX flag's name: no per-step
dispatch) asks for the graph and raises without a CUDA device.

Both loops take the JAX driver's recovery flags (:class:`Recovery`;
``run_steps``' keywords of the same names): ``--checkpoint-dir DIR`` saves
the fields every ``--checkpoint-every`` steps (default 25) and after the
last step (``utils/checkpoint.py``); ``--resume`` replaces the fields, after
the warm-up step (and the capture), by the latest checkpoint's and runs the
steps after it; ``--nan-guard`` checks the fields for a non-finite value at
every checkpoint boundary and raises ``RuntimeError`` before saving a
poisoned state.  The graph replays up to each boundary and runs these
between replays.  ``--profile LOGDIR`` writes a ``torch.profiler`` trace of
the timed loop into LOGDIR (``utils/timer.profile_trace``).  As in the JAX
driver, ``--fused-loop`` refuses the checkpoint flags and takes
``--profile``.

``--spmd`` (the JAX flag shards the whole step over every visible device,
``drivers/driver_namelist_sus.py:273-275``, ``:394-419``) runs the whole
step through ``parallel/runner.py::DistributedModel`` on ``--ranks N``
local ranks (default 1) of ``make_rank_grid(N)``, or, with ``--multihost``,
as one rank of a ``torchrun`` group on ``make_hybrid_rank_grid`` (each
node's ranks one block; ``--node-grid PRX,PRY`` tiles the nodes in 2-D).
nx and ny are trimmed to multiples of the grid's extents.  ``--comm``
names the process group's backend (default ``nccl`` on the card, ``gloo``
on the CPU; ``nccl`` takes a card a rank, ``gloo`` lets ranks share one).
One rank is the degenerate 1x1 grid, the single-device program, and steps
through the graph on the card as the single device does; more ranks step
eagerly and say so, since a halo exchange cannot be captured in a CUDA
graph (``--fused-loop`` raises there).  The recovery flags work under
``--spmd``: each rank writes its blocks of a sharded checkpoint
(``utils/checkpoint.py``), ``--resume`` restores the latest one onto the
current grid whatever grid wrote it, and the NaN guard stops every rank at
the same boundary.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_namelist_sus [--nx N] [--ny N]
        [--nz N] [--niter N] [--device cuda|cpu] [--merge smooth_smag]
        [--merge vadv_sed] [--coriolis F] [--implicit-vadv] [--no-jit | --fused-loop]
        [--checkpoint-dir DIR [--checkpoint-every N] [--resume]] [--nan-guard]
        [--profile LOGDIR] [--spmd [--ranks N] [--comm nccl|gloo]
        [--multihost [--node-grid PRX,PRY]]]

The namelist's device is ``cuda``; without a GPU, ``run`` raises unless the
namelist names the CPU (``--device cpu`` on the command line).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import tempfile
import time
from dataclasses import replace
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import TimeIntegrationOptions
from tasmania_tpu_torch.framework.splitting import SequentialUpdateSplitting
from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tasmania_tpu_torch.isentropic.physics.coriolis import IsentropicConservativeCoriolis
from tasmania_tpu_torch.isentropic.physics.diagnostics import (
    IsentropicDiagnostics,
    IsentropicVelocityComponents,
)
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import (
    IsentropicHorizontalSmoothing,
)
from tasmania_tpu_torch.isentropic.physics.implicit_vertical_advection import (
    IsentropicImplicitVerticalAdvectionDiagnostic,
)
from tasmania_tpu_torch.isentropic.physics.turbulence import IsentropicSmagorinsky
from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
from tasmania_tpu_torch.isentropic.state import (
    get_isentropic_state_from_brunt_vaisala_frequency,
)
from tasmania_tpu_torch.isentropic.utils import (
    AirPotentialTemperatureToDiagnostic,
    AirPotentialTemperatureToTendency,
)
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.physics.microphysics.kessler import (
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
)
from tasmania_tpu_torch.physics.microphysics.utils import Precipitation
from tasmania_tpu_torch.utils.checkpoint import CheckpointManager
from tasmania_tpu_torch.utils.jitx import StepBody, StepGraph, traced_step
from tasmania_tpu_torch.utils.timer import profile_trace

PROCESSES = (
    "diagnostics", "coriolis", "smoothing", "smagorinsky", "velocities",
    "kessler", "satadj", "vertical_advection", "sedimentation", "precipitation",
)


def build_domain_and_state(nl):
    """Domain, initial state (also the boundary reference state) and the top
    pressure ``pt``."""
    so = nl.so
    domain = Domain(
        nl.domain_x, nl.nx, nl.domain_y, nl.ny, nl.domain_z, nl.nz,
        horizontal_boundary_type=nl.hb_type,
        nb=nl.nb,
        horizontal_boundary_kwargs=nl.hb_kwargs,
        topography_type=nl.topo_type,
        topography_kwargs=nl.topo_kwargs,
        backend=nl.backend,
        backend_options=nl.bo,
        storage_options=so,
    )
    cgrid = domain.numerical_grid
    state = get_isentropic_state_from_brunt_vaisala_frequency(
        cgrid, nl.init_time, nl.x_velocity, nl.y_velocity, nl.brunt_vaisala,
        moist=True,
        precipitation=nl.sedimentation,
        relative_humidity=nl.relative_humidity,
        storage_options=so,
    )
    domain.horizontal_boundary.reference_state = state
    state["tendency_of_air_potential_temperature"] = FieldArray(
        torch.zeros((cgrid.nx, cgrid.ny, cgrid.nz), dtype=so.dtype, device=so.device),
        "K s^-1",
        ("x", "y", "z"),
    )
    p = state["air_pressure_on_interface_levels"].data
    pt = FieldArray(np.asarray(float(p[0, 0, 0])), "Pa", ())
    return domain, state, pt


def make_dycore(nl, domain, pt, **fast_components):
    """The namelist's isentropic dycore; ``fast_components`` are the
    dycore's fast tendency and diagnostic components, if any."""
    return IsentropicDynamicalCore(
        domain,
        moist=True,
        time_integration_scheme=nl.time_integration_scheme,
        horizontal_flux_scheme=nl.horizontal_flux_scheme,
        time_integration_properties={"pt": pt, "eps": nl.eps},
        damp=nl.damp,
        damp_type=nl.damp_type,
        damp_depth=nl.damp_depth,
        damp_max=nl.damp_max,
        damp_at_every_stage=nl.damp_at_every_stage,
        backend=nl.backend,
        backend_options=nl.bo,
        storage_options=nl.so,
        **fast_components,
    )


def build_components(nl, domain, pt):
    """Every physics component of the moist chain, under the keys of the
    JAX driver's ``build_components`` (``drivers/driver_isentropic_moist.py:36-105``):
    Coriolis (``"cf"``) when the namelist's ``coriolis_parameter`` is set,
    and, when its ``implicit_vertical_advection`` is, the implicit vertical
    advection (``"ivf"``), which only the SUS chain takes."""
    common = dict(backend=nl.backend, backend_options=nl.bo, storage_options=nl.so)
    c = {
        "dv": IsentropicDiagnostics(domain, "numerical", moist=True, pt=pt, **common),
        "turb": IsentropicSmagorinsky(domain, nl.smagorinsky_constant, **common),
        "vc": IsentropicVelocityComponents(domain, **common),
        "t2d": AirPotentialTemperatureToDiagnostic(domain, "numerical", **common),
        "d2t": AirPotentialTemperatureToTendency(domain, "numerical", **common),
        "ke": KesslerMicrophysics(
            domain, "numerical",
            autoconversion_threshold=nl.autoconversion_threshold,
            autoconversion_rate=nl.autoconversion_rate,
            collection_rate=nl.collection_rate,
            **common,
        ),
        "sa": KesslerSaturationAdjustmentPrognostic(
            domain, "numerical", saturation_rate=nl.saturation_rate, **common,
        ),
        "vf": IsentropicVerticalAdvection(domain, flux_scheme=nl.vertical_flux_scheme, **common),
        "rfv": KesslerFallVelocity(domain, "numerical", **common),
        "sd": KesslerSedimentation(
            domain, "numerical",
            sedimentation_flux_scheme=nl.sedimentation_flux_scheme,
            vt_mode=nl.sedimentation_vt_mode,
            **common,
        ),
        "ap": Precipitation(domain, "numerical", **common),
        "hs": IsentropicHorizontalSmoothing(
            domain,
            nl.smooth_type,
            nl.smooth_coeff,
            nl.smooth_coeff_max,
            nl.smooth_damp_depth,
            moist=nl.smooth_moist,
            smooth_moist_coeff=nl.smooth_moist_coeff,
            smooth_moist_coeff_max=nl.smooth_moist_coeff_max,
            smooth_moist_damp_depth=nl.smooth_moist_damp_depth,
            **common,
        ),
    }
    if nl.implicit_vertical_advection:
        c["ivf"] = IsentropicImplicitVerticalAdvectionDiagnostic(domain, moist=True, **common)
    if nl.coriolis_parameter is not None:
        c["cf"] = IsentropicConservativeCoriolis(domain, "numerical", nl.coriolis_parameter,
                                                 **common)
    return c


def physics_options(nl, c, skip=(), implicit_vertical_advection=False):
    """The chain's processes as ``TimeIntegrationOptions``, in the order of
    ``drivers/driver_namelist_sus.py:139-250`` (the splitting variants of
    ``drivers/driver_isentropic_moist.py:210-243`` share it); ``c`` holds
    the components of :func:`build_components`, ``skip`` names processes to
    leave out.  ``implicit_vertical_advection`` takes the implicit process
    in place of the explicit one, as the JAX SUS driver does when its
    namelist asks; the other couplings' JAX drivers never do."""
    unknown = set(skip) - set(PROCESSES)
    if unknown:
        raise ValueError(f"unknown processes in skip: {sorted(unknown)}")
    ptis = nl.physics_time_integration_scheme
    if implicit_vertical_advection:
        vertical = dict(component=c["ivf"])
    else:
        vertical = dict(component=c["vf"], scheme="rk3ws")
    processes = [
        ("diagnostics", dict(component=c["dv"])),
        ("coriolis", dict(component=c["cf"], scheme=ptis) if "cf" in c else None),
        ("smoothing", dict(component=c["hs"]) if nl.smooth else None),
        ("smagorinsky", dict(component=c["turb"], scheme=ptis)),
        ("velocities", dict(component=c["vc"])),
        ("kessler", dict(component=ConcurrentCoupling(c["ke"], c["t2d"]), scheme=ptis)),
        ("satadj", dict(component=ConcurrentCoupling(c["d2t"], c["sa"], c["t2d"]), scheme=ptis)),
        ("vertical_advection", vertical if nl.vertical_advection else None),
        ("sedimentation", dict(component=ConcurrentCoupling(c["rfv"], c["sd"]), scheme="rk3ws")),
        ("precipitation", dict(component=ConcurrentCoupling(c["rfv"], c["ap"]))),
    ]
    return [TimeIntegrationOptions(**kw, backend=nl.backend, backend_options=nl.bo)
            for name, kw in processes if kw is not None and name not in skip]


def build_model(nl, domain, pt, skip=()):
    """Dycore + physics chain, as ``drivers/driver_namelist_sus.py:87-251``
    builds it, with the namelist's ``process_merges`` and
    ``implicit_vertical_advection``.  ``skip`` names processes to leave
    out."""
    options = physics_options(nl, build_components(nl, domain, pt), skip,
                              implicit_vertical_advection=nl.implicit_vertical_advection)
    return make_dycore(nl, domain, pt), SequentialUpdateSplitting(*options, merges=nl.process_merges)


def fields_step(step_impl, field_names, dt_s: float):
    """One model timestep on a dict of ``FieldArray``s, with the current
    topography height ``hs`` as an input: ``step_impl(state, dt)`` on the
    fields and the topography, keeping ``field_names``."""

    def step(fields: Dict[str, FieldArray], hs: torch.Tensor) -> Dict[str, FieldArray]:
        st = dict(fields)
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = step_impl(st, dt_s)
        return {k: st[k] for k in field_names}

    return step


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def graph_mode(device, fused_loop: Optional[bool] = None) -> bool:
    """Whether the drivers step on ``device`` through a CUDA graph of the
    step.  ``fused_loop`` None (the default) takes the graph on a CUDA
    device and eager steps on the CPU, as the JAX drivers ``jax.jit`` every
    step; True takes the graph and raises ``ValueError`` on a CPU device
    (the graph has no eager fallback); False steps eagerly (the JAX
    ``--no-jit``)."""
    device = torch.device(device)
    if fused_loop is None:
        return device.type == "cuda"
    if fused_loop and device.type != "cuda":
        raise ValueError(f"the fused loop is a CUDA graph and needs a CUDA device, not {device}")
    return bool(fused_loop)


def check_device(device, *, fused_loop: Optional[bool] = None) -> bool:
    """Raise if ``device`` is a CUDA device this machine does not have, or
    if :func:`graph_mode` refuses ``fused_loop`` on it; else return whether
    the run steps through a CUDA graph.  The drivers check before they build
    the model."""
    graph = graph_mode(device, fused_loop)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the namelist's device is cuda but no CUDA device is available "
            "(name the CPU to run there: so=StorageOptions(..., device='cpu'))"
        )
    return graph


def launches_since(before: collections.Counter) -> Dict[str, int]:
    """The kernel launches counted since ``before`` (a copy of
    ``_lib.launch_counts``)."""
    return dict(collections.Counter(_lib.launch_counts) - before)


class Recovery:
    """Checkpoints, resume and the NaN guard of one run, eager or between
    graph replays (the JAX SUS driver's ``--checkpoint-dir``,
    ``--checkpoint-every``, ``--resume`` and ``--nan-guard``,
    ``drivers/driver_namelist_sus.py:497-583``).

    ``directory`` (None: no checkpoint) holds the checkpoints; at every
    ``every``-th step, and after the last if it is not one, the fields are
    saved as that step.  ``resume`` (True: the latest checkpoint, or a step
    number; nothing if the directory holds none) replaces the fields after
    the warm-up step and starts the loop after that step (``start``).
    ``nan_guard`` sums the magnitude of every field at every ``every``-th
    step and raises ``RuntimeError`` on a non-finite sum, before saving.

    With ``model`` (a ``DistributedModel``: the fields are its rank's owned
    blocks) the checkpoints are sharded, the resume lays the checkpoint out
    for the model's grid, and the guard's verdict is the ranks' maximum, so
    every rank stops at the same boundary."""

    def __init__(self, directory: Optional[str] = None, every: int = 25,
                 resume: Union[bool, int] = False, nan_guard: bool = False,
                 model=None) -> None:
        if every < 1:
            raise ValueError(f"checkpoint every {every} steps: give a positive count")
        if resume is not False and directory is None:
            raise ValueError("resume needs a checkpoint directory")
        self.manager = None if directory is None else CheckpointManager(directory)
        self.every = every
        self.resume = resume
        self.nan_guard = nan_guard
        self.model = model
        self.start = 0
        self.save_s: list = []  # each save's seconds on the host clock
        self.restore_s: Optional[float] = None

    def resumed(self, fields: Dict[str, FieldArray], device, verbose: bool = True):
        """``fields`` with the checkpoint's fields in place (those it lacks
        keep their values); sets ``start``."""
        if self.resume is False:
            return fields
        step = self.manager.latest_step if self.resume is True else self.resume
        if step is None:
            return fields
        t0 = time.perf_counter()
        restored = self.manager.restore(step, model=self.model, device=device)
        self.restore_s = time.perf_counter() - t0
        missing = sorted(k for k in fields if k not in restored)
        if missing and verbose:
            print(f"warning: checkpoint lacks {missing}; keeping their values")
        self.start = step
        if verbose:
            print(f"resumed from checkpoint step {step}")
        return {k: restored.get(k, fa) for k, fa in fields.items()}

    def after_step(self, n: int, fields: Dict[str, FieldArray]) -> None:
        """At a boundary (``n`` a multiple of ``every``), the guard, then the
        checkpoint of step ``n``."""
        if n % self.every:
            return
        if self.nan_guard and not self._finite(fields):
            last = self.manager.latest_step if self.manager is not None else None
            raise RuntimeError(f"non-finite state detected at step {n}; last good checkpoint: "
                               f"step {last} (restart with --resume)")
        if self.manager is not None:
            self._save(n, fields)

    def _save(self, n: int, fields: Dict[str, FieldArray]) -> None:
        t0 = time.perf_counter()
        self.manager.save(n, fields, force=True, model=self.model)
        self.save_s.append(time.perf_counter() - t0)

    def _finite(self, fields: Dict[str, FieldArray]) -> bool:
        total = torch.stack([fa.data.abs().sum(dtype=torch.float64) for fa in fields.values()]).sum()
        bad = not bool(torch.isfinite(total))
        if self.model is None or self.model.grid.size == 1:
            return not bad
        import torch.distributed as dist

        ex = self.model.ex
        flag = torch.tensor([float(bad)], device="cpu" if ex.backend == "gloo" else total.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=ex.group)
        return not bool(flag.item())

    def finish(self, n: int, fields: Dict[str, FieldArray]) -> None:
        """The last step's checkpoint, if it was not at a boundary."""
        if self.manager is not None and n % self.every:
            self._save(n, fields)

    def stops(self, last: int) -> list:
        """The steps after ``start`` up to ``last`` at which a graph's
        replays stop for :meth:`after_step`: every boundary, then ``last``
        (none if the run resumed at or after ``last``)."""
        first = (self.start // self.every + 1) * self.every
        return [n for n in sorted(set(range(first, last + 1, self.every)) | {last}) if n > self.start]


def warm_up(step, fields, hs0, hs_steady, facts: Sequence[float], device, *,
            fused_loop: Optional[bool] = None, verbose: bool = True):
    """One eager warm-up step at the topography ``hs0`` and, if
    :func:`graph_mode` takes the graph, one CUDA graph of ``step`` captured
    after it (the warm-up traced for the fields the step reads,
    ``utils/jitx.py``; the graph's ``i``-th replay steps at ``facts[i] *
    hs_steady``).  Returns the fields after the warm-up, the graph (None
    for eager steps), the kernel launches of one step (the warm-up's, or the
    captured step's) and the seconds of the capture (None without one)."""
    graph = graph_mode(device, fused_loop)
    before = collections.Counter(_lib.launch_counts)
    t0 = time.perf_counter()
    if graph:
        fields, carried = traced_step(step, fields, hs0)
    else:
        fields = step(fields, hs0)
    synchronize(device)
    per_step = launches_since(before)
    if verbose:
        print(f"warmup step: {time.perf_counter() - t0:.3f} s", flush=True)
    if not graph:
        return fields, None, per_step, None
    body = StepBody(step, fields, carried, hs_steady, facts)
    before = collections.Counter(_lib.launch_counts)
    t0 = time.perf_counter()
    captured = StepGraph(body)
    synchronize(device)
    capture_s = time.perf_counter() - t0
    if verbose:
        print(f"CUDA graph of the step carries {len(carried)}/{len(fields)} fields")
        print(f"capture: {capture_s:.3f} s", flush=True)
    return fields, captured, launches_since(before), capture_s


def step_sequence(step, fields, hs0, hs_steady, facts: Sequence[float], device, *,
                  verbose: bool = True, fused_loop: Optional[bool] = None,
                  recovery: Optional[Recovery] = None, profile: Optional[str] = None):
    """The drivers' loop: :func:`warm_up`, then ``len(facts)`` timed steps
    at ``facts[i] * hs_steady``, as replays of the warm-up's CUDA graph or
    eager (:func:`graph_mode` of ``device`` and ``fused_loop``).  Both take
    a :class:`Recovery`: a resumed run loads the checkpoint's fields (into
    the graph's buffers, its counter at ``recovery.start``) and times only
    the steps after ``recovery.start``; the graph replays up to each
    checkpoint boundary, where the guard and the save see its outputs.
    With ``profile`` a profiler trace of the timed steps goes into that
    directory.  Returns the final fields, the seconds of the timed steps
    (ending in a synchronize; the saves included), the kernel launches of
    one step (the warm-up's, or the captured step's) and the seconds of the
    capture (None without one)."""
    fields, graph, per_step, capture_s = warm_up(step, fields, hs0, hs_steady, facts, device,
                                                 fused_loop=check_device(device, fused_loop=fused_loop),
                                                 verbose=verbose)
    start = 0
    if recovery is not None:
        fields = recovery.resumed(fields, device, verbose)
        start = recovery.start
        if graph is not None:
            graph.body.load(fields, start)
    with profile_trace(profile) if profile else contextlib.nullcontext():
        t0 = time.perf_counter()
        if graph is None:
            for i in range(start, len(facts)):
                fields = step(fields, facts[i] * hs_steady)
                if recovery is not None:
                    recovery.after_step(i + 1, fields)
        else:
            done = start
            stops = [len(facts)] if recovery is None else recovery.stops(len(facts))
            for stop in stops:
                graph.replay(stop - done)
                done = stop
                if recovery is not None:
                    recovery.after_step(done, graph.body.outputs())
        synchronize(device)
        elapsed = time.perf_counter() - t0
    if graph is not None and len(facts) > start:
        fields = graph.fields()
    if recovery is not None:
        recovery.finish(len(facts), fields)
    return fields, elapsed, per_step, capture_s


def run(nl, skip=(), *, verbose: bool = True, fused_loop: Optional[bool] = None,
        **recovery) -> Dict[str, Any]:
    """Build the model, run the warm-up step and ``nl.niter`` timed steps on
    the namelist's device (on a CUDA device as replays of a CUDA graph of
    the step, unless ``fused_loop`` is False: :func:`graph_mode`;
    ``recovery`` holds :func:`run_steps`' checkpoint, resume, NaN guard and
    profile keywords).  Returns the validation numbers, the timing, the
    final fields and the kernel launches of one step."""
    check_device(nl.so.device, fused_loop=fused_loop)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip)
    return run_steps(nl, state, lambda st, dt: physics(dycore(st, {}, dt), dt),
                     dycore.topography_steady, verbose=verbose, fused_loop=fused_loop, **recovery)


def run_steps(nl, state, step_impl, hs_steady, *, verbose: bool = True,
              fused_loop: Optional[bool] = None, checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 25, resume: Union[bool, int] = False,
              nan_guard: bool = False, profile: Optional[str] = None) -> Dict[str, Any]:
    """The JAX drivers' step sequence from ``state``: one warm-up step at
    zero mountain height, then ``nl.niter`` timed steps with the mountain at
    ``min((i+1)·dt/1800 s, 1)`` of ``hs_steady``; ``step_impl(state, dt)``
    is one timestep.  On a CUDA device the timed steps are replays of one
    CUDA graph of the step, eager on the CPU or with ``fused_loop`` False
    (:func:`graph_mode`, :func:`step_sequence`).  Both take the checkpoints,
    the resume and the NaN guard (:class:`Recovery`: ``checkpoint_dir``,
    ``checkpoint_every``, ``resume``, ``nan_guard``) and ``profile``, a
    directory for a profiler trace of the timed steps.  Returns :func:`run`'s result;
    ``launches_per_step`` holds the kernel launches of the warm-up step, or
    of the captured step, ``capture_s`` the seconds of the capture (None
    without a graph) and ``start`` the step a resumed run started after;
    the throughput counts the steps after it."""
    nx, ny, nz = state["air_isentropic_density"].shape
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    field_names = sorted(k for k in state if k != "time")
    step = fields_step(step_impl, field_names, dt_s)
    fields = {k: state[k] for k in field_names}
    facts = [min((i + 1) * dt_s / topo_time, 1.0) for i in range(nl.niter)]
    recovery = None
    if checkpoint_dir is not None or resume is not False or nan_guard:
        recovery = Recovery(checkpoint_dir, checkpoint_every, resume, nan_guard)
    fields, elapsed, per_step, capture_s = step_sequence(
        step, fields, hs_steady * 0.0, hs_steady, facts, nl.so.device, verbose=verbose,
        fused_loop=fused_loop, recovery=recovery, profile=profile)
    start = 0 if recovery is None else recovery.start
    steps = max(nl.niter - start, 1)

    u = fields["x_velocity_at_u_locations"].data
    v = fields["y_velocity_at_v_locations"].data
    umax = float(u[:, :-1].max())
    vmax = float(v[:-1, :].max())
    gps = nx * ny * nz * steps / elapsed
    if verbose:
        print(f"Validation: umax = {umax:.5f}, vmax = {vmax:.5f}")
        print(f"Compute time: {elapsed:.3f} s.")
        print(f"Throughput: {gps:.3e} gridpoints/s")
    return {
        "umax": umax, "vmax": vmax, "elapsed": elapsed, "gps": gps,
        "ms_per_step": 1e3 * elapsed / steps, "fields": fields,
        "launches_per_step": per_step, "capture_s": capture_s, "start": start,
    }


def steady_topography(domain, nl) -> torch.Tensor:
    """The mountain's steady height on the global numerical grid, as the
    dycore keeps it (``topography_steady``)."""
    steady = np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data)
    return torch.as_tensor(steady, dtype=nl.so.dtype, device=nl.so.device)


# more than one rank steps eagerly: the refusal of an explicit graph
DECOMPOSED_GRAPH = ("--fused-loop is not available decomposed: a halo exchange cannot be captured in "
                    "a CUDA graph (run --spmd on one rank for the graph)")


def spmd_rank_run(ctx, *, overrides: Dict[str, Any], skip=(), fused_loop: Optional[bool] = None,
                  hybrid: bool = False, node_grid: Optional[Tuple[int, int]] = None,
                  halo: Optional[int] = None, verbose: bool = False,
                  checkpoint_dir: Optional[str] = None, checkpoint_every: int = 25,
                  resume: Union[bool, int] = False, nan_guard: bool = False) -> Dict[str, Any]:
    """One rank's part of a ``--spmd`` run (a job of ``parallel.launch``):
    the namelist with ``overrides`` on the rank's device, the whole step
    through ``DistributedModel`` on the rank's grid (with ``hybrid``,
    ``make_hybrid_rank_grid`` of the grid's shape and ``node_grid`` from the
    rank's environment), ring ``halo`` (default nb + 1), then :func:`run`'s
    step sequence with the recovery keywords: on one rank in the mode
    ``fused_loop`` resolves to (the graph on the card by default), on more
    eager, since a halo exchange cannot be captured.

    Every rank returns its kernel launches (counted from zero before the
    warm-up step), its grid coordinates, its exchanges' counts and, if the
    guard stopped the run, nothing: the guard's ``RuntimeError`` propagates.
    Rank 0 also returns the gathered global fields (numpy) and :func:`run`'s
    numbers."""
    from tasmania_tpu_torch.parallel.multihost import make_hybrid_rank_grid
    from tasmania_tpu_torch.parallel.runner import DistributedModel

    grid = make_hybrid_rank_grid(ctx.grid.shape, node_grid) if hybrid else ctx.grid
    so = replace(overrides.get("so", load_namelist().so), device=ctx.device)
    nl = load_namelist(**{**overrides, "so": so})
    domain, state, pt = build_domain_and_state(nl)
    dt_s = nl.timestep.total_seconds()
    dm = DistributedModel(domain, state, grid, ctx.rank, lambda dom: build_model(nl, dom, pt, skip),
                          dt_s, backend=ctx.backend, halo=nl.nb + 1 if halo is None else halo)
    fields = {n: FieldArray(b, dm.units[n], dm.dims[n]) for n, b in dm.scatter_state(state).items()}
    hs_steady = dm.put_topography(steady_topography(domain, nl))
    loud = verbose and ctx.rank == 0
    if grid.size > 1:
        if fused_loop:
            raise ValueError(DECOMPOSED_GRAPH)
        fused_loop = False
    if loud:
        mode = "CUDA graph replays" if graph_mode(ctx.device, fused_loop) else "eager steps"
        if grid.size > 1:
            mode += " (a halo exchange cannot be captured in a CUDA graph)"
        print(f"SPMD grid {grid.px}x{grid.py} of {ctx.backend} ranks (pads {dm.pads}), "
              f"{nl.nx}x{nl.ny}x{nl.nz}, device {ctx.device}, {mode}", flush=True)
    recovery = None
    if checkpoint_dir is not None or resume is not False or nan_guard:
        recovery = Recovery(checkpoint_dir, checkpoint_every, resume, nan_guard, model=dm)
    topo_time = nl.topo_kwargs["time"].total_seconds()
    facts = [min((i + 1) * dt_s / topo_time, 1.0) for i in range(nl.niter)]
    _lib.reset_launch_counts()
    fields, elapsed, per_step, capture_s = step_sequence(
        dm.step_state, fields, hs_steady * 0.0, hs_steady, facts, ctx.device, verbose=loud,
        fused_loop=fused_loop, recovery=recovery)
    out = {"launches_per_step": per_step, "launches": dict(_lib.launch_counts),
           "degenerate": dm.degenerate, "pads": dm.pads, "coords": grid.coords(ctx.rank),
           "grid_order": [grid.rank_of(i, j) for i in range(grid.px) for j in range(grid.py)],
           "exchange": dm.ex.counter.snapshot(),
           "checkpoint_save_s": [] if recovery is None else recovery.save_s,
           "restore_s": None if recovery is None else recovery.restore_s}
    full = dm.gather_state({n: fa.data for n, fa in fields.items()})
    if full is None:
        return out
    start = 0 if recovery is None else recovery.start
    steps = max(nl.niter - start, 1)
    full = {k: fa.data.numpy() for k, fa in full.items()}
    u, v = full["x_velocity_at_u_locations"], full["y_velocity_at_v_locations"]
    out.update(fields=full, umax=float(u[:, :-1].max()), vmax=float(v[:-1, :].max()),
               elapsed=elapsed, ms_per_step=1e3 * elapsed / steps, start=start,
               gps=nl.nx * nl.ny * nl.nz * steps / elapsed, capture_s=capture_s,
               grid=(nl.nx, nl.ny, nl.nz))
    if loud:
        print(f"Validation: umax = {out['umax']:.5f}, vmax = {out['vmax']:.5f}")
        print(f"Compute time: {elapsed:.3f} s.")
        print(f"Throughput: {out['gps']:.3e} gridpoints/s")
    return out


def run_spmd(overrides: Dict[str, Any], *, ranks: int = 1, comm: Optional[str] = None,
             device: str = "cuda", mesh: Optional[Tuple[int, int]] = None,
             local_world: Optional[int] = None, node_grid: Optional[Tuple[int, int]] = None,
             fused_loop: Optional[bool] = None, workdir=None, timeout_s: float = 600.0,
             verbose: bool = True, **job) -> Dict[str, Any]:
    """``--spmd``: the namelist with ``overrides`` (nx and ny trimmed to
    multiples of the grid's extents) on ``ranks`` local ranks of
    ``make_rank_grid(ranks, mesh)`` (``comm``: default ``nccl`` on a CUDA
    device, ``gloo`` on the CPU).  With ``local_world``, each rank is told
    that ``local_world`` ranks run a node and lays the grid out with
    ``make_hybrid_rank_grid(mesh, node_grid)``.  ``job`` holds
    :func:`spmd_rank_run`'s other keywords (``skip``, ``halo``, the recovery
    keywords).  Returns rank 0's result with every rank's launches,
    coordinates, exchanges and imported modules."""
    from tasmania_tpu_torch.drivers.driver_sharded import trimmed_extents
    from tasmania_tpu_torch.parallel.launch import RunSpec, check_backend, run_ranks
    from tasmania_tpu_torch.parallel.mesh import make_rank_grid

    comm = comm or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    check_backend(comm, device, ranks)
    if fused_loop and ranks > 1:
        raise ValueError(DECOMPOSED_GRAPH)
    grid = make_rank_grid(ranks, mesh)
    nl = load_namelist(**{k: v for k, v in overrides.items() if k != "so"})
    nx, ny = trimmed_extents(nl.nx, nl.ny, grid)
    overrides = {**overrides, "nx": nx, "ny": ny}
    spec = RunSpec(target="tasmania_tpu_torch.drivers.driver_namelist_sus:spmd_rank_run",
                   world=ranks, backend=comm, device=device, mesh=grid.shape, timeout_s=timeout_s,
                   local_world=local_world,
                   kwargs=dict(overrides=overrides, fused_loop=fused_loop, verbose=verbose,
                               hybrid=local_world is not None, node_grid=node_grid, **job))
    with tempfile.TemporaryDirectory(prefix="tasmania_spmd_") as tmp:
        results = run_ranks(spec, workdir or tmp)
    out = dict(results[0]["result"])
    out.update(mesh=grid.shape,
               launches_per_step_by_rank=[r["result"]["launches_per_step"] for r in results],
               launches_by_rank=[r["result"]["launches"] for r in results],
               coords_by_rank=[tuple(r["result"]["coords"]) for r in results],
               exchange_by_rank=[r["result"]["exchange"] for r in results],
               imported_by_rank=[r["imported"] for r in results])
    return out


VALIDATION_FIELDS = {
    "s": "air_isentropic_density",
    "su": "x_momentum_isentropic",
    "sv": "y_momentum_isentropic",
    "qv": "mass_fraction_of_water_vapor_in_air",
    "qc": "mass_fraction_of_cloud_liquid_water_in_air",
    "qr": "mass_fraction_of_precipitation_water_in_air",
    "prec": "precipitation",
    "accprec": "accumulated_precipitation",
}


def validation_summary(fields: Dict[str, np.ndarray]) -> Dict[str, float]:
    """umax and vmax as the drivers print them, and the max and the float64
    mean of the magnitude of s, su, sv, the mass fractions and the
    precipitation fields (the magnitude: sv's plain mean is a near-zero
    difference of large terms); ``fields`` maps names to numpy arrays.
    ``slice_reference.json`` and ``flagship_reference.json`` hold these
    numbers from the JAX package."""
    u = fields["x_velocity_at_u_locations"]
    v = fields["y_velocity_at_v_locations"]
    out = {"umax": float(u[:, :-1].max()), "vmax": float(v[:-1, :].max())}
    for short, name in VALIDATION_FIELDS.items():
        if name not in fields:
            continue
        out[f"{short}_max"] = float(fields[name].max())
        out[f"{short}_mean_abs"] = float(np.mean(np.abs(fields[name]), dtype=np.float64))
    return out


def size_parser(description: str) -> argparse.ArgumentParser:
    """The drivers' command line: grid size, step count, device, the
    process merges, Coriolis, the implicit vertical advection and the fused
    loop."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--backend", type=str, default=None,
                        help="the backend of the registered stencils (torch, numpy; the JAX "
                             "names jax, pallas, pallas:interpret run as torch)")
    parser.add_argument("--merge", action="append", default=[], metavar="NAME",
                        help="run a SUS process pair as one kernel: smooth_smag, vadv_sed "
                             "(repeatable)")
    parser.add_argument("--coriolis", type=float, default=None, metavar="F",
                        help="the Coriolis parameter f in rad s^-1 (the f-plane process)")
    parser.add_argument("--implicit-vadv", action="store_true",
                        help="implicit (Crank-Nicolson) vertical advection; the SUS chain "
                             "only, as in the JAX drivers")
    parser.add_argument("--fused-loop", action="store_true",
                        help="run the timed steps as replays of one CUDA graph of the step, as "
                             "on a CUDA device by default (removes per-step dispatch; raises "
                             "without a CUDA device)")
    return parser


def namelist_from(parser, cli, load_namelist):
    """The namelist with the command line's overrides; the parser exits if
    it names a CUDA device this machine does not have."""
    return load_namelist(**namelist_overrides(parser, cli, load_namelist))


def namelist_overrides(parser, cli, load_namelist) -> Dict[str, Any]:
    """The command line's overrides of the namelist (its storage options on
    the command line's device); the parser exits if it names a CUDA device
    this machine does not have."""
    device = torch.device(cli.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    overrides = {}
    if cli.nx:
        overrides["nx"] = cli.nx
        overrides["ny"] = cli.ny or cli.nx
    elif cli.ny:
        overrides["ny"] = cli.ny
    if cli.nz:
        overrides["nz"] = cli.nz
    if cli.niter:
        overrides["niter"] = cli.niter
    if cli.merge:
        overrides["process_merges"] = tuple(cli.merge)
    if cli.coriolis is not None:
        overrides["coriolis_parameter"] = cli.coriolis
    if cli.implicit_vadv:
        overrides["implicit_vertical_advection"] = True
    if cli.backend:
        overrides["backend"] = cli.backend
    overrides["so"] = replace(load_namelist().so, device=device)
    return overrides


def cli_mode(cli) -> Optional[bool]:
    """The ``fused_loop`` of a command line: True with ``--fused-loop``,
    False with ``--no-jit`` (where the parser has it), else None, the
    device's default (:func:`graph_mode`)."""
    if getattr(cli, "no_jit", False):
        return False
    return True if cli.fused_loop else None


def main(argv=None):
    parser = size_parser(__doc__.split("\n\n")[0])
    parser.add_argument("--no-jit", action="store_true",
                        help="step eagerly, one PyTorch dispatch at a time, also on a CUDA device")
    parser.add_argument("--profile", type=str, default=None, metavar="LOGDIR",
                        help="write a torch.profiler trace of the timed loop into LOGDIR")
    parser.add_argument("--checkpoint-dir", type=str, default=None,
                        help="write checkpoints of the fields into this directory")
    parser.add_argument("--checkpoint-every", type=int, default=25,
                        help="steps between checkpoints (with --checkpoint-dir) and NaN-guard probes")
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest checkpoint in --checkpoint-dir")
    parser.add_argument("--nan-guard", action="store_true",
                        help="probe the state for non-finite values at every checkpoint boundary; "
                             "abort (without checkpointing the poisoned state) so a supervisor can "
                             "restart from the last good checkpoint with --resume")
    parser.add_argument("--spmd", action="store_true",
                        help="run the whole step decomposed over a grid of ranks (DistributedModel)")
    parser.add_argument("--ranks", type=int, default=1, help="with --spmd: N local ranks")
    parser.add_argument("--comm", choices=("nccl", "gloo"), default=None,
                        help="with --spmd: the ranks' backend (default nccl on the card, gloo on "
                             "the CPU)")
    parser.add_argument("--multihost", action="store_true",
                        help="with --spmd: run as one rank of a torchrun group on the hybrid grid")
    parser.add_argument("--node-grid", type=str, default=None, metavar="PRX,PRY",
                        help="with --multihost: tile the nodes' blocks in a PRXxPRY grid")
    cli = parser.parse_args(argv)
    if cli.no_jit and cli.fused_loop:
        parser.error("--no-jit steps eagerly and --fused-loop through a CUDA graph: give one")
    if cli.fused_loop and (cli.checkpoint_dir or cli.resume or cli.nan_guard):
        parser.error("--fused-loop runs the timed steps as replays of one CUDA graph; the "
                     "checkpoint/resume/nan-guard machinery never sees intermediate states there.  "
                     "Drop --fused-loop (the default steps through the graph between "
                     "checkpoints) or the checkpointing flags.")
    if cli.resume and not cli.checkpoint_dir:
        parser.error("--resume needs --checkpoint-dir")
    if not cli.spmd and (cli.ranks != 1 or cli.comm or cli.multihost or cli.node_grid):
        parser.error("--ranks, --comm, --multihost and --node-grid go with --spmd")
    if cli.spmd and cli.profile:
        parser.error("--profile traces the single-device run; drop --spmd or --profile")
    recovery = dict(checkpoint_dir=cli.checkpoint_dir, checkpoint_every=cli.checkpoint_every,
                    resume=cli.resume, nan_guard=cli.nan_guard)
    mode = cli_mode(cli)
    if cli.spmd:
        overrides = namelist_overrides(parser, cli, load_namelist)
        node_grid = tuple(int(k) for k in cli.node_grid.split(",")) if cli.node_grid else None
        if cli.multihost:
            res = _spmd_multihost(cli, overrides, node_grid, recovery)
        else:
            res = run_spmd(overrides, ranks=cli.ranks, comm=cli.comm, device=cli.device,
                           fused_loop=mode, **recovery)
    else:
        res = run(namelist_from(parser, cli, load_namelist), fused_loop=mode, profile=cli.profile,
                  **recovery)
    print("Simulation successfully completed.")
    return res


def _spmd_multihost(cli, overrides, node_grid, recovery) -> Dict[str, Any]:
    """This process as one rank of a ``torchrun`` group, on the hybrid grid."""
    from tasmania_tpu_torch.drivers.driver_sharded import trimmed_extents
    from tasmania_tpu_torch.parallel.launch import RankContext, check_backend, rank_device
    from tasmania_tpu_torch.parallel.mesh import make_rank_grid
    from tasmania_tpu_torch.parallel.multihost import initialize_distributed

    comm = cli.comm or ("nccl" if torch.device(cli.device).type == "cuda" else "gloo")
    rank, world, local = initialize_distributed(comm)
    check_backend(comm, cli.device, 1)
    if cli.fused_loop and world > 1:
        raise ValueError(DECOMPOSED_GRAPH)
    grid = make_rank_grid(world)
    nl = load_namelist(**{k: v for k, v in overrides.items() if k != "so"})
    nx, ny = trimmed_extents(nl.nx, nl.ny, grid)
    ctx = RankContext(rank, grid, comm, rank_device(comm, cli.device, local))
    return spmd_rank_run(ctx, overrides={**overrides, "nx": nx, "ny": ny}, fused_loop=cli_mode(cli),
                         hybrid=True, node_grid=node_grid, verbose=True, **recovery)


if __name__ == "__main__":
    main()
