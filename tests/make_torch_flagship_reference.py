"""Record the JAX package's result of the full flagship step, and of the
other couplings, at full size.

Runs the JAX driver's ``build_domain_and_state``/``build_model`` with
``drivers/namelist_sus.py`` unchanged (161x161x120, float32, the whole SUS
chain, ``sedimentation_vt_mode="step"``) on the CPU with the
``"pallas:interpret"`` backend, so that the chain takes the same fused
kernels as the flagship run: one warm-up step at zero mountain height, then
100 steps with the growing mountain, as both drivers do.  Writes
``tasmania_tpu_torch/drivers/flagship_reference.json`` with the validation
summary of ``driver_namelist_sus.validation_summary`` (umax, vmax, and the max
and mean magnitude of s, su, sv, qv, qc, qr, precipitation and accumulated
precipitation); ``chip_smoke.py`` holds the port's run on the GPU against it.

In that run no rain forms (cloud water stays below the autoconversion
threshold), so ``--rain`` makes a second reference,
``flagship_rain_reference.json``: the same namelist from a supersaturated
start (relative humidity 1.05), 1 warm-up + 30 steps, in which saturation
adjustment makes cloud water above the threshold in the lower levels and
every branch of the Kessler scheme, sedimentation and precipitation run on
rain.  (At relative humidity 1.2 the full-size run is unstable within 30
steps: its largest water vapour mass fraction reaches 84.)

``--merges`` makes ``flagship_merged_reference.json``: the raining run
(relative humidity 1.05, 1 warm-up + 30 steps) with the SUS chain's two
optional process-pair merges on, [smoothing -> Smagorinsky RK2] and
[vertical advection -> sedimentation], each one Pallas kernel
(``fused_smoothing_smagorinsky_rk2``, ``fused_vadv_sedimentation_rk3ws``):
the JAX package turns them on with ``TASMANIA_FUSE_SMOOTH_SMAG=1`` and
``TASMANIA_FUSE_VADV_SED=1``, which this script sets in its own process; the
port's counterpart is the namelist's ``process_merges``.

``--coupling fc|lfc|ps|sts|ssus`` makes the reference of one of the five
other physics-dynamics couplings, ``variant_<coupling>_reference.json``: the
JAX driver's ``build_variant`` (``drivers/driver_isentropic_moist.py``) with
``drivers/namelist_<coupling>.py`` (161x161x120) from the raining run's
supersaturated start (relative humidity 1.05), 1 warm-up + 20 steps.

``--flux third_order_upwind`` and ``--boundary periodic`` run the SUS
chain, or with ``--coupling C`` that coupling, with the namelist's
``horizontal_flux_scheme`` or ``hb_type`` (``hb_kwargs={}``) overridden,
from the couplings' supersaturated start, 1 warm-up + 20 steps:
``flagship_third_reference.json`` (the whole-stage kernel at third order),
``variant_fc_third_reference.json`` (``--coupling fc --flux
third_order_upwind``: the two-kernel stage at third order) and
``flagship_periodic_reference.json`` (the generic stage on the periodic
boundary).

Usage: ``python tests/make_torch_flagship_reference.py [--rain | --merges |
--coupling C | --sharded] [--flux SCHEME] [--boundary TYPE] [--coriolis F]
[--implicit-vadv] [--yz] [--topography NAME]`` (about five minutes, a
minute and a half with ``--rain``, ``--merges``, ``--coupling``,
``--flux``, ``--boundary``, ``--coriolis``, ``--implicit-vadv`` or
``--topography``, seconds with ``--yz``).  With ``--check-port`` it writes no reference:
it runs the port on the CPU in float32 at the same configuration and prints
each number's relative deviation from the file, the measurement behind the
limits ``chip_smoke.py`` holds the card to.  With ``--float64`` it runs the
port on the CPU in float64 instead, prints the same deviations, and writes
the run's numbers as ``<name>_float64.json`` beside the reference (about a
minute): ``chip_smoke.py`` phase 13 holds the same run in float64 on the
card to ``flagship_periodic_float64.json`` (``--boundary periodic
--float64``), the witness that the card's float32 differences on that path
are rounding and not a fault.

``--coriolis F`` sets the namelist's ``coriolis_parameter`` (rad s^-1) and
``--implicit-vadv`` its ``implicit_vertical_advection`` (SUS only: the
other couplings' JAX drivers advect explicitly whatever it says), each on
the couplings' supersaturated start, 1 warm-up + 20 steps:
``flagship_coriolis_implicit_reference.json`` (``--coriolis 1e-4
--implicit-vadv``: the f-plane and the Crank–Nicolson column solve in the
SUS chain) and ``variant_fc_coriolis_reference.json`` (``--coupling fc
--coriolis 1e-4``).  The JAX registry resolves the Thomas solve for
``"pallas"`` but not for its CPU emulation, ``"pallas:interpret"``, so this
script registers the same function (``thomas_jax``) there in its own
process.

``--yz`` runs the SUS chain on a y-z slice of the flagship: ``nx = 1``
(numerically 7 columns wide: the relaxed boundary with ``nx == 1``), the
flagship's 22.5 m/s wind along y (``x_velocity = 0``, ``y_velocity =
22.5``), from the flagship's own start (relative humidity 0.95: from the
couplings' supersaturated start both packages blow up within five steps),
1 warm-up + 20 steps: ``flagship_yz_reference.json``.  ``--topography schaer`` runs it over the
Schaer mountain (``topo_type = "schaer"`` with the namelist's own
``topo_kwargs``) at 161x161x120: ``flagship_schaer_reference.json``.

``--sharded`` makes ``sharded_reference.json``, the reference of the
domain-decomposed run (BASELINE config 5, ``drivers/driver_sharded.py``):
the JAX ``DistributedModel`` on a 2x2 mesh of four virtual CPU devices,
``pallas:interpret`` (so the shard-aware whole-stage kernel in its ``dist``
mode and ``sedimentation_vt_mode="step"``, as the port runs), halo pad
nb + 1, float32, the flagship namelist at 256x256x64 with the whole SUS
chain; one warm-up step at zero mountain height whose result the JAX driver
discards, then 50 steps from the initial state.  With ``--check-port`` it
runs the port's single-device step on the CPU in float32 through the same
sequence and prints the deviations (``chip_smoke.py`` phase 14's limits).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

DRIVERS = ROOT / "tasmania_tpu_torch" / "drivers"
BACKEND = "pallas:interpret"
# the raining run: namelist overrides and output file
RAIN = {"relative_humidity": 1.05, "niter": 30}
# the merged run: the raining run with both merges (the port's namelist entry)
MERGES = ("smooth_smag", "vadv_sed")
JAX_MERGE_SWITCHES = ("TASMANIA_FUSE_SMOOTH_SMAG", "TASMANIA_FUSE_VADV_SED")


# the couplings' runs: namelist overrides (``variant_<coupling>_reference.json``)
VARIANT = {"niter": 20, "relative_humidity": 1.05}
COUPLINGS = ("fc", "lfc", "ps", "sts", "ssus")
# --flux and --boundary: the values each takes
FLUXES = ("third_order_upwind",)
BOUNDARIES = ("periodic",)
TOPOGRAPHIES = ("schaer",)
# --yz: the y-z slice with the flagship's wind along y (m s^-1), from the
# flagship's own start: from relative humidity 1.05 the slice blows up in
# both packages within five steps (the smoothing leaves the x-frame
# unsmoothed beside the smoothed column nb, and Smagorinsky differentiates
# that across the slice's dx of 1 m)
YZ = {"nx": 1, "x_velocity": 0.0, "y_velocity": 22.5, "relative_humidity": 0.95}
VELOCITIES = ("x_velocity", "y_velocity")


def namelist_values(overrides, field_array):
    """``overrides`` with the velocities (floats in m s^-1) as scalar fields
    of ``field_array``, the namelist's type of field (each package its own)."""
    return {k: field_array(np.asarray(v), "m s^-1", ()) if k in VELOCITIES else v
            for k, v in overrides.items()}


def surface_overrides(argv):
    """The namelist overrides of ``--flux``, ``--boundary``, ``--coriolis``,
    ``--implicit-vadv``, ``--yz`` and ``--topography``, and the file name's
    suffix ("" without any)."""
    overrides, suffix = {}, ""
    if "--flux" in argv:
        flux = argv[argv.index("--flux") + 1]
        if flux not in FLUXES:
            raise SystemExit(f"--flux: one of {FLUXES}")
        overrides["horizontal_flux_scheme"] = flux
        suffix += "_third"
    if "--boundary" in argv:
        boundary = argv[argv.index("--boundary") + 1]
        if boundary not in BOUNDARIES:
            raise SystemExit(f"--boundary: one of {BOUNDARIES}")
        overrides.update(hb_type=boundary, hb_kwargs={})
        suffix += "_periodic"
    if "--coriolis" in argv:
        overrides["coriolis_parameter"] = float(argv[argv.index("--coriolis") + 1])
        suffix += "_coriolis"
    if "--implicit-vadv" in argv:
        overrides["implicit_vertical_advection"] = True
        suffix += "_implicit"
    if "--yz" in argv:
        overrides.update(YZ)
        suffix += "_yz"
    if "--topography" in argv:
        topography = argv[argv.index("--topography") + 1]
        if topography not in TOPOGRAPHIES:
            raise SystemExit(f"--topography: one of {TOPOGRAPHIES}")
        overrides["topo_type"] = topography
        suffix += f"_{topography}"
    return overrides, suffix


def register_interpret_thomas() -> None:
    """The Thomas solve of the implicit vertical advection under
    ``"pallas:interpret"``: the JAX registry has it for ``"pallas"`` (its
    ``lax.scan`` version) but not for the CPU emulation; register the same
    function there, in this process."""
    from tasmania_tpu.framework.stencil import STENCIL_REGISTRY
    from tasmania_tpu.framework.stencil_definitions import thomas_jax

    STENCIL_REGISTRY.register(thomas_jax, "thomas", BACKEND)


def check_port(out, overrides, coupling=None, merges=(), float64=False) -> None:
    """The port's run on the CPU against the reference file ``out``; in
    float64 also written as ``<name>_float64.json``."""
    import torch

    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.framework.field import FieldArray
    from tasmania_tpu_torch.framework.options import StorageOptions

    overrides = namelist_values(overrides, FieldArray)
    dtype = torch.float64 if float64 else torch.float32
    so = StorageOptions(dtype=dtype, device="cpu")
    if coupling is None:
        from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

        nl = load_namelist(so=so, process_merges=merges, **overrides)
        res = drv.run(nl, verbose=False)
    else:
        nl = moist.load_namelist(coupling, so=so, **overrides)
        res = moist.run(nl, coupling, verbose=False)
    got = drv.validation_summary({k: fa.data.numpy() for k, fa in res["fields"].items()})
    ref = json.loads(out.read_text())
    for key, r in ref.items():
        if isinstance(r, (int, float)):
            dev = abs(got[key] - r) / abs(r) if r else abs(got[key])
            print(f"{key:18s} port {got[key]:.9g}  reference {r:.9g}  deviation {dev:.3e}")
    if float64:
        got["config"] = {**ref["config"], "dtype": "float64", "backend": "the port (CPU)"}
        got["command"] = " ".join(["python tests/make_torch_flagship_reference.py", *sys.argv[1:]])
        witness = out.with_name(out.name.replace("_reference.json", "_float64.json"))
        witness.write_text(json.dumps(got, indent=1) + "\n")
        print(f"wrote {witness}")


# the decomposed run (BASELINE config 5): namelist overrides and the mesh
SHARDED = {"nx": 256, "ny": 256, "nz": 64, "niter": 50}
SHARDED_MESH = (2, 2)


def sharded_reference(check_port_only: bool) -> None:
    """``--sharded``: the JAX ``DistributedModel``'s run, or with
    ``check_port_only`` the port's single-device CPU run against it."""
    out = DRIVERS / "sharded_reference.json"
    if check_port_only:
        import torch

        from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
        from tasmania_tpu_torch.drivers import driver_sharded as shd
        from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
        from tasmania_tpu_torch.framework.options import StorageOptions

        nl = load_namelist(so=StorageOptions(dtype=torch.float32, device="cpu"), **SHARDED)
        got = drv.validation_summary(shd.single_device_run(nl)["fields"])
        ref = json.loads(out.read_text())
        for key, r in ref.items():
            if isinstance(r, (int, float)):
                dev = abs(got[key] - r) / abs(r) if r else abs(got[key])
                print(f"{key:18s} port {got[key]:.9g}  reference {r:.9g}  deviation {dev:.3e}")
        return
    px, py = SHARDED_MESH
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + f" --xla_force_host_platform_device_count={px * py}"
    ).strip()
    import importlib

    import jax
    import jax.numpy as jnp

    from tasmania_tpu.parallel import make_mesh
    from tasmania_tpu.parallel.runner import DistributedModel
    from tasmania_tpu_torch.drivers.driver_namelist_sus import validation_summary

    jnl = importlib.import_module("drivers.namelist_sus")
    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    nl.backend = BACKEND
    for key, value in SHARDED.items():
        setattr(nl, key, value)
    from drivers.driver_namelist_sus import build_domain_and_state, build_model

    domain, state, pt = build_domain_and_state(nl)
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    mesh = make_mesh(jax.devices()[: px * py], shape=SHARDED_MESH)
    dm = DistributedModel(domain, state, mesh, lambda dom: build_model(nl, dom, pt), dt_s,
                          halo=nl.nb + 1)
    hs_steady = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )
    t0 = time.perf_counter()
    fields = dm.scatter_state(state)
    dm.step(fields, dm.put_topography(0.0 * hs_steady))  # the driver's warm-up, discarded
    for i in range(nl.niter):
        fields = dm.step(fields, dm.put_topography(min((i + 1) * dt_s / topo_time, 1.0) * hs_steady))
    full = {k: np.asarray(fa.data) for k, fa in dm.gather_state(fields).items()}
    elapsed = time.perf_counter() - t0
    ref = validation_summary(full)
    ref["config"] = {
        "namelist": "drivers/namelist_sus.py", "driver": "drivers/driver_sharded.py --physics",
        "nx": nl.nx, "ny": nl.ny, "nz": nl.nz, "mesh": list(SHARDED_MESH), "halo": nl.nb + 1,
        "steps": f"1 warm-up (discarded) + {nl.niter}", "niter": nl.niter, "dtype": "float32",
        "backend": f"{BACKEND} (CPU, {px * py} virtual devices)",
        "sedimentation_vt_mode": nl.sedimentation_vt_mode, "skip": [],
        "relative_humidity": nl.relative_humidity,
        "horizontal_flux_scheme": nl.horizontal_flux_scheme, "hb_type": nl.hb_type,
    }
    ref["command"] = "python tests/make_torch_flagship_reference.py --sharded"
    out.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


def jax_step(nl, coupling):
    """(domain, initial state, step(state, dt)) of the JAX drivers."""
    if coupling is None:
        from drivers.driver_namelist_sus import build_domain_and_state, build_model

        domain, state, pt = build_domain_and_state(nl)
        dycore, physics = build_model(nl, domain, pt)
        return domain, state, lambda st, dt: physics(dycore(st, {}, dt), dt)
    from drivers.driver_isentropic_moist import build_variant

    return build_variant(nl, coupling)


def main() -> None:
    argv = sys.argv[1:]
    if "--sharded" in argv:
        sharded_reference("--check-port" in argv)
        return
    rain = "--rain" in argv
    merges = MERGES if "--merges" in argv else ()
    coupling = argv[argv.index("--coupling") + 1] if "--coupling" in argv else None
    if coupling is not None and coupling not in COUPLINGS:
        raise SystemExit(f"--coupling: one of {COUPLINGS}")
    surface, suffix = surface_overrides(argv)
    if sum((rain, bool(merges), coupling is not None)) > 1 or (surface and (rain or merges)):
        raise SystemExit("--rain, --merges and --coupling exclude each other, and --flux, "
                         "--boundary, --coriolis, --implicit-vadv, --yz and --topography go with "
                         "--coupling or alone")
    if "implicit_vertical_advection" in surface and coupling is not None:
        raise SystemExit("--implicit-vadv: the SUS chain's switch (the other couplings ignore it)")
    if surface:
        overrides = {**VARIANT, **surface}
        out = DRIVERS / f"{f'variant_{coupling}' if coupling else 'flagship'}{suffix}_reference.json"
    elif coupling is not None:
        overrides = VARIANT
        out = DRIVERS / f"variant_{coupling}_reference.json"
    elif merges:
        overrides = RAIN
        out = DRIVERS / "flagship_merged_reference.json"
    else:
        overrides = RAIN if rain else {}
        out = DRIVERS / ("flagship_rain_reference.json" if rain else "flagship_reference.json")
    if "--check-port" in argv or "--float64" in argv:
        check_port(out, overrides, coupling, merges, float64="--float64" in argv)
        return
    for switch in JAX_MERGE_SWITCHES if merges else ():
        os.environ[switch] = "1"
    if "implicit_vertical_advection" in surface:
        register_interpret_thomas()
    import importlib

    import jax
    import jax.numpy as jnp

    from tasmania_tpu.framework.field import FieldArray
    from tasmania_tpu_torch.drivers.driver_namelist_sus import validation_summary

    jnl = importlib.import_module(f"drivers.namelist_{coupling or 'sus'}")
    nl = SimpleNamespace(**{k: getattr(jnl, k) for k in dir(jnl) if not k.startswith("_")})
    nl.backend = BACKEND
    for key, value in namelist_values(overrides, FieldArray).items():
        setattr(nl, key, value)
    domain, state, step_impl = jax_step(nl, coupling)
    names = sorted(k for k in state if k != "time")
    units = {k: state[k].units for k in names}
    dims = {k: state[k].dims for k in names}
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    hs_steady = jnp.asarray(
        np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data),
        dtype=nl.so.dtype,
    )

    def step(fields, hs):
        st = {k: FieldArray(v, units[k], dims[k]) for k, v in fields.items()}
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = step_impl(st, dt_s)
        return {k: st[k].data for k in names}

    step_c = jax.jit(step)
    t0 = time.perf_counter()
    fields = step_c({k: state[k].data for k in names}, hs_steady * 0.0)
    for i in range(nl.niter):
        fields = step_c(fields, min((i + 1) * dt_s / topo_time, 1.0) * hs_steady)
    fields = {k: np.asarray(v) for k, v in fields.items()}
    elapsed = time.perf_counter() - t0

    ref = validation_summary(fields)
    ref["config"] = {
        "namelist": f"drivers/namelist_{coupling or 'sus'}.py", "nx": nl.nx, "ny": nl.ny,
        "nz": nl.nz, "steps": f"1 warm-up + {nl.niter}", "niter": nl.niter, "dtype": "float32",
        "backend": f"{BACKEND} (CPU)", "sedimentation_vt_mode": nl.sedimentation_vt_mode,
        "skip": [], "relative_humidity": nl.relative_humidity,
        "horizontal_flux_scheme": nl.horizontal_flux_scheme, "hb_type": nl.hb_type,
    }
    if coupling is not None:
        ref["config"]["coupling"] = coupling
    for key in ("coriolis_parameter", "implicit_vertical_advection", *VELOCITIES, "topo_type"):
        if key in surface:
            ref["config"][key] = surface[key]
    if merges:
        ref["config"]["process_merges"] = list(merges)
        ref["config"]["jax_switches"] = list(JAX_MERGE_SWITCHES)
    ref["command"] = "python tests/make_torch_flagship_reference.py" + (
        f" --coupling {coupling}" if coupling else " --rain" if rain else " --merges" if merges else ""
    ) + "".join(f" {flag} {argv[argv.index(flag) + 1]}"
                for flag in ("--flux", "--boundary", "--coriolis", "--topography") if flag in argv) + "".join(
        f" {flag}" for flag in ("--implicit-vadv", "--yz") if flag in argv)
    out.write_text(json.dumps(ref, indent=1) + "\n")
    print(json.dumps(ref, indent=1))
    print(f"{elapsed:.1f} s")


if __name__ == "__main__":
    main()
