"""Moist isentropic benchmark driver, sequential-update splitting (counterpart
of ``drivers/driver_namelist_sus.py``).

The dycore steps the state, then the physics chain runs in sequence:
diagnostics -> smoothing -> Smagorinsky (RK2) -> velocities -> Kessler (RK2)
-> saturation adjustment (RK2) -> vertical advection (RK3WS) -> fall velocity
+ sedimentation (RK3WS) -> fall velocity + precipitation.  Kessler and
saturation adjustment run as one fused pair.  ``skip`` leaves processes out
(``namelist_sus.slice_skip`` gives the port's first slice); Coriolis is not
ported and raises ``NotImplementedError``.  The step sequence is the JAX
driver's: one step at zero mountain height (the warm-up), then ``niter``
timed steps with the mountain at ``min((i+1)·dt/1800 s, 1)`` of its height.

Usage::

    python -m tasmania_tpu_torch.drivers.driver_namelist_sus [--nx N] [--ny N]
        [--nz N] [--niter N] [--device cuda|cpu]

The namelist's device is ``cuda``; without a GPU, ``run`` raises unless the
namelist names the CPU (``--device cpu`` on the command line).
"""

from __future__ import annotations

import argparse
import time
from dataclasses import replace
from typing import Any, Dict

import numpy as np
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.framework.concurrent_coupling import ConcurrentCoupling
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import TimeIntegrationOptions
from tasmania_tpu_torch.framework.splitting import SequentialUpdateSplitting
from tasmania_tpu_torch.isentropic.dynamics.dycore import IsentropicDynamicalCore
from tasmania_tpu_torch.isentropic.physics.diagnostics import (
    IsentropicDiagnostics,
    IsentropicVelocityComponents,
)
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import (
    IsentropicHorizontalSmoothing,
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
from tasmania_tpu_torch.physics.microphysics.kessler import (
    KesslerFallVelocity,
    KesslerMicrophysics,
    KesslerSaturationAdjustmentPrognostic,
    KesslerSedimentation,
)
from tasmania_tpu_torch.physics.microphysics.utils import Precipitation

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


def build_model(nl, domain, pt, skip=()):
    """Dycore + physics chain, as ``drivers/driver_namelist_sus.py:87-251``
    builds it.  ``skip`` names processes to leave out."""
    unknown = set(skip) - set(PROCESSES)
    if unknown:
        raise ValueError(f"unknown processes in skip: {sorted(unknown)}")
    so = nl.so
    dycore = IsentropicDynamicalCore(
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
        storage_options=so,
    )
    ptis = nl.physics_time_integration_scheme
    args = []
    if "diagnostics" not in skip:
        dv = IsentropicDiagnostics(domain, "numerical", moist=True, pt=pt, storage_options=so)
        args.append(TimeIntegrationOptions(component=dv))
    if nl.coriolis_parameter is not None and "coriolis" not in skip:
        raise NotImplementedError("the Coriolis process is not ported; set coriolis_parameter=None")
    if nl.smooth and "smoothing" not in skip:
        smoother = IsentropicHorizontalSmoothing(
            domain,
            nl.smooth_type,
            nl.smooth_coeff,
            nl.smooth_coeff_max,
            nl.smooth_damp_depth,
            moist=nl.smooth_moist,
            smooth_moist_coeff=nl.smooth_moist_coeff,
            smooth_moist_coeff_max=nl.smooth_moist_coeff_max,
            smooth_moist_damp_depth=nl.smooth_moist_damp_depth,
            storage_options=so,
        )
        args.append(TimeIntegrationOptions(component=smoother))
    if "smagorinsky" not in skip:
        turb = IsentropicSmagorinsky(domain, nl.smagorinsky_constant, storage_options=so)
        args.append(TimeIntegrationOptions(component=turb, scheme=ptis))
    if "velocities" not in skip:
        args.append(TimeIntegrationOptions(component=IsentropicVelocityComponents(domain, storage_options=so)))
    t2d = AirPotentialTemperatureToDiagnostic(domain, "numerical")
    if "kessler" not in skip:
        ke = KesslerMicrophysics(
            domain,
            "numerical",
            autoconversion_threshold=nl.autoconversion_threshold,
            autoconversion_rate=nl.autoconversion_rate,
            collection_rate=nl.collection_rate,
            storage_options=so,
        )
        args.append(TimeIntegrationOptions(component=ConcurrentCoupling(ke, t2d), scheme=ptis))
    if "satadj" not in skip:
        d2t = AirPotentialTemperatureToTendency(domain, "numerical")
        sa = KesslerSaturationAdjustmentPrognostic(
            domain,
            "numerical",
            saturation_rate=nl.saturation_rate,
            storage_options=so,
        )
        args.append(TimeIntegrationOptions(component=ConcurrentCoupling(d2t, sa, t2d), scheme=ptis))
    if nl.vertical_advection and "vertical_advection" not in skip:
        if nl.implicit_vertical_advection:
            raise NotImplementedError("implicit vertical advection is not ported")
        va = IsentropicVerticalAdvection(domain, flux_scheme=nl.vertical_flux_scheme, storage_options=so)
        args.append(TimeIntegrationOptions(component=va, scheme="rk3ws"))
    rfv = KesslerFallVelocity(domain, "numerical", storage_options=so)
    if "sedimentation" not in skip:
        sd = KesslerSedimentation(
            domain,
            "numerical",
            sedimentation_flux_scheme=nl.sedimentation_flux_scheme,
            vt_mode=nl.sedimentation_vt_mode,
            storage_options=so,
        )
        args.append(TimeIntegrationOptions(component=ConcurrentCoupling(rfv, sd), scheme="rk3ws"))
    if "precipitation" not in skip:
        ap = Precipitation(domain, "numerical", storage_options=so)
        args.append(TimeIntegrationOptions(component=ConcurrentCoupling(rfv, ap)))
    return dycore, SequentialUpdateSplitting(*args)


def make_step(dycore, physics, field_names, dt_s: float):
    """One model timestep on a dict of ``FieldArray``s, with the current
    topography height ``hs`` as an input."""

    def step(fields: Dict[str, FieldArray], hs: torch.Tensor) -> Dict[str, FieldArray]:
        st = dict(fields)
        st["topography_height"] = FieldArray(hs, "m", ("x", "y"))
        st = dycore(st, {}, dt_s)
        st = physics(st, dt_s)
        return {k: st[k] for k in field_names}

    return step


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def check_device(device) -> None:
    """Raise if ``device`` is a CUDA device this machine does not have."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the namelist's device is cuda but no CUDA device is available "
            "(name the CPU to run there: so=StorageOptions(..., device='cpu'))"
        )


def run(nl, skip=(), *, verbose: bool = True) -> Dict[str, Any]:
    """Build the model, run the warm-up step and ``nl.niter`` timed steps on
    the namelist's device.  Returns the validation numbers, the timing and
    the final fields."""
    check_device(nl.so.device)
    domain, state, pt = build_domain_and_state(nl)
    dycore, physics = build_model(nl, domain, pt, skip)
    cgrid = domain.numerical_grid
    dt_s = nl.timestep.total_seconds()
    topo_time = nl.topo_kwargs["time"].total_seconds()
    hs_steady = dycore.topography_steady
    field_names = sorted(k for k in state if k != "time")
    step = make_step(dycore, physics, field_names, dt_s)
    fields = {k: state[k] for k in field_names}
    device = nl.so.device

    t0 = time.perf_counter()
    fields = step(fields, hs_steady * 0.0)
    synchronize(device)
    if verbose:
        print(f"warmup step: {time.perf_counter() - t0:.3f} s", flush=True)

    t0 = time.perf_counter()
    for i in range(nl.niter):
        fact = min((i + 1) * dt_s / topo_time, 1.0)
        fields = step(fields, fact * hs_steady)
    synchronize(device)
    elapsed = time.perf_counter() - t0

    u = fields["x_velocity_at_u_locations"].data
    v = fields["y_velocity_at_v_locations"].data
    umax = float(u[:, :-1].max())
    vmax = float(v[:-1, :].max())
    gps = cgrid.nx * cgrid.ny * cgrid.nz * max(nl.niter, 1) / elapsed
    if verbose:
        print(f"Validation: umax = {umax:.5f}, vmax = {vmax:.5f}")
        print(f"Compute time: {elapsed:.3f} s.")
        print(f"Throughput: {gps:.3e} gridpoints/s")
    return {
        "umax": umax, "vmax": vmax, "elapsed": elapsed, "gps": gps,
        "ms_per_step": 1e3 * elapsed / max(nl.niter, 1), "fields": fields,
    }


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


def main(argv=None):
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--nx", type=int, default=None)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--niter", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    device = torch.device(cli.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    nl = load_namelist()
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
    overrides["so"] = replace(nl.so, device=device)
    res = run(load_namelist(**overrides))
    print("Simulation successfully completed.")
    return res


if __name__ == "__main__":
    main()
