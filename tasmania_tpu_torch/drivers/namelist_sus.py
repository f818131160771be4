"""Namelist of the moist isentropic SUS benchmark: the values of
``drivers/namelist_sus.py`` (161x161x120, dt 5 s, 100 steps, rk3ws_si with
fifth-order upwind fluxes, relaxed BC nb=3/nr=6, a Gaussian mountain that
grows over 1800 s), restated here because that file imports the JAX package.

The storage device is ``cuda``: a run needs a GPU unless the caller passes
``so=StorageOptions(..., device="cpu")``.  ``slice_skip`` names the processes
the first slice of the port left out (its chain was diagnostics -> smoothing
-> velocities); ``driver_namelist_sus.run(nl, skip=slice_skip)`` still runs
that slice.  Use :func:`load_namelist` for a copy with overrides; the
module's own values are never mutated.
"""

from __future__ import annotations

import copy
from datetime import datetime, timedelta
from types import FunctionType, ModuleType, SimpleNamespace

import numpy as np
import torch

from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import BackendOptions, StorageOptions

# computational domain
domain_x = (-176e3, 176e3)
nx = 161
domain_y = (-176e3, 176e3)
ny = 161
domain_z = FieldArray(np.array([400.0, 280.0]), "K", ("z",))
nz = 120

# horizontal boundary
hb_type = "relaxed"
nb = 3
hb_kwargs = {"nr": 6}

# backend and storage: the backend names the registered stencils the
# components compile (the JAX names "jax", "pallas" and "pallas:interpret"
# run as "torch"); the device alone decides between a kernel and its plain
# version
backend = "torch"
bo = BackendOptions()
so = StorageOptions(dtype=torch.float32, device="cuda")
enable_checks = False

# topography
topo_type = "gaussian"
topo_kwargs = {
    "time": timedelta(seconds=1800),
    "max_height": FieldArray(np.asarray(0.5), "km", ()),
    "width_x": FieldArray(np.asarray(50.0), "km", ()),
    "width_y": FieldArray(np.asarray(50.0), "km", ()),
    "smooth": False,
}

# initial conditions
init_time = datetime(1992, 2, 20)
x_velocity = FieldArray(np.asarray(22.5), "m s^-1", ())
y_velocity = FieldArray(np.asarray(0.0), "m s^-1", ())
brunt_vaisala = FieldArray(np.asarray(0.015), "s^-1", ())
relative_humidity = 0.95

# time stepping
time_integration_scheme = "rk3ws_si"
eps = 0.5
physics_time_integration_scheme = "rk2"

# advection
horizontal_flux_scheme = "fifth_order_upwind"
vertical_advection = True
implicit_vertical_advection = False
vertical_flux_scheme = "third_order_upwind"

# damping
damp = True
damp_type = "rayleigh"
damp_depth = 15
damp_max = 0.0005
damp_at_every_stage = False

# horizontal smoothing
smooth = True
smooth_type = "second_order"
smooth_coeff = 1.0
smooth_coeff_max = 1.0
smooth_damp_depth = 0
smooth_moist = True
smooth_moist_coeff = 1.0
smooth_moist_coeff_max = 1.0
smooth_moist_damp_depth = 0

# turbulence
smagorinsky_constant = 0.18

# coriolis
coriolis_parameter = None

# microphysics
sedimentation = True
sedimentation_flux_scheme = "second_order_upwind"
sedimentation_vt_mode = "step"
autoconversion_threshold = FieldArray(np.asarray(0.1), "g kg^-1", ())
autoconversion_rate = FieldArray(np.asarray(0.001), "s^-1", ())
collection_rate = FieldArray(np.asarray(2.2), "s^-1", ())
saturation_rate = FieldArray(np.asarray(0.025), "s^-1", ())

# optional process-pair merges of the SUS chain, each one kernel:
# "smooth_smag" (smoothing -> Smagorinsky RK2), "vadv_sed" (vertical
# advection -> sedimentation); off by default, as in the JAX package
process_merges = ()

# simulation length
timestep = timedelta(seconds=5)
niter = 100

# the processes the first slice of the port left out
slice_skip = frozenset(
    {"smagorinsky", "kessler", "satadj", "vertical_advection", "sedimentation", "precipitation"}
)


def load_namelist(**overrides) -> SimpleNamespace:
    """A (deep) copy of this namelist with ``overrides`` applied."""
    values = copy.deepcopy({
        k: v for k, v in globals().items()
        if not k.startswith("_") and k != "annotations"
        and not isinstance(v, (ModuleType, FunctionType, type))
    })
    unknown = set(overrides) - set(values)
    if unknown:
        raise KeyError(f"unknown namelist entries {sorted(unknown)}")
    values.update(overrides)
    return SimpleNamespace(**values)
