"""The system under test: the port's model of a configuration, built through
the port's own builders and stepped as the drivers step it by default on the
card, replays of one CUDA graph of the step.

* :func:`port_namelist` turns a configuration file's ``namelist`` into the
  port's namelist (``tasmania_tpu_torch.drivers.namelist_<coupling>``), every
  value given, so that the port runs what the file states.
* :class:`Program` builds the model (``sus``: ``build_domain_and_state`` and
  ``build_model``; ``fc``: ``build_variant(nl, "fc")``), takes the drivers'
  warm-up step and capture (``driver_namelist_sus.warm_up``) and runs a
  forecast as ``StepBody.load`` of its initial fields, ``n`` replays and
  nothing else.  On a CPU device, which only the tests use, the captured
  body steps eagerly.

The module imports the port lazily, inside :class:`Program`, so that the
harness's arithmetic can be imported without it.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Dict, Optional

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64}

#: the port's names of the fields a forecast is judged by, and the harness's
FIELDS = {
    "s": "air_isentropic_density",
    "su": "x_momentum_isentropic",
    "sv": "y_momentum_isentropic",
    "qv": "mass_fraction_of_water_vapor_in_air",
    "qc": "mass_fraction_of_cloud_liquid_water_in_air",
    "qr": "mass_fraction_of_precipitation_water_in_air",
    "accprec": "accumulated_precipitation",
}
U, V = "x_velocity_at_u_locations", "y_velocity_at_v_locations"


def port_namelist(nl: dict, device, dtype: Optional[torch.dtype] = None):
    """The port's namelist of the configuration's ``namelist`` on ``device``
    (in ``dtype``, default the file's)."""
    from tasmania_tpu_torch.drivers.driver_isentropic_moist import load_namelist
    from tasmania_tpu_torch.framework.field import FieldArray
    from tasmania_tpu_torch.framework.options import StorageOptions

    def fa(value, units):
        return FieldArray(np.asarray(value), units, ())

    topo = nl["topography"]
    mp = nl["microphysics"]
    overrides = dict(
        domain_x=tuple(nl["domain_x_m"]), nx=nl["nx"], domain_y=tuple(nl["domain_y_m"]), ny=nl["ny"],
        domain_z=FieldArray(np.array(nl["domain_z_K"]), "K", ("z",)), nz=nl["nz"],
        hb_type=nl["hb_type"], nb=nl["nb"], hb_kwargs={"nr": nl["nr"]},
        so=StorageOptions(dtype=dtype or DTYPES[nl["dtype"]], device=str(device)),
        topo_type=topo["type"],
        topo_kwargs={"time": timedelta(seconds=topo["time_s"]),
                     "max_height": fa(topo["max_height_m"], "m"), "width_x": fa(topo["width_x_m"], "m"),
                     "width_y": fa(topo["width_y_m"], "m"), "smooth": False},
        x_velocity=fa(nl["x_velocity_m_s"], "m s^-1"), y_velocity=fa(nl["y_velocity_m_s"], "m s^-1"),
        brunt_vaisala=fa(nl["brunt_vaisala_s-1"], "s^-1"), relative_humidity=nl["relative_humidity"],
        time_integration_scheme=nl["time_integration_scheme"], eps=nl["eps"],
        physics_time_integration_scheme=nl["physics_time_integration_scheme"],
        horizontal_flux_scheme=nl["horizontal_flux_scheme"], vertical_advection=nl["vertical_advection"],
        implicit_vertical_advection=nl["implicit_vertical_advection"],
        vertical_flux_scheme=nl["vertical_flux_scheme"], damp=nl["damp"], damp_type=nl["damp_type"],
        damp_depth=nl["damp_depth"], damp_max=nl["damp_max"], damp_at_every_stage=nl["damp_at_every_stage"],
        smooth=nl["smooth"], smooth_type=nl["smooth_type"], smooth_coeff=nl["smooth_coeff"],
        smooth_coeff_max=nl["smooth_coeff_max"], smooth_damp_depth=nl["smooth_damp_depth"],
        smooth_moist=nl["smooth_moist"], smooth_moist_coeff=nl["smooth_moist_coeff"],
        smooth_moist_coeff_max=nl["smooth_moist_coeff_max"],
        smooth_moist_damp_depth=nl["smooth_moist_damp_depth"],
        smagorinsky_constant=nl["smagorinsky_constant"], coriolis_parameter=nl["coriolis_parameter"],
        sedimentation=nl["sedimentation"], sedimentation_flux_scheme=nl["sedimentation_flux_scheme"],
        sedimentation_vt_mode=nl["sedimentation_vt_mode"],
        autoconversion_threshold=fa(mp["autoconversion_threshold"], "g g^-1"),
        autoconversion_rate=fa(mp["autoconversion_rate"], "s^-1"),
        collection_rate=fa(mp["collection_rate"], "s^-1"), saturation_rate=fa(mp["saturation_rate"], "s^-1"),
        process_merges=tuple(nl["process_merges"]),
        timestep=timedelta(seconds=nl["timestep_s"]), niter=nl["niter"],
    )
    return load_namelist(nl["coupling"], **overrides)


def facts(nl: dict):
    """The mountain's share of its height at each of a forecast's steps."""
    dt, grow = nl["timestep_s"], nl["topography"]["time_s"]
    return [min((i + 1) * dt / grow, 1.0) for i in range(nl["niter"])]


def build_model(nl: dict, device, dtype=None):
    """``(initial state, step, steady topography)`` of the port:
    ``step(fields, hs)`` is one timestep on a dict of ``FieldArray``s."""
    from tasmania_tpu_torch.drivers import driver_namelist_sus as sus
    from tasmania_tpu_torch.drivers.driver_isentropic_moist import build_variant

    pnl = port_namelist(nl, device, dtype)
    if nl["coupling"] == "sus":
        domain, state, pt = sus.build_domain_and_state(pnl)
        dycore, physics = sus.build_model(pnl, domain, pt)

        def step_impl(st, dt):
            return physics(dycore(st, {}, dt), dt)
    else:
        domain, state, dycore, step_impl = build_variant(pnl, nl["coupling"])
    names = sorted(k for k in state if k != "time")
    step = sus.fields_step(step_impl, names, nl["timestep_s"])
    return {k: state[k] for k in names}, step, dycore.topography_steady


class Program:
    """The port's model of a configuration after the drivers' warm-up step
    and capture; ``run(initial)`` is one forecast."""

    def __init__(self, nl: dict, device, dtype=None, verbose: bool = False) -> None:
        from tasmania_tpu_torch.drivers.driver_namelist_sus import warm_up
        from tasmania_tpu_torch.utils.jitx import StepBody, traced_step

        self.device = torch.device(device)
        self.steps = nl["niter"]
        fields, step, hs_steady = build_model(nl, device, dtype)
        #: the base state, the lateral boundary's reference (the port's fields)
        self.base = dict(fields)
        hs0 = hs_steady * 0.0
        _, graph, self.launches, self.capture_s = warm_up(step, fields, hs0, hs_steady, facts(nl),
                                                          self.device, verbose=verbose)
        self.graph = graph
        if graph is None:  # a CPU device: the captured body, stepped eagerly
            _, carried = traced_step(step, fields, hs0)
            self.body = StepBody(step, fields, carried, hs_steady, facts(nl))
        else:
            self.body = graph.body

    def load(self, initial: Dict) -> None:
        self.body.load(initial, 0)

    def advance(self, n: int) -> None:
        if self.graph is not None:
            self.graph.replay(n)
        else:
            for _ in range(n):
                self.body()

    def outputs(self) -> Dict[str, torch.Tensor]:
        """The last step's fields a forecast is judged by, under the
        harness's names (views of the graph's buffers)."""
        out = self.body.outputs()
        return {k: out[name].data for k, name in FIELDS.items()}

    def initial(self, pert: Dict[str, torch.Tensor]):
        """The port's base state with a forecast's perturbation (see
        ``traffic.perturbation``): the staggered velocities plus ``du``,
        ``dv``, the momenta formed from them as the state builder forms
        them, the water vapour times 1 + ``rq``."""
        b = self.base
        s = b[FIELDS["s"]].data
        u = b[U].data + pert["du"].to(s.dtype)
        v = b[V].data + pert["dv"].to(s.dtype)
        new = {U: u, V: v, FIELDS["su"]: 0.5 * s * (u[:-1] + u[1:]), FIELDS["sv"]: 0.5 * s * (v[:, :-1] + v[:, 1:]),
               FIELDS["qv"]: b[FIELDS["qv"]].data * (1.0 + pert["rq"].to(s.dtype))}
        return {k: (fa.with_data(new[k]) if k in new else fa) for k, fa in b.items()}
