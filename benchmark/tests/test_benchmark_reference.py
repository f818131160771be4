"""The frozen reference against the port's plain PyTorch path on the CPU, in
float64, at a tiny grid: the base state, and a forecast whose perturbation
is strong enough to form cloud and rain within it, so that every layer of
the step (the dycore, the boundary, the coupling, every physics process and
the precipitation) is compared."""

from __future__ import annotations

import pytest
import torch

from benchmark import traffic
from benchmark.program import FIELDS, Program
from benchmark.reference.model import Reference
from benchmark.tests.conftest import tiny_config

STEPS = 40
#: the two float64 implementations sum in other orders; they agree to about
#: 1e-10 of each field's magnitude after 40 steps
TOLERANCE = 1e-8


def perturbation(cfg):
    nl = cfg["namelist"]
    p = dict(cfg["assumed"]["perturbation"], qv_relative=0.3, edge_cells=4, taper_cells=2, scale_cells=4,
             scale_levels=5)
    return traffic.perturbation((nl["nx"], nl["ny"], nl["nz"]), p, 7, 0, "cpu")


def test_reference_base_state_matches_port(config_name):
    cfg = tiny_config(config_name, niter=1)
    program = Program(cfg["namelist"], "cpu", torch.float64)
    ref = Reference(cfg["namelist"], "cpu", torch.float64)
    pairs = {"s": FIELDS["s"], "su": FIELDS["su"], "qv": FIELDS["qv"], "mtg": "montgomery_potential",
             "p": "air_pressure_on_interface_levels", "h": "height_on_interface_levels",
             "rho": "air_density", "t": "air_temperature"}
    for short, name in pairs.items():
        mine, port = ref.base[short], program.base[name].data
        assert float((mine - port).abs().max()) <= TOLERANCE * float(port.abs().max()), short


def test_reference_forecast_matches_port(config_name):
    cfg = tiny_config(config_name, niter=STEPS)
    pert = perturbation(cfg)
    program = Program(cfg["namelist"], "cpu", torch.float64)
    program.load(program.initial(pert))
    program.advance(STEPS)
    out = program.outputs()
    ref = Reference(cfg["namelist"], "cpu", torch.float64)
    st = ref.forecast(ref.initial_state(pert["du"], pert["dv"], pert["rq"]), STEPS)
    for k in FIELDS:
        scale = float(st[k].abs().max())
        assert scale > 0.0, f"{k} never formed: the forecast does not reach that layer"
        assert float((out[k] - st[k]).abs().max()) <= TOLERANCE * scale, k


def test_reference_refuses_another_scheme():
    cfg = tiny_config("sus")
    with pytest.raises(ValueError, match="horizontal_flux_scheme"):
        Reference(dict(cfg["namelist"], horizontal_flux_scheme="third_order_upwind"))
