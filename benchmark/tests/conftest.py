"""Shared pieces of the benchmark's CPU tests: a configuration cut to a
tiny grid (the upstream namelist's values but the grid and the length)."""

from __future__ import annotations

import pytest

from benchmark import spec

TINY = dict(nx=25, ny=23, nz=20, domain_x_m=[-52800.0, 52800.0], domain_y_m=[-48400.0, 48400.0])


#: sus, which has no cell yet, differs from fc in its namelist only here
SUS = dict(coupling="sus", physics_time_integration_scheme="rk2")


def tiny_config(name: str, niter: int = 10, **namelist) -> dict:
    """``fc``'s configuration, or sus on fc's grid and physics, cut to
    ``TINY``."""
    cfg = spec.load_json("configs", "fc")
    cfg["namelist"] = dict(cfg["namelist"], **(SUS if name == "sus" else {}), **TINY, niter=niter, **namelist)
    return cfg


@pytest.fixture(params=["sus", "fc"])
def config_name(request):
    return request.param
