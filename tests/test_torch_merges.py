"""The SUS chain's two optional process-pair merges against the JAX package,
on the CPU in float64.

* ``fused_smoothing_smagorinsky_rk2_plain`` (smoothing, then Smagorinsky RK2
  of the smoothed fields) vs the Pallas ``fused_smoothing_smagorinsky_rk2``
  in interpret mode at 33x21x8, nb 3, orders 1, 2 and 3, dry (3 fields) and
  moist (6): every output within 1e-12 of its largest magnitude.
* ``fused_vadv_sedimentation_rk3ws_plain`` (vertical advection, then
  sedimentation of the advected rain) vs the Pallas
  ``fused_vadv_sedimentation_rk3ws`` at 25x21x16, advection orders 3 and 5,
  sedimentation orders 1 and 2, both ``vt_mode``s: the advected fields within
  1e-12, the sedimented qr and the fall velocity within the JAX package's
  own tolerance for the merged kernel (rtol 1e-5, atol 1e-12,
  ``tests/test_pallas_ops.py:500-509``).
* The port's SUS chain with ``process_merges=("smooth_smag", "vadv_sed")``
  against the JAX driver's chain under ``"pallas:interpret"`` with
  ``TASMANIA_FUSE_SMOOTH_SMAG=1`` and ``TASMANIA_FUSE_VADV_SED=1`` (set only
  around the JAX run), from a supersaturated start at 17x17x8 (the JAX
  matcher fuses from nx = 16): the warm-up step and two more, every field
  within 1e-10 of its largest magnitude; the same under ssus.  Both JAX
  merges are checked to have run.
* The port with and without the merges: bitwise on the CPU, where each
  merged operation is the two plain versions in turn.
* The plan: no merge without ``merges``; each name plans its pair alone; an
  unknown name, or merges under a coupling without sequential-update
  splitting, raise ``ValueError``.  Each wrapper takes its plain version for
  CPU tensors and counts no launch.
* ``smooth_smag`` is planned exactly where the JAX matcher merges, for the
  boundary's nb 2 and 3 and smoothing orders 1-3 at 21x21 (wide enough for
  the JAX kernel's x-tile): only where nb >= max(order, 2), since the merged
  kernel runs the smoothing and Smagorinsky with one nb, the boundary's.
  With third-order smoothing and nb 3 the merged chain stays bitwise the
  unmerged one.
"""

from __future__ import annotations

import functools
import os
from contextlib import contextmanager
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tasmania_tpu.ops.smagorinsky_step import (
    fused_smoothing_smagorinsky_rk2 as jax_smooth_smag,
)
from tasmania_tpu.ops.vertical_advection_step import (
    fused_vadv_sedimentation_rk3ws as jax_vadv_sed,
)
from tasmania_tpu_torch.drivers import driver_isentropic_moist as port_moist
from tasmania_tpu_torch.drivers import driver_namelist_sus as port_driver
from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
from tasmania_tpu_torch.dwarfs.horizontal_smoothing import HorizontalSmoothing
from tasmania_tpu_torch.framework.options import StorageOptions
from tasmania_tpu_torch.framework.splitting import SequentialUpdateSplitting, _pair_plan
from tasmania_tpu_torch.interop import state_to_numpy
from tasmania_tpu_torch.isentropic.physics.horizontal_smoothing import IsentropicHorizontalSmoothing
from tasmania_tpu_torch.isentropic.physics.vertical_advection import IsentropicVerticalAdvection
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.smagorinsky_step import (
    fused_smoothing_smagorinsky_rk2,
    fused_smoothing_smagorinsky_rk2_plain,
)
from tasmania_tpu_torch.ops.vertical_advection_step import (
    fused_vadv_sedimentation_rk3ws,
    fused_vadv_sedimentation_rk3ws_plain,
)
from tests.test_torch_flagship import assert_fields_agree
from tests.test_torch_kernels import SMAG, assert_scaled, smooth_smag_inputs, tensor, vadv_sed_inputs
from tests.test_torch_variants import jax_namelist

MERGES = ("smooth_smag", "vadv_sed")
JAX_SWITCHES = ("TASMANIA_FUSE_SMOOTH_SMAG", "TASMANIA_FUSE_VADV_SED")
SIZE = {"nx": 17, "ny": 17, "nz": 8, "relative_humidity": 1.2}
NSTEPS = 2  # after the warm-up step: rain forms in the last
TOL = 1e-10
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
QR = "mass_fraction_of_precipitation_water_in_air"


# ------------------------------------------------------------ the kernels' twins


@pytest.mark.parametrize("nf", [3, 6])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_smooth_smag_plain_vs_pallas(order, nf):
    fields, gamma = smooth_smag_inputs(order + nf, nf)
    kw = dict(order=order, nb=SMAG["nb"], dx=SMAG["dx"], dy=SMAG["dy"], cs=SMAG["cs"], dt=SMAG["dt"])
    ref = jax_smooth_smag(tuple(map(jnp.asarray, fields)), jnp.asarray(gamma), interpret=True, **kw)
    got = fused_smoothing_smagorinsky_rk2_plain([tensor(a) for a in fields], tensor(gamma), **kw)
    assert len(got) == len(ref) == nf
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-12, f"output {k}, order {order}")


@pytest.mark.parametrize("vt_mode", ["step", "stage"])
@pytest.mark.parametrize("sorder", [1, 2])
@pytest.mark.parametrize("vorder", [3, 5])
def test_vadv_sed_plain_vs_pallas(vorder, sorder, vt_mode):
    inputs = vadv_sed_inputs(vorder + 10 * sorder)
    kw = dict(vorder=vorder, sorder=sorder, dt=5.0, dz=1.0, vt_mode=vt_mode)
    ref = jax_vadv_sed(*map(jnp.asarray, inputs), tile_x=8, interpret=True, **kw)
    got = fused_vadv_sedimentation_rk3ws_plain(*[tensor(a) for a in inputs], **kw)
    assert len(got) == len(ref) == 7
    for k, (a, b) in enumerate(zip(got[:5], ref[:5])):
        assert_scaled(a.numpy(), b, 1e-12, f"advected output {k}")
    for name, a, b in zip(("qr", "vt"), got[5:], ref[5:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-12, err_msg=name)
    assert np.asarray(ref[5]).max() > 0.0  # rain to sediment


def test_merged_wrappers_take_plain_on_cpu():
    before = dict(_lib.launch_counts)
    fields, gamma = smooth_smag_inputs(7, 6)
    tf, tg = [tensor(a) for a in fields], tensor(gamma)
    kw = dict(order=2, nb=SMAG["nb"], dx=SMAG["dx"], dy=SMAG["dy"], cs=SMAG["cs"], dt=SMAG["dt"])
    for a, b in zip(fused_smoothing_smagorinsky_rk2(tf, tg, **kw),
                    fused_smoothing_smagorinsky_rk2_plain(tf, tg, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    args = [tensor(a) for a in vadv_sed_inputs(8)]
    kw = dict(vorder=3, sorder=2, dt=5.0, dz=1.0, vt_mode="step")
    for a, b in zip(fused_vadv_sedimentation_rk3ws(*args, **kw),
                    fused_vadv_sedimentation_rk3ws_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dict(_lib.launch_counts) == before


# ------------------------------------------------------------ the chains


@contextmanager
def jax_merges_on():
    """The JAX package's two merge switches, set for the duration only."""
    saved = {k: os.environ.get(k) for k in JAX_SWITCHES}
    os.environ.update({k: "1" for k in JAX_SWITCHES})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@functools.lru_cache(maxsize=None)
def run_jax_merged(coupling):
    """The JAX driver's step sequence under ``"pallas:interpret"`` with both
    merges, and the names of the merged Pallas kernels it called."""
    import tasmania_tpu.ops.smagorinsky_step as jsmag
    import tasmania_tpu.ops.vertical_advection_step as jvadv
    from drivers.driver_isentropic_moist import build_variant
    from tasmania_tpu.framework.field import FieldArray as JaxFieldArray

    called = set()

    def spy(module, name):
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            called.add(name)
            return real(*args, **kwargs)

        return mock.patch.object(module, name, wrapped)

    nl = jax_namelist(coupling, "pallas:interpret", **SIZE)
    with jax_merges_on(), spy(jsmag, "fused_smoothing_smagorinsky_rk2"), \
            spy(jvadv, "fused_vadv_sedimentation_rk3ws"):
        domain, state, step_impl = build_variant(nl, coupling)
        names = sorted(k for k in state if k != "time")
        hs = jnp.asarray(np.asarray(domain.numerical_grid.topography.steady_profile.to_units("m").data))
        dt_s = nl.timestep.total_seconds()
        topo_time = nl.topo_kwargs["time"].total_seconds()
        fields = {k: state[k] for k in names}
        for i in range(-1, NSTEPS):
            fact = 0.0 if i < 0 else min((i + 1) * dt_s / topo_time, 1.0)
            st = dict(fields)
            st["topography_height"] = JaxFieldArray(fact * hs, "m", ("x", "y"))
            st = step_impl(st, dt_s)
            fields = {k: st[k] for k in names}
    return {k: np.asarray(v.data) for k, v in fields.items()}, frozenset(called)


@functools.lru_cache(maxsize=None)
def run_port(coupling, merges, smooth_type="second_order"):
    nl = port_moist.load_namelist(coupling, **SIZE, niter=NSTEPS, so=CPU64, process_merges=merges,
                                  smooth_type=smooth_type)
    res = port_moist.run(nl, coupling, verbose=False)
    return {k: a for k, (a, _) in state_to_numpy(res["fields"]).items()}


@pytest.mark.parametrize("coupling", ["sus", "ssus"])
def test_merged_chain_agrees_with_pallas_interpret(coupling):
    ref, called = run_jax_merged(coupling)
    assert called == {"fused_smoothing_smagorinsky_rk2", "fused_vadv_sedimentation_rk3ws"}
    assert ref[QR].max() > 0.0  # sedimentation acted on rain
    assert_fields_agree(run_port(coupling, MERGES), ref, TOL)


@pytest.mark.parametrize("coupling", ["sus", "ssus"])
def test_merges_leave_the_cpu_result_unchanged(coupling):
    merged, plain = run_port(coupling, MERGES), run_port(coupling, ())
    assert set(merged) == set(plain)
    for name in sorted(plain):
        np.testing.assert_array_equal(merged[name], plain[name], err_msg=name)


# ------------------------------------------------------------ the plan


@functools.lru_cache(maxsize=None)
def _sus_processes(**overrides):
    """The SUS physics chain's processes (no dycore: its fifth-order fluxes
    need nb >= 3)."""
    nl = load_namelist(**{**SIZE, **overrides}, so=CPU64)
    domain, _, pt = port_driver.build_domain_and_state(nl)
    options = port_driver.physics_options(nl, port_driver.build_components(nl, domain, pt))
    return SequentialUpdateSplitting(*options)._processes


def _merged_pairs(merges, **overrides):
    """The first process of each pair the plan makes, by type."""
    pairs = [e for e in _pair_plan(_sus_processes(**overrides), frozenset(merges)) if e[0] == "pair"]
    out = set()
    for _, a, b, _ in pairs:
        if isinstance(a, IsentropicHorizontalSmoothing):
            out.add("smooth_smag")
        elif isinstance(a.coupling.components[0], IsentropicVerticalAdvection):
            out.add("vadv_sed")
        else:
            out.add("kessler_satadj")
    return out


@pytest.mark.parametrize("merges", [(), ("smooth_smag",), ("vadv_sed",), MERGES])
def test_plan_holds_exactly_the_named_merges(merges):
    assert _merged_pairs(merges) == {"kessler_satadj", *merges}


def test_unknown_merge_raises():
    with pytest.raises(ValueError, match="unknown process merges"):
        SequentialUpdateSplitting(merges=("smooth_smag", "no_such_pair"))


@pytest.mark.parametrize("coupling", ["fc", "lfc", "ps", "sts"])
def test_merges_without_sequential_update_splitting_raise(coupling):
    nl = port_moist.load_namelist(coupling, **SIZE, so=CPU64, process_merges=("vadv_sed",))
    with pytest.raises(ValueError, match="process_merges"):
        port_moist.build_variant(nl, coupling)


def _jax_merges_smooth_smag(nb, smooth_type, n):
    """Whether the JAX package's planner merges its smoothing and its
    Smagorinsky RK2 stepper (``"pallas:interpret"``, the merge switch on) on
    an n x n grid with the boundary's ``nb``."""
    from tasmania_tpu.domain import Domain as JaxDomain
    from tasmania_tpu.framework import TimeIntegrationOptions as JaxOptions
    from tasmania_tpu.framework.splitting import SequentialUpdateSplitting as JaxSplitting
    from tasmania_tpu.framework.splitting import _pair_plan as jax_pair_plan
    from tasmania_tpu.isentropic.physics import IsentropicHorizontalSmoothing as JaxSmoothing
    from tasmania_tpu.isentropic.physics import IsentropicSmagorinsky as JaxSmagorinsky

    nl = jax_namelist("sus", "pallas:interpret", nx=n, ny=n, nb=nb)
    common = dict(backend=nl.backend, backend_options=nl.bo, storage_options=nl.so)
    domain = JaxDomain(
        nl.domain_x, n, nl.domain_y, n, nl.domain_z, nl.nz, horizontal_boundary_type=nl.hb_type,
        nb=nb, horizontal_boundary_kwargs=nl.hb_kwargs, topography_type=nl.topo_type,
        topography_kwargs=nl.topo_kwargs, **common,
    )
    smoothing = JaxSmoothing(domain, smooth_type, nl.smooth_coeff, nl.smooth_coeff_max,
                             nl.smooth_damp_depth, moist=True, **common)
    smag = JaxSmagorinsky(domain, nl.smagorinsky_constant, **common)
    with jax_merges_on():
        split = JaxSplitting(JaxOptions(component=smoothing), JaxOptions(component=smag, scheme="rk2"))
        return any(e[0] == "pair" for e in jax_pair_plan(split._steppers))


@pytest.mark.parametrize("smooth_type", ["first_order", "second_order", "third_order"])
@pytest.mark.parametrize("nb", [2, 3])
def test_smooth_smag_planned_where_the_jax_matcher_merges(nb, smooth_type):
    n = 21  # the JAX matcher asks nx >= 8 + 2 order + 4 for its x-tile
    expected = nb >= max(HorizontalSmoothing.registry[smooth_type].order, 2)
    assert _jax_merges_smooth_smag(nb, smooth_type, n) == expected
    merged = "smooth_smag" in _merged_pairs(("smooth_smag",), nx=n, ny=n, nb=nb, smooth_type=smooth_type)
    assert merged == expected


def test_third_order_merge_leaves_the_cpu_result_unchanged():
    """nb 3, third-order smoothing: the pair is planned, and the merged
    chain is bitwise the unmerged one."""
    assert "smooth_smag" in _merged_pairs(("smooth_smag",), smooth_type="third_order")
    merged = run_port("sus", ("smooth_smag",), "third_order")
    plain = run_port("sus", (), "third_order")
    assert set(merged) == set(plain)
    for name in sorted(plain):
        np.testing.assert_array_equal(merged[name], plain[name], err_msg=name)
