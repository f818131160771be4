"""The plain PyTorch versions of the moist chain's four kernels against the JAX
package's Pallas kernels run in interpret mode, in float64, at 25x21x16 on
inputs made with numpy from a seed (``tests/test_torch_kernels.py``):

* ``fused_kessler_satadj_rk2_plain`` vs ``fused_kessler_satadj_rk2`` on
  states that reach every branch of the scheme;
* ``fused_smagorinsky_rk2_plain`` vs ``_smag_rk2_fused`` (``tile_x=8``, the
  one-kernel path) and vs two ``_smag_stage`` launches;
* ``fused_vertical_advection_rk3ws_plain`` vs
  ``fused_vertical_advection_rk3ws`` for flux orders 1, 2, 3 and 5, moist
  and dry;
* ``fused_sedimentation_rk3ws_plain`` vs ``fused_sedimentation_rk3ws`` for
  orders 1 and 2 and both ``vt_mode``s.

Tolerance: every output within 1e-13 of its largest magnitude (the same
terms in the same order; the bound covers the compilers' freedom to contract
multiply-adds and XLA's rewrites of powers and divisions), the Kessler step's
within 1e-10: its exponential and three powers per cell come from two
different math libraries, and near saturation qvs - qv cancels digits before
the adjustment compares it with qc.  Each wrapper
also takes its plain version for CPU tensors, bitwise, and counts no launch.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tasmania_tpu.ops.kessler_step import fused_kessler_satadj_rk2 as jax_kessler
from tasmania_tpu.ops.sedimentation_step import fused_sedimentation_rk3ws as jax_sedimentation
from tasmania_tpu.ops.smagorinsky_step import _smag_rk2_fused, _smag_stage
from tasmania_tpu.ops.vertical_advection_step import (
    fused_vertical_advection_rk3ws as jax_vertical_advection,
)
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.kessler_step import (
    fused_kessler_satadj_rk2,
    fused_kessler_satadj_rk2_plain,
)
from tasmania_tpu_torch.ops.sedimentation_step import (
    fused_sedimentation_rk3ws,
    fused_sedimentation_rk3ws_plain,
)
from tasmania_tpu_torch.ops.smagorinsky_step import (
    fused_smagorinsky_rk2,
    fused_smagorinsky_rk2_plain,
)
from tasmania_tpu_torch.ops.vertical_advection_step import (
    fused_vertical_advection_rk3ws,
    fused_vertical_advection_rk3ws_plain,
)
from tests.test_torch_kernels import (
    KESSLER,
    SMAG,
    assert_scaled,
    kessler_inputs,
    sedimentation_inputs,
    smagorinsky_inputs,
    tensor,
    vertical_advection_inputs,
)

TOL = 1e-13
KESSLER_TOL = 1e-10


def _jax(arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_outputs(got, ref, what, tol=TOL):
    assert len(got) == len(ref), what
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), np.asarray(b), tol, f"{what}: output {k}")


@pytest.mark.parametrize("seed", [0, 1])
def test_kessler_satadj_plain_vs_pallas(seed):
    inputs = kessler_inputs(seed)
    c = KESSLER
    ref = jax_kessler(
        *_jax(inputs), a=c.a, k1=c.k1, k2=c.k2, sr=c.sr, beta=c.beta, lhvw=c.lhvw, cp=c.cp,
        rv=c.rv, dt=c.dt, tile_x=8, interpret=True,
    )
    got = fused_kessler_satadj_rk2_plain(*[tensor(a) for a in inputs], c)
    _assert_outputs(got, ref, f"seed {seed}", tol=KESSLER_TOL)


def test_kessler_inputs_reach_every_branch():
    rho, t, p_if, exn_if, qv, qc, qr = kessler_inputs(0)
    assert (qc > KESSLER.a).any() and (qc <= KESSLER.a).any() and (qc == 0).any()
    assert (qr > 0).any() and (qr == 0).any() and (qr < 0).any()
    # saturation adjustment: capped by qc at some cells, not at others
    c = KESSLER
    p = 0.5 * (p_if[..., :-1] + p_if[..., 1:])
    qvs = c.beta * 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86)) / p
    sat = (qvs - qv) / (1.0 + qvs * c.lhvw**2 / (c.cp * c.rv * t**2))
    assert (sat > qc).any() and (sat <= qc).any()


def test_smagorinsky_plain_vs_pallas_fused():
    inputs = smagorinsky_inputs(3)
    ref = _smag_rk2_fused(*_jax(inputs), tile_x=8, interpret=True, **SMAG)
    got = fused_smagorinsky_rk2_plain(*[tensor(a) for a in inputs], **SMAG)
    _assert_outputs(got, ref, "one-kernel path")


def test_smagorinsky_plain_vs_pallas_two_stages():
    inputs = smagorinsky_inputs(4)
    s, su, sv = _jax(inputs)
    kw = {k: v for k, v in SMAG.items() if k != "dt"}
    su1, sv1 = _smag_stage(s, su, sv, su, sv, c=0.5 * SMAG["dt"], tile_x=8, interpret=True, **kw)
    ref = _smag_stage(s, su1, sv1, su, sv, c=SMAG["dt"], tile_x=8, interpret=True, **kw)
    got = fused_smagorinsky_rk2_plain(*[tensor(a) for a in inputs], **SMAG)
    _assert_outputs(got, ref, "two-launch path")


def test_smagorinsky_plain_keeps_the_frame():
    s, su, sv = (tensor(a) for a in smagorinsky_inputs(5))
    nb = SMAG["nb"]
    out_su, out_sv = fused_smagorinsky_rk2_plain(s, su, sv, **SMAG)
    for out, base in ((out_su, su), (out_sv, sv)):
        for sl in ((slice(0, nb),), (slice(-nb, None),), (slice(None), slice(0, nb)),
                   (slice(None), slice(-nb, None))):
            torch.testing.assert_close(out[sl], base[sl], rtol=0, atol=0)
        assert not torch.equal(out[nb:-nb, nb:-nb], base[nb:-nb, nb:-nb])


@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("moist", [True, False])
def test_vertical_advection_plain_vs_pallas(order, moist):
    w, s, su, sv, qv, qc, qr = vertical_advection_inputs(order)
    q = (qv, qc, qr) if moist else ()
    qkw = dict(zip(("qv", "qc", "qr"), _jax(q)))
    ref = jax_vertical_advection(
        *_jax((w, s, su, sv)), **qkw, order=order, dt=5.0, dz=1.0, tile_x=8, interpret=True,
    )
    got = fused_vertical_advection_rk3ws_plain(
        *[tensor(a) for a in (w, s, su, sv)], tuple(tensor(a) for a in q), order=order, dt=5.0, dz=1.0,
    )
    _assert_outputs(got, ref, f"order {order}, moist {moist}")


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
def test_sedimentation_plain_vs_pallas(order, vt_mode):
    inputs = sedimentation_inputs(10 + order)
    ref = jax_sedimentation(*_jax(inputs), order=order, dt=5.0, tile_x=8, vt_mode=vt_mode, interpret=True)
    got = fused_sedimentation_rk3ws_plain(*[tensor(a) for a in inputs], order=order, dt=5.0, vt_mode=vt_mode)
    _assert_outputs(got, ref, f"order {order}, vt_mode {vt_mode}")


def test_sedimentation_vt_modes_differ():
    """The two modes are two schemes: freezing vt at stage 1 changes qr."""
    args = [tensor(a) for a in sedimentation_inputs(7)]
    step = fused_sedimentation_rk3ws_plain(*args, order=2, dt=5.0, vt_mode="step")
    stage = fused_sedimentation_rk3ws_plain(*args, order=2, dt=5.0, vt_mode="stage")
    torch.testing.assert_close(step[1], stage[1], rtol=0, atol=0)  # both return the stage-1 vt
    assert not torch.equal(step[0], stage[0])


# ------------------------------------------- the wrappers on CPU tensors


def _cpu_routing(wrapper, plain, args, kwargs):
    before = sum(_lib.launch_counts.values())
    got = wrapper(*args, **kwargs)
    ref = plain(*args, **kwargs)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(_lib.launch_counts.values()) == before


def test_kessler_wrapper_takes_plain_on_cpu():
    args = [tensor(a) for a in kessler_inputs(2)] + [KESSLER]
    _cpu_routing(fused_kessler_satadj_rk2, fused_kessler_satadj_rk2_plain, args, {})


def test_smagorinsky_wrapper_takes_plain_on_cpu():
    args = [tensor(a) for a in smagorinsky_inputs(6)]
    _cpu_routing(fused_smagorinsky_rk2, fused_smagorinsky_rk2_plain, args, SMAG)


def test_vertical_advection_wrapper_takes_plain_on_cpu():
    w, s, su, sv, *q = [tensor(a) for a in vertical_advection_inputs(6)]
    _cpu_routing(fused_vertical_advection_rk3ws, fused_vertical_advection_rk3ws_plain,
                 (w, s, su, sv, tuple(q)), dict(order=3, dt=5.0, dz=1.0))


def test_sedimentation_wrapper_takes_plain_on_cpu():
    args = [tensor(a) for a in sedimentation_inputs(6)]
    _cpu_routing(fused_sedimentation_rk3ws, fused_sedimentation_rk3ws_plain, args,
                 dict(order=2, dt=5.0, vt_mode="step"))
