"""The port's kernel operations (plain PyTorch versions) against the JAX
package's Pallas kernels run in interpret mode, in float64.

* ``si_stage_plain`` vs ``fused_si_stage(interpret=True)`` at 19x21x8, moist,
  with damping on and off, at the three RK3WS stage timesteps, frame
  finished.  Scaled atol 1e-12: the JAX kernel sums the Montgomery scans as
  triangular matrix products, the port as cumulative sums.
* ``fused_smoothing_plain`` vs ``fused_smoothing(interpret=True)`` for
  orders 1-3, scaled atol 1e-13 (same terms, same order; the bound covers
  the compilers' freedom to contract multiply-adds).
* ``paste_x_edges_multi_plain`` vs ``paste_x_edges_multi``: bitwise.

The kernels themselves are tested against these plain versions on the card
in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tasmania_tpu.ops.paste import paste_x_edges_multi as jax_paste
from tasmania_tpu.ops.si_stage import fused_si_stage
from tasmania_tpu.ops.smoothing_step import fused_smoothing as jax_smoothing
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.paste import paste_x_edges_multi, paste_x_edges_multi_plain
from tasmania_tpu_torch.ops.si_stage import (
    StageConstants,
    frame_strips,
    si_stage,
    si_stage_plain,
)
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
from tests.test_torch_kernels import (
    CONSTS,
    DTF,
    FRACS,
    NB,
    NR,
    NX,
    NY,
    NZ,
    assert_scaled,
    port_args,
    smoothing_inputs,
    stage_inputs,
    tensor,
)


def _jax_stage(inp, damp, dt):
    j = jnp.asarray
    return fused_si_stage(
        j(inp["u"]), j(inp["v"]), j(inp["s_now"]), j(inp["s_int"]),
        tuple(map(j, inp["q_now"])), tuple(map(j, inp["q_int"])),
        j(inp["su_now"]), j(inp["sv_now"]), j(inp["su_int"]), j(inp["sv_int"]),
        j(inp["mtg_now"]), j(inp["hs"]), j(inp["theta"])[None, :], j(inp["gamma"]),
        j(inp["s_ref"]), j(inp["su_ref"]), j(inp["sv_ref"]), tuple(map(j, inp["q_refs"])),
        j(inp["rmat"])[None, :],
        order=5, nb=NB, nr=NR, dt=dt, dtf=DTF, nq=3, do_damp=damp,
        dd=inp["dd"] if damp else 1, interpret=True, **CONSTS,
    )


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("damp", [True, False])
def test_si_stage_plain_vs_pallas(stage, damp):
    inp = stage_inputs(seed=10 + stage)
    dt = FRACS[stage] * DTF
    ref = _jax_stage(inp, damp, dt)
    c = StageConstants(dt=dt, dtf=DTF, **CONSTS)
    got = si_stage_plain(*port_args(inp, damp), nb=NB, c=c, dd=inp["dd"] if damp else 0)
    assert len(got) == len(ref) == 6
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-12, f"output {k}, stage {stage}, damp {damp}")


@pytest.mark.parametrize("damp", [True, False])
def test_frame_strips_match_plain_stage_bitwise(damp):
    """The kernel path composes the x-frame with ``frame_strips``: it must be
    bitwise the plain stage's frame columns."""
    inp = stage_inputs(seed=3)
    c = StageConstants(dt=FRACS[1] * DTF, dtf=DTF, **CONSTS)
    args = port_args(inp, damp)
    full = si_stage_plain(*args, nb=NB, c=c)
    (u, v, s_now, s_int, q_now, q_int, su_now, sv_now, su_int, sv_int, mtg_now, hs,
     theta, gamma, s_ref, su_ref, sv_ref, q_refs, rmat) = args
    for sl in (slice(0, NB), slice(NX - NB, NX)):
        strips = frame_strips(sl, s_now, su_now, sv_now, q_now, gamma, s_ref, su_ref,
                              sv_ref, q_refs, rmat, DTF)
        for k, (a, b) in enumerate(zip(strips, full)):
            torch.testing.assert_close(a, b[sl], rtol=0, atol=0, msg=f"output {k}")


def test_si_stage_wrapper_takes_plain_on_cpu():
    inp = stage_inputs(seed=4)
    c = StageConstants(dt=DTF, dtf=DTF, **CONSTS)
    args = port_args(inp, True)
    before = sum(_lib.launch_counts.values())
    got = si_stage(*args, nb=NB, c=c, dd=inp["dd"])
    ref = si_stage_plain(*args, nb=NB, c=c)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(_lib.launch_counts.values()) == before


@pytest.mark.parametrize("order", [1, 2, 3])
def test_smoothing_plain_vs_pallas(order):
    fields, gamma = smoothing_inputs(seed=order)
    ref = jax_smoothing(tuple(map(jnp.asarray, fields)), jnp.asarray(gamma),
                        order=order, nb=NB, interpret=True)
    got = fused_smoothing_plain([tensor(a) for a in fields], tensor(gamma), order=order, nb=NB)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-13, f"field {k}, order {order}")
        # the nb-frame passes through untouched
        np.testing.assert_array_equal(a.numpy()[:NB], fields[k][:NB])
        np.testing.assert_array_equal(a.numpy()[:, :NB], fields[k][:, :NB])


def test_smoothing_wrapper_takes_plain_on_cpu():
    fields, gamma = smoothing_inputs(seed=7)
    tf = [tensor(a) for a in fields]
    got = fused_smoothing(tf, tensor(gamma), order=2, nb=NB)
    ref = fused_smoothing_plain(tf, tensor(gamma), order=2, nb=NB)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("n,w", [(1, 3), (6, 3), (2, 6)])
def test_paste_plain_vs_pallas_bitwise(n, w):
    rng = np.random.default_rng(n * 10 + w)
    fulls = [rng.normal(size=(NX, NY, NZ)) for _ in range(n)]
    lo = [rng.normal(size=(w, NY, NZ)) for _ in range(n)]
    hi = [rng.normal(size=(w, NY, NZ)) for _ in range(n)]
    ref = jax_paste(tuple(map(jnp.asarray, fulls)), tuple(map(jnp.asarray, lo)),
                    tuple(map(jnp.asarray, hi)), interpret=True)
    tfulls = [tensor(a) for a in fulls]
    got = paste_x_edges_multi(tfulls, [tensor(a) for a in lo], [tensor(a) for a in hi])
    for a, b, t in zip(got, ref, tfulls):
        assert a is t  # in place
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_paste_plain_writes_in_place():
    full = torch.zeros(NX, NY, NZ, dtype=torch.float64)
    lo = torch.ones(2, NY, NZ, dtype=torch.float64)
    hi = torch.full((2, NY, NZ), 2.0, dtype=torch.float64)
    paste_x_edges_multi_plain([full], [lo], [hi])
    assert float(full[:2].min()) == 1.0 and float(full[-2:].min()) == 2.0
    assert float(full[2:-2].abs().max()) == 0.0
