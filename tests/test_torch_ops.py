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
* The two kernels of the tendency-carrying stage at the same geometry:
  ``fused_advection_fields_plain`` vs ``fused_advection_fields(interpret=True)``
  on s and the three mass fractions, with and without tendencies (one field
  without), the relaxed BC on field 0 and the in-kernel s·q products;
  ``fused_momentum_epilogue_plain`` vs ``fused_momentum_epilogue(interpret=True)``
  with and without damping and momentum tendencies.  Scaled atol 1e-13 (the
  same terms in the same order; no column scan).
* The kernels of the unfused stage (the one-dimensional relaxed boundary of
  the mountain wave): ``fused_advection_fields_plain`` at third order vs the
  Pallas kernel, on a two-dimensional grid (with the relaxed BC) and on one a
  single row deep (without, as ``_step_density_and_water`` calls it);
  ``fused_momentum_step_plain`` vs ``fused_momentum_step(interpret=True)`` at
  orders 3 and 5, with and without tendencies, on both grids.  Scaled atol
  1e-12.
* ``fused_isentropic_diagnostics_plain`` vs
  ``fused_isentropic_diagnostics(impl="pallas", interpret=True)`` in modes
  ``"mtg"``, ``"dry"`` and ``"moist"``: scaled atol 1e-12 (triangular matrix
  products against cumulative sums).
* ``paste_x_edges`` (one array) vs the Pallas ``paste_x_edges``: bitwise;
  ``smag_stage``'s plain version vs ``_smag_stage(interpret=True)`` at an nx
  below ``tile_x + 8``, where the JAX package routes the RK2 update to it:
  scaled atol 1e-13.

The kernels themselves are tested against these plain versions on the card
in ``tests/test_torch_kernels.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tasmania_tpu.ops.advection_step import fused_advection_fields as jax_advection
from tasmania_tpu.ops.advection_step import fused_momentum_epilogue as jax_momentum_epilogue
from tasmania_tpu.ops.advection_step import fused_momentum_step as jax_momentum_step
from tasmania_tpu.ops.diagnostics_step import fused_isentropic_diagnostics as jax_diagnostics
from tasmania_tpu.ops.paste import paste_x_edges as jax_paste_one
from tasmania_tpu.ops.paste import paste_x_edges_multi as jax_paste
from tasmania_tpu.ops.smagorinsky_step import _smag_stage as jax_smag_stage
from tasmania_tpu.ops.si_stage import fused_si_stage
from tasmania_tpu.ops.smoothing_step import fused_smoothing as jax_smoothing
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.advection_step import (
    fused_advection_fields,
    fused_advection_fields_plain,
    fused_momentum_epilogue,
    fused_momentum_epilogue_plain,
    fused_momentum_step,
    fused_momentum_step_plain,
)
from tasmania_tpu_torch.ops.diagnostics_step import (
    fused_isentropic_diagnostics,
    fused_isentropic_diagnostics_plain,
)
from tasmania_tpu_torch.ops.paste import paste_x_edges, paste_x_edges_multi, paste_x_edges_multi_plain
from tasmania_tpu_torch.ops.si_stage import (
    StageConstants,
    frame_strips,
    si_stage,
    si_stage_plain,
)
from tasmania_tpu_torch.ops.smagorinsky_step import smag_stage, smagorinsky_stage_plain
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
from tests.test_torch_kernels import (
    CONSTS,
    DIAG_CONSTS,
    DTF,
    FRACS,
    NB,
    NR,
    NX,
    NY,
    NY1,
    NZ,
    SMAG,
    advection_args,
    advection_inputs,
    assert_scaled,
    diagnostics_inputs,
    epilogue_args,
    momentum_step_args,
    momentum_step_inputs,
    port_args,
    smagorinsky_inputs,
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


def _jax_tuple(arrays):
    return None if arrays is None else tuple(None if a is None else jnp.asarray(a.numpy()) for a in arrays)


def _jax_or_none(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("enforce", [True, False])
@pytest.mark.parametrize("q_product", [True, False])
def test_advection_fields_plain_vs_pallas(tendencies, enforce, q_product):
    args, kw = advection_args(advection_inputs(seed=20), tendencies, enforce)
    if not q_product:
        kw["q_product"] = None
    u, v, now, intl, tnds, gamma, ref0 = args
    if tendencies:
        tnds = [tnds[0], None, tnds[2], tnds[3]]  # a field without a tendency
    ref = jax_advection(
        _jax_or_none(u), _jax_or_none(v), _jax_tuple(now), _jax_tuple(intl), _jax_tuple(tnds),
        _jax_or_none(gamma), _jax_or_none(ref0), order=5, interpret=True,
        **{k: (tuple(val) if k == "q_product" and val is not None else val) for k, val in kw.items()},
    )
    got = fused_advection_fields_plain(u, v, now, intl, tnds, gamma, ref0, **kw)
    assert len(got) == len(ref) == 4
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-13, f"field {k}")


@pytest.mark.parametrize("damp", [True, False])
@pytest.mark.parametrize("tendencies", [True, False])
def test_momentum_epilogue_plain_vs_pallas(damp, tendencies):
    inp = advection_inputs(seed=21)
    args = epilogue_args(inp, damp, tendencies)
    c = StageConstants(dt=FRACS[0] * DTF, dtf=DTF, **CONSTS)
    (u, v, su_now, sv_now, su_int, sv_int, s_now, mtg_now, s_e, mtg, sqs, gamma, s_ref,
     su_ref, sv_ref, q_refs, rmat, su_tnd, sv_tnd) = args
    j = _jax_or_none
    ref = jax_momentum_epilogue(
        j(u), j(v), j(su_now), j(sv_now), j(su_int), j(sv_int), j(s_now), j(mtg_now), j(s_e),
        j(mtg), _jax_tuple(sqs), j(gamma), j(s_ref), j(su_ref), j(sv_ref), _jax_tuple(q_refs),
        jnp.asarray(inp["rmat"])[None, :], j(su_tnd), j(sv_tnd),
        order=5, nb=NB, dt=c.dt, dtf=c.dtf, dx=c.dx, dy=c.dy, eps=c.eps, nq=3,
        do_damp=damp, has_tnd=tendencies, interpret=True,
    )
    got = fused_momentum_epilogue_plain(*args, nb=NB, c=c)
    assert len(got) == len(ref) == 6
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-13, f"output {k}")


def test_advection_wrappers_take_plain_on_cpu():
    inp = advection_inputs(seed=22)
    args, kw = advection_args(inp, True, True)
    before = sum(_lib.launch_counts.values())
    for a, b in zip(fused_advection_fields(*args, **kw), fused_advection_fields_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = StageConstants(dt=DTF, dtf=DTF, **CONSTS)
    args = epilogue_args(inp, True, True)
    for a, b in zip(fused_momentum_epilogue(*args, nb=NB, c=c),
                    fused_momentum_epilogue_plain(*args, nb=NB, c=c)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sum(_lib.launch_counts.values()) == before


def test_paste_plain_writes_in_place():
    full = torch.zeros(NX, NY, NZ, dtype=torch.float64)
    lo = torch.ones(2, NY, NZ, dtype=torch.float64)
    hi = torch.full((2, NY, NZ), 2.0, dtype=torch.float64)
    paste_x_edges_multi_plain([full], [lo], [hi])
    assert float(full[:2].min()) == 1.0 and float(full[-2:].min()) == 2.0
    assert float(full[2:-2].abs().max()) == 0.0


@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("grid", ["2d", "one_row"])
def test_third_order_advection_plain_vs_pallas(grid, tendencies):
    """On the two-dimensional grid s and the three mass fractions with the
    relaxed BC on s; on the grid one row deep, s alone without it."""
    args, kw = advection_args(advection_inputs(seed=23), tendencies, grid == "2d")
    kw["order"] = 3
    u, v, now, intl, tnds, gamma, ref0 = args
    if grid == "one_row":
        rows = slice(NB - NB, 2 * NB + 1)
        u, v = u[:, rows].contiguous(), torch.zeros_like(v[:, : 2 * NB + 2])
        now, intl = [now[0][:, rows].contiguous()], [intl[0][:, rows].contiguous()]
        tnds = None if tnds is None else [tnds[0][:, rows].contiguous()]
        kw["q_product"] = None
    ref = jax_advection(
        _jax_or_none(u), _jax_or_none(v), _jax_tuple(now), _jax_tuple(intl), _jax_tuple(tnds),
        _jax_or_none(gamma), _jax_or_none(ref0), interpret=True,
        **{k: (tuple(val) if k == "q_product" and val is not None else val) for k, val in kw.items()},
    )
    got = fused_advection_fields_plain(u, v, now, intl, tnds, gamma, ref0, **kw)
    assert len(got) == len(ref) == len(now)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-12, f"field {k}")


@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("ny", [NY, NY1])
def test_momentum_step_plain_vs_pallas(ny, order, tendencies):
    args = momentum_step_args(momentum_step_inputs(seed=30 + order + ny, ny=ny), tendencies)
    kw = dict(order=order, nb=NB, dt=FRACS[2] * DTF, dx=CONSTS["dx"], dy=CONSTS["dy"], eps=0.5)
    ref = jax_momentum_step(*(_jax_or_none(a) for a in args), has_tnd=tendencies, interpret=True, **kw)
    got = fused_momentum_step_plain(*args, **kw)
    assert len(got) == len(ref) == 2
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-12, f"output {k}")


@pytest.mark.parametrize("mode", ["mtg", "dry", "moist"])
def test_diagnostics_plain_vs_pallas(mode):
    s, hs, theta = diagnostics_inputs(seed=40)
    ref = jax_diagnostics(jnp.asarray(s), jnp.asarray(hs), jnp.asarray(theta)[None, :], mode=mode,
                          impl="pallas", interpret=True, **DIAG_CONSTS)
    got = fused_isentropic_diagnostics_plain(tensor(s), tensor(hs), tensor(theta), mode=mode,
                                             **DIAG_CONSTS)
    got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
    assert len(got) == len(ref) == {"mtg": 1, "dry": 4, "moist": 6}[mode]
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-12, f"output {k}")


def test_single_paste_plain_vs_pallas_bitwise():
    rng = np.random.default_rng(50)
    full, lo, hi = rng.normal(size=(NX, NY, NZ)), rng.normal(size=(NB, NY, NZ)), rng.normal(size=(NB, NY, NZ))
    ref = jax_paste_one(jnp.asarray(full), jnp.asarray(lo), jnp.asarray(hi), interpret=True)
    t = tensor(full)
    got = paste_x_edges(t, tensor(lo), tensor(hi))
    assert got is t
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("stage", [1, 2])
def test_smagorinsky_stage_plain_vs_pallas(stage):
    """nx = 17 with nb = 3 and tile_x 32: the tile is 11 columns and
    17 < 11 + 8, so the JAX ``fused_smagorinsky_rk2`` itself takes ``_smag_stage``."""
    s, su, sv = smagorinsky_inputs(seed=60 + stage)
    s, su, sv = s[:17], su[:17], sv[:17]
    rng = np.random.default_rng(61)
    su_st = su if stage == 1 else su * (1.0 + rng.normal(0.0, 0.01, su.shape))
    sv_st = sv if stage == 1 else sv + s * rng.normal(0.0, 0.5, sv.shape)
    c = 0.5 * SMAG["dt"] if stage == 1 else SMAG["dt"]
    kw = {k: SMAG[k] for k in ("dx", "dy", "cs", "nb")}
    ref = jax_smag_stage(*(jnp.asarray(a) for a in (s, su_st, sv_st, su, sv)), c=c, tile_x=32,
                         interpret=True, **kw)
    got = smagorinsky_stage_plain(*(tensor(a) for a in (s, su_st, sv_st, su, sv)), c=c, **kw)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.numpy(), b, 1e-13, f"output {k}")


def test_unfused_stage_wrappers_take_plain_on_cpu():
    before = dict(_lib.launch_counts)
    args = momentum_step_args(momentum_step_inputs(seed=70, ny=NY1), True)
    kw = dict(order=3, nb=NB, dt=DTF, dx=CONSTS["dx"], dy=CONSTS["dy"], eps=0.5)
    for a, b in zip(fused_momentum_step(*args, **kw), fused_momentum_step_plain(*args, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    s, hs, theta = (tensor(a) for a in diagnostics_inputs(seed=71))
    for mode in ("mtg", "dry", "moist"):
        got = fused_isentropic_diagnostics(s, hs, theta, mode=mode, **DIAG_CONSTS)
        ref = fused_isentropic_diagnostics_plain(s, hs, theta, mode=mode, **DIAG_CONSTS)
        for a, b in zip((got,) if mode == "mtg" else got, (ref,) if mode == "mtg" else ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    s, su, sv = (tensor(a) for a in smagorinsky_inputs(seed=72))
    kw = {k: SMAG[k] for k in ("dx", "dy", "cs", "nb")}
    for a, b in zip(smag_stage(s, su, sv, su, sv, c=1.0, **kw),
                    smagorinsky_stage_plain(s, su, sv, su, sv, c=1.0, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert dict(_lib.launch_counts) == before
