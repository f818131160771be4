"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import neither JAX nor the JAX package, so they also run on a GPU
machine without them; without a CUDA device they skip.  On the GPU machine::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances, float64: paste bitwise (N arrays and one); smoothing and the
stage within 1e-12 of the largest magnitude of the output (FMA contraction;
the stage's column scans sum in another order than the plain version's
cumulative sums); the kernels of the stages that do not run whole
(advection of the fields at third and fifth order, the momentum step at
both orders on a two-dimensional grid and on one a single row deep, the
momentum epilogue), the isentropic diagnostics in their three modes, the
Kessler and saturation-adjustment steps (the pair and each alone),
Smagorinsky (both stages, and one stage alone), vertical advection and
sedimentation within 1e-12 of the output's largest magnitude (FMA
contraction, and PyTorch's division by a scalar on the card, a product with
the reciprocal); the advection of the fields and the momentum step also in
float32, within 1e-5.  The input helpers here are shared with
``tests/test_torch_ops.py`` and ``tests/test_torch_physics_ops.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.dwarfs.vertical_damping import Rayleigh
from tasmania_tpu_torch.framework.field import FieldArray
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
from tasmania_tpu_torch.ops.kessler_step import (
    KesslerConstants,
    fused_kessler_rk2,
    fused_kessler_rk2_plain,
    fused_kessler_satadj_rk2,
    fused_kessler_satadj_rk2_plain,
    fused_satadj_rk2,
    fused_satadj_rk2_plain,
)
from tasmania_tpu_torch.ops.paste import paste_x_edges, paste_x_edges_multi, paste_x_edges_multi_plain
from tasmania_tpu_torch.ops.sedimentation_step import (
    fused_sedimentation_rk3ws,
    fused_sedimentation_rk3ws_plain,
)
from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage, si_stage_plain
from tasmania_tpu_torch.ops.smagorinsky_step import (
    fused_smagorinsky_rk2,
    fused_smagorinsky_rk2_plain,
    smag_stage,
    smagorinsky_stage_plain,
)
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
from tasmania_tpu_torch.ops.vertical_advection_step import (
    fused_vertical_advection_rk3ws,
    fused_vertical_advection_rk3ws_plain,
)

NX, NY, NZ, NB, NR = 19, 21, 8, 3, 6
FRACS = (1.0 / 3.0, 0.5, 1.0)
DTF = 10.0
CONSTS = dict(dx=5e3, dy=4e3, eps=0.5, pt=2000.0, dz=10.0, g=9.80665, cp=1004.0,
              rd=287.05, pref=1e5)


def tensor(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def stage_inputs(seed):
    """Random stage inputs (numpy) at the test geometry, with the relaxed-BC
    γ and the Rayleigh profile of a real domain."""
    rng = np.random.default_rng(seed)

    def f(*shape, lo=0.5, hi=1.5):
        return rng.uniform(lo, hi, shape)

    domain = Domain(
        (0.0, 1e5), NX, (0.0, 1e5), NY, FieldArray(np.array([400.0, 300.0]), "K", ("z",)), NZ,
        horizontal_boundary_type="relaxed", nb=NB, horizontal_boundary_kwargs={"nr": NR},
    )
    damper = Rayleigh(domain.numerical_grid, 4, 0.05)
    cell = (NX, NY, NZ)
    return dict(
        u=f(NX + 1, NY, NZ, lo=-4, hi=12),
        v=f(NX, NY + 1, NZ, lo=-6, hi=6),
        s_now=f(*cell, lo=5, hi=10),
        s_int=f(*cell, lo=5, hi=10),
        q_now=[f(*cell, lo=-1e-4, hi=1e-3) for _ in range(3)],
        q_int=[f(*cell, lo=-1e-4, hi=1e-3) for _ in range(3)],
        su_now=f(*cell, lo=20, hi=80),
        sv_now=f(*cell, lo=-20, hi=20),
        su_int=f(*cell, lo=20, hi=80),
        sv_int=f(*cell, lo=-20, hi=20),
        mtg_now=f(*cell, lo=1e5, hi=3e5),
        hs=f(NX, NY, lo=0, hi=300),
        theta=np.linspace(400.0, 300.0, NZ + 1),
        gamma=domain.horizontal_boundary.gamma[:NX, :NY].numpy(),
        s_ref=f(*cell, lo=5, hi=10),
        su_ref=f(*cell, lo=20, hi=80),
        sv_ref=f(*cell, lo=-20, hi=20),
        q_refs=[f(*cell, lo=0, hi=1e-3) for _ in range(3)],
        rmat=damper.rmat.numpy(),
        dd=damper.dd,
    )


def port_args(inp, damp, device="cpu"):
    keys = ("u", "v", "s_now", "s_int", "q_now", "q_int", "su_now", "sv_now", "su_int",
            "sv_int", "mtg_now", "hs", "theta", "gamma", "s_ref", "su_ref", "sv_ref", "q_refs")
    args = [[tensor(a, device) for a in inp[k]] if isinstance(inp[k], list) else tensor(inp[k], device)
            for k in keys]
    return args + [tensor(inp["rmat"], device) if damp else None]


def advection_inputs(seed):
    """Stage inputs (numpy) for the two-kernel stage: those of
    :func:`stage_inputs`, tendencies of s, the three water densities and the
    momenta, the stepped density ``s_e``, its Montgomery potential ``mtg``
    and the stepped water densities ``sqs``."""
    inp = stage_inputs(seed)
    rng = np.random.default_rng(seed + 1000)
    cell = (NX, NY, NZ)
    inp.update(
        tnds=[rng.normal(0.0, 1e-3, cell)] + [rng.normal(0.0, 1e-6, cell) for _ in range(3)],
        su_tnd=rng.normal(0.0, 0.1, cell),
        sv_tnd=rng.normal(0.0, 0.1, cell),
        s_e=rng.uniform(5.0, 10.0, cell),
        mtg=rng.uniform(1e5, 3e5, cell),
        sqs=[rng.uniform(-1e-4, 1e-2, cell) for _ in range(3)],
    )
    return inp


def advection_args(inp, tendencies, enforce, device="cpu"):
    """(positional args, keyword args) of ``fused_advection_fields`` for s
    and the three mass fractions."""
    t = lambda a: tensor(a, device)
    args = (
        t(inp["u"]), t(inp["v"]),
        [t(inp["s_now"])] + [t(a) for a in inp["q_now"]],
        [t(inp["s_int"])] + [t(a) for a in inp["q_int"]],
        [t(a) for a in inp["tnds"]] if tendencies else None,
        t(inp["gamma"]) if enforce else None,
        t(inp["s_ref"]) if enforce else None,
    )
    kw = dict(nb=NB, dt=FRACS[1] * DTF, dx=CONSTS["dx"], dy=CONSTS["dy"],
              q_product=(False, True, True, True))
    return args, kw


def epilogue_args(inp, damp, tendencies, device="cpu"):
    """Positional args of ``fused_momentum_epilogue``."""
    t = lambda a: tensor(a, device)
    return (
        *(t(inp[k]) for k in ("u", "v", "su_now", "sv_now", "su_int", "sv_int", "s_now",
                              "mtg_now", "s_e", "mtg")),
        [t(a) for a in inp["sqs"]],
        *(t(inp[k]) for k in ("gamma", "s_ref", "su_ref", "sv_ref")),
        [t(a) for a in inp["q_refs"]],
        t(inp["rmat"]) if damp else None,
        t(inp["su_tnd"]) if tendencies else None,
        t(inp["sv_tnd"]) if tendencies else None,
    )


# a grid one cell deep in y, as the one-dimensional relaxed boundary makes it:
# ny = 2 nb + 1, exactly one interior row
NY1 = 2 * NB + 1


def momentum_step_inputs(seed, ny=NY):
    """Numpy inputs of ``fused_momentum_step`` at (NX, ny, NZ): u, v (zero
    when ny is a single interior row, as on the one-dimensional boundary),
    the momenta now and int, s and mtg now and stepped, the tendencies."""
    rng = np.random.default_rng(seed)
    cell = (NX, ny, NZ)
    v = np.zeros((NX, ny + 1, NZ)) if ny == NY1 else rng.uniform(-6, 6, (NX, ny + 1, NZ))
    return dict(
        u=rng.uniform(-4, 12, (NX + 1, ny, NZ)), v=v,
        su_now=rng.uniform(20, 80, cell), sv_now=rng.uniform(-20, 20, cell),
        su_int=rng.uniform(20, 80, cell), sv_int=rng.uniform(-20, 20, cell),
        s_now=rng.uniform(5, 10, cell), mtg_now=rng.uniform(1e5, 3e5, cell),
        s_new=rng.uniform(5, 10, cell), mtg_new=rng.uniform(1e5, 3e5, cell),
        su_tnd=rng.normal(0.0, 0.1, cell), sv_tnd=rng.normal(0.0, 0.1, cell),
    )


def momentum_step_args(inp, tendencies, device="cpu"):
    t = lambda a: tensor(a, device)
    keys = ("u", "v", "su_now", "sv_now", "su_int", "sv_int", "s_now", "mtg_now", "s_new", "mtg_new")
    return tuple(t(inp[k]) for k in keys) + (
        (t(inp["su_tnd"]), t(inp["sv_tnd"])) if tendencies else (None, None))


def diagnostics_inputs(seed, ny=NY):
    """(s, hs, theta) in numpy: a column from θ = 400 K at the top to 300 K
    at the surface, a density that makes the pressure grow from 2000 Pa to
    about 1e5 Pa, a topography up to 300 m."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(50.0, 150.0, (NX, ny, NZ)), rng.uniform(0.0, 300.0, (NX, ny)),
            np.linspace(400.0, 300.0, NZ + 1))


DIAG_CONSTS = dict(pt=2000.0, dz=12.5, g=9.80665, cp=1004.0, rd=287.05, pref=1e5)


def smoothing_inputs(seed, nf=6):
    rng = np.random.default_rng(seed)
    fields = [rng.normal(size=(NX, NY, NZ)) * 10.0 ** rng.integers(-3, 3) for _ in range(nf)]
    gamma = rng.uniform(0.0, 1.0, (nf, NZ))
    return fields, gamma


# the moist physics' geometry: nx >= 2 nb + 16, so that the TPU Smagorinsky
# entry takes its one-kernel path at tile_x = 8
PX, PY, PZ = 25, 21, 16
KESSLER = KesslerConstants(
    a=1e-4, k1=1e-3, k2=2.2, sr=0.025, beta=287.05 / 461.52, lhvw=2.5e6, cp=1004.0,
    rv=461.52, dt=5.0,
)
SMAG = dict(dx=2200.0, dy=2150.0, cs=0.18, nb=3, dt=5.0)


def kessler_inputs(seed):
    """(rho, t, p_if, exn_if, qv, qc, qr) in numpy reaching every branch of the
    scheme: T 250-300 K, p 1e4-1e5 Pa, qv on both sides of saturation, qc on
    both sides of the threshold 1e-4 (a tenth of it zero), qr with zeros and
    a few negatives.  Saturation adjustment alone takes (t, p_if, exn_if, qv,
    qc) and a θ-tendency (:func:`theta_tendency`)."""
    rng = np.random.default_rng(seed)
    cell, iface = (PX, PY, PZ), (PX, PY, PZ + 1)
    t = rng.uniform(250.0, 300.0, cell)
    p_if = rng.uniform(1e4, 1e5, iface)
    exn_if = 1004.0 * (p_if / 1e5) ** (287.05 / 1004.0)
    p = 0.5 * (p_if[..., :-1] + p_if[..., 1:])
    qvs = KESSLER.beta * 610.78 * np.exp(17.27 * (t - 273.16) / (t - 35.86)) / p
    qv = qvs * rng.uniform(0.8, 1.2, cell)
    qc = rng.uniform(0.0, 3e-4, cell) * (rng.uniform(size=cell) > 0.1)
    qr = rng.uniform(-1e-6, 1e-3, cell) * (rng.uniform(size=cell) > 0.3)
    rho = rng.uniform(0.3, 1.3, cell)
    return rho, t, p_if, exn_if, qv, qc, qr


def theta_tendency(seed):
    """A θ-tendency in numpy, the input saturation adjustment adds to."""
    return np.random.default_rng(seed + 500).normal(0.0, 1e-3, (PX, PY, PZ))


def satadj_inputs(seed):
    """(t, p_if, exn_if, qv, qc, θ-tendency) in numpy."""
    _, t, p_if, exn_if, qv, qc, _ = kessler_inputs(seed)
    return t, p_if, exn_if, qv, qc, theta_tendency(seed)


def smagorinsky_inputs(seed):
    """(s, su, sv) in numpy: a sheared flow with noise."""
    rng = np.random.default_rng(seed)
    cell = (PX, PY, PZ)
    s = rng.uniform(5.0, 10.0, cell)
    su = s * (10.0 + 5.0 * np.sin(np.arange(PY) / 3.0)[None, :, None] + rng.normal(0, 2.0, cell))
    sv = s * rng.normal(0.0, 3.0, cell)
    return s, su, sv


def vertical_advection_inputs(seed):
    """(w, s, su, sv, qv, qc, qr) in numpy; w = dθ/dt of both signs."""
    rng = np.random.default_rng(seed)
    cell = (PX, PY, PZ)
    w = rng.normal(0.0, 0.05, cell)
    s = rng.uniform(5.0, 10.0, cell)
    su = rng.uniform(20.0, 80.0, cell)
    sv = rng.uniform(-20.0, 20.0, cell)
    qv = rng.uniform(1e-3, 1e-2, cell)
    qc = rng.uniform(0.0, 1e-3, cell)
    qr = rng.uniform(0.0, 1e-3, cell) * (rng.uniform(size=cell) > 0.3)
    return w, s, su, sv, qv, qc, qr


def sedimentation_inputs(seed):
    """(rho, h_if, qr) in numpy: density growing and heights falling towards
    the surface (the last level), qr with zeros and a few negatives."""
    rng = np.random.default_rng(seed)
    cell = (PX, PY, PZ)
    rho = np.sort(rng.uniform(0.3, 1.3, cell), axis=-1)
    dh = rng.uniform(100.0, 400.0, (PX, PY, PZ))
    h_if = np.zeros((PX, PY, PZ + 1))
    h_if[..., PZ] = rng.uniform(0.0, 500.0, (PX, PY))
    h_if[..., :PZ] = h_if[..., PZ:] + np.cumsum(dh[..., ::-1], axis=-1)[..., ::-1]
    qr = rng.uniform(-1e-6, 2e-3, cell) * (rng.uniform(size=cell) > 0.3)
    return rho, h_if, qr


def assert_scaled(got, ref, atol, what):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, what
    scale = np.max(np.abs(ref)) or 1.0
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_paste_kernel_bitwise(cuda_device, dtype):
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=cuda_device)
    fulls = [mk(NX, NY, NZ) for _ in range(6)]
    lo = [mk(NB, NY, NZ) for _ in range(6)]
    hi = [mk(NB, NY, NZ) for _ in range(6)]
    ref = paste_x_edges_multi_plain([f.clone() for f in fulls], lo, hi)
    got = paste_x_edges_multi(fulls, lo, hi)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_single_paste_kernel_bitwise(cuda_device, dtype):
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype, device=cuda_device)
    full, lo, hi = mk(NX, NY, NZ), mk(NB, NY, NZ), mk(NB, NY, NZ)
    ref = paste_x_edges_multi_plain([full.clone()], [lo], [hi])[0]
    got = paste_x_edges(full, lo, hi)
    assert got is full
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 3])
def test_smoothing_kernel_vs_plain(cuda_device, order):
    fields, gamma = smoothing_inputs(seed=order)
    tf = [tensor(a, cuda_device) for a in fields]
    g = tensor(gamma, cuda_device)
    got = fused_smoothing(tf, g, order=order, nb=NB)
    ref = fused_smoothing_plain(tf, g, order=order, nb=NB)
    for a, b in zip(got, ref):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-13, f"order {order}")


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("damp", [True, False])
def test_si_stage_kernel_vs_plain(cuda_device, damp, stage):
    inp = stage_inputs(seed=5 + stage)
    c = StageConstants(dt=FRACS[stage] * DTF, dtf=DTF, **CONSTS)
    args = port_args(inp, damp, cuda_device)
    dd = inp["dd"] if damp else 0
    got = si_stage(*args, nb=NB, c=c, dd=dd)
    ref = si_stage_plain(*args, nb=NB, c=c, dd=dd)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
def test_kessler_satadj_kernel_vs_plain(cuda_device):
    args = [tensor(a, cuda_device) for a in kessler_inputs(seed=1)]
    got = fused_kessler_satadj_rk2(*args, KESSLER)
    ref = fused_kessler_satadj_rk2_plain(*args, KESSLER)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
def test_kessler_kernel_vs_plain(cuda_device):
    args = [tensor(a, cuda_device) for a in kessler_inputs(seed=3)]
    got = fused_kessler_rk2(*args, KESSLER)
    ref = fused_kessler_rk2_plain(*args, KESSLER)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
def test_satadj_kernel_vs_plain(cuda_device):
    args = [tensor(a, cuda_device) for a in satadj_inputs(seed=4)]
    got = fused_satadj_rk2(*args, KESSLER)
    ref = fused_satadj_rk2_plain(*args, KESSLER)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("enforce", [True, False])
def test_advection_fields_kernel_vs_plain(cuda_device, dtype, tendencies, enforce, order):
    args, kw = advection_args(advection_inputs(seed=8), tendencies, enforce, cuda_device)
    kw["order"] = order
    args = _cast(args, dtype)
    got = fused_advection_fields(*args, **kw)
    ref = fused_advection_fields_plain(*args, **kw)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"field {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("ny", [NY, NY1])
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("tendencies", [True, False])
def test_momentum_step_kernel_vs_plain(cuda_device, tendencies, order, ny, dtype):
    args = _cast(momentum_step_args(momentum_step_inputs(seed=order + ny, ny=ny), tendencies,
                                    cuda_device), dtype)
    kw = dict(order=order, nb=NB, dt=FRACS[1] * DTF, dx=CONSTS["dx"], dy=CONSTS["dy"], eps=0.5)
    got = fused_momentum_step(*args, **kw)
    ref = fused_momentum_step_plain(*args, **kw)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    # su and sv to the momentum vector's scale (float32: the pressure
    # gradient differences the large Montgomery potential)
    scale = max(float(r.abs().max()) for r in ref)
    for k, (a, b) in enumerate(zip(got, ref)):
        err = float((a.double() - b.double()).abs().max())
        assert err <= tol * scale, f"output {k}: {err} > {tol} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mtg", "dry", "moist"])
def test_diagnostics_kernel_vs_plain(cuda_device, mode):
    s, hs, theta = (tensor(a, cuda_device) for a in diagnostics_inputs(seed=6))
    got = fused_isentropic_diagnostics(s, hs, theta, mode=mode, **DIAG_CONSTS)
    ref = fused_isentropic_diagnostics_plain(s, hs, theta, mode=mode, **DIAG_CONSTS)
    got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
    assert len(got) == len(ref) == {"mtg": 1, "dry": 4, "moist": 6}[mode]
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("damp", [True, False])
@pytest.mark.parametrize("tendencies", [True, False])
def test_momentum_epilogue_kernel_vs_plain(cuda_device, damp, tendencies):
    inp = advection_inputs(seed=9)
    args = epilogue_args(inp, damp, tendencies, cuda_device)
    c = StageConstants(dt=FRACS[2] * DTF, dtf=DTF, **CONSTS)
    got = fused_momentum_epilogue(*args, nb=NB, c=c)
    ref = fused_momentum_epilogue_plain(*args, nb=NB, c=c)
    assert len(got) == len(ref) == 6
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


def _cast(args, dtype):
    """``args`` with every tensor (also inside lists) cast to ``dtype``."""
    def cast(a):
        if isinstance(a, list):
            return [cast(x) for x in a]
        return a.to(dtype) if isinstance(a, torch.Tensor) else a
    return tuple(cast(a) for a in args)


@pytest.mark.cuda
def test_smagorinsky_kernel_vs_plain(cuda_device):
    args = [tensor(a, cuda_device) for a in smagorinsky_inputs(seed=2)]
    got = fused_smagorinsky_rk2(*args, **SMAG)
    ref = fused_smagorinsky_rk2_plain(*args, **SMAG)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("moist", [True, False])
def test_vertical_advection_kernel_vs_plain(cuda_device, order, moist):
    w, s, su, sv, *q = [tensor(a, cuda_device) for a in vertical_advection_inputs(seed=order)]
    q = q if moist else ()
    got = fused_vertical_advection_rk3ws(w, s, su, sv, q, order=order, dt=5.0, dz=1.0)
    ref = fused_vertical_advection_rk3ws_plain(w, s, su, sv, q, order=order, dt=5.0, dz=1.0)
    assert len(got) == len(ref) == (6 if moist else 3)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
def test_sedimentation_kernel_vs_plain(cuda_device, order, vt_mode):
    args = [tensor(a, cuda_device) for a in sedimentation_inputs(seed=order)]
    got = fused_sedimentation_rk3ws(*args, order=order, dt=5.0, vt_mode=vt_mode)
    ref = fused_sedimentation_rk3ws_plain(*args, order=order, dt=5.0, vt_mode=vt_mode)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")


@pytest.mark.cuda
def test_smagorinsky_stage_kernel_vs_plain(cuda_device):
    s, su, sv = (tensor(a, cuda_device) for a in smagorinsky_inputs(seed=5))
    kw = {k: SMAG[k] for k in ("dx", "dy", "cs", "nb")}
    su1, sv1 = su * 1.01, sv + 0.5 * s
    got = smag_stage(s, su1, sv1, su, sv, c=SMAG["dt"], **kw)
    ref = smagorinsky_stage_plain(s, su1, sv1, su, sv, c=SMAG["dt"], **kw)
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")
