"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests import neither JAX nor the JAX package, so they also run on a GPU
machine without them; without a CUDA device they skip.  On the GPU machine::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

Tolerances, float64: paste bitwise (N arrays and one); smoothing within
1e-13 and the stage (third and fifth order) within 1e-12 of the largest
magnitude of the output (FMA contraction), both also in float32 (1e-6; 1e-5, su and sv of the momentum
vector's) and on a ragged shape, every cell compared, frame included; the
stage's distributed mode the same on the 41x41x20 blocks of a corner, an
edge and an interior shard of a 3x3 grid of ranks, and its single-device
mode bit for bit its distributed mode's trivial shard; the
kernels of the stages that do not run whole (advection of the fields at third and fifth order, the momentum step at
both orders on a two-dimensional grid, on one a single row deep and on the
ragged 37x29x13, the
momentum epilogue), the isentropic diagnostics in their three modes, the
Kessler and saturation-adjustment steps (the pair and each alone),
Smagorinsky (both stages, and one stage alone), vertical advection and
sedimentation within 1e-12 of the output's largest magnitude (FMA
contraction, and PyTorch's division by a scalar on the card, a product with
the reciprocal); the advection of the fields and the momentum step also in
float32, within 1e-5; the advection of the fields (F = 1 and 4, at both
orders, some tendencies None) and the momentum epilogue (float32 within 1e-5,
su and sv of the momentum vector's; nq 0 and 3; both orders) also on the shapes their
column tiles make hard, 23x19x130 and the one-row grid; Smagorinsky and vertical advection also in float32
and on the ragged shape, within 1e-5 of their update plus 4 ulps; the
diagnostics also in float32 (1e-5, rho 4e-5), at 130 levels, on one row
and, in float64, at 600 levels; sedimentation also in float32 (1e-5), on
the ragged shape and at 150 levels.  The two merged kernels (smoothing + Smagorinsky RK2,
vertical advection + sedimentation) in float64 within 1e-12 and in float32
with the gates of the kernels they merge (``chip_smoke.py`` phase 3), on the
shapes their tiles make hard (37x37x121; 121, 130 and 260 levels), and bit
for bit against their two kernels run in turn, whose device code they share.
The column kernels' tall path (``csrc/tall_column.cu``, above the fused
kernels' 1024 levels, 2048 for sedimentation) at 1100 and 2100 levels of 4x3
columns with the fused kernels' gates, counted under its own name; the fused
kernels still taking their tallest columns; the wrappers naming their cell
limit.  Each kernel of the y-z slice's path (``chip_smoke.py``'s sus_yz) on
its 7-column grids, 7x41x20 in both types and 7x161x120 in float32, with
the gates above.  The fused loop: a CUDA graph of the step equal to the
eager run bit for bit (every coupling, sus and fc at third order, sus on
the periodic boundary, sus with Coriolis and the implicit vertical
advection, fc with Coriolis at 41x41x20, sus on a 1x41x20 y-z slice and
over the Schaer mountain, the mountain wave, Burgers, 1 + 5 steps),
its captured step launching ``chip_smoke.py``'s ``LAUNCHES_PER_STEP``.
Checkpoints: an eager run resumed from a checkpoint equal to the
uninterrupted run bit for bit, and card fields restored onto the CPU.  The
graph by default: the SUS driver with no mode given captures a graph, its
checkpoints equal the eager run's bit for bit, a resume ends on the
uninterrupted bits and a NaN through a device counter trips the guard as
eagerly.  The
input helpers here are shared with ``tests/test_torch_ops.py``,
``tests/test_torch_physics_ops.py`` and ``tests/test_torch_merges.py``.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

from tasmania_tpu_torch.domain.domain import Domain
from tasmania_tpu_torch.dwarfs.vertical_damping import Rayleigh
from tasmania_tpu_torch.framework.field import FieldArray
from tasmania_tpu_torch.framework.options import StorageOptions
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
from tasmania_tpu_torch.ops import _lib
from tasmania_tpu_torch.ops.sedimentation_step import MAX_CELLS
from tasmania_tpu_torch.ops.sedimentation_step import MAX_NZ as SED_MAX_NZ
from tasmania_tpu_torch.ops.sedimentation_step import (
    fused_sedimentation_rk3ws,
    fused_sedimentation_rk3ws_plain,
)
from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage, si_stage_plain
from tasmania_tpu_torch.parallel.distributed import window
from tasmania_tpu_torch.parallel.mesh import CartesianDecomposition, RankGrid
from tasmania_tpu_torch.ops.smagorinsky_step import (
    fused_smagorinsky_rk2,
    fused_smagorinsky_rk2_plain,
    fused_smoothing_smagorinsky_rk2,
    fused_smoothing_smagorinsky_rk2_plain,
    smag_stage,
    smagorinsky_stage_plain,
)
from tasmania_tpu_torch.ops.smoothing_step import fused_smoothing, fused_smoothing_plain
from tasmania_tpu_torch.ops.vertical_advection_step import MAX_NZ as VADV_MAX_NZ
from tasmania_tpu_torch.ops.vertical_advection_step import (
    VADV_SED_MAX_NZ,
    fused_vadv_sedimentation_rk3ws,
    fused_vadv_sedimentation_rk3ws_plain,
    fused_vertical_advection_rk3ws,
    fused_vertical_advection_rk3ws_plain,
)

NX, NY, NZ, NB, NR = 19, 21, 8, 3, 6
# the domain's constant fields on the CPU (the port allocates on the card by default)
CPU64 = StorageOptions(dtype=torch.float64, device="cpu")
FRACS = (1.0 / 3.0, 0.5, 1.0)
DTF = 10.0
CONSTS = dict(dx=5e3, dy=4e3, eps=0.5, pt=2000.0, dz=10.0, g=9.80665, cp=1004.0,
              rd=287.05, pref=1e5)


def tensor(a, device="cpu"):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def stage_inputs(seed, shape=(NX, NY, NZ)):
    """Random stage inputs (numpy) at the test geometry (or ``shape``), with
    the relaxed-BC γ and the Rayleigh profile of a real domain (its relaxation
    zone NR cells wide, narrower where the grid is: the one-row grid)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = cell = shape

    def f(*shape, lo=0.5, hi=1.5):
        return rng.uniform(lo, hi, shape)

    domain = Domain(
        (0.0, 1e5), nx, (0.0, 1e5), ny, FieldArray(np.array([400.0, 300.0]), "K", ("z",)), nz,
        horizontal_boundary_type="relaxed", nb=NB,
        horizontal_boundary_kwargs={"nr": min(NR, nx // 2, ny // 2)},
        storage_options=CPU64,
    )
    damper = Rayleigh(domain.numerical_grid, 4, 0.05, storage_options=CPU64)
    return dict(
        u=f(nx + 1, ny, nz, lo=-4, hi=12),
        v=f(nx, ny + 1, nz, lo=-6, hi=6),
        s_now=f(*cell, lo=5, hi=10),
        s_int=f(*cell, lo=5, hi=10),
        q_now=[f(*cell, lo=-1e-4, hi=1e-3) for _ in range(3)],
        q_int=[f(*cell, lo=-1e-4, hi=1e-3) for _ in range(3)],
        su_now=f(*cell, lo=20, hi=80),
        sv_now=f(*cell, lo=-20, hi=20),
        su_int=f(*cell, lo=20, hi=80),
        sv_int=f(*cell, lo=-20, hi=20),
        mtg_now=f(*cell, lo=1e5, hi=3e5),
        hs=f(nx, ny, lo=0, hi=300),
        theta=np.linspace(400.0, 300.0, nz + 1),
        gamma=domain.horizontal_boundary.gamma[:nx, :ny].numpy(),
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


def advection_inputs(seed, shape=(NX, NY, NZ)):
    """Stage inputs (numpy) for the two-kernel stage at the test geometry (or
    ``shape``): those of :func:`stage_inputs`, tendencies of s, the three
    water densities and the momenta, the stepped density ``s_e``, its
    Montgomery potential ``mtg`` and the stepped water densities ``sqs``."""
    inp = stage_inputs(seed, shape)
    rng = np.random.default_rng(seed + 1000)
    cell = shape
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


def momentum_step_inputs(seed, ny=NY, shape=None):
    """Numpy inputs of ``fused_momentum_step`` at (NX, ny, NZ) (or
    ``shape``): u, v (zero when ny is a single interior row, as on the
    one-dimensional boundary), the momenta now and int, s and mtg now and
    stepped, the tendencies."""
    rng = np.random.default_rng(seed)
    cell = shape or (NX, ny, NZ)
    nx, ny, nz = cell
    v = np.zeros((nx, ny + 1, nz)) if ny == NY1 else rng.uniform(-6, 6, (nx, ny + 1, nz))
    return dict(
        u=rng.uniform(-4, 12, (nx + 1, ny, nz)), v=v,
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


def diagnostics_inputs(seed, ny=NY, shape=None):
    """(s, hs, theta) in numpy at (NX, ny, NZ) (or ``shape``): a column from
    θ = 400 K at the top to 300 K at the surface, a density that makes the
    pressure grow from 2000 Pa by about 1.2e4 Pa a level (to about 1e5 Pa at
    NZ levels), a topography up to 300 m."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape or (NX, ny, NZ)
    return (rng.uniform(50.0, 150.0, (nx, ny, nz)), rng.uniform(0.0, 300.0, (nx, ny)),
            np.linspace(400.0, 300.0, nz + 1))


DIAG_CONSTS = dict(pt=2000.0, dz=12.5, g=9.80665, cp=1004.0, rd=287.05, pref=1e5)


def smoothing_inputs(seed, nf=6, shape=(NX, NY, NZ)):
    rng = np.random.default_rng(seed)
    fields = [rng.normal(size=shape) * 10.0 ** rng.integers(-3, 3) for _ in range(nf)]
    gamma = rng.uniform(0.0, 1.0, (nf, shape[2]))
    return fields, gamma


# the moist physics' geometry: nx >= 2 nb + 16, so that the TPU Smagorinsky
# entry takes its one-kernel path at tile_x = 8
PX, PY, PZ = 25, 21, 16
KESSLER = KesslerConstants(
    a=1e-4, k1=1e-3, k2=2.2, sr=0.025, beta=287.05 / 461.52, lhvw=2.5e6, cp=1004.0,
    rv=461.52, dt=5.0,
)
SMAG = dict(dx=2200.0, dy=2150.0, cs=0.18, nb=3, dt=5.0)


def kessler_inputs(seed, shape=(PX, PY, PZ)):
    """(rho, t, p_if, exn_if, qv, qc, qr) in numpy reaching every branch of the
    scheme: T 250-300 K, p 1e4-1e5 Pa, qv on both sides of saturation, qc on
    both sides of the threshold 1e-4 (a tenth of it zero), qr with zeros and
    a few negatives.  Saturation adjustment alone takes (t, p_if, exn_if, qv,
    qc) and a θ-tendency (:func:`theta_tendency`)."""
    rng = np.random.default_rng(seed)
    cell, iface = shape, (*shape[:2], shape[2] + 1)
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


def smagorinsky_inputs(seed, shape=(PX, PY, PZ)):
    """(s, su, sv) in numpy: a sheared flow with noise."""
    rng = np.random.default_rng(seed)
    cell = shape
    s = rng.uniform(5.0, 10.0, cell)
    su = s * (10.0 + 5.0 * np.sin(np.arange(cell[1]) / 3.0)[None, :, None] + rng.normal(0, 2.0, cell))
    sv = s * rng.normal(0.0, 3.0, cell)
    return s, su, sv


def vertical_advection_inputs(seed, shape=(PX, PY, PZ)):
    """(w, s, su, sv, qv, qc, qr) in numpy; w = dθ/dt of both signs."""
    rng = np.random.default_rng(seed)
    cell = shape
    w = rng.normal(0.0, 0.05, cell)
    s = rng.uniform(5.0, 10.0, cell)
    su = rng.uniform(20.0, 80.0, cell)
    sv = rng.uniform(-20.0, 20.0, cell)
    qv = rng.uniform(1e-3, 1e-2, cell)
    qc = rng.uniform(0.0, 1e-3, cell)
    qr = rng.uniform(0.0, 1e-3, cell) * (rng.uniform(size=cell) > 0.3)
    return w, s, su, sv, qv, qc, qr


def sedimentation_inputs(seed, shape=(PX, PY, PZ)):
    """(rho, h_if, qr) in numpy: density growing and heights falling towards
    the surface (the last level), qr with zeros and a few negatives."""
    rng = np.random.default_rng(seed)
    cell = shape
    nx, ny, nz = shape
    rho = np.sort(rng.uniform(0.3, 1.3, cell), axis=-1)
    dh = rng.uniform(100.0, 400.0, cell)
    h_if = np.zeros((nx, ny, nz + 1))
    h_if[..., nz] = rng.uniform(0.0, 500.0, (nx, ny))
    h_if[..., :nz] = h_if[..., nz:] + np.cumsum(dh[..., ::-1], axis=-1)[..., ::-1]
    qr = rng.uniform(-1e-6, 2e-3, cell) * (rng.uniform(size=cell) > 0.3)
    return rho, h_if, qr


def smooth_smag_inputs(seed, nf, shape=(33, 21, 8)):
    """(fields, gamma) in numpy for the merged smoothing + Smagorinsky: a
    density of 5-10, momenta of a sheared flow with noise, nf - 3 mass
    fractions of 1e-3, coefficients in [0.2, 0.7)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape
    s = rng.uniform(5.0, 10.0, shape)
    su = s * (10.0 + 5.0 * np.sin(np.arange(ny) / 3.0)[None, :, None] + rng.normal(0.0, 2.0, shape))
    sv = s * rng.normal(0.0, 3.0, shape)
    q = [rng.uniform(0.0, 1e-3, shape) for _ in range(nf - 3)]
    return [s, su, sv] + q, 0.2 + 0.5 * rng.random((nf, nz))


def vadv_sed_inputs(seed, shape=(PX, PY, PZ)):
    """(w, s, su, sv, qv, qc, qr, rho, h_if) in numpy (25x21x16 unless
    ``shape``) for the merged vertical advection + sedimentation, with rain
    everywhere: where the advected qr lands within rounding of zero, the fall
    velocity's max(qr, 0)^0.1346 tells two roundings apart (a difference of
    1e-20 in qr is one of 2e-3 in vt)."""
    w, s, su, sv, qv, qc, _ = vertical_advection_inputs(seed, shape)
    rho, h_if, _ = sedimentation_inputs(seed + 100, shape)
    qr = np.random.default_rng(seed + 200).uniform(1e-4, 1e-3, s.shape)
    return w, s, su, sv, qv, qc, qr, rho, h_if


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


# a shape that leaves partial tiles: nx and ny not multiples of the kernels'
# 8-column tiles, nz not a multiple of their level runs (8 and 32)
RAGGED = (23, 19, 13)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(NX, NY, NZ), RAGGED])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_smoothing_kernel_vs_plain(cuda_device, order, shape, dtype):
    """Every cell, frame included: float64 within 1e-13 of each output's
    largest magnitude, float32 within 1e-6 (``chip_smoke.py`` phase 3)."""
    fields, gamma = smoothing_inputs(order, shape=shape)
    tf = [tensor(a, cuda_device).to(dtype) for a in fields]
    g = tensor(gamma, cuda_device).to(dtype)
    got = fused_smoothing(tf, g, order=order, nb=NB)
    ref = fused_smoothing_plain(tf, g, order=order, nb=NB)
    tol = 1e-13 if dtype == torch.float64 else 1e-6
    for a, b in zip(got, ref):
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"order {order}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(NX, NY, NZ), RAGGED])
@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("damp", [True, False])
@pytest.mark.parametrize("order", [3, 5])
def test_si_stage_kernel_vs_plain(cuda_device, order, damp, stage, shape, dtype):
    """Every cell, frame included, at both orders: float64 within 1e-12 of
    each output's largest magnitude; float32 within 1e-5, su and sv of the
    momentum vector's (``chip_smoke.py`` phase 3: the pressure gradient
    differences the large Montgomery potential)."""
    inp = stage_inputs(5 + stage, shape)
    c = StageConstants(dt=FRACS[stage] * DTF, dtf=DTF, **CONSTS)
    args = _cast(port_args(inp, damp, cuda_device), dtype)
    dd = inp["dd"] if damp else 0
    got = si_stage(*args, nb=NB, c=c, dd=dd, order=order)
    ref = si_stage_plain(*args, nb=NB, c=c, dd=dd, order=order)
    assert len(got) == len(ref) == 6
    if dtype == torch.float64:
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")
        return
    momentum = max(float(r.abs().max()) for r in ref[1:3])
    for k, (a, b) in enumerate(zip(got, ref)):
        scale = momentum if k in (1, 2) else float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        assert err <= 1e-5 * scale, f"output {k}: {err} > 1e-5 * {scale}"


def stage_windows(inp, decomp, rank):
    """``rank``'s halo-extended windows of global stage inputs (numpy), as
    the decomposed step hands them to the stage: the fields edge-padded
    outside the domain, γ zero-padded."""
    def cell(a, mode="edge"):
        return window(a, decomp, rank, pad_mode=mode)

    out = {k: cell(inp[k]) for k in ("s_now", "s_int", "su_now", "sv_now", "su_int",
                                      "sv_int", "mtg_now", "hs", "s_ref", "su_ref", "sv_ref")}
    out.update({k: [cell(a) for a in inp[k]] for k in ("q_now", "q_int", "q_refs")})
    out["u"] = window(inp["u"], decomp, rank, (True, False), pad_mode="edge")
    out["v"] = window(inp["v"], decomp, rank, (False, True), pad_mode="edge")
    out["gamma"] = cell(inp["gamma"], "constant")
    out.update(theta=inp["theta"], rmat=inp["rmat"], dd=inp["dd"])
    return out


# the distributed mode: a 3x3 grid of ranks, blocks 41x41x20 with the ring
# nb + 1 deep; rank 0 a corner shard, 1 an edge shard, 4 the interior one
DIST_GRID, DIST_PAD, DIST_NZ = RankGrid(3, 3), NB + 1, 20
DIST_N = 3 * (41 - 2 * (NB + 1))
DIST_SHARDS = {"corner": 0, "edge": 1, "interior": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shard", list(DIST_SHARDS))
@pytest.mark.parametrize("order", [3, 5])
def test_si_stage_dist_kernel_vs_plain(cuda_device, order, shard, dtype):
    """The distributed mode on a shard's 41x41x20 block, the last stage with
    damping: every cell within the gates of the single-device mode (float64
    1e-12, float32 1e-5, su and sv of the momentum vector's)."""
    inp = stage_inputs(7, (DIST_N, DIST_N, DIST_NZ))
    decomp = CartesianDecomposition(DIST_N, DIST_N, DIST_GRID, NB, DIST_PAD, DIST_PAD)
    rank = DIST_SHARDS[shard]
    w = stage_windows(inp, decomp, rank)
    assert w["s_now"].shape == (41, 41, DIST_NZ)
    c = StageConstants(dt=DTF, dtf=DTF, **CONSTS)
    args = _cast(port_args(w, True, cuda_device), dtype)
    dist = dict(dist=True, goff=decomp.offset(rank), gnx=DIST_N, gny=DIST_N)
    before = _lib.launch_counts["si_stage"]
    got = si_stage(*args, nb=NB, c=c, dd=w["dd"], order=order, **dist)
    assert _lib.launch_counts["si_stage"] == before + 1
    ref = si_stage_plain(*args, nb=NB, c=c, dd=w["dd"], order=order, **dist)
    momentum = max(float(r.abs().max()) for r in ref[1:3])
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for k, (a, b) in enumerate(zip(got, ref)):
        scale = momentum if k in (1, 2) else float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        assert err <= tol * scale, f"output {k}: {err} > {tol} * {scale}"


@pytest.mark.cuda
@pytest.mark.parametrize("order", [3, 5])
def test_si_stage_single_device_is_the_trivial_shard(cuda_device, order):
    """dist=False is the instance goff = (0, 0), gnx = nx, gny = ny of the
    distributed mode: the same kernel, bit for bit."""
    inp = stage_inputs(8, (NX, NY, NZ))
    c = StageConstants(dt=DTF, dtf=DTF, **CONSTS)
    args = _cast(port_args(inp, True, cuda_device), torch.float32)
    got = si_stage(*args, nb=NB, c=c, dd=inp["dd"], order=order)
    same = si_stage(*args, nb=NB, c=c, dd=inp["dd"], order=order, dist=True, goff=(0, 0),
                    gnx=NX, gny=NY)
    for a, b in zip(got, same):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


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


# the shapes the column tiles of the advection kernels make hard: 23x19x130
# (x and y not multiples of the 8-column tiles, runs of levels that are not
# whole 16-byte copies in float32) and the one-row grid of the
# one-dimensional relaxed boundary
TILE_SHAPES = [pytest.param((23, 19, 130), id="23x19x130"), pytest.param((NX, NY1, NZ), id="19x7x8")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TILE_SHAPES)
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nf", [1, 4])
def test_advection_fields_kernel_tiles(cuda_device, nf, dtype, order, shape):
    """The advection of the fields on the hard shapes: F = 1 (s alone, as on
    the mountain wave, no relaxed BC) and F = 4 (s and the three water
    species, the relaxed BC on s), tendencies given for the even fields
    only; every cell within the tolerances of
    ``test_advection_fields_kernel_vs_plain``."""
    args, kw = advection_args(advection_inputs(seed=10 + order, shape=shape), True, nf == 4,
                              cuda_device)
    now, ints, tnds = (a[:nf] for a in args[2:5])
    tnds = [t if f % 2 == 0 else None for f, t in enumerate(tnds)]
    args = _cast((*args[:2], now, ints, tnds, *args[5:]), dtype)
    kw.update(order=order, q_product=kw["q_product"][:nf])
    got = fused_advection_fields(*args, **kw)
    ref = fused_advection_fields_plain(*args, **kw)
    assert len(got) == len(ref) == nf
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"field {k}")


# the momentum step's shapes: the test geometry; its one-row grid; 37x29x13,
# several 8 x 4 column tiles in x and y straddling the frame and the ragged
# edge, and runs of levels that are not whole 16-byte copies
MOMENTUM_SHAPES = [pytest.param((NX, NY, NZ), id="19x21x8"), pytest.param((NX, NY1, NZ), id="19x7x8"),
                   pytest.param((37, 29, 13), id="37x29x13")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", MOMENTUM_SHAPES)
@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("tendencies", [True, False])
def test_momentum_step_kernel_vs_plain(cuda_device, tendencies, order, shape, dtype):
    args = _cast(momentum_step_args(momentum_step_inputs(seed=order + shape[1], shape=shape), tendencies,
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


# the diagnostics' shapes on the card: the test geometry; columns of 130
# levels (a column's run of s is not a whole number of 16-byte copies, so the
# tiles start at every alignment); the mountain wave's one interior row; a
# column so tall (nz = 600 in float64) that fewer columns than the kernel's
# default fill a block
DIAG_SHAPES = [
    *[pytest.param(shape, dtype, id=f"{name}-{str(dtype)[6:]}")
      for name, shape in (("19x21x8", (NX, NY, NZ)), ("23x19x130", (23, 19, 130)),
                          ("19x7x8", (NX, NY1, NZ)))
      for dtype in (torch.float32, torch.float64)],
    pytest.param((7, 5, 600), torch.float64, id="7x5x600-float64"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", DIAG_SHAPES)
@pytest.mark.parametrize("mode", ["mtg", "dry", "moist"])
def test_diagnostics_kernel_vs_plain(cuda_device, mode, shape, dtype):
    """float64 within 1e-12 of each output's largest magnitude; float32 with
    ``chip_smoke.py``'s gates: 1e-5, and 4e-5 on rho (``DIAG_RHO_TOL``)."""
    s, hs, theta = (tensor(a, cuda_device).to(dtype) for a in diagnostics_inputs(seed=6, shape=shape))
    got = fused_isentropic_diagnostics(s, hs, theta, mode=mode, **DIAG_CONSTS)
    ref = fused_isentropic_diagnostics_plain(s, hs, theta, mode=mode, **DIAG_CONSTS)
    got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
    assert len(got) == len(ref) == {"mtg": 1, "dry": 4, "moist": 6}[mode]
    for k, (a, b) in enumerate(zip(got, ref)):
        tol = 1e-12 if dtype == torch.float64 else (4e-5 if k == 4 else 1e-5)
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [pytest.param((NX, NY, NZ), id="19x21x8"), *TILE_SHAPES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nq", [3, 0])
@pytest.mark.parametrize("damp", [True, False])
@pytest.mark.parametrize("tendencies", [True, False])
@pytest.mark.parametrize("order", [3, 5])
def test_momentum_epilogue_kernel_vs_plain(cuda_device, order, damp, tendencies, nq, dtype, shape):
    """Without and with the water species, at both orders, on the test
    geometry and the shapes the column tiles make hard: float64 within
    1e-12 of each output's largest magnitude; float32 within 1e-5, su and
    sv of the momentum vector's (``chip_smoke.py`` phase 3: the pressure
    gradient differences the large Montgomery potential)."""
    args = list(epilogue_args(advection_inputs(seed=9, shape=shape), damp, tendencies, cuda_device))
    args[10], args[15] = args[10][:nq], args[15][:nq]  # sqs, q_refs
    args = _cast(tuple(args), dtype)
    c = StageConstants(dt=FRACS[2] * DTF, dtf=DTF, **CONSTS)
    got = fused_momentum_epilogue(*args, nb=NB, c=c, order=order)
    ref = fused_momentum_epilogue_plain(*args, nb=NB, c=c, order=order)
    assert len(got) == len(ref) == 3 + nq
    if dtype == torch.float64:
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")
        return
    momentum = max(float(r.abs().max()) for r in ref[1:3])
    for k, (a, b) in enumerate(zip(got, ref)):
        scale = momentum if k in (1, 2) else float(b.abs().max())
        err = float((a.double() - b.double()).abs().max())
        assert err <= 1e-5 * scale, f"output {k}: {err} > 1e-5 * {scale}"


def _cast(args, dtype):
    """``args`` with every tensor (also inside lists) cast to ``dtype``."""
    def cast(a):
        if isinstance(a, list):
            return [cast(x) for x in a]
        return a.to(dtype) if isinstance(a, torch.Tensor) else a
    return tuple(cast(a) for a in args)


def assert_updates(got, ref, base, dtype):
    """float64: every output within 1e-12 of its largest magnitude; float32:
    within 1e-5 of its update plus 4 ulps (``chip_smoke.py`` phase 3's gate
    for a small update on a large field)."""
    assert len(got) == len(ref) == len(base)
    for k, (a, b, c) in enumerate(zip(got, ref, base)):
        if dtype == torch.float64:
            assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")
        else:
            assert_increments(a, b, c, 1e-5, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(PX, PY, PZ), RAGGED])
@pytest.mark.parametrize("nb", [2, 3])
def test_smagorinsky_kernel_vs_plain(cuda_device, nb, shape, dtype):
    """Both stages in one launch, every cell, frame included; the ragged
    shape leaves partial tiles and takes the copies that are not 16-byte."""
    s, su, sv = [tensor(a, cuda_device).to(dtype) for a in smagorinsky_inputs(2, shape)]
    kw = {**SMAG, "nb": nb}
    got = fused_smagorinsky_rk2(s, su, sv, **kw)
    ref = fused_smagorinsky_rk2_plain(s, su, sv, **kw)
    assert_updates(got, ref, (su, sv), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(PX, PY, PZ), RAGGED])
@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("moist", [True, False])
def test_vertical_advection_kernel_vs_plain(cuda_device, order, moist, shape, dtype):
    w, s, su, sv, *q = [tensor(a, cuda_device).to(dtype)
                        for a in vertical_advection_inputs(order, shape)]
    q = tuple(q) if moist else ()
    got = fused_vertical_advection_rk3ws(w, s, su, sv, q, order=order, dt=5.0, dz=1.0)
    ref = fused_vertical_advection_rk3ws_plain(w, s, su, sv, q, order=order, dt=5.0, dz=1.0)
    assert len(got) == (6 if moist else 3)
    assert_updates(got, ref, (s, su, sv) + q, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(PX, PY, PZ), RAGGED, (9, 7, 150)])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
def test_sedimentation_kernel_vs_plain(cuda_device, order, vt_mode, shape, dtype):
    """float64 within 1e-12 of each output's largest magnitude, float32 within
    ``chip_smoke.py``'s 1e-5; at nz = 150 a thread takes two levels."""
    args = [tensor(a, cuda_device).to(dtype) for a in sedimentation_inputs(order, shape)]
    got = fused_sedimentation_rk3ws(*args, order=order, dt=5.0, vt_mode=vt_mode)
    ref = fused_sedimentation_rk3ws_plain(*args, order=order, dt=5.0, vt_mode=vt_mode)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(PX, PY, PZ), RAGGED])
@pytest.mark.parametrize("nb", [2, 3])
def test_smagorinsky_stage_kernel_vs_plain(cuda_device, nb, shape, dtype):
    s, su, sv = (tensor(a, cuda_device).to(dtype) for a in smagorinsky_inputs(5, shape))
    kw = {**{k: SMAG[k] for k in ("dx", "dy", "cs")}, "nb": nb}
    su1, sv1 = su * 1.01, sv + 0.5 * s
    got = smag_stage(s, su1, sv1, su, sv, c=SMAG["dt"], **kw)
    ref = smagorinsky_stage_plain(s, su1, sv1, su, sv, c=SMAG["dt"], **kw)
    assert_updates(got, ref, (su, sv), dtype)


def assert_increments(got, ref, base, tol, what, ulps=4):
    """max|got - ref| <= tol * max|ref - base| plus ``ulps`` units in the last
    place of max|ref|: a small update on a large field (``chip_smoke.py``'s
    gate for Smagorinsky and vertical advection)."""
    err = float((got - ref).abs().max())
    limit = tol * float((ref - base).abs().max()) + ulps * torch.finfo(ref.dtype).eps * float(ref.abs().max())
    assert err <= limit, f"{what}: {err} > {limit}"


# the merged kernels' hard shapes: smoothing + Smagorinsky's tiles (12 x 12
# columns, 16-byte level runs) partial in x, y and z; vertical advection +
# sedimentation at two and four levels a thread (nz 130 and 260)
SMOOTH_SMAG_SHAPES = [(33, 21, 8), (25, 29, 13), (37, 37, 121)]
VADV_SED_SHAPES = [(PX, PY, PZ), (7, 5, 121), (5, 4, 130), (3, 3, 260)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SMOOTH_SMAG_SHAPES)
@pytest.mark.parametrize("nf", [3, 6, 8])
@pytest.mark.parametrize("order", [1, 2, 3])
def test_smooth_smag_kernel_vs_plain(cuda_device, order, nf, shape, dtype):
    """float64: every output within 1e-12 of its largest magnitude; float32:
    the smoothed fields within 1e-6 (as the smoothing kernel's), the momenta
    within 1e-5 of their Smagorinsky update plus 4 ulps (as Smagorinsky's).
    The second and third shapes leave partial tiles in x, y and z."""
    fields, gamma = smooth_smag_inputs(order + nf, nf, shape)
    tf = [tensor(a, cuda_device).to(dtype) for a in fields]
    tg = tensor(gamma, cuda_device).to(dtype)
    kw = dict(order=order, nb=SMAG["nb"], dx=SMAG["dx"], dy=SMAG["dy"], cs=SMAG["cs"], dt=SMAG["dt"])
    got = fused_smoothing_smagorinsky_rk2(tf, tg, **kw)
    ref = fused_smoothing_smagorinsky_rk2_plain(tf, tg, **kw)
    assert len(got) == len(ref) == nf
    if dtype == torch.float64:
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.cpu().numpy(), b.cpu().numpy(), 1e-12, f"output {k}")
        return
    smoothed = fused_smoothing_plain(tf, tg, order=order, nb=SMAG["nb"])
    for k, (a, b) in enumerate(zip(got, ref)):
        if k in (1, 2):
            assert_increments(a, b, smoothed[k], 1e-5, f"momentum {k}")
        else:
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), 1e-6, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", SMOOTH_SMAG_SHAPES)
@pytest.mark.parametrize("nf, order", [(3, 1), (6, 2), (8, 3)])
def test_smooth_smag_kernel_matches_pair(cuda_device, order, nf, shape, dtype):
    """The merge against its two kernels run in turn (the smoothing, then
    Smagorinsky's RK2 on the smoothed s, su, sv): bit for bit, since both
    run the same device code (tt::shapiro_taps, tt::SmagBlock)."""
    fields, gamma = smooth_smag_inputs(order + nf, nf, shape)
    tf = [tensor(a, cuda_device).to(dtype) for a in fields]
    tg = tensor(gamma, cuda_device).to(dtype)
    kw = dict(dx=SMAG["dx"], dy=SMAG["dy"], cs=SMAG["cs"], nb=SMAG["nb"], dt=SMAG["dt"])
    got = fused_smoothing_smagorinsky_rk2(tf, tg, order=order, **kw)
    smoothed = fused_smoothing(tf, tg, order=order, nb=SMAG["nb"])
    pair = (smoothed[0], *fused_smagorinsky_rk2(*smoothed[:3], **kw), *smoothed[3:])
    for k, (a, b) in enumerate(zip(got, pair)):
        assert torch.equal(a, b), f"output {k}: max|d| = {float((a - b).abs().max())}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", VADV_SED_SHAPES)
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
@pytest.mark.parametrize("sorder", [1, 2])
@pytest.mark.parametrize("vorder", [1, 2, 3, 5])
def test_vadv_sed_kernel_vs_plain(cuda_device, vorder, sorder, vt_mode, shape, dtype):
    """float64: every output within 1e-12 of its largest magnitude; float32:
    the advected fields within 1e-5 of their update plus 4 ulps (as vertical
    advection's), qr and vt within 1e-5 of their largest magnitude (as
    sedimentation's).  At nz = 130 and 260 a thread takes two and four
    levels."""
    args = [tensor(a, cuda_device).to(dtype) for a in vadv_sed_inputs(vorder + 10 * sorder, shape)]
    kw = dict(vorder=vorder, sorder=sorder, dt=5.0, dz=1.0, vt_mode=vt_mode)
    got = fused_vadv_sedimentation_rk3ws(*args, **kw)
    ref = fused_vadv_sedimentation_rk3ws_plain(*args, **kw)
    assert len(got) == len(ref) == 7
    for k, (a, b) in enumerate(zip(got, ref)):
        if dtype == torch.float32 and k < 5:
            assert_increments(a, b, args[1 + k], 1e-5, f"advected output {k}")
        else:
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", VADV_SED_SHAPES)
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
@pytest.mark.parametrize("vorder, sorder", [(1, 1), (2, 2), (3, 2), (5, 1)])
def test_vadv_sed_kernel_matches_pair(cuda_device, vorder, sorder, vt_mode, shape, dtype):
    """The merge against its two kernels run in turn (vertical advection,
    then sedimentation of the advected qr): bit for bit, since both run the
    same device code (tt::VadvLevels, tt::sed_stages)."""
    args = [tensor(a, cuda_device).to(dtype) for a in vadv_sed_inputs(vorder + 10 * sorder, shape)]
    got = fused_vadv_sedimentation_rk3ws(*args, vorder=vorder, sorder=sorder, dt=5.0, dz=1.0,
                                         vt_mode=vt_mode)
    adv = fused_vertical_advection_rk3ws(*args[:4], args[4:7], order=vorder, dt=5.0, dz=1.0)
    pair = (*adv[:5], *fused_sedimentation_rk3ws(args[7], args[8], adv[5], order=sorder, dt=5.0,
                                                 vt_mode=vt_mode))
    for k, (a, b) in enumerate(zip(got, pair)):
        assert torch.equal(a, b), f"output {k}: max|d| = {float((a - b).abs().max())}"


# ---------------------------------------------------------------- y-z slice
# the kernels of the flagship on a y-z slice (chip_smoke.py's sus_yz): the
# relaxed boundary with nx == 1 makes the numerical grid 2 nb + 1 = 7
# columns wide, less than one x-tile of each kernel, whose x-halo reads at
# i < nb and i >= nx - nb fall on the frame; at the path's sizes in float32
# and at 7x41x20 in both types, every cell compared, frame included
NX1 = 2 * NB + 1
YZ_SHAPES = [pytest.param((NX1, 41, 20), torch.float64, id="7x41x20-float64"),
             pytest.param((NX1, 41, 20), torch.float32, id="7x41x20-float32"),
             pytest.param((NX1, 161, 120), torch.float32, id="7x161x120-float32")]
YZ_KERNELS = ("smoothing", "smagorinsky", "kessler_satadj", "vertical_advection", "sedimentation",
              "diagnostics_mtg", "diagnostics_moist", "advection_fields", "momentum_step")


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", YZ_SHAPES)
@pytest.mark.parametrize("kernel", YZ_KERNELS)
def test_yz_slice_kernel_vs_plain(cuda_device, kernel, shape, dtype):
    """Each kernel of the sus_yz path as that path calls it (second-order
    smoothing of six fields, Smagorinsky RK2 with nb = 3, Kessler with
    saturation adjustment, third-order vertical advection of s, the momenta
    and the three water species, second-order sedimentation on ``vt_mode``
    step, the diagnostics' Montgomery and moist modes, the generic stage's
    fifth-order advection of s and the water densities without the boundary
    and its momentum step), with the gates of the tests above."""
    t = lambda a: tensor(a, cuda_device).to(dtype)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    if kernel == "smoothing":
        fields, gamma = smoothing_inputs(21, shape=shape)
        tf, g = [t(a) for a in fields], t(gamma)
        got = fused_smoothing(tf, g, order=2, nb=NB)
        ref = fused_smoothing_plain(tf, g, order=2, nb=NB)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(),
                          1e-13 if dtype == torch.float64 else 1e-6, f"field {k}")
    elif kernel == "smagorinsky":
        s, su, sv = [t(a) for a in smagorinsky_inputs(22, shape)]
        got = fused_smagorinsky_rk2(s, su, sv, **SMAG)
        ref = fused_smagorinsky_rk2_plain(s, su, sv, **SMAG)
        assert_updates(got, ref, (su, sv), dtype)
    elif kernel == "kessler_satadj":
        args = [t(a) for a in kessler_inputs(23, shape)]
        got = fused_kessler_satadj_rk2(*args, KESSLER)
        ref = fused_kessler_satadj_rk2_plain(*args, KESSLER)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")
    elif kernel == "vertical_advection":
        w, s, su, sv, *q = [t(a) for a in vertical_advection_inputs(24, shape)]
        got = fused_vertical_advection_rk3ws(w, s, su, sv, tuple(q), order=3, dt=5.0, dz=1.0)
        ref = fused_vertical_advection_rk3ws_plain(w, s, su, sv, tuple(q), order=3, dt=5.0, dz=1.0)
        assert_updates(got, ref, (s, su, sv, *q), dtype)
    elif kernel == "sedimentation":
        args = [t(a) for a in sedimentation_inputs(25, shape)]
        got = fused_sedimentation_rk3ws(*args, order=2, dt=5.0, vt_mode="step")
        ref = fused_sedimentation_rk3ws_plain(*args, order=2, dt=5.0, vt_mode="step")
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")
    elif kernel.startswith("diagnostics_"):
        mode = kernel[len("diagnostics_"):]
        s, hs, theta = (t(a) for a in diagnostics_inputs(seed=26, shape=shape))
        got = fused_isentropic_diagnostics(s, hs, theta, mode=mode, **DIAG_CONSTS)
        ref = fused_isentropic_diagnostics_plain(s, hs, theta, mode=mode, **DIAG_CONSTS)
        got, ref = ((got,), (ref,)) if mode == "mtg" else (got, ref)
        for k, (a, b) in enumerate(zip(got, ref)):
            gate = tol if dtype == torch.float64 or k != 4 else 4e-5
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), gate, f"output {k}")
    elif kernel == "advection_fields":
        args, kw = advection_args(advection_inputs(seed=27, shape=shape), False, False, cuda_device)
        args = _cast(args, dtype)
        got = fused_advection_fields(*args, **kw, order=5)
        ref = fused_advection_fields_plain(*args, **kw, order=5)
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"field {k}")
    else:
        args = _cast(momentum_step_args(momentum_step_inputs(seed=28, shape=shape), False, cuda_device),
                     dtype)
        kw = dict(order=5, nb=NB, dt=FRACS[1] * DTF, dx=CONSTS["dx"], dy=CONSTS["dy"], eps=0.5)
        got = fused_momentum_step(*args, **kw)
        ref = fused_momentum_step_plain(*args, **kw)
        scale = max(float(r.abs().max()) for r in ref)
        for k, (a, b) in enumerate(zip(got, ref)):
            err = float((a.double() - b.double()).abs().max())
            assert err <= tol * scale, f"output {k}: {err} > {tol} * {scale}"


# ---------------------------------------------------------------- tall columns
# above the fused kernels' heights (vertical advection and its merge with
# sedimentation 1024 levels, sedimentation 2048) the wrappers take the tall
# path (csrc/tall_column.cu), each tall helper counted under its own name
TALL_VADV = (4, 3, 1100)
TALL_SED = (4, 3, 2100)


def launches_of(fn):
    """``fn()`` and the kernel launches it counted."""
    before = collections.Counter(_lib.launch_counts)
    out = fn()
    return out, dict(collections.Counter(_lib.launch_counts) - before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2, 3, 5])
@pytest.mark.parametrize("moist", [True, False])
def test_vertical_advection_tall_vs_plain(cuda_device, moist, order, dtype):
    """1100 levels of 4x3 columns: the tall path, within the fused kernel's
    gates of the plain version (float64 1e-12 of each output's largest
    magnitude, float32 1e-5 of its update plus 4 ulps)."""
    w, s, su, sv, *q = [tensor(a, cuda_device).to(dtype)
                        for a in vertical_advection_inputs(order, TALL_VADV)]
    q = tuple(q) if moist else ()
    got, counts = launches_of(
        lambda: fused_vertical_advection_rk3ws(w, s, su, sv, q, order=order, dt=5.0, dz=1.0))
    assert counts == {"vertical_advection_tall": 1}
    ref = fused_vertical_advection_rk3ws_plain(w, s, su, sv, q, order=order, dt=5.0, dz=1.0)
    assert_updates(got, ref, (s, su, sv) + q, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
def test_sedimentation_tall_vs_plain(cuda_device, vt_mode, order, dtype):
    """2100 levels of 4x3 columns: the tall path, within the fused kernel's
    gates (float64 1e-12, float32 1e-5 of each output's largest magnitude)."""
    args = [tensor(a, cuda_device).to(dtype) for a in sedimentation_inputs(order, TALL_SED)]
    got, counts = launches_of(
        lambda: fused_sedimentation_rk3ws(*args, order=order, dt=5.0, vt_mode=vt_mode))
    assert counts == {"sedimentation_tall": 1}
    ref = fused_sedimentation_rk3ws_plain(*args, order=order, dt=5.0, vt_mode=vt_mode)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for k, (a, b) in enumerate(zip(got, ref)):
        assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("vt_mode", ["stage", "step"])
@pytest.mark.parametrize("vorder, sorder", [(1, 1), (2, 2), (3, 2), (5, 1)])
def test_vadv_sed_tall_vs_plain(cuda_device, vorder, sorder, vt_mode, dtype):
    """1100 levels of 4x3 columns: the two tall paths in turn, within the
    merged kernel's gates (``test_vadv_sed_kernel_vs_plain``'s)."""
    args = [tensor(a, cuda_device).to(dtype) for a in vadv_sed_inputs(vorder + 10 * sorder, TALL_VADV)]
    kw = dict(vorder=vorder, sorder=sorder, dt=5.0, dz=1.0, vt_mode=vt_mode)
    got, counts = launches_of(lambda: fused_vadv_sedimentation_rk3ws(*args, **kw))
    assert counts == {"vertical_advection_tall": 1, "sedimentation_tall": 1}
    ref = fused_vadv_sedimentation_rk3ws_plain(*args, **kw)
    assert len(got) == len(ref) == 7
    for k, (a, b) in enumerate(zip(got, ref)):
        if dtype == torch.float32 and k < 5:
            assert_increments(a, b, args[1 + k], 1e-5, f"advected output {k}")
        else:
            tol = 1e-12 if dtype == torch.float64 else 1e-5
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), tol, f"output {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vertical_advection", "vadv_sed", "sedimentation"])
def test_fused_column_kernels_take_their_tallest_columns(cuda_device, kernel):
    """At their limits (1024, 1024 and 2048 levels) the fused kernels run,
    not the tall path, within their gates in float32."""
    dtype = torch.float32
    if kernel == "sedimentation":
        args = [tensor(a, cuda_device).to(dtype) for a in sedimentation_inputs(2, (2, 2, SED_MAX_NZ))]
        got, counts = launches_of(lambda: fused_sedimentation_rk3ws(*args, order=2, dt=5.0, vt_mode="step"))
        ref = fused_sedimentation_rk3ws_plain(*args, order=2, dt=5.0, vt_mode="step")
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_scaled(a.double().cpu().numpy(), b.double().cpu().numpy(), 1e-5, f"output {k}")
        assert counts == {"fused_sedimentation_rk3ws": 1}
        return
    if kernel == "vadv_sed":
        args = [tensor(a, cuda_device).to(dtype) for a in vadv_sed_inputs(3, (2, 2, VADV_SED_MAX_NZ))]
        kw = dict(vorder=3, sorder=2, dt=5.0, dz=1.0, vt_mode="step")
        got, counts = launches_of(lambda: fused_vadv_sedimentation_rk3ws(*args, **kw))
        ref = fused_vadv_sedimentation_rk3ws_plain(*args, **kw)
        assert_updates(got[:5], ref[:5], args[1:6], dtype)
        assert counts == {"fused_vadv_sedimentation_rk3ws": 1}
        return
    w, s, su, sv, *q = [tensor(a, cuda_device).to(dtype)
                        for a in vertical_advection_inputs(3, (2, 2, VADV_MAX_NZ))]
    got, counts = launches_of(
        lambda: fused_vertical_advection_rk3ws(w, s, su, sv, q, order=3, dt=5.0, dz=1.0))
    ref = fused_vertical_advection_rk3ws_plain(w, s, su, sv, q, order=3, dt=5.0, dz=1.0)
    assert_updates(got, ref, (s, su, sv, *q), dtype)
    assert counts == {"fused_vertical_advection_rk3ws": 1}


@pytest.mark.cuda
def test_column_wrappers_name_their_limit(cuda_device):
    """A grid of more cells than the column kernels index in 32 bits raises
    a ValueError naming the limit before anything is launched (broadcast
    views: nothing that size is allocated)."""
    big = (2**16, 2**8, 130)
    t = torch.zeros(1, 1, 130, device=cuda_device).expand(*big)
    t_if = torch.zeros(1, 1, 131, device=cuda_device).expand(big[0], big[1], 131)
    calls = [
        lambda: fused_vertical_advection_rk3ws(t, t, t, t, order=3, dt=5.0, dz=1.0),
        lambda: fused_vadv_sedimentation_rk3ws(t, t, t, t, t, t, t, t, t_if, vorder=3, sorder=2,
                                               dt=5.0, dz=1.0),
        lambda: fused_sedimentation_rk3ws(t, t_if, t, order=2, dt=5.0),
    ]
    for call in calls:
        with pytest.raises(ValueError, match=str(MAX_CELLS)):
            launches_of(call)


# ---------------------------------------------------------------- fused loop

GRAPH_SIZE = dict(nx=41, ny=41, nz=20, niter=5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["sus", "sus_merged", "fc", "lfc", "ps", "sts", "ssus", "mountain_wave",
                                  "burgers_bench", "burgers_zhao", "sus_third", "fc_third",
                                  "sus_periodic", "sus_coriolis_implicit", "fc_coriolis", "sus_yz",
                                  "sus_schaer"])
def test_fused_loop_graph_matches_eager(cuda_device, path):
    """41x41x20 (the mountain wave 41x1x20, Burgers 41x41, sus_yz 1x41x20),
    float32, 1 + 5 steps: the CUDA graph's final fields equal the eager run's bit for bit,
    and one captured step launches what ``chip_smoke.py`` counts for the
    path (``LAUNCHES_PER_STEP``; Burgers no kernel), as one eager step
    does.  ``SURFACE_PATHS`` are couplings with namelist overrides (third
    order, the periodic boundary, Coriolis and the implicit vertical
    advection, the y-z slice, the Schaer mountain)."""
    from chip_smoke import LAUNCHES_PER_STEP, SURFACE_PATHS, namelist_overrides
    from tasmania_tpu_torch.drivers import driver_burgers as burgers
    from tasmania_tpu_torch.drivers import driver_isentropic_moist as moist
    from tasmania_tpu_torch.drivers import driver_mountain_wave as mw

    kw = dict(so=StorageOptions(dtype=torch.float32, device="cuda"), verbose=False)
    if path == "mountain_wave":
        runs = [mw.run_case(41, 20, 6 * 20.0 / 3600.0, 20.0, fused_loop=f, **kw) for f in (False, True)]
    elif path.startswith("burgers_"):
        runs = [burgers.run_case(path[len("burgers_"):], 41, steps=5, fused_loop=f, **kw)
                for f in (False, True)]
    elif path in SURFACE_PATHS:
        coupling, overrides, _ = SURFACE_PATHS[path]
        nl = moist.load_namelist(coupling, **{**GRAPH_SIZE, **namelist_overrides(overrides)})
        runs = [moist.run(nl, coupling, verbose=False, fused_loop=f) for f in (False, True)]
    else:
        coupling = "sus" if path == "sus_merged" else path
        merges = ("smooth_smag", "vadv_sed") if path == "sus_merged" else ()
        nl = moist.load_namelist(coupling, **GRAPH_SIZE, process_merges=merges)
        runs = [moist.run(nl, coupling, verbose=False, fused_loop=f) for f in (False, True)]
    eager, graph = runs
    assert set(graph["fields"]) == set(eager["fields"])
    for name, fa in eager["fields"].items():
        assert torch.equal(graph["fields"][name].data, fa.data), name
    assert eager["launches_per_step"] == graph["launches_per_step"] == LAUNCHES_PER_STEP.get(path, {})


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["torch", "jax", "pallas"])
def test_registered_names_and_backend_names_launch_as_sus(cuda_device, backend):
    """41x41x20, float32, 1 + 5 steps, eager and as a CUDA graph: the
    flagship built through a topography and a boundary a user registered
    under new names, under each backend name, launches sus's kernels a step
    (``LAUNCHES_PER_STEP["sus_registry"]``) and gives the fields of the run
    built through "gaussian" and "relaxed" bit for bit: no backend name
    routes a plain version onto the card."""
    from chip_smoke import LAUNCHES_PER_STEP, register_user_flavours
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist

    user = register_user_flavours()
    try:
        so = StorageOptions(dtype=torch.float32, device="cuda")
        base = drv.run(load_namelist(**GRAPH_SIZE, so=so), verbose=False)
        assert base["launches_per_step"] == LAUNCHES_PER_STEP["sus_registry"]
        nl = load_namelist(**GRAPH_SIZE, so=so, backend=backend, topo_type=user["topography"],
                           hb_type=user["boundary"])
        for fused in (False, True):
            res = drv.run(nl, verbose=False, fused_loop=fused)
            assert res["launches_per_step"] == LAUNCHES_PER_STEP["sus_registry"], fused
            for name, fa in base["fields"].items():
                assert torch.equal(res["fields"][name].data, fa.data), (fused, name)
    finally:
        user["unregister"]()


# ---------------------------------------------------------------- checkpoints


@pytest.mark.cuda
def test_checkpoint_resume_bitwise_on_card(cuda_device, tmp_path):
    """41x41x20, float32, eager: a run checkpointed every 2 steps and
    resumed from step 4 ends on the uninterrupted 1 + 6 steps' fields bit
    for bit (no kernel of the SUS chain uses atomics)."""
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

    nl = load_namelist(**{**GRAPH_SIZE, "niter": 6}, so=StorageOptions(dtype=torch.float32, device="cuda"))
    full = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.all_steps() == [2, 4, 6]
    resumed = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp_path / "ck"), resume=4)
    assert resumed["start"] == 4
    for name, fa in full["fields"].items():
        assert fa.data.is_cuda and resumed["fields"][name].data.is_cuda
        assert torch.equal(resumed["fields"][name].data, fa.data), name


@pytest.mark.cuda
def test_graph_default_recovery_on_card(cuda_device, tmp_path):
    """41x41x20, float32, 1 + 7 steps every 3 with the NaN guard: the SUS
    driver with no mode given steps through a graph whose checkpoints (3, 6,
    7) and final fields equal the eager run's bit for bit; resumed from 3
    and from 7 (nothing replayed) it ends on the uninterrupted bits; a NaN
    written at step 4 through a device counter the step reads trips the
    guard at step 6, as in the eager run."""
    from tasmania_tpu_torch.drivers import driver_namelist_sus as drv
    from tasmania_tpu_torch.drivers.namelist_sus import load_namelist
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

    nl = load_namelist(**{**GRAPH_SIZE, "niter": 7}, so=StorageOptions(dtype=torch.float32, device="cuda"))
    rec = dict(checkpoint_every=3, nan_guard=True)
    eager = drv.run(nl, verbose=False, fused_loop=False, checkpoint_dir=str(tmp_path / "eager"), **rec)
    graph = drv.run(nl, verbose=False, checkpoint_dir=str(tmp_path / "graph"), **rec)
    assert eager["capture_s"] is None and graph["capture_s"] is not None
    mgrs = [CheckpointManager(str(tmp_path / d)) for d in ("eager", "graph")]
    assert mgrs[0].all_steps() == mgrs[1].all_steps() == [3, 6, 7]
    for step in (3, 6, 7):
        ref, got = (m.restore(step) for m in mgrs)
        for name in ref:
            if name != "time":
                assert torch.equal(got[name].data, ref[name].data), (step, name)
    for name, fa in eager["fields"].items():
        assert torch.equal(graph["fields"][name].data, fa.data), name
    for step in (3, 7):
        resumed = drv.run(nl, verbose=False, checkpoint_dir=str(tmp_path / "graph"), resume=step, **rec)
        assert resumed["start"] == step and resumed["capture_s"] is not None
        for name, fa in graph["fields"].items():
            assert torch.equal(resumed["fields"][name].data, fa.data), (step, name)

    messages = []
    for mode in (False, None):
        domain, state, pt = drv.build_domain_and_state(nl)
        dycore, physics = drv.build_model(nl, domain, pt)
        calls = torch.zeros((), dtype=torch.long, device="cuda")

        def step_impl(st, dt, physics=physics, dycore=dycore, calls=calls):
            out = physics(dycore(st, {}, dt), dt)
            calls.add_(1)
            s = out["air_isentropic_density"].data
            s[3, 4, 2] = torch.where(calls == 1 + 4, float("nan"), s[3, 4, 2])
            return out

        with pytest.raises(RuntimeError, match="non-finite state") as err:
            drv.run_steps(nl, state, step_impl, dycore.topography_steady, verbose=False, fused_loop=mode,
                          checkpoint_dir=str(tmp_path / f"nan_{mode}"), **rec)
        messages.append(str(err.value))
        assert CheckpointManager(str(tmp_path / f"nan_{mode}")).all_steps() == [3]
    assert messages[0] == messages[1]
    assert "at step 6; last good checkpoint: step 3" in messages[1]


@pytest.mark.cuda
def test_checkpoint_restores_card_fields_on_cpu(cuda_device, tmp_path):
    """A checkpoint of card fields restores onto the CPU (``device="cpu"``)
    with the card's values bit for bit, and by default onto the card."""
    from tasmania_tpu_torch.utils.checkpoint import CheckpointManager

    rng = np.random.default_rng(3)
    state = {name: FieldArray(torch.as_tensor(rng.normal(size=(41, 41, 20)), dtype=torch.float32,
                                              device=cuda_device), "1")
             for name in ("a", "b")}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    on_cpu, on_card = mgr.restore(device="cpu"), mgr.restore()
    for name, fa in state.items():
        assert on_cpu[name].data.device.type == "cpu" and on_card[name].data.is_cuda
        assert torch.equal(on_cpu[name].data, fa.data.cpu())
        assert torch.equal(on_card[name].data, fa.data)
