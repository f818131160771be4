"""Whether a stage kernel of this tree gives the bits of another tree's on
the card: the whole-stage kernel (``csrc/si_stage.cu``, in its
single-device mode; ``--kernel si_stage``, the default), the momentum step
or the momentum epilogue (``csrc/advection.cu``; ``--kernel
momentum_step``, ``--kernel momentum_epilogue``).

``si_stage``: on seeded inputs at the flagship's 161x161x120 (float32) and
on a ragged 23x19x13 (float32 and float64), orders 3 and 5, the three RK3WS
stages with damping on the last.  ``momentum_step``: on seeded inputs of
the flagship's magnitudes at the periodic grid's 167x167x120 and the
flagship's 161x161x120 (float32, order 5), the mountain wave's one interior
row 161x7x120 (float32, order 3, v zero) and a ragged 37x29x13 (float64 at
orders 3 and 5, float32 at order 5), each without and with the momentum
tendencies.  ``momentum_epilogue``: on seeded inputs of the flagship's
magnitudes at 161x161x120 (float32) and a ragged 37x29x13 (float64), orders
3 and 5, each with and without the momentum tendencies, the damping and
the three water species (eight calls a case).

It runs the kernel of the tree given by ``--tree`` (default: this one) and
saves the outputs (``--save FILE``), or compares them with a saved file bit
for bit (``--compare FILE``).  To hold a change against its parent, unpack
the parent into a git-ignored directory and run, on the GPU machine, from
the root of this tree (the saved file inside the checkout)::

    python tests/check_torch_stage_bits.py [--kernel K] --tree PARENT --save PARENT/bits.pt
    python tests/check_torch_stage_bits.py [--kernel K] --compare PARENT/bits.pt
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

import numpy as np

CASES = [((161, 161, 120), "float32"), ((23, 19, 13), "float32"), ((23, 19, 13), "float64")]
NB, NR, DTF = 3, 6, 5.0
FRACS = (1.0 / 3.0, 0.5, 1.0)
CONSTS = dict(dx=2.2e3, dy=2.2e3, eps=0.5, pt=2.3e4, dz=1.0, g=9.80665, cp=1004.0, rd=287.05,
              pref=1e5)


def inputs(shape, seed):
    """Stage inputs of the flagship's magnitudes (numpy)."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape

    def f(*s, lo=0.5, hi=1.5):
        return rng.uniform(lo, hi, s)

    dist = np.minimum.outer(np.minimum(np.arange(nx), np.arange(nx)[::-1]),
                            np.minimum(np.arange(ny), np.arange(ny)[::-1]))
    ramp = np.where(dist < NB, 1.0, np.clip(1.0 - (dist - NB + 1) / (NR - NB + 1), 0.0, 1.0))
    rmat = np.zeros(nz)
    rmat[: min(15, nz)] = np.linspace(5e-4, 1e-5, min(15, nz))
    return dict(
        u=f(nx + 1, ny, nz, lo=10, hi=30), v=f(nx, ny + 1, nz, lo=-2, hi=2),
        s_now=f(*shape, lo=50, hi=190), s_int=f(*shape, lo=50, hi=190),
        q_now=[f(*shape, lo=0, hi=6e-3) for _ in range(3)],
        q_int=[f(*shape, lo=0, hi=6e-3) for _ in range(3)],
        su_now=f(*shape, lo=1e3, hi=4.4e3), sv_now=f(*shape, lo=-100, hi=100),
        su_int=f(*shape, lo=1e3, hi=4.4e3), sv_int=f(*shape, lo=-100, hi=100),
        mtg_now=f(*shape, lo=3.5e5, hi=3.8e5), hs=f(nx, ny, lo=0, hi=500),
        theta=np.linspace(400.0, 280.0, nz + 1), gamma=ramp,
        s_ref=f(*shape, lo=50, hi=190), su_ref=f(*shape, lo=1e3, hi=4.4e3),
        sv_ref=f(*shape, lo=-1, hi=1), q_refs=[f(*shape, lo=0, hi=6e-3) for _ in range(3)],
        rmat=rmat, dd=min(15, nz),
    )


# the momentum step's cases: shape, dtype, flux order
MOMENTUM_CASES = [((167, 167, 120), "float32", 5), ((161, 161, 120), "float32", 5),
                  ((161, 7, 120), "float32", 3), ((37, 29, 13), "float64", 3),
                  ((37, 29, 13), "float64", 5), ((37, 29, 13), "float32", 5)]
MOMENTUM_CONSTS = dict(nb=NB, dt=FRACS[1] * DTF, dx=CONSTS["dx"], dy=CONSTS["dy"], eps=CONSTS["eps"])
# the momentum epilogue's cases: shape, dtype (each at orders 3 and 5)
EPILOGUE_CASES = [((161, 161, 120), "float32"), ((37, 29, 13), "float64")]


def momentum_inputs(shape, seed):
    """Momentum-step inputs of the flagship's magnitudes (numpy); v zero on
    a grid one interior row deep, as on the one-dimensional boundary."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = shape

    def f(*s, lo, hi):
        return rng.uniform(lo, hi, s)

    v = np.zeros((nx, ny + 1, nz)) if ny == 2 * NB + 1 else f(nx, ny + 1, nz, lo=-2, hi=2)
    return dict(
        u=f(nx + 1, ny, nz, lo=10, hi=30), v=v,
        su_now=f(*shape, lo=1e3, hi=4.4e3), sv_now=f(*shape, lo=-100, hi=100),
        su_int=f(*shape, lo=1e3, hi=4.4e3), sv_int=f(*shape, lo=-100, hi=100),
        s_now=f(*shape, lo=50, hi=190), mtg_now=f(*shape, lo=3.5e5, hi=3.8e5),
        s_new=f(*shape, lo=50, hi=190), mtg_new=f(*shape, lo=3.5e5, hi=3.8e5),
        su_tnd=f(*shape, lo=-0.1, hi=0.1), sv_tnd=f(*shape, lo=-0.1, hi=0.1),
    )


def run_momentum(tree: Path):
    sys.path.insert(0, str(tree.resolve()))
    import torch

    from tasmania_tpu_torch.ops.advection_step import fused_momentum_step

    outs = []
    keys = ("u", "v", "su_now", "sv_now", "su_int", "sv_int", "s_now", "mtg_now", "s_new", "mtg_new")
    for case, (shape, dtype, order) in enumerate(MOMENTUM_CASES):
        inp = momentum_inputs(shape, seed=200 + case)
        args = [torch.as_tensor(inp[k], dtype=getattr(torch, dtype), device="cuda")
                for k in (*keys, "su_tnd", "sv_tnd")]
        for tendencies in (False, True):
            a = args if tendencies else args[:10]
            got = fused_momentum_step(*a, order=order, **MOMENTUM_CONSTS)
            outs.append(([o.cpu() for o in got], f"{'x'.join(map(str, shape))} {dtype} order {order} "
                         f"{'with' if tendencies else 'without'} tendencies"))
    torch.cuda.synchronize()
    return outs


def run_epilogue(tree: Path):
    sys.path.insert(0, str(tree.resolve()))
    import torch

    from tasmania_tpu_torch.ops.advection_step import fused_momentum_epilogue
    from tasmania_tpu_torch.ops.si_stage import StageConstants

    outs = []
    c = StageConstants(dt=FRACS[2] * DTF, dtf=DTF, **CONSTS)
    for case, (shape, dtype) in enumerate(EPILOGUE_CASES):
        inp = inputs(shape, seed=300 + case)
        extra = momentum_inputs(shape, seed=400 + case)
        dt = getattr(torch, dtype)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")

        # the stepped density s_e and its potential, the water densities
        base = [t(inp[k]) for k in ("u", "v", "su_now", "sv_now", "su_int", "sv_int", "s_now", "mtg_now")]
        base += [t(extra["s_new"]), t(extra["mtg_new"])]
        sqs = [t(extra["s_new"] * q) for q in inp["q_int"]]
        refs = [t(inp[k]) for k in ("gamma", "s_ref", "su_ref", "sv_ref")]
        q_refs, tnd = [t(q) for q in inp["q_refs"]], [t(extra["su_tnd"]), t(extra["sv_tnd"])]
        for order, tendencies, damping, water in itertools.product((3, 5), *[(False, True)] * 3):
            got = fused_momentum_epilogue(
                *base, sqs if water else [], *refs, q_refs if water else [],
                t(inp["rmat"]) if damping else None, *(tnd if tendencies else (None, None)),
                nb=NB, c=c, order=order)
            outs.append(([o.cpu() for o in got],
                         f"{'x'.join(map(str, shape))} {dtype} order {order}, tendencies {tendencies}, "
                         f"damping {damping}, water {water}"))
    torch.cuda.synchronize()
    return outs


def run(tree: Path):
    sys.path.insert(0, str(tree.resolve()))
    import torch

    from tasmania_tpu_torch.ops.si_stage import StageConstants, si_stage

    outs = []
    for case, (shape, dtype) in enumerate(CASES):
        inp = inputs(shape, seed=100 + case)
        dt = getattr(torch, dtype)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device="cuda")

        keys = ("u", "v", "s_now", "s_int", "q_now", "q_int", "su_now", "sv_now", "su_int",
                "sv_int", "mtg_now", "hs", "theta", "gamma", "s_ref", "su_ref", "sv_ref", "q_refs")
        args = [[t(a) for a in inp[k]] if isinstance(inp[k], list) else t(inp[k]) for k in keys]
        for order in (3, 5):
            for stage, frac in enumerate(FRACS):
                last = stage == 2
                c = StageConstants(dt=frac * DTF, dtf=DTF, **CONSTS)
                got = si_stage(*args, t(inp["rmat"]) if last else None, nb=NB, c=c,
                               dd=inp["dd"] if last else 0, order=order)
                outs.append(([o.cpu() for o in got], f"{shape} {dtype} order {order} stage {stage}"))
    torch.cuda.synchronize()
    return outs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parent.parent)
    parser.add_argument("--kernel", choices=("si_stage", "momentum_step", "momentum_epilogue"),
                        default="si_stage")
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--save", type=Path)
    group.add_argument("--compare", type=Path)
    cli = parser.parse_args()
    outs = {"si_stage": run, "momentum_step": run_momentum, "momentum_epilogue": run_epilogue}[
        cli.kernel](cli.tree)
    if cli.save:
        torch.save(outs, cli.save)
        print(f"saved {len(outs)} calls of {cli.tree}")
        return 0
    theirs = torch.load(cli.compare)
    differ = [what for (a, what), (b, _) in zip(outs, theirs)
              if not all(torch.equal(x, y) for x, y in zip(a, b))]
    for (a, what), (b, _) in zip(outs, theirs):
        if what in differ:  # how far: cells that differ, the largest difference over the output's magnitude
            for k, (x, y) in enumerate(zip(a, b)):
                d = (x.double() - y.double()).abs()
                print(f"  {what}, output {k}: {int((x != y).sum())} of {x.numel()} cells differ, "
                      f"at most {float(d.max()):.3e} ({float(d.max()) / float(y.abs().max()):.2e} of "
                      f"the output's largest magnitude)")
    print(f"bitwise against {cli.compare}: {len(outs) - len(differ)} of {len(outs)} calls equal; "
          f"differing: {differ}")
    return 1 if differ or len(outs) != len(theirs) else 0


if __name__ == "__main__":
    sys.exit(main())
