"""Achieved bandwidth of the mountain wave's two stencil kernels
(counterpart of ``drivers/bench_kernels.py``).

Times ``fused_advection_fields`` at fifth order on s and three water
species with the q-product (``drivers/bench_kernels.py:71-86``: no
boundary, the same fields as now and intermediate) and
``fused_momentum_step`` (#6, which the JAX tool's docstring names beside it
but its body does not time), at 161x161x120 float32 by default on seeded
inputs of 1 + 0.1·N(0, 1) (the water species 1e-3 of that), and the
card's practical copy rate, with ``kernel_timing``: each row the device
time of a call, the unique bytes (each distinct input once, then the
outputs), GB/s and the shares of the copy rate and of the data sheet's
3.35 TB/s (a spec).

Usage::

    python -m tasmania_tpu_torch.drivers.bench_kernels [--nx 161] [--nz 120] [--out PATH]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List

import torch

from tasmania_tpu_torch.drivers.driver_namelist_sus import check_device
from tasmania_tpu_torch.drivers.kernel_timing import REPS, Case, copy_rate, measure, nbytes, report, unique_bytes
from tasmania_tpu_torch.ops.advection_step import fused_advection_fields, fused_momentum_step

NX = 161
NZ = 120
NB = 3
SEED = 0
# the JAX tool's stencil scalars
STEP = dict(nb=NB, dt=1e-3, dx=1e3, dy=1e3, order=5)
TILES_NOTE = ("The JAX tool's --tiles (the Pallas kernel's x-tile) has no counterpart: the CUDA "
              "kernels' tiles are compile-time constants (csrc/advection.cu, S::TX).")


def build_cases(device, nx: int = NX, nz: int = NZ, seed: int = SEED) -> List[Case]:
    """The two cases on a ``nx`` x ``nx`` x ``nz`` grid."""
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)

    def mk(*shape):
        return 1.0 + 0.1 * torch.randn(shape, generator=gen, device=device)

    ny = nx
    t = dict(u=mk(nx + 1, ny, nz), v=mk(nx, ny + 1, nz), s=mk(nx, ny, nz))
    for i in range(3):
        t[f"q{i}"] = 1e-3 * mk(nx, ny, nz)
    for n in ("su", "sv", "sui", "svi", "mtg", "s_new", "mtg_new"):
        t[n] = mk(nx, ny, nz)
    cell = nbytes(t["s"])
    f = ("s", "q0", "q1", "q2")

    def advection(a):
        fields = [a[n] for n in f]
        return fused_advection_fields(a["u"], a["v"], fields, fields, q_product=(False, True, True, True),
                                      **STEP)

    mom = ("u", "v", "su", "sv", "sui", "svi", "s", "mtg", "s_new", "mtg_new")
    return [
        Case("advection_fields (order 5, 4 fields, q product)", "fused_advection_fields", 5,
             "advection (drivers/bench_kernels.py:71-86)", {n: t[n] for n in ("u", "v", *f)}, advection,
             unique_bytes(*(t[n] for n in ("u", "v", *f))) + 4 * cell),
        Case("momentum_step (order 5)", "fused_momentum_step", 6, "none (its docstring names it)",
             {n: t[n] for n in mom}, lambda a: fused_momentum_step(*(a[n] for n in mom), eps=0.5, **STEP),
             unique_bytes(*(t[n] for n in mom)) + 2 * cell),
    ]


def bench(device="cuda", nx: int = NX, nz: int = NZ, reps: int = REPS) -> Dict[str, Any]:
    """The copy rate and the two rows."""
    check_device(device)
    copy = copy_rate((nx, nx, nz), device)
    return dict(grid=[nx, nx, nz], copy=copy,
                rows=[measure(c, device, copy["gbs"], reps) for c in build_cases(device, nx, nz)])


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0], epilog=TILES_NOTE)
    parser.add_argument("--nx", type=int, default=NX, help="nx and ny")
    parser.add_argument("--nz", type=int, default=NZ)
    parser.add_argument("--out", type=str, default=None, metavar="PATH",
                        help="write the copy rate and the rows as JSON to PATH")
    parser.add_argument("--device", type=str, default="cuda")
    cli = parser.parse_args(argv)
    if torch.device(cli.device).type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device is available (pass --device cpu to run on the CPU)")
    res = bench(cli.device, cli.nx, cli.nz)
    where = torch.cuda.get_device_name(0) if torch.device(cli.device).type == "cuda" else "cpu"
    print(report(f"kernel bandwidth on {where}, {cli.nx}x{cli.nx}x{cli.nz} float32", res["copy"], res["rows"]))
    if cli.out:
        Path(cli.out).write_text(json.dumps({**res, "device": where}, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()
