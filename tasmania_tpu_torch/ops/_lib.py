"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``tasmania_tpu_torch/csrc`` are compiled by ``nvcc`` for Hopper
(``sm_90a``), one process per source started together, and linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/tasmania_tpu_torch/`` at the root of the
checkout, in a directory keyed by a hash of the sources and flags, so a
changed source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: CPU-only machines import every module.

``launch_counts`` counts kernel launches per wrapper; each wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "tasmania_tpu_torch"
# no --use_fast_math: the Exner power must be powf, not __powf
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

launch_counts: collections.Counter = collections.Counter()

_vp = ctypes.c_void_p
_int = ctypes.c_int
_SIGNATURES = {
    # dtype, fulls, lows, highs (host arrays, at most 16 each), n, nx, ny, nz,
    # w, stream
    "tt_paste_x_edges_multi": (_int, _vp, _vp, _vp, _int, _int, _int, _int, _int, _vp),
    # dtype, inputs (host array), outputs (host array), gamma, nf, nx, ny, nz,
    # order, nb, stream
    "tt_smoothing": (_int, _vp, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp),
    # dtype, inputs, outputs, nq, nx, ny, nz, nb, dd, scalars, stream
    "tt_si_stage": (_int, _vp, _vp, _int, _int, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (host array), outputs (host array), ncol, nz, scalars, stream
    "tt_kessler_satadj": (_int, _vp, _vp, _int, _int, _vp, _vp),
    # the same, Kessler alone (out: qv, qc, qr, theta tendency)
    "tt_kessler_rk2": (_int, _vp, _vp, _int, _int, _vp, _vp),
    # the same, saturation adjustment alone (in: t, p_if, exn_if, qv, qc,
    # theta tendency; out: qv, qc, theta tendency)
    "tt_satadj_rk2": (_int, _vp, _vp, _int, _int, _vp, _vp),
    # dtype, inputs (u, v, gamma, ref0, now[nf], int[nf], tnd[nf]), outputs,
    # nf, q_mask, nx, ny, nz, nb, order, scalars (dt, dx, dy), stream
    "tt_advection_fields": (_int, _vp, _vp, _int, _int, _int, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (u, v, su/sv now, su/sv int, s and mtg now, s and mtg
    # new, su/sv tendencies or null), outputs (su, sv), nx, ny, nz, nb,
    # order, scalars (dt, dx, dy, eps), stream
    "tt_momentum_step": (_int, _vp, _vp, _int, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (s, hs, theta), outputs (mtg | p, exn, mtg, h[, rho, t]),
    # ncol, nz, mode (0 mtg, 1 dry, 2 moist), scalars (pt, dz, g, cp, rd,
    # pref), stream
    "tt_isentropic_diagnostics": (_int, _vp, _vp, _int, _int, _int, _vp, _vp),
    # dtype, inputs (17 arrays, sq[nq], q_ref[nq]), outputs (s, su, sv,
    # q[nq]), nq, nx, ny, nz, nb, scalars (dt, dtf, dx, dy, eps), stream
    "tt_momentum_epilogue": (_int, _vp, _vp, _int, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (s, su_stage, sv_stage, su_base, sv_base), outputs (su, sv),
    # nx, ny, nz, nb, scalars (c, nu factor, 2 dx, 2 dy), stream
    "tt_smagorinsky_stage": (_int, _vp, _vp, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (w, s, su, sv[, qv, qc, qr]), outputs, nfields, ncol, nz,
    # order, scalars (dt, dz), stream
    "tt_vertical_advection_rk3ws": (_int, _vp, _vp, _int, _int, _int, _int, _vp, _vp),
    # dtype, inputs (rho, h_if, qr), outputs (qr, vt), ncol, nz, order,
    # vt_step, dt, stream
    "tt_sedimentation_rk3ws": (_int, _vp, _vp, _int, _int, _int, _int, ctypes.c_double, _vp),
}

_loaded = None
build_info: dict = {}


def reset_launch_counts() -> None:
    launch_counts.clear()


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libtasmania_kernels.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return nvcc


def build() -> Path:
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc -c`` per source, all started together, then one link (a cold
    build's time is bounded by the slowest source, not the sum of all).
    Raises with the compiler's output if a step fails, leaving no object or
    partial library behind."""
    path = library_path()
    if path.exists():
        build_info.update(path=str(path), seconds=0.0, cached=True, log="")
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    cu = [p for p in _sources() if p.suffix == ".cu"]
    objs = [path.with_name(f"{src.stem}.{tag}.o") for src in cu]
    tmp = path.with_name(f"{path.name}.{tag}")
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-I", str(CSRC), "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(cu, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log in zip(cu, procs, logs) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        link = subprocess.run(
            [_nvcc(), "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, path)
    finally:
        for leftover in (*objs, tmp):
            leftover.unlink(missing_ok=True)
    build_info.update(
        path=str(path), seconds=time.perf_counter() - t0, cached=False,
        log="".join(logs) + link.stdout + link.stderr,
    )
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _loaded
    if _loaded is None:
        dll = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(dll, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded = dll
    return _loaded


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def pointer_array(tensors) -> ctypes.Array:
    """A host array of the tensors' data pointers (null for None)."""
    return (ctypes.c_void_p * len(tensors))(*[None if t is None else t.data_ptr() for t in tensors])


def scalar_array(values) -> ctypes.Array:
    """A host array of doubles, the kernels' scalar arguments."""
    return (ctypes.c_double * len(values))(*values)


def check_cuda_tensors(name: str, tensors, dtype, shapes=None) -> None:
    """Device, dtype, shape and contiguity checks shared by the wrappers."""
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dtype} not supported (float32, float64)")
    device = tensors[0].device
    if device.type == "cuda" and device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {device}, but the current device is "
                         f"cuda:{torch.cuda.current_device()} (the launch stream's)")
    for a, t in enumerate(tensors):
        if not t.is_cuda or t.device != device:
            raise ValueError(f"{name}: argument {a} is not on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: argument {a} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {a} is not contiguous")
        if shapes is not None and tuple(t.shape) != tuple(shapes[a]):
            raise ValueError(f"{name}: argument {a} has shape {tuple(t.shape)}, expected {shapes[a]}")
