"""Device selection, the CUDA kernel library, and kernel launch counts.

The hand-written Hopper kernels live in ``csrc/*.cu``.  They are built on
first use with ``nvcc`` into one shared library with a plain C interface
and loaded with ``ctypes``.  Each source compiles to its own object in a
separate ``nvcc`` process, all started together, and one link joins them.
The library is cached under ``_build/`` keyed by a hash of the sources and
flags, so an edit to any source rebuilds it.

Nothing here touches CUDA at import: the CPU tests import every module.
"""

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np
import torch

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD = pathlib.Path(__file__).parent / "_build"
SOURCES = ("voigt_sum.cu", "disort_fused.cu", "zeeman_mp.cu", "eigh_jacobi.cu")
# no --use_fast_math: the tolerances need IEEE divides, sqrt and exp
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# launches per kernel, incremented by each wrapper where it launches
LAUNCHES = {"voigt_sum": 0, "disort_stage1": 0, "disort_stage1_beam": 0, "disort_stage23": 0,
            "voigt_sum_pol": 0, "zeeman_mp": 0, "eigh_jacobi": 0, "fused_eigen": 0}

# build facts for chip_smoke.py: seconds, library path, ptxas report
BUILD_INFO = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def resolve(device=None, dtype=None):
    """(torch.device, dtype) for an entry point.

    device None means the card.  Without a card that raises: the port
    never falls back to the CPU on its own; callers ask for it with
    device="cpu".  dtype None means float32, the production precision.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "arts_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev, (torch.float32 if dtype is None else dtype)


def tensor(x, device, dtype):
    """x as a tensor on `device` in `dtype`.  Numbers and arrays are read at
    double precision first (torch.as_tensor would read a Python float as
    float32)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        x = torch.as_tensor(a.astype(np.result_type(a, np.float64)))
    return x.to(device=device, dtype=dtype)


def move(obj, device, dtype):
    """Copy of a frozen dataclass (or tuple) of tensors on `device`, its
    floating tensors cast to `dtype`; integer tensors keep their type, and
    a dataclass with a `fixed_dtype` class attribute keeps its floating
    tensors in that dtype (lbl.ecs.EcsBand: float64)."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device=device, dtype=dtype if obj.is_floating_point() else None)
    if isinstance(obj, tuple):
        return tuple(move(o, device, dtype) for o in obj)
    if dataclasses.is_dataclass(obj):
        dtype = getattr(obj, "fixed_dtype", dtype)
        return dataclasses.replace(obj, **{
            f.name: move(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj)
        })
    return obj


@contextlib.contextmanager
def full_f32_matmul():
    """Run float32 matrix products in full float32 (no TF32) and restore
    the caller's setting afterwards; the port changes no global precision
    setting at import."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _nvcc():
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.exists(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return path


def _source_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + tuple(sorted(p.name for p in CSRC.glob("*.cuh"))):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build():
    """Compile the kernel library if its sources changed; return its path."""
    tag = _source_hash()
    lib = BUILD / f"libarts_kernels_{tag}.so"
    log = BUILD / f"ptxas_{tag}.log"
    if lib.exists():
        BUILD_INFO.update(seconds=0.0, library=str(lib), cached=True,
                          ptxas=log.read_text() if log.exists() else "")
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD / f"{pathlib.Path(name).stem}_{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    logs = []
    failed = []
    for name, _, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode:
            failed.append(name)
    report = "\n".join(logs)
    log.write_text(report)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{report}")
    tmp = BUILD / f"{lib.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        capture_output=True, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)
    BUILD_INFO.update(
        seconds=time.perf_counter() - t0, library=str(lib), cached=False,
        ptxas=report,
    )
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # f, lines, ext, blkidx, nvisit, wcoef, blkpol, tab, part, out, Z, nf,
    # nl, nweid, split, stream (voigt_sum_pol alike)
    "voigt_sum": [_P] * 10 + [_I] * 5 + [_P],
    # pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt, ub, vb,
    # n, L, B, sweeps, qp, qm, ebt, ebb (null without the beam), mu0, stream
    "disort_stage1": [_P] * 14 + [_I] * 4 + [_P] * 4 + [ctypes.c_double, _P],
    # n, beam, blocks per SM (out), dynamic shared memory bytes (out)
    "disort_stage1_occupancy": [_I, _I, _P, _P],
    # gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, S, utop, vtop, ubot, vbot,
    # n, L, B, stream
    "disort_stage23": [_P] * 14 + [_I] * 3 + [_P],
    "voigt_sum_pol": [_P] * 10 + [_I] * 5 + [_P],
    # f, rec, out, part, Z, F, NP, P, slabs of part, stream
    "zeeman_mp": [_P] * 4 + [_I] * 5 + [_P],
    # a [B, n, n] row-major, w [B, n], v [B, n, n], n, B, sweeps, stream
    "eigh_jacobi": [_P] * 3 + [_I] * 3 + [_P],
    # pp, pm, om, dtau, qtab, k, ek, gp, gm, n, L, B, sweeps, stream
    "fused_eigen": [_P] * 9 + [_I] * 4 + [_P],
}


@functools.cache
def library():
    """The loaded kernel library (built first if needed)."""
    lib = ctypes.CDLL(str(build()))
    for base, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def launch(name, dtype, *args, counter=None):
    """Call kernel `name` for `dtype` on the current stream; raise on a
    launch error; count the launch (under `counter`, default `name`)."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(library(), f"{name}_{suffix}")
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}_{suffix}: CUDA error {rc} at launch")
    LAUNCHES[counter or name] += 1


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def check(name, t, device, dtype, shape=None):
    """Raise unless tensor t is on `device`, of `dtype`, contiguous and
    (when given) of `shape`."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
