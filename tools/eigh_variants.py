"""Time design variants of the batched Jacobi eigh kernel on one NVIDIA card,
beside a parent checkout's kernel, and compare the eigen stage's machine
code with the parent's.

    python3 tools/eigh_variants.py [--parent DIR]

Each variant is arts_tpu_torch/csrc/eigh_jacobi.cu with one text
substitution: kColValues, the values of M per thread that set the team
size per instance (shipped: float32 32, float64 16; "smaller teams" 56 /
32 and 112 / 64); no exact float32 instances (FMA and rot_fast
at every n); or registers capped for 5 blocks per SM.  With --parent,
DIR is a checkout of an earlier commit (git archive), whose
csrc/eigh_jacobi.cu is built too and called in its own layout (lane
layout [n*n, B] before this design; its wrapper's lane transposes are
timed beside it).  Every library is built with the
package's nvcc flags (one nvcc each, all started together) under
arts_tpu_torch/_build/, held against eigh_jacobi_plain on each case
(eigenvalues within 2e-6 (float32) or 1e-12 (float64) of the eigenvalue
scale, A V = V diag(w) and V^T V = I within 4 of them) and timed with CUDA
events: 20 launches per library, the libraries in turn, 3 rounds, the
median round; the shipped library also at 0 sweeps (the work outside
the sweeps).  Cases: float32 n = 8 on the bench scene's Hsym batch
(241,664 matrices) and on random symmetric batches of that size at n = 8,
13 and 16; float64 n = 8 and 16 on random batches.  Prints the card, each
variant's ptxas lines for the eigh kernels and one line per case and
library: ms, and the bound (chip_smoke.jacobi_flops over 67 TFLOP/s).

With --parent it also compares the machine code of the parent's and this
tree's csrc/disort_fused.cu kernels (tools/sass_diff.py): the eigen core
moved into csrc/jacobi.cuh must leave them unchanged.  Exits non-zero
if a library does not build or does not match, or no card is present.
"""

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from arts_tpu_torch import _cuda  # noqa: E402
from arts_tpu_torch.ops import eigh_jacobi as E  # noqa: E402
import sass_diff  # noqa: E402

TARGET = "constexpr int kColValues = sizeof(T) == 4 ? 32 : 16;"
EXACT = "constexpr bool kExact = sizeof(T) == 4 && N >= 10;"
BOUNDS = "__launch_bounds__(kThreads)\neigh_team_kernel"
SHIPPED = "shipped (float32 32, float64 16 values of M per thread)"
VARIANTS = {
    SHIPPED: [],
    "smaller teams (56 / 32)": [(TARGET, TARGET.replace("32 : 16", "56 : 32"))],
    "smaller teams still (112 / 64)": [(TARGET, TARGET.replace("32 : 16", "112 : 64"))],
    "float32 FMA and rot_fast at every n (no exact instances)": [
        (EXACT, EXACT.replace("sizeof(T) == 4 && N >= 10", "false"))],
    "registers capped for 5 blocks per SM": [
        (BOUNDS, BOUNDS.replace("(kThreads)", "(kThreads, 5)"))],
}
PARENT = "parent"
BATCH, REPS, ROUNDS = 241_664, 20, 3
SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def start_builds(root, parent):
    """{name: (library path, nvcc process)}, one nvcc per library."""
    nvcc = _cuda._nvcc()
    procs = {}
    libs = dict(VARIANTS)
    if parent:
        libs[PARENT] = None
    for i, (name, subs) in enumerate(libs.items()):
        d = root / f"v{i}"
        d.mkdir()
        csrc = parent / "arts_tpu_torch" / "csrc" if subs is None else _cuda.CSRC
        for p in csrc.glob("*.cuh"):
            (d / p.name).write_text(p.read_text())
        text = (csrc / "eigh_jacobi.cu").read_text()
        for old, new in subs or []:
            if old not in text:
                raise SystemExit(f"substitution target not in eigh_jacobi.cu: {old!r}")
            text = text.replace(old, new)
        (d / "eigh_jacobi.cu").write_text(text)
        lib = d / "lib.so"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(d / "eigh_jacobi.cu"), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return procs


def ptxas_lines(log):
    """[(kernel<type, N>, 'Used ...' line)] of the eigh kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(eigh_\w*kernel)I([fd])(?:Li(\d+)E)?", line)
        if "Compiling entry function" in line and m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}" + (
                f", {m.group(3)}>" if m.group(3) else ">")
        elif name and ("Used" in line or "spill" in line):
            out.append((name, line.split(":", 1)[-1].strip()))
    return out


def load(procs):
    """{name: (f32 function, f64 function)}; prints the ptxas lines."""
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name!r}:\n{log}")
        print(f"-- {name}", flush=True)
        for kernel, text in ptxas_lines(log):
            print(f"  ptxas {kernel}: {text}", flush=True)
        so = ctypes.CDLL(str(lib))
        fns = []
        for sym in ("eigh_jacobi_f32", "eigh_jacobi_f64"):
            fn = getattr(so, sym)
            fn.argtypes = SIG
            fn.restype = ctypes.c_int
            fns.append(fn)
        out[name] = tuple(fns)
    return out


def cases(dev):
    """[(label, A [B, n, n] contiguous)]."""
    from arts_tpu_torch.scene import build_scene

    scene, f = build_scene(device=dev, dtype=torch.float32)
    H = chip_smoke.bench_hsym(scene, f, dev, torch.float32)[3]
    out = [("float32 n=8 bench Hsym", H.reshape(-1, 8, 8).contiguous())]
    for dt, ns in ((torch.float32, (8, 13, 16)), (torch.float64, (8, 16))):
        for n in ns:
            out.append((f"{str(dt)[6:]} n={n} random",
                        chip_smoke.random_symmetric(BATCH, n, dt, dev, seed=n)))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, help="a checkout of an earlier commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD) as tmp:
        root = pathlib.Path(tmp)
        procs = start_builds(root, args.parent)
        same_code = sass_diff.compare(args.parent) if args.parent else True
        work = cases(dev)
        libs = load(procs)
        stream = lambda: torch.cuda.current_stream().cuda_stream

        for label, A in work:
            B, n = A.shape[0], A.shape[-1]
            dt = A.dtype
            tol = 2e-6 if dt == torch.float32 else 1e-12
            sweeps = E._default_sweeps(dt)
            w_ref, _ = E.eigh_jacobi_plain(A)
            scale = float(w_ref.abs().max())
            lanes = A.reshape(B, n * n).t().contiguous()
            calls = {}
            for name, fns in libs.items():
                fn = fns[0 if dt == torch.float32 else 1]
                if name == PARENT:
                    w, V = torch.empty((n, B), dtype=dt, device=dev), torch.empty((n * n, B), dtype=dt, device=dev)
                    args_ = (lanes, w, V)
                    unpack = lambda w=w, V=V: (w.t(), V.view(n, n, B).permute(2, 0, 1))
                else:
                    w, V = torch.empty((B, n), dtype=dt, device=dev), torch.empty((B, n, n), dtype=dt, device=dev)
                    args_ = (A, w, V)
                    unpack = lambda w=w, V=V: (w, V)
                ptrs = tuple(map(_cuda.ptr, args_))

                def call(fn=fn, ptrs=ptrs):
                    rc = fn(*ptrs, n, B, sweeps, stream())
                    if rc:
                        raise SystemExit(f"launch failed: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                wk, Vk = unpack()
                err = float((wk - w_ref).abs().max()) / scale
                recon = float((A @ Vk - Vk * wk[:, None, :]).abs().max()) / float(A.abs().max())
                orth = float((Vk.mT @ Vk - torch.eye(n, dtype=dt, device=dev)).abs().max())
                if not err <= tol or not max(recon, orth) <= 4 * tol:
                    raise SystemExit(f"{name!r} on {label}: eigenvalues {err:.2e}, reconstruction "
                                     f"{recon:.2e}, orthogonality {orth:.2e}")
                calls[name] = (call, err)

            def parent_wrapper():
                a = A.reshape(B, n * n).t().contiguous()
                w = torch.empty((n, B), dtype=dt, device=dev)
                V = torch.empty((n * n, B), dtype=dt, device=dev)
                rc = libs[PARENT][0 if dt == torch.float32 else 1](
                    *map(_cuda.ptr, (a, w, V)), n, B, sweeps, stream())
                if rc:
                    raise SystemExit(f"launch failed: CUDA error {rc}")
                return E._from_lanes(w, V.view(n, n, B), (B,))

            timed = {name: c for name, (c, _) in calls.items()}
            zero = tuple(map(_cuda.ptr, (A, torch.empty((B, n), dtype=dt, device=dev),
                                         torch.empty((B, n, n), dtype=dt, device=dev))))
            fn0 = libs[SHIPPED][0 if dt == torch.float32 else 1]
            timed["shipped at 0 sweeps (the work outside the sweeps)"] = (
                lambda: fn0(*zero, n, B, 0, stream()))
            timed["wrapper (this tree)"] = lambda: E.eigh_jacobi_kernel(A)
            if args.parent:
                timed["parent's wrapper (lane transposes)"] = parent_wrapper
            times = {name: [] for name in timed}
            for _ in range(ROUNDS):
                for name, fn in timed.items():
                    times[name].append(chip_smoke.cuda_ms(fn, REPS))
            b_ms, b_by = chip_smoke.bound(B * chip_smoke.jacobi_flops(n, sweeps),
                                          2 * chip_smoke.nbytes(A) + B * n * dt.itemsize)
            print(f"{label} [{B} x {n} x {n}], bound {b_ms:.4f} ms ({b_by}):", flush=True)
            for name, ts in times.items():
                err = f", eigenvalues {calls[name][1]:.2e} of scale" if name in calls else ""
                print(f"  {name}: {float(np.median(ts)):.4f} ms (rounds "
                      f"{', '.join(f'{t:.4f}' for t in ts)}){err}", flush=True)
    if not same_code:
        raise SystemExit("the eigen stage's machine code is not the parent's")


if __name__ == "__main__":
    main()
