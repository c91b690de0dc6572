"""Time design variants of the DISORT stage 2+3 kernel on one NVIDIA card.

    python3 tools/stage23_variants.py

Each variant is arts_tpu_torch/csrc/disort_fused.cu with one text
substitution: fewer lanes per block, 16 threads per lane in place of 8
(n = 8 only), or the IEEE quotient in place of the float32 pivot
reciprocal (rcp.approx and one Newton step).  Every variant, the shipped
source included, is built with the package's nvcc flags into a library of
its own (one nvcc each, all started together) under arts_tpu_torch/_build/,
held against stage23_plain on random problems at the bench shape (59
layers x 4096 lanes, 16 streams, float32; scene.build_stage23_case) at
rtol 1e-4 of the largest radiance, and timed with CUDA events: 20 calls
per variant, the variants in turn, 3 rounds, the median round.  Prints
the card, then one line per variant: ms, ptxas registers and spill
stores, max |diff| of scale.  Exits non-zero if a variant does not build,
does not match, or no card is present.
"""

import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arts_tpu_torch import _cuda  # noqa: E402
from arts_tpu_torch.disort import fused_kernel as FK  # noqa: E402
from arts_tpu_torch.scene import build_stage23_case  # noqa: E402

N4 = "  if (n == 4) return launch_stage23<T, 4>(a, o, L, B, s);\n"
RCP = "  asm(\"rcp.approx.ftz.f32 %0, %1;\" : \"=f\"(r) : \"f\"(x));\n  return fmaf(r, fmaf(-x, r, 1.0f), r);\n"
VARIANTS = {
    "shipped: 8 threads per lane, 16 lanes per block": [],
    "8 lanes per block": [("constexpr int kLanes = 16;", "constexpr int kLanes = 8;")],
    "4 lanes per block": [("constexpr int kLanes = 16;", "constexpr int kLanes = 4;")],
    "16 threads per lane": [("constexpr int kTPL = 8;", "constexpr int kTPL = 16;"), (N4, "")],
    "IEEE pivot reciprocal": [(RCP, "  r = 1.0f / x;\n  return r;\n")],
}
L, B, NQUAD, REPS, ROUNDS = 59, 4096, 16, 20, 3


def sources(subs, d):
    """Copy of csrc in d with the substitutions applied to disort_fused.cu."""
    for p in _cuda.CSRC.glob("*.cuh"):
        (d / p.name).write_text(p.read_text())
    text = (_cuda.CSRC / "disort_fused.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"substitution target not in disort_fused.cu: {old!r}")
        text = text.replace(old, new)
    (d / "disort_fused.cu").write_text(text)
    return d / "disort_fused.cu"


def build_all(root):
    """{name: (ctypes function, ptxas text)}, one nvcc per variant."""
    nvcc = _cuda._nvcc()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        d = root / f"v{i}"
        d.mkdir()
        lib = d / "lib.so"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(sources(subs, d)), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{log}")
        fn = ctypes.CDLL(str(lib)).disort_stage23_f32
        fn.argtypes = _cuda._SIGNATURES["disort_stage23"]
        fn.restype = ctypes.c_int
        out[name] = (fn, log)
    return out


def ptxas(log):
    """'registers R, spill stores S B' of stage23_kernel<float, 8>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "stage23_kernelIfLi8E" in line:
            tail = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            return f"registers {regs.group(1)}, spill stores {spill.group(1)} B"
    return "ptxas line not found"


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    ins = build_stage23_case(NQUAD, B, L, seed=L, device=dev, dtype=torch.float32)
    want = FK.stage23_plain(*ins)
    scale = max(float(w.double().abs().max()) for w in want)
    n = NQUAD // 2
    S = torch.empty((L, B, n + 1, 2 * n), device=dev)
    outs = tuple(torch.empty((L, n, B), device=dev) for _ in range(4))
    args = tuple(map(_cuda.ptr, ins + (S,) + outs)) + (n, L, B)
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD) as tmp:
        libs = build_all(pathlib.Path(tmp))

        def call(fn):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        errs = {}
        for name, (fn, _) in libs.items():
            for o in outs:
                o.fill_(float("nan"))
            call(fn)
            torch.cuda.synchronize()
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(outs, want))
            if not all(bool(torch.isfinite(g).all()) for g in outs) or err > 1e-4 * scale:
                raise SystemExit(f"variant {name!r}: max |diff| {err:.3e} of scale {scale:.3e}")
            errs[name] = err / scale
        times = {name: [] for name in libs}
        for _ in range(ROUNDS):
            for name, (fn, _) in libs.items():
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                call(fn)
                a.record()
                for _ in range(REPS):
                    call(fn)
                b.record()
                torch.cuda.synchronize()
                times[name].append(a.elapsed_time(b) / REPS)
        for name, (_, log) in libs.items():
            ms = sorted(times[name])[ROUNDS // 2]
            print(f"{name}: {ms:.4f} ms (rounds {', '.join(f'{t:.4f}' for t in times[name])}); "
                  f"{ptxas(log)}; max|diff| {errs[name]:.2e} of scale", flush=True)


if __name__ == "__main__":
    main()
