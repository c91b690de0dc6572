"""Time design variants of the Zeeman parent-pole kernel on one NVIDIA card,
beside a parent checkout's kernel.

    python3 tools/zeeman_mp_variants.py [--parent DIR]

Each variant is arts_tpu_torch/csrc/zeeman_mp.cu with text substitutions
(VARIANTS): of its constants, frequencies per thread (FPT, shipped 2),
threads per block (shipped 128), parents per staged chunk (shipped 32),
parents per iteration of the summing loop (shipped 2) and parts of the
parents (kSplit: blocks over the parents of one tile and level, added by
combine_kernel; shipped 4); and of whole blocks of code, for designs the
shipped kernel does not carry: the block's window test per chunk of 32
parents (a hit keeps all 32) or none, the IEEE quotient or the hardware
reciprocal without its Newton step in place of jacobi::recip, no warp
filter (each warp sums every staged parent, the masks as selects), and a
thread's FPT frequencies kThreads apart in place of next to each other;
some in combination.  With --parent, DIR is a checkout of an earlier
commit (git archive), whose csrc/zeeman_mp.cu is built too and called on
the same inputs in its own layout (unpadded records, 256 threads).

Every library is built with the package's nvcc flags (one nvcc each, all
started together) under arts_tpu_torch/_build/, held against
zeeman_mp_plain on each case (each of the 7 components within 2e-6 of its
own scale in float32, 1e-12 in float64; exactly 0 where the plain
version's is) and timed with CUDA events: 20 calls per library (both
kernels), all in turn, 3 rounds, the median round.  Cases: the benchmark's
Zeeman stage pole records (60 levels, 2048 parents, 4096 frequencies,
float32; the shipped kernel and the parent's also in float64) and
scene.build_zeeman_mp_case at 60 levels, 2061 parents, 4173 frequencies.
Beside them it times a loop of independent FFMAs (CALIBRATION: the
float32 rate the card reaches on nothing else), counts the instructions
of the shipped float32 kernel's summing loop (kUnroll parents at kFPT
frequencies) in its machine code (cuobjdump), and, per case, the pairs
the shipped warp filter keeps (each warp's 32 kFPT frequencies times the
parents whose window reaches them): those pairs at the loop's
instructions per pair and the FFMA loop's rate give the time the shipped
kernel would take at that rate.
Prints the card, each library's ptxas lines for zeeman_mp_kernel, then
per case its pairs and bound (chip_smoke.bound of pair_counts and
pair_flops) and one line per library.  Exits non-zero if a
library does not build or does not match, a substitution finds no
target, or no card is present.
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
from arts_tpu_torch.ops import zeeman_mp_kernel as MP  # noqa: E402

def const(name, value):
    """(shipped line, variant line) of the integer constant `name`."""
    line = f"constexpr int {name} = {{}};"
    return lambda n: (line.format(value), line.format(n))


FPT_ = const("kFPT", 2)
THREADS_ = const("kThreads", 128)
CHUNK_ = const("kPB", 32)
UNROLL_ = const("kUnroll", 2)
SPLIT_ = const("kSplit", 4)
WINDOW_TEST = """    unsigned mask = 0u;
#pragma unroll 8
    for (int i = 0; i < kScan; ++i) {
      if (i < nq) {
        const T* r = rz + static_cast<long>(q0 + i) * W;
        const T c = r[0], cut = r[4];
        const bool hit = lo - c <= cut && hi - c >= -cut;
        mask |= static_cast<unsigned>(hit) << i;
      }
    }
"""
VALID = "(nq == kScan ? 0xffffffffu : (1u << nq) - 1u)"  # bits of the nq parents
PER_CHUNK = (WINDOW_TEST, WINDOW_TEST + f"    if (mask != 0u) mask = {VALID};\n")
NO_WINDOW_TEST = (WINDOW_TEST, f"    unsigned mask = {VALID};\n")
RECIP = "const T invR = R * recip(d2);"
DIVIDE = (RECIP, "const T invR = R / d2;")
POLE = "// one parent's terms at the thread's kFPT frequencies, added to part"
NO_NEWTON = [(RECIP, "const T invR = R * rcp_approx(d2);"), (POLE, """\
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ double rcp_approx(double x) { return 1.0 / x; }

""" + POLE)]
NO_FILTER = ("""      // the same window test against the warp's range, 32 parents a ballot
      for (int p0 = 0; p0 < rows; p0 += 32) {
        const T* r = buf + (p0 + lane) * W;
        const bool hit = p0 + lane < rows && wlo - r[0] <= r[4] && whi - r[0] >= -r[4];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) sel[__popc(m & ((1u << lane) - 1u))] = p0 + lane;
        __syncwarp();
        const int n = __popc(m);
#pragma unroll kUnroll
        for (int i = 0; i < n; ++i) pole<T, P>(buf + sel[i] * W, fv, part);
        __syncwarp();  // sel is read before the next ballot writes it
      }
""", """#pragma unroll kUnroll
      for (int p = 0; p < rows; ++p) pole<T, P>(buf + p * W, fv, part);
""")
STRIDED = ("fi[k] = base + tid * kFPT + k;", "fi[k] = base + k * kThreads + tid;")
SHIPPED = "shipped"
VARIANTS = {
    SHIPPED: [],
    "split 1": [SPLIT_(1)],
    "split 2": [SPLIT_(2)],
    "split 8": [SPLIT_(8)],
    "FPT 1": [FPT_(1)],
    "FPT 4": [FPT_(4)],
    "FPT 8": [FPT_(8)],
    "64 threads": [THREADS_(64)],
    "256 threads": [THREADS_(256)],
    "chunks of 16": [CHUNK_(16)],
    "chunks of 64": [CHUNK_(64)],
    "window test per chunk of 32": [PER_CHUNK],
    "no window test": [NO_WINDOW_TEST],
    "IEEE divide": [DIVIDE],
    "no Newton step": NO_NEWTON,
    "no warp filter (selects only)": [NO_FILTER],
    "strided frequencies, no warp filter": [STRIDED, NO_FILTER],
    "1 parent per loop iteration": [UNROLL_(1)],
    "4 parents per loop iteration": [UNROLL_(4)],
    "FPT 4, 1 parent per loop iteration": [FPT_(4), UNROLL_(1)],
    "chunks of 64, no Newton step": [CHUNK_(64), *NO_NEWTON],
}
# independent FFMA chains and nothing else: the float32 rate this card
# reaches, beside which the kernel's instruction rate is read
CALIBRATION = r"""
#include <cuda_runtime.h>
__global__ void __launch_bounds__(128) ffma_loop(float* out, int iters) {
  float a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = threadIdx.x * 1e-3f + k;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) a[k] = fmaf(a[k], 0.999f, 1e-3f);
  }
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) s += a[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int ffma_loop_launch(float* out, int blocks, int iters, void* stream) {
  ffma_loop<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""
PARENT = "parent"
REPS, ROUNDS = 20, 3
NEW_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
PARENT_SIG = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def start_builds(root, parent):
    """{name: (library path, nvcc process, kSplit)}, one nvcc per library
    (kSplit None for the parent's)."""
    nvcc = _cuda._nvcc()
    (root / "calibration.cu").write_text(CALIBRATION)
    procs = {"calibration": (root / "calibration.so", subprocess.Popen(
        [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(root / "calibration.cu"), "-o",
         str(root / "calibration.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True), None)}
    libs = dict(VARIANTS)
    if parent:
        libs[PARENT] = None
    for i, (name, subs) in enumerate(libs.items()):
        d = root / f"v{i}"
        d.mkdir()
        csrc = parent / "arts_tpu_torch" / "csrc" if subs is None else _cuda.CSRC
        for p in csrc.glob("*.cuh"):
            (d / p.name).write_text(p.read_text())
        text = (csrc / "zeeman_mp.cu").read_text()
        for old, new in subs or []:
            if old not in text:
                raise SystemExit(f"substitution target not in zeeman_mp.cu: {old!r}")
            text = text.replace(old, new)
        (d / "zeeman_mp.cu").write_text(text)
        lib = d / "lib.so"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(d / "zeeman_mp.cu"), "-o", str(lib)]
        split = None if subs is None else int(re.search(r"constexpr int kSplit = (\d+);",
                                                        text).group(1))
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True), split)
    return procs


def load(procs):
    """{name: (f32 function, f64 function, kSplit)}; prints the ptxas lines."""
    out = {}
    for name, (lib, p, split) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on {name!r}:\n{log}")
        if name == "calibration":
            fn = ctypes.CDLL(str(lib)).ffma_loop_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            out[name] = fn
            continue
        print(f"-- {name}", flush=True)
        kernel = None
        for line in log.splitlines():
            m = re.search(r"(zeeman_mp_kernel|combine_kernel)I([fd])", line)
            if "Compiling entry function" in line and m:
                kernel = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>"
            elif kernel and ("Used" in line or "spill" in line):
                print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}", flush=True)
        so = ctypes.CDLL(str(lib))
        fns = []
        for sym in ("zeeman_mp_f32", "zeeman_mp_f64"):
            fn = getattr(so, sym)
            fn.argtypes = PARENT_SIG if name == PARENT else NEW_SIG
            fn.restype = ctypes.c_int
            fns.append(fn)
        out[name] = (*fns, split)
    return out


def calibrate(fn, dev):
    """TFLOP/s of the FFMA loop: 16 blocks of 128 threads per SM."""
    blocks, iters = 16 * torch.cuda.get_device_properties(dev).multi_processor_count, 4096
    out = torch.empty(blocks * 128, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    ms = chip_smoke.cuda_ms(lambda: fn(_cuda.ptr(out), blocks, iters, stream), 20)
    return blocks * 128 * iters * 16 * 2 / (ms * 1e-3) / 1e12


def pole_loop(lib):
    """(instructions, {opcode: count}) of the loop of the float32
    zeeman_mp_kernel in lib (cuobjdump -sass) with the most FFMAs per
    instruction among those of at least 100: one parent's terms."""
    cuobjdump = pathlib.Path(_cuda._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    body = text[text.index("zeeman_mp_kernelIfLi5"):]
    body = body[:body.index("Function :")] if "Function :" in body else body
    code = [(int(a, 16), ins) for a, ins in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    best = (0.0, [])
    for a, ins in code:
        m = re.search(r"BRA (0x[0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < a:
            loop = [i for b, i in code if int(m.group(1), 16) <= b <= a]
            ffma = sum("FFMA" in i for i in loop)
            if ffma >= 100 and ffma / len(loop) > best[0]:
                best = (ffma / len(loop), loop)
    ops = {}
    for ins in best[1]:
        op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
        ops[op] = ops.get(op, 0) + 1
    return len(best[1]), dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def shipped_constant(name):
    """The integer constant `name` of the shipped csrc/zeeman_mp.cu."""
    text = (_cuda.CSRC / "zeeman_mp.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def kept_pairs(f, rec, span):
    """Pairs the warp filter keeps: for each run of `span` adjacent
    frequencies (one warp's), span times the parents whose window reaches
    their range, by the kernel's test."""
    c, cut = rec[..., 0], rec[..., 4]
    n = 0
    for start in range(0, f.shape[0], span):
        fw = f[start:start + span]
        lo, hi = fw.min(), fw.max()
        n += int(((lo - c <= cut) & (hi - c >= -cut)).sum()) * span
    return n


def cases(dev):
    """[(label, f, rec)] on the card, records padded to record_width."""
    from arts_tpu_torch.lbl.zeeman import zeeman_mp_args
    from arts_tpu_torch.scene import build_zeeman_inputs, build_zeeman_mp_case

    out = []
    for dt in (torch.float32, torch.float64):
        d = build_zeeman_inputs(device=dev, dtype=dt)
        poles, _, _ = zeeman_mp_args(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"], d["vmr"],
                                     d["mag"], d["los_za_deg"], mp_kappa=d["tune"]["mp_kappa"])
        out.append((f"bench {str(dt)[6:]}", poles[0].contiguous(), MP.pole_records(*poles[1:])))
    out.append(("random float32", *build_zeeman_mp_case(60, 2061, 4173, seed=9, device=dev,
                                                        dtype=torch.float32)))
    return out


def held(got, want, tol):
    """The largest share of tol of a component's own scale (inf where a
    component that is 0 throughout is not 0)."""
    worst = 0.0
    for c in range(MP.NCOMP):
        err = float((got[:, c].double() - want[:, c].double()).abs().max())
        scale = float(want[:, c].double().abs().max())
        worst = max(worst, err / (tol * scale) if scale > 0 else (0.0 if err == 0 else np.inf))
    return worst


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
        procs = start_builds(pathlib.Path(tmp), args.parent)
        work = cases(dev)
        libs = load(procs)
        rate = calibrate(libs.pop("calibration"), dev)
        print(f"FFMA loop: {rate:.2f} TFLOP/s ({rate / (chip_smoke.FP32_FLOPS / 1e12):.1%} of "
              f"{chip_smoke.FP32_FLOPS / 1e12:.0f})", flush=True)
        n, ops = pole_loop(procs[SHIPPED][0])
        fpt, unroll = shipped_constant("kFPT"), shipped_constant("kUnroll")
        per_pair = n / (fpt * unroll)
        print(f"shipped zeeman_mp_kernel<float>, summing loop ({unroll} parents x {fpt} "
              f"frequencies): {n} instructions, {per_pair:.1f} per pair {ops}", flush=True)
        stream = lambda: torch.cuda.current_stream().cuda_stream
        bad = []
        for label, f, rec in work:
            dt = f.dtype
            f64 = dt == torch.float64
            tol = 1e-12 if f64 else 2e-6
            Z, NP, _ = rec.shape
            F = f.shape[0]
            want = MP.zeeman_mp_plain(f, rec)
            unpadded = rec[..., :12 + 2 * MP.NCOMP * MP.MP_TERMS].contiguous()
            counts = MP.pair_counts(f, rec)
            pf = MP.pair_flops(MP.MP_TERMS)
            b_ms, b_by = chip_smoke.bound(sum(counts[k] * pf[k] for k in pf),
                                          chip_smoke.nbytes(f, rec) + Z * 7 * F * dt.itemsize)
            kept = kept_pairs(f, rec, 32 * fpt)
            print(f"{label} [{Z} levels, {NP} parents, {F} freqs]: pairs {counts}, bound "
                  f"{b_ms:.4f} ms ({b_by}); the warp filter keeps {kept} pairs "
                  f"({kept / (Z * NP * F):.1%} of all): {kept * per_pair * 2 / rate / 1e9:.4f} ms "
                  f"at {per_pair:.1f} instructions each and the FFMA loop's rate", flush=True)
            timed, errs, buffers = {}, {}, []
            for name, (*fns, split) in libs.items():
                if f64 and name not in (SHIPPED, PARENT):
                    continue
                fn = fns[1 if f64 else 0]
                out = torch.empty((Z, 7, F), dtype=dt, device=dev)
                if name == PARENT:
                    ptrs = tuple(map(_cuda.ptr, (f, unpadded, out)))
                    call = lambda fn=fn, ptrs=ptrs: fn(*ptrs, Z, F, NP, MP.MP_TERMS, 256, stream())
                else:
                    part = torch.empty((split, Z, 7, F), dtype=dt, device=dev)
                    buffers.append(part)  # alive while the timed calls write it
                    ptrs = tuple(map(_cuda.ptr, (f, rec, out, part)))
                    call = lambda fn=fn, ptrs=ptrs, s=split: fn(*ptrs, Z, F, NP, MP.MP_TERMS, s,
                                                                  stream())
                buffers.append(out)
                rc = call()
                torch.cuda.synchronize()
                if rc:
                    raise SystemExit(f"{name!r}: CUDA error {rc} at launch")
                errs[name] = held(out, want, tol)
                if not errs[name] <= 1.0:
                    bad.append(f"{name} on {label}: {errs[name]:.3g} of the tolerance")
                timed[name] = call
            times = {key: [] for key in timed}
            for _ in range(ROUNDS):
                for key, call in timed.items():
                    times[key].append(chip_smoke.cuda_ms(call, REPS))
            for key, ts in times.items():
                med = float(np.median(ts))
                print(f"  {key}: {med:.4f} ms ({b_ms / med:.1%} of the bound; rounds "
                      f"{', '.join(f'{t:.4f}' for t in ts)}), {errs[key]:.2e} of the tolerance",
                      flush=True)
        if bad:
            raise SystemExit("variants beyond the tolerance:\n" + "\n".join(bad))


if __name__ == "__main__":
    main()
