"""Time design variants of the DISORT stage 1 and fused_eigen kernels on one
NVIDIA card.

    python3 tools/stage1_variants.py

Each variant is arts_tpu_torch/csrc/disort_fused.cu with one text
substitution: the team of threads per (lane, layer) problem (4 = n/2 or 1
in place of 2 at n = 8; or n = 8, one column of M each), the registers
capped so that 4 blocks fit an SM, H1/H2 read from pp/pm in global memory
at each use in place of the problem's shared tiles, or IEEE division and
square root in the rotation angle in place of the hardware approximations
with their Newton steps.  Every variant, the shipped source
included, is built with the package's nvcc flags into a library of its own
(one nvcc each, all started together) under arts_tpu_torch/_build/, held
against stage1_plain and eigen_lanes_plain on random scattering problems at
the bench shape (59 layers x 4096 lanes, 16 streams, float32;
scene.build_stage1_case), every output mode for mode at rtol 1e-4 of its
own scale (G+- also 1e-6 of their shared scale, for cancellation), and
timed with CUDA events on those problems and on the bench scene's stage 1
inputs: 20 calls per variant, the variants in turn, 3 rounds, the median
round.  Prints the card, then one line per variant: stage 1 ms on the
random and on the bench inputs, fused_eigen ms on the random inputs with
the sweeps and without them (sweeps = 0: the time outside the Jacobi), the
ptxas registers, stack and spill stores of stage1_kernel<float, 8> and
fused_eigen_kernel<float, 8>, and the largest difference.  Exits non-zero
if a variant does not build, does not match, or no card is present.
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
from arts_tpu_torch.disort import eigen_kernel as EK  # noqa: E402
from arts_tpu_torch.disort import fused_kernel as FK  # noqa: E402
from arts_tpu_torch.scene import build_scene, build_stage1_case  # noqa: E402

ROT = "rot_fast(lo ? maa : mbb, lo ? mbb : maa, mab, c, s);"  # both call sites
VARIANTS = {
    "shipped: a team of 2 threads per problem, two pairs each": [],
    "a team of 4 (n/2), one pair each": [("constexpr int kTeamMax = 2;", "constexpr int kTeamMax = 4;")],
    "one thread per problem": [("constexpr int kTeamMax = 2;", "constexpr int kTeamMax = 1;")],
    "a team of n = 8, one column each": [("constexpr bool kSeatPerThread = false;",
                                          "constexpr bool kSeatPerThread = true;")],
    "registers capped for 4 blocks per SM": [("__launch_bounds__(kThreads1)",
                                              "__launch_bounds__(kThreads1, 4)")],
    "H1/H2 from pp/pm at each use, no H tiles": [("constexpr bool kTilesShared = true;",
                                                  "constexpr bool kTilesShared = false;")],
    "IEEE division and square root in the rotation angle": [(ROT, ROT.replace("rot_fast", "jacobi::rot_cs"))],
}
L, B, NQUAD, SWEEPS, REPS, ROUNDS = 59, 4096, 16, 6, 20, 3


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


def start_builds(root):
    """{name: (library path, nvcc process)}, one nvcc per variant."""
    nvcc = _cuda._nvcc()
    procs = {}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        d = root / f"v{i}"
        d.mkdir()
        lib = d / "lib.so"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(sources(subs, d)), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return procs


def load(procs):
    """{name: (stage 1 function, fused_eigen function, ptxas text)}."""
    out = {}
    for name, (lib, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{log}")
        so = ctypes.CDLL(str(lib))
        fns = []
        for sym, sig in (("disort_stage1_f32", "disort_stage1"), ("fused_eigen_f32", "fused_eigen")):
            fn = getattr(so, sym)
            fn.argtypes = _cuda._SIGNATURES[sig]
            fn.restype = ctypes.c_int
            fns.append(fn)
        out[name] = (*fns, log)
    return out


def ptxas(log, kernel):
    """'R registers, stack S B, spill stores P B' of kernel<float, 8>."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and f"{kernel}IfLi8E" in line:
            tail = " ".join(lines[i + 1:i + 4])
            regs = re.search(r"Used (\d+) registers", tail)
            stack = re.search(r"(\d+) bytes stack frame", tail)
            spill = re.search(r"(\d+) bytes spill stores", tail)
            return (f"{regs.group(1)} registers, stack {stack.group(1)} B, "
                    f"spill stores {spill.group(1)} B")
    return "ptxas line not found"


def bench_inputs(dev):
    """stage1_inputs of the bench scene (build_scene, float32)."""
    from arts_tpu_torch import gas_absorption_profile
    from arts_tpu_torch.disort.solver import solve_terms
    from arts_tpu_torch.fwd_allsky import allsky_input

    kw = dict(device=dev, dtype=torch.float32)
    scene, f = build_scene(**kw)
    t = solve_terms(allsky_input(scene, f, gas_absorption_profile(scene, f, **kw), NQUAD), NQUAD, 1)
    return FK.stage1_inputs(t["leg_scaled"], t["omega_p"], t["dtau_p"], t["tb0"], t["tb1"],
                            lam=t["lam"], sign=t["sign"], mu=t["mu"], w=t["w"])


def worst(got, want, pm_pairs):
    """Largest |diff| over the outputs as a share of its limit: rtol 1e-4 of
    each output's scale, plus 1e-6 of the G+- shared scale for the outputs
    at the indices pm_pairs; and the largest |diff| of scale."""
    g_scale = max(float(want[i].abs().max()) for i in pm_pairs)
    share, rel = 0.0, 0.0
    for i, (x, y) in enumerate(zip(got, want)):
        own = float(y.abs().max())
        err = float((x.double() - y.double()).abs().max())
        if not bool(torch.isfinite(x).all()):
            return float("inf"), float("inf")
        share = max(share, err / (1e-4 * own + (1e-6 * g_scale if i in pm_pairs else 0.0)))
        rel = max(rel, err / own)
    return share, rel


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD) as tmp:
        procs = start_builds(pathlib.Path(tmp))
        ins = {"random": build_stage1_case(NQUAD, B, L, seed=L, device=dev, dtype=torch.float32),
               "bench": bench_inputs(dev)}
        libs = load(procs)
        n = NQUAD // 2
        want1 = FK.stage1_plain(*ins["random"], SWEEPS)
        pp, pm, om, dtau, _, _, qtab = ins["random"]
        want8 = EK.eigen_lanes_plain(pp, pm, om, dtau, qtab, SWEEPS)
        outs = {key: tuple(torch.empty_like(w) for w in want1) for key in ins}
        outs8 = tuple(torch.empty_like(w) for w in want8)
        args1 = {key: tuple(map(_cuda.ptr, ins[key] + outs[key])) + (n, L, B, SWEEPS) for key in ins}
        args8 = tuple(map(_cuda.ptr, (pp, pm, om, dtau, qtab) + outs8)) + (n, L, B, SWEEPS)
        args0 = args8[:-1] + (0,)

        def call(fn, args):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        errs = {}
        for name, (f1, f8, _) in libs.items():
            for o in outs["random"] + outs8:
                o.fill_(float("nan"))
            call(f1, args1["random"])
            call(f8, args8)
            torch.cuda.synchronize()
            s1, r1 = worst(outs["random"], want1, (1, 2))
            s8, r8 = worst(outs8, want8, (2, 3))
            if max(s1, s8) > 1.0:
                raise SystemExit(f"variant {name!r}: stage 1 at {s1:.2f}, fused_eigen at {s8:.2f} "
                                 f"of their limits")
            errs[name] = max(r1, r8)
        timed = {"random": lambda f1, f8: call(f1, args1["random"]),
                 "bench": lambda f1, f8: call(f1, args1["bench"]),
                 "fused_eigen": lambda f1, f8: call(f8, args8),
                 "no sweeps": lambda f1, f8: call(f8, args0)}
        times = {(name, key): [] for name in libs for key in timed}
        for _ in range(ROUNDS):
            for name, (f1, f8, _) in libs.items():
                for key, fn in timed.items():
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    fn(f1, f8)
                    a.record()
                    for _ in range(REPS):
                        fn(f1, f8)
                    b.record()
                    torch.cuda.synchronize()
                    times[name, key].append(a.elapsed_time(b) / REPS)
        for name, (_, _, log) in libs.items():
            ms = {key: sorted(times[name, key])[ROUNDS // 2] for key in timed}
            rounds = "; ".join(f"{key} " + ", ".join(f"{t:.4f}" for t in times[name, key])
                               for key in timed)
            print(f"{name}: stage 1 {ms['random']:.4f} ms (bench inputs {ms['bench']:.4f}), "
                  f"fused_eigen {ms['fused_eigen']:.4f} ms ({ms['no sweeps']:.4f} without the "
                  f"sweeps) (rounds: {rounds}); stage1_kernel "
                  f"{ptxas(log, 'stage1_kernel')}; fused_eigen_kernel "
                  f"{ptxas(log, 'fused_eigen_kernel')}; max|diff| {errs[name]:.2e} of scale",
                  flush=True)


if __name__ == "__main__":
    main()
