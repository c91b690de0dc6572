"""Time design variants of the DISORT stage 1 and fused_eigen kernels on one
NVIDIA card.

    python3 tools/stage1_variants.py
    python3 tools/stage1_variants.py --beam --parent DIR

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

With --beam, the beam instance stage1_kernel<float, 8, true> instead: the
parent's disort_fused.cu (DIR, a checkout such as `git archive` of the
parent commit), the shipped source and the float32 beam instance's
registers capped at 96 (a __launch_bounds__ minimum of 5 blocks) or 104
(__maxnreg__), each built into a library of its own, run on scene.build_beam_case
problems at the solar scene's shape (65,536 lanes x 59 layers, 16
streams, mu0 = 0.5, float32), held against stage1_plain (each output at
rtol 1e-4 of its own scale, G+- also 1e-6 of their shared scale) and
compared with the parent's outputs bit for bit, and timed with CUDA
events beside the same library's thermal instance on the same inputs (5
calls per variant, the variants in turn, 3 rounds, the median round).
Prints per variant the beam and thermal ms and their ratio, the ptxas
registers, stack and spill stores of stage1_kernel<float, 8, true> and
<float, 8, false>, the blocks per SM of each (the CUDA runtime's
occupancy query; the parent's source has none), the largest difference
from the plain version and whether the outputs equal the parent's.  Then
the solar call itself (float32 simulate_allsky on
scene.build_solar_scene, as chip_smoke.py times it) with
disort_fused.cu's entry points from the parent's library and the shipped
one in turn (parent, shipped, shipped, parent; 3 rounds of 5 calls after
a warm-up each), the other kernels the package's: the median ms of each.
"""

import argparse
import ctypes
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arts_tpu_torch import _cuda  # noqa: E402
from arts_tpu_torch.disort import eigen_kernel as EK  # noqa: E402
from arts_tpu_torch.disort import fused_kernel as FK  # noqa: E402
from arts_tpu_torch.scene import build_beam_case, build_scene, build_stage1_case  # noqa: E402

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
BOUNDS = "__launch_bounds__(kThreads1)\nstage1_kernel("
# the float32 beam instance's registers capped at the thermal instance's 96
# (a minimum of 5 blocks per SM; 0 leaves the other instances as they are),
# or at 104 (__maxnreg__: the other instances then compile under a cap of
# 255, which changes their code)
CAP96 = (BOUNDS, "__launch_bounds__(kThreads1, BEAM && sizeof(T) == 4 ? 5 : 0)\nstage1_kernel(")
CAP104 = (BOUNDS, "__launch_bounds__(kThreads1) __maxnreg__(BEAM && sizeof(T) == 4 ? 104 : 255)\n"
                  "stage1_kernel(")

PARENT = "parent"
SHIPPED = "shipped: the beam's solve first, z+- and the attenuation waiting in the X tile"
BEAM_VARIANTS = {
    SHIPPED: [],
    "shipped, the float32 beam instance capped at 96 registers": [CAP96],
    "shipped, the float32 beam instance capped at 104 registers": [CAP104],
}
BEAM_B, BEAM_MU0, BEAM_REPS = 65536, 0.5, 5


def sources(subs, d, csrc=_cuda.CSRC):
    """Copy of csrc in d with the substitutions applied to disort_fused.cu."""
    for p in csrc.glob("*.cuh"):
        (d / p.name).write_text(p.read_text())
    text = (csrc / "disort_fused.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"substitution target not in disort_fused.cu: {old!r}")
        text = text.replace(old, new)
    (d / "disort_fused.cu").write_text(text)
    return d / "disort_fused.cu"


def start_builds(root, variants, parent=None):
    """{name: (library path, nvcc process)}, one nvcc per variant (and the
    parent checkout's source under PARENT)."""
    nvcc = _cuda._nvcc()
    procs = {}
    todo = [(name, subs, _cuda.CSRC) for name, subs in variants.items()]
    if parent is not None:
        todo.insert(0, (PARENT, [], parent / "arts_tpu_torch" / "csrc"))
    for i, (name, subs, csrc) in enumerate(todo):
        d = root / f"v{i}"
        d.mkdir()
        lib = d / "lib.so"
        cmd = [nvcc, *_cuda.NVCC_FLAGS, "-shared", str(sources(subs, d, csrc)), "-o", str(lib)]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    return procs


def load(procs):
    """{name: (stage 1 function, fused_eigen function, ptxas text, library)}."""
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
        out[name] = (*fns, log, so)
    return out


def ptxas(log, kernel):
    """'R registers, stack S B, spill stores P B' of the instance whose
    mangled name holds `kernel` (e.g. "stage1_kernelIfLi8ELb1E")."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
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
        procs = start_builds(pathlib.Path(tmp), VARIANTS)
        ins = {"random": build_stage1_case(NQUAD, B, L, seed=L, device=dev, dtype=torch.float32),
               "bench": bench_inputs(dev)}
        libs = load(procs)
        n = NQUAD // 2
        want1 = FK.stage1_plain(*ins["random"], SWEEPS)
        pp, pm, om, dtau, _, _, qtab = ins["random"]
        want8 = EK.eigen_lanes_plain(pp, pm, om, dtau, qtab, SWEEPS)
        outs = {key: tuple(torch.empty_like(w) for w in want1) for key in ins}
        outs8 = tuple(torch.empty_like(w) for w in want8)
        no_beam = (ctypes.c_void_p(),) * 4 + (0.0,)
        args1 = {key: tuple(map(_cuda.ptr, ins[key] + outs[key])) + (n, L, B, SWEEPS) + no_beam
                 for key in ins}
        args8 = tuple(map(_cuda.ptr, (pp, pm, om, dtau, qtab) + outs8)) + (n, L, B, SWEEPS)
        args0 = args8[:-1] + (0,)

        def call(fn, args):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        errs = {}
        for name, (f1, f8, *_) in libs.items():
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
            for name, (f1, f8, *_) in libs.items():
                for key, fn in timed.items():
                    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    fn(f1, f8)
                    a.record()
                    for _ in range(REPS):
                        fn(f1, f8)
                    b.record()
                    torch.cuda.synchronize()
                    times[name, key].append(a.elapsed_time(b) / REPS)
        for name, (_, _, log, _) in libs.items():
            ms = {key: sorted(times[name, key])[ROUNDS // 2] for key in timed}
            rounds = "; ".join(f"{key} " + ", ".join(f"{t:.4f}" for t in times[name, key])
                               for key in timed)
            print(f"{name}: stage 1 {ms['random']:.4f} ms (bench inputs {ms['bench']:.4f}), "
                  f"fused_eigen {ms['fused_eigen']:.4f} ms ({ms['no sweeps']:.4f} without the "
                  f"sweeps) (rounds: {rounds}); stage1_kernel "
                  f"{ptxas(log, 'stage1_kernelIfLi8ELb0E')}; fused_eigen_kernel "
                  f"{ptxas(log, 'fused_eigen_kernelIfLi8E')}; max|diff| {errs[name]:.2e} of scale",
                  flush=True)


def solar_calls(libs, rounds=ROUNDS, reps=BEAM_REPS):
    """{PARENT: ms, SHIPPED: ms}: the median solar call with disort_fused.cu's
    entry points (stage 1, stages 2+3) from each of the two libraries in
    turn and every other kernel from the package's library."""
    from arts_tpu_torch import gas_absorption_profile, simulate_allsky
    from arts_tpu_torch.scene import build_solar_scene

    dev, dt = torch.device("cuda"), torch.float32
    scene, f, kw = build_solar_scene(device=dev, dtype=dt)
    pkg, real = _cuda.library(), _cuda.library

    class Lib:
        def __init__(self, so):
            self.so = so
            for sym, sig in (("disort_stage1_f32", "disort_stage1"),
                             ("disort_stage23_f32", "disort_stage23")):
                getattr(so, sym).argtypes = _cuda._SIGNATURES[sig]
                getattr(so, sym).restype = ctypes.c_int

        def __getattr__(self, sym):
            return getattr(self.so if sym.startswith("disort_") else pkg, sym)

    swap = {name: Lib(libs[name][3]) for name in (PARENT, SHIPPED)}
    times = {name: [] for name in swap}
    try:
        for _ in range(rounds):
            for name in (PARENT, SHIPPED, SHIPPED, PARENT):
                _cuda.library = lambda lib=swap[name]: lib
                for i in range(reps + 1):
                    t0 = time.perf_counter()
                    simulate_allsky(scene, f, k_gas=gas_absorption_profile(
                        scene, f, device=dev, dtype=dt), **kw, device=dev, dtype=dt)
                    torch.cuda.synchronize()
                    if i:
                        times[name].append((time.perf_counter() - t0) * 1e3)
    finally:
        _cuda.library = real
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def beam_main(parent):
    """The --beam mode: the beam instance's variants beside the parent's."""
    dev = torch.device("cuda")
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_cuda.BUILD) as tmp:
        procs = start_builds(pathlib.Path(tmp), BEAM_VARIANTS, parent)
        ins, beam = build_beam_case(NQUAD, BEAM_B, L, seed=L, mu0=BEAM_MU0, device=dev,
                                    dtype=torch.float32)
        libs = load(procs)
        n = NQUAD // 2
        want = FK.stage1_plain(*ins, SWEEPS, beam)
        torch.cuda.synchronize()
        outs = {name: tuple(torch.empty_like(w) for w in want) for name in libs}
        spare = tuple(torch.empty_like(w) for w in want)
        head = (n, L, BEAM_B, SWEEPS)
        args = {name: tuple(map(_cuda.ptr, ins + outs[name])) + head
                + tuple(map(_cuda.ptr, beam[:4])) + (float(beam[4]),) for name in libs}
        thermal = tuple(map(_cuda.ptr, ins + spare)) + head + (ctypes.c_void_p(),) * 4 + (0.0,)

        def call(fn, a):
            rc = fn(*a, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"launch failed: CUDA error {rc}")

        errs = {}
        for name, (f1, *_) in libs.items():
            for o in outs[name]:
                o.fill_(float("nan"))
            call(f1, args[name])
            torch.cuda.synchronize()
            share, rel = worst(outs[name], want, (1, 2))
            if share > 1.0:
                raise SystemExit(f"variant {name!r}: the beam instance at {share:.2f} of its limit")
            errs[name] = rel
        del want
        times = {(name, key): [] for name in libs for key in ("beam", "thermal")}
        for _ in range(ROUNDS):
            for name, (f1, *_) in libs.items():
                for key, a in (("beam", args[name]), ("thermal", thermal)):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    call(f1, a)
                    e0.record()
                    for _ in range(BEAM_REPS):
                        call(f1, a)
                    e1.record()
                    torch.cuda.synchronize()
                    times[name, key].append(e0.elapsed_time(e1) / BEAM_REPS)
        for name, (_, _, log, so) in libs.items():
            ms = {key: sorted(times[name, key])[ROUNDS // 2] for key in ("beam", "thermal")}
            rounds = "; ".join(f"{key} " + ", ".join(f"{t:.4f}" for t in times[name, key])
                               for key in ("beam", "thermal"))
            parts = []
            smem = "no occupancy query"
            for what, sym, flag in (("beam", "stage1_kernelIfLi8ELb1E", True),
                                    ("thermal", "stage1_kernelIfLi8ELb0E", False)):
                occ = "? blocks per SM"
                if hasattr(so, "disort_stage1_occupancy_f32"):
                    blocks, nb = FK.stage1_occupancy(n, torch.float32, flag, lib=so)
                    occ, smem = f"{blocks} blocks per SM", f"{nb} B of shared memory per block"
                parts.append(f"{what} {ptxas(log, sym)}, {occ}")
            same = "" if name == PARENT else (
                "; outputs bit for bit the parent's" if all(
                    torch.equal(x, y) for x, y in zip(outs[name], outs[PARENT])) else
                "; outputs differ from the parent's by at most " + ", ".join(
                    f"{float((x.double() - y.double()).abs().max() / y.double().abs().max()):.2e}"
                    for x, y in zip(outs[name], outs[PARENT])) + " of scale (Ek, G+, G-, ut, "
                "vt, ub, vb)")
            print(f"{name}: beam {ms['beam']:.4f} ms, thermal {ms['thermal']:.4f} ms "
                  f"(ratio {ms['beam'] / ms['thermal']:.3f}) at [{L} x {BEAM_B}], mu0 {BEAM_MU0} "
                  f"(rounds: {rounds}); {'; '.join(parts)} ({smem}); max|diff| from the plain "
                  f"version {errs[name]:.2e} of scale{same}", flush=True)
        del ins, beam, outs, spare
        torch.cuda.empty_cache()
        solar = solar_calls(libs)
        print(f"solar call (float32, build_solar_scene), median of {ROUNDS * 2 * BEAM_REPS} "
              f"calls each: parent {solar[PARENT]:.3f} ms, shipped {solar[SHIPPED]:.3f} ms "
              f"({solar[PARENT] - solar[SHIPPED]:.3f} ms saved)", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--beam", action="store_true", help="the beam instance's variants")
    ap.add_argument("--parent", type=pathlib.Path, help="a checkout of the parent (with --beam)")
    cli = ap.parse_args()
    if cli.beam != (cli.parent is not None):
        ap.error("--beam and --parent go together")
    if not cli.beam:
        main()
    else:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True
                             ).stdout.strip(), flush=True)
        beam_main(cli.parent)
