"""Smoke run of arts_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card, its power limit, the PyTorch build and its TF32
   settings, and builds the CUDA kernels from arts_tpu_torch/csrc;
2. holds the Voigt kernel against its plain PyTorch version on the
   benchmark scene (top, middle and bottom level) and on a
   Doppler-dominated case that reaches the mid and Weideman tiers;
3. holds the two DISORT kernels against their plain versions at the full
   4096 x 59 x n=8 shape, in float64 and float32-against-float64;
4. drives the all-sky main path (2048 lines x 4096 frequencies x 60
   levels, 16 streams, float32) through gas_absorption_profile and
   simulate_allsky, with every launch counter set to 0 just before and
   read just after, and guards its fluxes and radiances against the
   float64 plain route on the same inputs, on every 16th frequency;
5. prints each kernel's launches, time, plain-version time, largest
   difference and bound as one JSON line, then the card line, then
   {"ok": true, "device": {...}} as the last line.

Every check raises on failure.  Without a CUDA device the script exits
with status 1 and prints no result.  It imports nothing of JAX.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# published peaks of an H100 SXM at its 700 W limit (NVIDIA data sheet):
# float32 outside the tensor cores, and HBM3 bandwidth
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
NQUAD = 16


def log(*args):
    print(*args, flush=True)


def require(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def close(got, want, rtol, atol_scale, what):
    """|got - want| <= atol_scale * max|want| + rtol * |want| everywhere;
    returns the largest absolute difference."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    scale = float(want.abs().max())
    bad = err > atol_scale * scale + rtol * want.abs()
    require(torch.isfinite(got).all(), f"{what}: non-finite values")
    require(not bool(bad.any()), f"{what}: max |diff| {float(err.max()):.3e} "
            f"(scale {scale:.3e}) beyond rtol {rtol} / atol {atol_scale} * scale")
    return float(err.max()), float(err.max()) / scale


def rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


def cuda_ms(fn, reps):
    """Mean device time of fn over reps back-to-back calls, in ms."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops, nbytes_):
    """(ms, "operations" | "bytes"): the larger of the float32 time of the
    operations and the HBM time of the bytes."""
    t_ops = flops / FP32_FLOPS * 1e3
    t_mem = nbytes_ / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def ge_flops(n, k):
    """Operations of the unpivoted elimination in csrc/disort_fused.cu."""
    total = 0
    for i in range(n):
        r = n - 1 - i
        total += 1 + r + k + r * (2 * r + 2 * k) + 2 * k * r
    return total


def stage1_flops(n, sweeps):
    """Operations per (lane, layer) problem of disort_stage1, counted from
    its loops (add, multiply, divide, sqrt and exp count 1)."""
    ops = 7 * n * n  # H1, H2
    ops += 2 * n * n + 2 * n + ge_flops(n, 2) + ge_flops(n, 1) + 9 * n  # thermal
    ops += sum(3 + 2 * j + (n - 1 - j) * (2 * j + 1) for j in range(n))  # Cholesky
    ops += n * sum(1 + 2 * (n - 1 - m) for m in range(n))  # H2 Lc
    ops += sum((n - i) * (1 + 2 * (n - 1 - i)) for i in range(n))  # Lc^T (H2 Lc)
    ops += sweeps * (n - 1) * (n // 2) * (16 + 18 * n)  # Jacobi rotations
    ops += 3 * n  # k, Ek
    ops += sum(n * (2 + 2 * i) for i in range(n))  # Y
    ops += n * n * (2 + 3 * (n - 1) + 2 + 4)  # G+, G-
    return ops


def stage23_flops(n, L):
    """Operations per lane of disort_stage23, counted from its loops."""
    n2 = 2 * n
    fwd = 2 * n * n + n * n2 * n2 + n + ge_flops(n2, n + 1) + n * n * (2 * n2 - 1) \
        + n * (2 * n2 - 1)
    bwd = n2 * n2 + n * (22 + 18 * (n - 1))
    return L * (fwd + bwd) + n * n2 * n2  # + the surface reflection term


def phase_build():
    from arts_tpu_torch import _cuda

    log(card_line())
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}, float32 matmul precision "
        f"{torch.get_float32_matmul_precision()}")
    t0 = time.perf_counter()
    _cuda.library()
    info = _cuda.BUILD_INFO
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {info.get('seconds', 0.0):.1f} s, cached={info.get('cached')}) -> {info['library']}")
    name = None
    for line in info.get("ptxas", "").splitlines():
        m = re.search(r"(voigt_sum_kernel|stage1_kernel|stage23_kernel)I([fd])(?:Li(\d+)E)?", line)
        if "Compiling entry function" in line and m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}" + (
                f", n={m.group(3)}>" if m.group(3) else ">")
        elif "Used" in line and name:
            log(f"  ptxas {name}: {line.split(':', 1)[1].strip()}")
    return _cuda


def level_slice(kin, z):
    f, lines, ext, blkidx, nvisit, wcoef = kin
    return (f, lines[z : z + 1], ext[z : z + 1], blkidx[z : z + 1],
            nvisit[z : z + 1], wcoef)


def phase_voigt(scenes, dev):
    from arts_tpu_torch.lbl.voigt import voigt_sum_args
    from arts_tpu_torch.ops import voigt_kernel as V

    kins = {}
    max_abs = 0.0
    for dt, rtol, atol in ((torch.float64, 0.0, 1e-9), (torch.float32, 2e-6, 5e-7)):
        scene, f = scenes[dt]
        pts = scene.atm.at(scene.atm.z.flip(0))
        kin, _ = V.voigt_inputs(*voigt_sum_args(f, scene.cat, scene.pf, pts.t, pts.p, pts.vmr))
        kins[dt] = kin
        full = V.voigt_kernel(*kin)
        torch.cuda.synchronize()
        for z in (0, kin[1].shape[0] // 2, kin[1].shape[0] - 1):
            want = V.voigt_kernel_plain(*level_slice(kin, z))[0]
            err, r = close(full[z], want, rtol, atol, f"voigt_sum {dt} level {z}")
            log(f"voigt_sum {str(dt)[6:]} level {z:2d}: max|diff| {err:.3e} ({r:.2e} of scale; "
                f"held at rtol {rtol}, atol {atol} * scale)")
            if dt == torch.float32:
                max_abs = max(max_abs, err)

    # Doppler-dominated lines one tile away (tests/test_tpu_kernels.py:59)
    rng = np.random.default_rng(9)
    L, F = 256, 512
    case = [np.linspace(-5e9, 5e9, F), np.sort(rng.uniform(6e9, 15e9, L)),
            rng.uniform(1.0e-9, 1.4e-9, L), rng.uniform(1e-3, 0.3, L),
            rng.normal(size=L), 0.1 * rng.normal(size=L), np.full(L, 1e30),
            np.zeros(L), np.zeros(L)]
    tiers = {}
    for dt, rtol, atol in ((torch.float64, 0.0, 1e-9), (torch.float32, 2e-6, 5e-7)):
        t = [torch.tensor(a, dtype=dt, device=dev) for a in case]
        t[1:] = [c[None] for c in t[1:]]
        kin, _ = V.voigt_inputs(*t)
        got = V.voigt_kernel(*kin)
        torch.cuda.synchronize()
        err, r = close(got, V.voigt_kernel_plain(*kin), rtol, atol, f"voigt_sum Doppler {dt}")
        counts = V.pair_counts(*kin[:5])["visited"]
        log(f"voigt_sum {str(dt)[6:]} Doppler case: max|diff| {err:.3e} ({r:.2e} of scale; "
            f"held at rtol {rtol}, atol {atol} * scale); "
            f"visited pairs per tier {counts}")
        for k, v in counts.items():
            tiers[k] = tiers.get(k, 0) + v
    require(tiers["mid"] > 0 and tiers["weideman"] > 0, f"tiers not reached: {tiers}")

    kin = kins[torch.float32]
    ms = cuda_ms(lambda: V.voigt_kernel(*kin), 20)
    plain_ms = cuda_ms(lambda: V.voigt_kernel_plain(*kin), 2)
    counts = V.pair_counts(*kin[:5])
    pf = V.pair_flops(torch.float32)
    flops = sum(counts["in_window"][k] * pf[k] for k in pf)
    out_bytes = kin[1].shape[0] * kin[0].shape[0] * 4
    b_ms, b_by = bound(flops, nbytes(*kin) + out_bytes)
    log(f"voigt_sum float32, {kin[1].shape[0]} levels: {ms:.3f} ms (plain {plain_ms:.1f} ms); "
        f"visited pairs {counts['visited']}; in-window pairs {counts['in_window']}; "
        f"{flops / 1e9:.2f} GFLOP in window -> bound {b_ms:.4f} ms ({b_by})")
    return dict(
        name="voigt_sum", route="cuda", source="arts_tpu_torch/csrc/voigt_sum.cu",
        replaces="arts_tpu/ops/voigt_kernel.py:869", max_abs_err=max_abs, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def phase_disort(scenes, dev):
    from arts_tpu_torch import gas_absorption_profile
    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.disort import disort
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.disort.solver import solve_terms
    from arts_tpu_torch.fwd_allsky import allsky_input

    scene, f = scenes[torch.float64]
    inp = {torch.float64: allsky_input(scene, f, gas_absorption_profile(
        scene, f, device=dev, dtype=torch.float64), NQUAD)}
    inp[torch.float32] = move(inp[torch.float64], dev, torch.float32)
    s1_in, terms = {}, {}
    for dt, x in inp.items():
        t = terms[dt] = solve_terms(x, NQUAD, 1)
        s1_in[dt] = FK.stage1_inputs(
            t["leg_scaled"], t["omega_p"], t["dtau_p"], t["tb0"], t["tb1"],
            lam=t["lam"], sign=t["sign"], mu=t["mu"], w=t["w"],
        )
    sweeps = {torch.float64: 8, torch.float32: 6}

    def stage1_pair(dt):
        a = FK.stage1(*s1_in[dt], sweeps[dt])
        b = FK.stage1_plain(*s1_in[dt], sweeps[dt])
        torch.cuda.synchronize()
        return a, b

    def s23_inputs(dt, s1):
        t = terms[dt]
        ek, gp, gm, ut, vt, ub, vb = s1
        rhs, rsurf = FK.stage23_inputs(ut, vt, ub, vb, t["rsurf"], t["b_neg"], t["rhs_surf"])
        return (gp, gm, ek, rhs, rsurf, ut, vt, ub, vb)

    # float64 at the JAX fused test's rtol 2e-5; float32 at 1e-4, the same
    # arithmetic rounded in another order (FMA contraction, summation),
    # 30x inside the float32-vs-float64 guard below
    errs = {}
    for dt, rtol in ((torch.float64, 2e-5), (torch.float32, 1e-4)):
        a, b = stage1_pair(dt)
        names = ("ek (sorted)", "ut", "vt", "ub", "vb")
        pairs = [(a[0].sort(1).values, b[0].sort(1).values)] + list(zip(a[3:], b[3:]))
        e1 = 0.0
        for name, (x, y) in zip(names, pairs):
            err, r = close(x, y, rtol, rtol, f"disort_stage1 {dt} {name}")
            e1 = max(e1, err)
            log(f"disort_stage1 {str(dt)[6:]} {name}: max|diff| {err:.3e} ({r:.2e} of scale; "
                f"held at rtol {rtol}, atol {rtol} * scale)")
        s23 = s23_inputs(dt, b)
        x4 = FK.stage23(*s23)
        y4 = FK.stage23_plain(*s23)
        torch.cuda.synchronize()
        e23 = 0.0
        for name, x, y in zip(("utop", "vtop", "ubot", "vbot"), x4, y4):
            err, r = close(x, y, rtol, rtol, f"disort_stage23 {dt} {name}")
            e23 = max(e23, err)
            log(f"disort_stage23 {str(dt)[6:]} {name}: max|diff| {err:.3e} ({r:.2e} of scale; "
                f"held at rtol {rtol}, atol {rtol} * scale)")
        errs[dt] = (e1, e23)

    # the whole fused solve: float64 kernels against float64 plain, and the
    # float32 kernels against float64 plain at the on-chip guard bounds
    kw = dict(nquad=NQUAD, nfourier=1, device=dev)
    ref = disort(inp[torch.float64], plain=True, dtype=torch.float64, **kw)
    got = disort(inp[torch.float64], dtype=torch.float64, **kw)
    for key in ("flux_up", "u0"):
        err, r = close(getattr(got, key), getattr(ref, key), 2e-5, 2e-5, f"disort f64 {key}")
        log(f"fused DISORT float64 kernels vs plain, {key}: max|diff| {err:.3e} "
            f"({r:.2e} of scale; held at rtol 2e-5, atol 2e-5 * scale)")
    got32 = disort(inp[torch.float32], dtype=torch.float32, **kw)
    for key, lim in (("flux_up", 3e-3), ("u0", 5e-3)):
        r = rel(getattr(got32, key), getattr(ref, key))
        log(f"fused DISORT float32 kernels vs float64 plain, {key}: {r:.3e} of scale (limit {lim})")
        require(r <= lim, f"float32 DISORT {key} {r:.3e} > {lim}")

    dt = torch.float32
    s1 = s1_in[dt]
    L, nn, B = s1[0].shape
    n = int(round(nn**0.5))
    ms1 = cuda_ms(lambda: FK.stage1(*s1, 6), 10)
    plain1 = cuda_ms(lambda: FK.stage1_plain(*s1, 6), 2)
    outs1 = FK.stage1_plain(*s1, 6)
    b1 = bound(B * L * stage1_flops(n, 6), nbytes(*s1) + nbytes(*outs1))
    s23 = s23_inputs(dt, outs1)
    ms23 = cuda_ms(lambda: FK.stage23(*s23), 10)
    plain23 = cuda_ms(lambda: FK.stage23_plain(*s23), 2)
    b23 = bound(B * stage23_flops(n, L), nbytes(*s23) + 4 * L * n * B * 4)
    log(f"disort_stage1 float32 [{L} x {B}] n={n}: {ms1:.3f} ms (plain {plain1:.1f} ms), "
        f"bound {b1[0]:.4f} ms ({b1[1]})")
    log(f"disort_stage23 float32 [{L} x {B}] n={n}: {ms23:.3f} ms (plain {plain23:.1f} ms), "
        f"bound {b23[0]:.4f} ms ({b23[1]})")
    common = dict(route="cuda", source="arts_tpu_torch/csrc/disort_fused.cu", library_ms=None)
    return [
        dict(name="disort_stage1", replaces="arts_tpu/disort/fused_kernel.py:447",
             max_abs_err=errs[dt][0], ms=ms1, plain_ms=plain1, bound_ms=b1[0],
             bound_by=b1[1], **common),
        dict(name="disort_stage23", replaces="arts_tpu/disort/fused_kernel.py:489",
             also_replaces="arts_tpu/disort/fused_kernel.py:508",
             max_abs_err=errs[dt][1], ms=ms23, plain_ms=plain23, bound_ms=b23[0],
             bound_by=b23[1], **common),
    ]


def phase_main_path(scenes, dev, _cuda, reps=5):
    from arts_tpu_torch import gas_absorption_profile, simulate_allsky

    scene, f = scenes[torch.float32]
    kw = dict(device=dev, dtype=torch.float32)

    def lbl():
        return gas_absorption_profile(scene, f, **kw)

    def dis(k):
        return simulate_allsky(scene, f, nquad=NQUAD, nfourier=1, k_gas=k, **kw)

    dis(lbl())  # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = dis(lbl())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    log(f"main path launches over {reps} runs: {launches}")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")

    F, Z = f.shape[0], scene.atm.z.shape[0]
    require(tuple(out.flux_up.shape) == (F, Z), f"flux_up shape {tuple(out.flux_up.shape)}")
    require(tuple(out.u0.shape) == (F, Z, NQUAD), f"u0 shape {tuple(out.u0.shape)}")
    require(bool(torch.isfinite(out.flux_up).all() and torch.isfinite(out.u0).all()),
            "non-finite main-path output")

    lbl_ms, dis_ms = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        k = lbl()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        dis(k)
        torch.cuda.synchronize()
        lbl_ms.append((t1 - t0) * 1e3)
        dis_ms.append((time.perf_counter() - t1) * 1e3)
    med = float(np.median(times))
    log(f"main path, float32, {F} freqs x {Z} levels x {scene.cat.n_lines} lines, "
        f"{NQUAD} streams: {F / med:.1f} points/s (median of {reps} runs, "
        f"{med * 1e3:.2f} ms; runs {[round(t * 1e3, 3) for t in times]} ms)")
    log(f"stage times: LBL {np.median(lbl_ms):.2f} ms {[round(t, 3) for t in lbl_ms]}, "
        f"DISORT {np.median(dis_ms):.2f} ms {[round(t, 3) for t in dis_ms]}")

    # one profiled run: device busy share and time by kernel
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dis(lbl())
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages() if e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profiled main-path run: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy:.2f} ms ({busy / wall_ms:.1%}), {sum(r[1] for r in rows)} device ops")
    for ms, count, key in rows[:12]:
        log(f"  {ms:8.3f} ms  x{count:<5d} {key[:100]}")

    # end-to-end guard: the float64 plain route on every 16th frequency, on
    # the same inputs (the float32 scene and grid, cast up); the guard
    # holds the float32 arithmetic, not the float32 rounding of the data
    from arts_tpu_torch._cuda import move

    kw64 = dict(device=dev, dtype=torch.float64, plain=True)
    refs = {
        "same inputs": (move(scene, dev, torch.float64), f[::16].double()),
        "float64 scene (reported, not held)": (scenes[torch.float64][0],
                                               scenes[torch.float64][1][::16]),
    }
    for what, (scene_r, f_r) in refs.items():
        k_ref = gas_absorption_profile(scene_r, f_r, **kw64)
        ref = simulate_allsky(scene_r, f_r, nquad=NQUAD, nfourier=1, k_gas=k_ref, **kw64)
        for key, lim in (("flux_up", 3e-3), ("u0", 5e-3)):
            r = rel(getattr(out, key)[::16], getattr(ref, key))
            log(f"end-to-end, float32 kernels vs float64 plain route ({what}), {key}: "
                f"{r:.3e} of scale (limit {lim})")
            if what == "same inputs":
                require(r <= lim, f"end-to-end {key} {r:.3e} > {lim}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import arts_tpu_torch  # noqa: F401  (fails alone, outside the repository)
    from arts_tpu_torch.scene import build_scene

    t_start = time.perf_counter()
    _cuda = phase_build()
    dev = torch.device("cuda")
    scenes = {dt: build_scene(device=dev, dtype=dt) for dt in (torch.float64, torch.float32)}
    kernels = [phase_voigt(scenes, dev)] + phase_disort(scenes, dev)
    launches = phase_main_path(scenes, dev, _cuda)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
