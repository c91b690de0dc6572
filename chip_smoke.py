"""Smoke run of arts_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card, its power limit, the PyTorch build and its TF32
   settings, and builds the CUDA kernels from arts_tpu_torch/csrc (one
   nvcc per source, all started together), with each kernel's registers
   and spills from ptxas;
2. holds the Voigt kernel against its plain PyTorch version on the
   benchmark scene (top, middle and bottom level) and on a
   Doppler-dominated case that reaches the mid and Weideman tiers, checks
   that two float32 runs are bit-identical, and times it at the default
   split of the visit lists and at SPLITS, beside its bound and ptxas
   report;
3. holds the two DISORT kernels against their plain versions at the full
   4096 x 59 x n=8 shape, in float64 and float32-against-float64; for
   stages 2+3 also on random problems with a reflecting surface, where
   the elimination carries a large part of the radiances, and for stage 1
   on random scattering problems, where the Jacobi sweeps turn the
   eigenvectors away from the coordinate axes (all seven outputs, G+-
   included), each at 4096 + 5 lanes (not a multiple of a block's lanes)
   with 59 layers and with one (L = 1); checks two float32 runs of each
   (and of fused_eigen) bit-identical, times stage 1 on the bench inputs
   and on random problems of their shape, and logs the traffic of stage
   2+3's algorithm beside its bound and the kernels' ptxas report;
4. drives the all-sky main path (2048 lines x 4096 frequencies x 60
   levels, 16 streams, float32) through gas_absorption_profile and
   simulate_allsky, with every launch counter set to 0 just before and
   read just after, and guards its fluxes and radiances against the
   float64 plain route on the same inputs, on every 16th frequency;
5. holds the polarized Voigt kernel against its plain version on the
   benchmark's Zeeman inputs (2048 .par lines -> 62,460 pseudo-lines,
   4096 frequencies) at the top, a middle and the bottom level with an
   oblique field, in float64 and float32, then drives its path,
   zeeman_propmat(backend="pallas") over all 60 levels in float32, with
   the counters set to 0 just before and read just after; at the full
   shape it checks two float32 runs bit-identical and times the kernel as
   in 2;
6. holds the zeeman_mp kernel against its plain version at the full
   [60 levels, 2048 poles, 4096 frequencies] shape and on random pole
   records (scene.build_zeeman_mp_case: 2061 poles, 4173 frequencies, all
   7 components and both halves of the moments nonzero), float64 and
   float32, overall and each component against its own scale, checks two
   float32 runs bit-identical and, level by level, that the near
   correction's points are the kernel's near pairs, and times it, with
   the device times of its two kernels (the sum over the parents and the
   fixed-order combine of the parts) from a profiled run;
7. runs the Zeeman stage as bench.py defines it: zeeman_propmat_profile
   in float32 at the full shape, the median of 5 runs after a warm-up
   (counters set to 0 just before, read just after), zeeman points/s,
   and the guard against the dense zeeman_propmat route at the top and
   bottom levels (max |diff| / max |ref| <= 1e-4);
7b. holds float32 against float64 on identical inputs (the float32 Zeeman
   inputs cast to float64) at the top 5 levels, each level against its own
   largest value: kernel 5's route (zeeman_propmat(backend="pallas"), the
   kernel fed each centre as f0 - anchor plus the remainder of adding its
   offset) and the float32 dense route at 1e-5, the profile route (kernel
   6 and the near correction) at 1e-4, all against the float64 dense route;
8. runs simulate_clearsky_polarized on the 2_zeeman example's scene
   (one O2 118.75 GHz line, 401 frequencies, 51 levels to 100 km, an
   up-looking path in 2 km steps, a constant [0, 3e-5, 3e-5] T field) in
   float64 on the card and on the CPU: equal to 1e-10 of scale, |V| > 0;
8b. runs simulate_clearsky_polarized(background="surface_reflect",
   rte_option="linprop") at full width on scene.build_zeeman_nlte_scene
   (the bench Zeeman catalog and grid, 60 levels, the IGRF-13 field at
   60 N, a surface of reflectance 0.1, a 16-line non-LTE band whose
   populations nlte_fit_profile fits on the card in float64, a
   down-looking path) in float32: the median of 3 calls, the 3 runs
   bit-identical, a profiled call (device operations and busy share);
   float32 against float64 on 256 frequencies (1e-4 of I's scale, each
   Stokes component; V also against its own scale), float64 on the card
   against the CPU (1e-10 of scale), nlte_fit_profile in float64 on the
   card against the CPU (the same iterations, ratios within 1e-8) with
   both times, and igrf13 and add_faraday on the card against the CPU
   (1e-12);
9. (after phase 4, on the benchmark scene) holds the Jacobi eigh kernel
   against its plain version on the differentiable route's Hsym batch
   (241,664 problems of 8 x 8) in float64 and float32 and on random
   float32 batches of that size at n = 13 and 16 (eigenvalues,
   reconstruction, orthogonality), checks two float32 runs bit-identical,
   and times it at the three shapes beside torch.linalg.eigh; holds
   the fused_eigen kernel against its plain version and against the
   differentiable route's eigen stage, then drives its entry point; and
   holds the differentiable all-sky route (simulate_allsky(fast_linalg=
   False)) and the fused route in float32 against the float64 plain
   differentiable route on the same inputs at the bench guards;
10. runs the OEM cloud retrieval at full width (scene.build_cloud_retrieval:
   51 levels, 4096 frequencies, 16 streams, float32): its Jacobian
   against the float64 plain route on the same inputs, then the
   Gauss-Newton retrieval from the prior (counters set to 0 just before,
   read just after), held to the truth, and the times of one forward,
   one Jacobian and one Gauss-Newton iteration;
11. (after phase 8) drives the clear-sky measurement path at full width
   (scene.build_clearsky_measurement: one ATMS scan line of 96 beam
   positions from 824 km over the benchmark scene without its cloud, the
   five 183 GHz channels as 960 Gaussian elements) through
   measurement_vector with the level-cached observer on the Voigt kernel:
   float32 against the float64 plain route on the same inputs (1e-4 of
   scale, with the largest brightness-temperature difference), two
   float32 runs bit-identical, the float64 kernel route against the plain
   route (1e-9 of scale), the cached observer against the direct one on
   two level-aligned paths (the Pallas-vs-XLA bound), the median of 5
   float32 calls with the counts set to 0 just before and read just after
   (one launch of the Voigt kernel per call), a profiled call, the
   measurement Jacobian d y / d H2O VMR at all frequencies by forward
   mode (in chunks of 15 columns) with its time and peak memory, its three
   largest columns against the float64 route on the same inputs (1e-4 of
   each column's largest entry), and the clear-sky water-vapour retrieval
   (scene.build_clearsky_retrieval, float64), each Gauss-Newton iterate on
   the card against the CPU's (1e-10 of scale), converged within 0.02 of
   the truth below 12 km;
12. prints each kernel's launches on its path, time, plain-version time,
   library time, largest difference and bound as one JSON line, then the
   total seconds and the card line, then {"ok": true, "device": {...}} as
   the last line.

Every check raises on failure.  Without a CUDA device the script exits
with status 1 and prints no result.  It imports nothing of JAX.
"""

import dataclasses
import json
import math
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
RADIANCES = ("utop", "vtop", "ubot", "vbot")
# chunks per (level, tile) visit list timed beside the default split
SPLITS = (1, 2, 4, 8, 16)


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


def close(got, want, rtol, atol_scale, what, scale=None):
    """|got - want| <= atol_scale * scale + rtol * |want| everywhere, scale
    max|want| unless given; returns the largest absolute difference and
    its ratio to scale."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    scale = float(want.abs().max()) if scale is None else scale
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


def log_profile(what, fn, top):
    """Profile one call of fn: log its wall time, the device busy share and
    operation count, and the top device operations by time; returns the
    first three.  Only the device's own rows count: the rows of the
    operators that launched them carry the same device time again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    n_ops = sum(r[1] for r in rows)
    log(f"profiled {what}: wall {wall_ms:.2f} ms (profiler on), device busy "
        f"{busy:.2f} ms ({busy / wall_ms:.1%}), {n_ops} device ops")
    for ms, count, key in rows[:top]:
        log(f"  {ms:8.3f} ms  x{count:<5d} {key[:100]}")
    return wall_ms, busy, n_ops


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


def off_axis(ins, sweeps):
    """[n, L * B]: for each eigenvector of the plain eigen stage on the
    stage 1 inputs `ins` (float64), the sine of its angle to the nearest
    coordinate axis, sqrt(1 - max_i V_ij^2); 0 where the sweeps left the
    mode on an axis."""
    from arts_tpu_torch.disort import eigen_kernel as EK
    from arts_tpu_torch.ops.eigh_jacobi import jacobi_sweeps

    pp, pm, om, _, _, _, q = (x.double() for x in ins)
    n = math.isqrt(pp.shape[1])
    H1, H2 = EK.h12_plain(pp, pm, om, q)
    Lc = torch.linalg.cholesky(-H1)
    Hs = -Lc.mT @ H2 @ Lc
    _, V = jacobi_sweeps((0.5 * (Hs + Hs.mT)).reshape(-1, n, n).permute(1, 2, 0), sweeps)
    return torch.sqrt(torch.clamp(1.0 - V.square().amax(0), min=0.0))


def hold_stage1(got, want, rtol, floor, what):
    """Stage 1's seven outputs (Ek, G+, G-, ut, vt, ub, vb) mode for mode:
    each within rtol of its own scale plus rtol of |want| (close), G+ and
    G- also within `floor` of their shared scale; logs one line and
    returns the largest difference."""
    g_scale = max(float(want[i].double().abs().max()) for i in (1, 2))
    worst, parts = 0.0, []
    for i, name in enumerate(("Ek", "G+", "G-", "ut", "vt", "ub", "vb")):
        own = float(want[i].double().abs().max())
        atol = rtol + (floor * g_scale / own if i in (1, 2) else 0.0)
        err, r = close(got[i], want[i], rtol, atol, f"{what} {name}", own)
        worst = max(worst, err)
        parts.append(f"{name} {r:.2e}")
    log(f"{what}: max|diff| of each output's scale: {', '.join(parts)} (held at rtol {rtol}, "
        f"atol {rtol} * scale, G+- also {floor} of their shared scale {g_scale:.3e})")
    return worst


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
        m = re.search(r"(voigt_sum_kernel|combine_kernel|stage1_kernel|stage23_kernel|"
                      r"zeeman_mp_kernel|fused_eigen_kernel|eigh_team_kernel)I([fd])"
                      r"(?:Li(\d+)E)?", line)
        if "Compiling entry function" in line and m:
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}" + (
                f", {m.group(3)}>" if m.group(3) else ">")
        elif name and ("Used" in line or "spill" in line):
            text = line.split(':', 1)[-1].strip()
            PTXAS.setdefault(name, []).append(text)
            log(f"  ptxas {name}: {text}")
    return _cuda


# ptxas lines (registers; stack and spills) per kernel instance, from the build
PTXAS = {}


def log_ptxas(*names):
    for name in names:
        for text in PTXAS.get(name, ["(not in the ptxas report: a cached build keeps it in _build/ptxas_*.log)"]):
            log(f"  {name}: {text}")


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
    require(torch.equal(V.voigt_kernel(*kin), V.voigt_kernel(*kin)),
            "voigt_sum float32: two runs differ")
    ms = cuda_ms(lambda: V.voigt_kernel(*kin), 20)
    by_split = {sp: round(cuda_ms(lambda: V.voigt_kernel(*kin, split=sp), 20), 4)
                for sp in SPLITS}
    plain_ms = cuda_ms(lambda: V.voigt_kernel_plain(*kin), 2)
    counts = V.pair_counts(*kin[:5])
    pf = V.pair_flops(torch.float32)
    flops = sum(counts["in_window"][k] * pf[k] for k in pf)
    out_bytes = kin[1].shape[0] * kin[0].shape[0] * 4
    b_ms, b_by = bound(flops, nbytes(*kin) + out_bytes)
    log(f"voigt_sum float32, {kin[1].shape[0]} levels, {kin[2].shape[-1]} line blocks, "
        f"{int(kin[4].sum())} visits: {ms:.3f} ms at split "
        f"{V.default_split(kin[2].shape[-1])} beside bound {b_ms:.4f} ms ({b_by}); "
        f"by split {by_split}; two runs bit-identical; plain {plain_ms:.1f} ms; "
        f"visited pairs {counts['visited']}; in-window pairs {counts['in_window']}; "
        f"{flops / 1e9:.2f} GFLOP in window")
    log_ptxas("voigt_sum_kernel<float, 1>", "voigt_sum_kernel<double, 1>",
              "combine_kernel<float, 1>")
    return dict(
        name="voigt_sum", route="cuda", source="arts_tpu_torch/csrc/voigt_sum.cu",
        replaces="arts_tpu/ops/voigt_kernel.py:869", max_abs_err=max_abs, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def phase_disort(scenes, dev):
    from arts_tpu_torch import gas_absorption_profile
    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.disort import disort
    from arts_tpu_torch.disort import eigen_kernel as EK
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.disort.solver import solve_terms
    from arts_tpu_torch.fwd_allsky import allsky_input
    from arts_tpu_torch.scene import build_stage1_case, build_stage23_case

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
        for name, x, y in zip(RADIANCES, x4, y4):
            err, r = close(x, y, rtol, rtol, f"disort_stage23 {dt} {name}")
            e23 = max(e23, err)
            log(f"disort_stage23 {str(dt)[6:]} {name}: max|diff| {err:.3e} ({r:.2e} of scale; "
                f"held at rtol {rtol}, atol {rtol} * scale)")
        # random problems with a cold top and a reflecting surface
        # (scene.build_stage23_case), where the homogeneous solution that
        # the elimination computes is a large part of the radiances (on
        # the bench's black surface they are the particular solution to
        # within its rounding, so the checks above hardly see the
        # elimination): the bench's 16 streams and 59 layers and the
        # surface layer alone (L = 1), at 5 lanes past the bench's (not a
        # multiple of the kernel's 16 lanes per block).  The four radiances
        # are held together, at rtol of the largest of them: at L = 1, vtop
        # is the top boundary value alone, which the solve returns through
        # a cancellation of terms of the radiances' scale
        Lb, _, Bb = s23[0].shape
        for Lr in (Lb, 1):
            ins = build_stage23_case(NQUAD, Bb + 5, Lr, seed=Lr, device=dev, dtype=dt)
            x4, y4 = FK.stage23(*ins), FK.stage23_plain(*ins)
            torch.cuda.synchronize()
            what = f"disort_stage23 {str(dt)[6:]} random L={Lr}, B={Bb + 5}"
            scale = max(float(y.double().abs().max()) for y in y4)
            hom = max(float((y.double() - p.double()).abs().max()) for y, p in zip(y4, ins[5:]))
            require(hom >= 100 * rtol * scale, f"{what}: the homogeneous part "
                    f"{hom / scale:.2e} of scale is within 100 rtol")
            err = max(close(x, y, rtol, rtol, f"{what} {name}", scale)[0]
                      for name, x, y in zip(RADIANCES, x4, y4))
            e23 = max(e23, err)
            log(f"{what}: max|diff| {err:.3e} ({err / scale:.2e} of the radiances' scale; held "
                f"at rtol {rtol}, atol {rtol} * that scale); plain radiances minus the "
                f"particular solution {hom / scale:.2e} of that scale")
            if dt == torch.float32:
                require(all(torch.equal(x, y) for x, y in zip(x4, FK.stage23(*ins))),
                        f"{what}: two runs differ")
                log(f"{what}: two runs bit-identical")
        # random scattering problems (scene.build_stage1_case), where the
        # Jacobi sweeps turn the eigenvectors well away from the coordinate
        # axes (in the bench's layers H1 and H2 are diagonal to ~1e-3, so
        # the checks above hardly see the sweeps, and they leave out G+-):
        # all seven outputs mode for mode, at the bench's lanes + 5 with its
        # 59 layers and with one (L = 1); G+- also at `floor` of their shared
        # scale, phase_fused_eigen's allowance for the cancellation in (Y
        # -+ D)/2
        floor = 1e-13 if dt == torch.float64 else 1e-6
        for Lr in (Lb, 1):
            ins = build_stage1_case(NQUAD, Bb + 5, Lr, seed=Lr, device=dev, dtype=dt)
            got = FK.stage1(*ins, sweeps[dt])
            want = FK.stage1_plain(*ins, sweeps[dt])
            torch.cuda.synchronize()
            what = f"disort_stage1 {str(dt)[6:]} random L={Lr}, B={Bb + 5}"
            off = off_axis(ins, sweeps[dt])
            log(f"{what}: the plain eigenvectors' distance from the nearest coordinate axis "
                f"(sine of the angle): median {float(off.median()):.3f}, 10 % quantile "
                f"{float(off.quantile(0.1)):.2e}, largest {float(off.max()):.3f}")
            require(float(off.median()) >= 0.05, f"{what}: the eigenvectors lie near the axes "
                    f"(median sine {float(off.median()):.3e} < 0.05)")
            e1 = max(e1, hold_stage1(got, want, rtol, floor, what))
            if dt == torch.float32 and Lr == Lb:
                require(all(torch.equal(x, y) for x, y in zip(got, FK.stage1(*ins, 6))),
                        f"{what}: two runs differ")
                eig = ins[:4] + (ins[6], 6)
                require(all(torch.equal(x, y) for x, y in zip(EK.eigen_lanes(*eig),
                                                              EK.eigen_lanes(*eig))),
                        f"fused_eigen float32 random L={Lr}, B={Bb + 5}: two runs differ")
                log(f"{what}: two runs bit-identical, and two of fused_eigen")
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
    # the same shape of random problems: nothing in the kernel depends on
    # the data, so the times agree
    s1r = build_stage1_case(NQUAD, B, L, seed=L, device=dev, dtype=dt)
    ms1r = cuda_ms(lambda: FK.stage1(*s1r, 6), 10)
    del s1r
    require(0.8 <= ms1r / ms1 <= 1.25, f"disort_stage1 float32: {ms1r:.3f} ms on random problems "
            f"against {ms1:.3f} ms on the bench inputs of the same shape")
    plain1 = cuda_ms(lambda: FK.stage1_plain(*s1, 6), 2)
    outs1 = FK.stage1_plain(*s1, 6)
    b1 = bound(B * L * stage1_flops(n, 6), nbytes(*s1) + nbytes(*outs1))
    s23 = s23_inputs(dt, outs1)
    ms23 = cuda_ms(lambda: FK.stage23(*s23), 10)
    plain23 = cuda_ms(lambda: FK.stage23_plain(*s23), 2)
    b23 = bound(B * stage23_flops(n, L), nbytes(*s23) + 4 * L * n * B * 4)
    # what the algorithm moves: G+-/Ek read by both passes, the scratch
    # (P and y, [L, B, n + 1, 2n]) written by the forward and read by the
    # backward pass
    traffic = (2 * nbytes(*s23[:3]) + nbytes(*s23[3:]) + 2 * L * B * (n + 1) * 2 * n * 4
               + 4 * L * n * B * 4)
    log(f"disort_stage1 float32 [{L} x {B}] n={n}: {ms1:.3f} ms (plain {plain1:.1f} ms), "
        f"bound {b1[0]:.4f} ms ({b1[1]}); {ms1r:.3f} ms on random problems of that shape")
    log_ptxas("stage1_kernel<float, 8>", "stage1_kernel<float, 4>", "stage1_kernel<double, 8>",
              "stage1_kernel<double, 4>", "fused_eigen_kernel<float, 8>",
              "fused_eigen_kernel<float, 4>", "fused_eigen_kernel<double, 8>",
              "fused_eigen_kernel<double, 4>")
    log(f"disort_stage23 float32 [{L} x {B}] n={n}: {ms23:.3f} ms (plain {plain23:.1f} ms), "
        f"bound {b23[0]:.4f} ms ({b23[1]}; {B * stage23_flops(n, L) / 1e9:.2f} GFLOP); "
        f"the algorithm's own traffic {traffic / 1e6:.1f} MB, "
        f"{traffic / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s")
    log_ptxas("stage23_kernel<float, 8>", "stage23_kernel<float, 4>",
              "stage23_kernel<double, 8>", "stage23_kernel<double, 4>")
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
    for name in ("voigt_sum", "disort_stage1", "disort_stage23"):
        require(launches[name] > 0, f"kernel {name} was not launched on the main path")

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
    log_profile("main-path run", lambda: dis(lbl()), 12)

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


def jacobi_flops(n, sweeps):
    """Operations per matrix of the tournament Jacobi sweeps (csrc/jacobi.cuh):
    per rotation pair ~16 for the angle and 18 n for the row, column and V
    updates, every pair once a sweep: n/2 pairs in each of n - 1 rounds for
    even n; for odd n, n + 1 players in n rounds, the dummy's pairs not
    counted."""
    return sweeps * (n * (n - 1) // 2) * (16 + 18 * n)


def random_symmetric(B, n, dt, dev, seed):
    """B random symmetric n x n matrices X + X^T, X standard normal from a
    seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((B, n, n), generator=g, device=dev, dtype=dt)
    return X + X.mT


def eigen_flops(n, sweeps):
    """Operations per (lane, layer) problem of fused_eigen_kernel: stage 1
    without the thermal particular solution (csrc/disort_fused.cu)."""
    thermal = 2 * n * n + 2 * n + ge_flops(n, 2) + ge_flops(n, 1) + 9 * n
    return stage1_flops(n, sweeps) - thermal


def bench_hsym(scene, f, dev, dt):
    """(disort terms, Pp, Pm, Hsym) of the benchmark scene's DISORT problem
    in dtype dt: Hsym [F, 1, L, n, n], the batch of the differentiable
    route's eigh."""
    from arts_tpu_torch import gas_absorption_profile
    from arts_tpu_torch.disort.solver import hsym, phase_matrices, solve_terms
    from arts_tpu_torch.fwd_allsky import allsky_input

    inp = allsky_input(scene, f, gas_absorption_profile(scene, f, device=dev, dtype=dt), NQUAD)
    t = solve_terms(inp, NQUAD, 1)
    Pp, Pm = phase_matrices(t["leg_scaled"], t["lam"], t["sign"])
    mu = torch.as_tensor(t["mu"], dtype=dt, device=dev)
    w = torch.as_tensor(t["w"], dtype=dt, device=dev)
    return t, Pp, Pm, hsym(Pp, Pm, t["omega_p"], mu, w)[0]


LIB_CHUNK = 16384


def hold_eigh(A, w, V, w_p, tol, what):
    """Eigenvalues within tol of their scale (max |w_p|) of the plain
    version's, A V = V diag(w) within 4 tol of max |A| and V^T V = I within
    4 tol; logs one line, returns the largest eigenvalue difference."""
    n, dt = A.shape[-1], A.dtype
    scale = float(w_p.abs().max())
    err = float((w - w_p).abs().max())
    recon = float((A @ V - V * w[..., None, :]).abs().max()) / float(A.abs().max())
    orth = float((V.mT @ V - torch.eye(n, dtype=dt, device=A.device)).abs().max())
    log(f"{what} [{A.shape[0]} x {n} x {n}]: eigenvalues max|diff| {err:.3e} ({err / scale:.2e} "
        f"of scale; held at {tol}{', bit for bit' if err == 0.0 else ''}); |A V - V diag(w)| / "
        f"|A| {recon:.2e}, |V^T V - I| {orth:.2e} (both held at {4 * tol})")
    require(bool(torch.isfinite(w).all() and torch.isfinite(V).all()), f"{what}: non-finite values")
    require(err <= tol * scale, f"{what} eigenvalues {err / scale:.3e} > {tol}")
    require(recon <= 4 * tol and orth <= 4 * tol,
            f"{what} reconstruction {recon:.3e} / orthogonality {orth:.3e}")
    return err


def phase_eigh(hs, dev):
    """Kernel 7 on the Hsym batch of the benchmark scene (hs, bench_hsym per
    dtype) against its plain version, float64 and float32, and in float32
    on random symmetric batches of the same size at n = 13 (an odd n, a
    zero dummy player) and n = 16; two float32 runs bit-identical; times
    beside the bound, the plain version and torch.linalg.eigh."""
    from arts_tpu_torch import _cuda
    from arts_tpu_torch.ops import eigh_jacobi as E

    max_abs = 0.0
    batches = {}
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
        H = hs[dt][3]
        A = H.reshape(-1, H.shape[-1], H.shape[-1]).contiguous()
        batches[dt] = A
        w, V = E.eigh_jacobi_kernel(A)
        w_p, V_p = E.eigh_jacobi_plain(A)
        torch.cuda.synchronize()
        err = hold_eigh(A, w, V, w_p, tol, f"eigh_jacobi {str(dt)[6:]} bench Hsym")
        log(f"  eigenvectors vs plain: max|diff| {float((V - V_p).abs().max()):.3e}")
        if dt == torch.float32:
            max_abs = err
    A = batches[torch.float32]
    B = A.shape[0]
    rand = {n: random_symmetric(B, n, torch.float32, dev, seed=n) for n in (13, 16)}
    for n, An in rand.items():
        w, V = E.eigh_jacobi_kernel(An)
        hold_eigh(An, w, V, E.eigh_jacobi_plain(An)[0], 2e-6, f"eigh_jacobi float32 random n={n}")
    for what, An in (("bench Hsym n=8", A), ("random n=16", rand[16])):
        w1, V1 = E.eigh_jacobi_kernel(An)
        w2, V2 = E.eigh_jacobi_kernel(An)
        require(torch.equal(w1, w2) and torch.equal(V1, V2),
                f"eigh_jacobi float32 {what}: two runs differ")
    log("eigh_jacobi float32: two runs bit-identical (bench Hsym n=8, random n=16)")
    log_ptxas(*(f"eigh_team_kernel<{t}, {N}>" for t in ("float", "double")
                for N in (4, 6, 8, 10, 12, 14, 16)))

    out = {}
    for what, An in (("bench Hsym", A), ("random n=13", rand[13]), ("random n=16", rand[16])):
        n = An.shape[-1]
        w = torch.empty((B, n), dtype=An.dtype, device=dev)
        V = torch.empty((B, n, n), dtype=An.dtype, device=dev)
        ptrs = tuple(map(_cuda.ptr, (An, w, V)))
        ms = cuda_ms(lambda: _cuda.launch("eigh_jacobi", An.dtype, *ptrs, n, B, 6), 20)
        wrapper_ms = cuda_ms(lambda: E.eigh_jacobi_kernel(An), 20)
        plain_ms = cuda_ms(lambda: E.eigh_jacobi_plain(An), 2)
        # torch.linalg.eigh: cuSOLVER's batched syev refuses batches of 32,768
        # matrices or more (CUSOLVER_STATUS_INVALID_VALUE; 16,384 pass), so the
        # library time is the sum over calls of LIB_CHUNK matrices each
        library_ms = cuda_ms(lambda: [torch.linalg.eigh(c) for c in An.split(LIB_CHUNK)], 2)
        b_ms, b_by = bound(B * jacobi_flops(n, 6), 2 * nbytes(An) + nbytes(w))
        log(f"eigh_jacobi float32 {what} [{B} x {n} x {n}]: kernel {ms:.4f} ms, wrapper "
            f"{wrapper_ms:.4f} ms (plain {plain_ms:.1f} ms, torch.linalg.eigh {library_ms:.3f} ms "
            f"in {-(-B // LIB_CHUNK)} calls of <= {LIB_CHUNK}), bound {b_ms:.4f} ms ({b_by})")
        out[what] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms)
    return dict(name="eigh_jacobi", route="cuda", source="arts_tpu_torch/csrc/eigh_jacobi.cu",
                replaces="arts_tpu/ops/eigh_jacobi.py:235", max_abs_err=max_abs,
                **out["bench Hsym"])


def phase_fused_eigen(hs, dev, _cuda):
    """Kernel 8 on the benchmark scene's layers against its plain version
    (mode for mode) and against the differentiable route's eigen stage
    (sorted k and order-invariant sums); then its entry point, fused_eigen,
    at full width with the counts set to 0 just before and read after."""
    from arts_tpu_torch.disort import eigen_kernel as EK
    from arts_tpu_torch.disort.fused_kernel import stage1_inputs
    from arts_tpu_torch.disort.solver import _eigen

    max_abs = 0.0
    lanes = {}
    # rtol of each output's own scale (float32: stage 1's 1e-4), plus for
    # G+- and the sums below a floor for cancellation, `floor` of a scale
    # shared by the outputs: G+ and G- are (Y + D)/2 and (Y - D)/2, and in
    # the gas-only layers G+ is zero up to the rounding of Y and D, whose
    # scale is G-'s.  The floor lies far below G+'s own largest entry (~1e-4
    # of the shared scale on the benchmark scene), so a wrong G+ cannot
    # hide under it.
    for dt, rtol, floor in ((torch.float64, 1e-12, 1e-13), (torch.float32, 1e-4, 1e-6)):
        t, Pp, Pm, _ = hs[dt]
        zero = torch.zeros_like(t["tb0"])
        s1 = stage1_inputs(t["leg_scaled"], t["omega_p"], t["dtau_p"], zero, zero,
                           lam=t["lam"], sign=t["sign"], mu=t["mu"], w=t["w"])
        pp, pm, om, dtau, _, _, q = s1
        lanes[dt] = (pp, pm, om, dtau, q)
        sw = 8 if dt == torch.float64 else 6
        got = EK.eigen_lanes(pp, pm, om, dtau, q, sw)
        want = EK.eigen_lanes_plain(pp, pm, om, dtau, q, sw)
        torch.cuda.synchronize()
        for name, x, y in zip(("k", "Ek"), got, want):
            err, r = close(x, y, rtol, rtol, f"fused_eigen {dt} {name}")
            log(f"fused_eigen {str(dt)[6:]} {name} vs plain: max|diff| {err:.3e} ({r:.2e} of "
                f"scale; held at rtol {rtol}, atol {rtol} * scale)")
            if dt == torch.float32:
                max_abs = max(max_abs, err)
        g_scale = max(float(y.abs().max()) for y in want[2:])
        for name, x, y in zip(("G+", "G-"), got[2:], want[2:]):
            own = float(y.abs().max())
            err, lim = float((x - y).abs().max()), rtol * own + floor * g_scale
            log(f"fused_eigen {str(dt)[6:]} {name} vs plain: max|diff| {err:.3e} "
                f"({err / own:.2e} of its scale {own:.3e}; held at {lim:.3e} = {rtol} of it "
                f"+ {floor} of the G+- scale {g_scale:.3e})")
            require(bool(torch.isfinite(x).all()) and err <= lim,
                    f"fused_eigen {dt} {name}: max|diff| {err:.3e} > {lim:.3e}")
            if dt == torch.float32:
                max_abs = max(max_abs, err)
        # against the differentiable route's eigen stage (LAPACK-free, sorted):
        # sorted k, and sum_i Ek_i A[:, i] B[:, i]^T (tests/test_tpu_kernels.py:117)
        mu = torch.as_tensor(t["mu"], dtype=dt, device=dev)
        w = torch.as_tensor(t["w"], dtype=dt, device=dev)
        k_r, Gp_r, Gm_r = _eigen(Pp, Pm, t["omega_p"], mu, w)
        L, n, F = got[0].shape
        k_f = got[0].permute(2, 0, 1)  # [F, L, n]
        Ek_f = got[1].permute(2, 0, 1)
        Gp_f, Gm_f = (x.view(L, n, n, F).permute(3, 0, 1, 2) for x in got[2:])
        k_r, Gp_r, Gm_r = k_r[:, 0], Gp_r[:, 0], Gm_r[:, 0]
        Ek_r = torch.exp(-k_r * t["dtau_p"][..., None])
        lim_k, lim_s = (1e-10, 1e-9) if dt == torch.float64 else (1e-4, 1e-4)
        rk = rel(k_f.sort(-1).values, k_r.sort(-1).values)
        # each sum at lim_s of its own scale plus the floor of the largest
        # (the G- G-^T sum's).  On the benchmark scene the sums with G+ are
        # at rounding level (<= 4e-12 at float64), so the comparison with
        # the plain version above is what holds G+
        sums = [(torch.einsum("...i,...ji,...ki->...jk", Ek_f, A_f, B_f),
                 torch.einsum("...i,...ji,...ki->...jk", Ek_r, A_r, B_r))
                for A_r, B_r, A_f, B_f in ((Gp_r, Gm_r, Gp_f, Gm_f), (Gp_r, Gp_r, Gp_f, Gp_f),
                                           (Gm_r, Gm_r, Gm_f, Gm_f))]
        s_scale = max(float(r.abs().max()) for _, r in sums)
        rs = []
        for name, (f_, r) in zip(("G+ G-^T", "G+ G+^T", "G- G-^T"), sums):
            own = float(r.abs().max())
            err, lim = float((f_ - r).abs().max()), lim_s * own + floor * s_scale
            rs.append(err / lim)
            log(f"fused_eigen {str(dt)[6:]} vs the differentiable route's eigen stage, sum of "
                f"Ek {name}: max|diff| {err:.3e} ({err / own:.2e} of its scale {own:.3e}; held "
                f"at {lim:.3e} = {lim_s} of it + {floor} of the largest sum's scale)")
        log(f"fused_eigen {str(dt)[6:]} vs the differentiable route's eigen stage: sorted k "
            f"{rk:.2e} of scale (held at {lim_k})")
        require(rk <= lim_k and max(rs) <= 1.0,
                f"fused_eigen {dt} vs _eigen: k {rk:.3e}, sums at {max(rs):.3e} of their limits")

    pp, pm, om, dtau, q = lanes[torch.float32]
    L, nn, B = pp.shape
    n = math.isqrt(nn)
    ms = cuda_ms(lambda: EK.eigen_lanes(pp, pm, om, dtau, q, 6), 10)
    plain_ms = cuda_ms(lambda: EK.eigen_lanes_plain(pp, pm, om, dtau, q, 6), 2)
    outs = EK.eigen_lanes_plain(pp, pm, om, dtau, q, 6)
    b_ms, b_by = bound(B * L * eigen_flops(n, 6), nbytes(pp, pm, om, dtau, q) + nbytes(*outs))
    log(f"fused_eigen float32 [{L} x {B}] n={n}: {ms:.3f} ms (plain {plain_ms:.1f} ms), "
        f"bound {b_ms:.4f} ms ({b_by})")

    # its path: the entry point on the [F, 1, L, n, n] phase matrices
    t, Pp, Pm, _ = hs[torch.float32]
    kw = dict(omega=t["omega_p"][:, None], dtau=t["dtau_p"][:, None], mu=t["mu"], w=t["w"],
              device=dev)
    EK.fused_eigen(Pp, Pm, **kw)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    k, Ek, Gp, Gm = EK.fused_eigen(Pp, Pm, **kw)
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    log(f"fused_eigen entry point, float32, {tuple(Pp.shape)}: {path_ms:.2f} ms, launches {launches}")
    require(launches["fused_eigen"] > 0, "fused_eigen was not launched by its entry point")
    require(tuple(Gp.shape) == tuple(Pp.shape) and tuple(k.shape) == tuple(Pp.shape[:-1]),
            f"fused_eigen shapes {tuple(k.shape)}, {tuple(Gp.shape)}")
    require(bool(torch.isfinite(Gp).all() and torch.isfinite(k).all()), "non-finite fused_eigen")
    return dict(
        name="fused_eigen", route="cuda", source="arts_tpu_torch/csrc/disort_fused.cu",
        replaces="arts_tpu/disort/eigen_kernel.py:207", launches=launches["fused_eigen"],
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )


def phase_differentiable_allsky(scenes, dev, _cuda, reps=3):
    """The differentiable all-sky route (fast_linalg=False) and the fused
    route in float32 against the float64 plain differentiable route on the
    same inputs, at the bench guards; the route's wall time and launches."""
    from arts_tpu_torch import gas_absorption_profile, simulate_allsky
    from arts_tpu_torch._cuda import move

    scene, f = scenes[torch.float32]
    kw = dict(device=dev, dtype=torch.float32)
    k = gas_absorption_profile(scene, f, **kw)
    route = lambda: simulate_allsky(scene, f, nquad=NQUAD, nfourier=1, k_gas=k,
                                    fast_linalg=False, **kw)
    route()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = route()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(_cuda.LAUNCHES)
    require(launches["eigh_jacobi"] > 0, "eigh_jacobi was not launched on the differentiable route")
    fused = simulate_allsky(scene, f, nquad=NQUAD, nfourier=1, k_gas=k, **kw)
    scene64, f64, k64 = move((scene, f, k), dev, torch.float64)
    ref = simulate_allsky(scene64, f64, nquad=NQUAD, nfourier=1, k_gas=k64, fast_linalg=False,
                          plain=True, device=dev, dtype=torch.float64)
    for what, got in (("differentiable", out), ("fused", fused)):
        for key, lim in (("flux_up", 3e-3), ("u0", 5e-3)):
            r = rel(getattr(got, key), getattr(ref, key))
            log(f"{what} route float32 vs float64 plain differentiable route (same inputs), "
                f"{key}: {r:.3e} of scale (limit {lim})")
            require(r <= lim, f"{what} route {key} {r:.3e} > {lim}")
    log(f"differentiable route, float32, {f.shape[0]} freqs x {scene.atm.z.shape[0]} levels, "
        f"{NQUAD} streams: median {np.median(times):.2f} ms of {reps} runs "
        f"{[round(x, 3) for x in times]}; launches over the {reps} runs {launches}")


# the oblique field of tests/test_zeeman.py:123, under which all 7
# propagation-matrix components are nonzero
OBLIQUE = ([10e-6, -20e-6, 40e-6], 65.0, 30.0)
# the polarized kernel's count over the unpolarized one: 2 per (line,
# frequency) pair for routing each term to its polarization's sum and,
# per frequency, the epilogue's 7 x (3 multiplies + 2 adds); fixed counts,
# so that the bound reads the same work whatever kernel implements it
POL_PAIR_EXTRA, POL_EPILOGUE = 2, 35


def phase_zeeman_pol(zin, dev, _cuda, levels=(0, 29, 59)):
    """The polarized Voigt kernel against its plain version, then its path."""
    from arts_tpu_torch.lbl.zeeman import voigt_sum_pol_args, zeeman_propmat
    from arts_tpu_torch.ops import voigt_kernel as V

    sel = list(levels)
    max_abs = 0.0
    for dt, rtol, atol in ((torch.float64, 0.0, 1e-12), (torch.float32, 2e-5, 2e-6)):
        d = zin[dt]
        mag = torch.tensor(OBLIQUE[0], dtype=dt, device=dev)
        args, _ = voigt_sum_pol_args(d["f_grid"], d["zcat"], d["pf"], d["T"][sel],
                                     d["P"][sel], d["vmr"][sel], mag, *OBLIQUE[1:])
        kin, _ = V.voigt_inputs(*args[:9], polidx=args[9], table=args[10], res=args[11])
        got = V.voigt_kernel_pol(*kin)
        want = V.voigt_kernel_pol_plain(*kin)
        torch.cuda.synchronize()
        comp = want.abs().amax((0, 2))
        require(bool((comp > 0).all()), f"voigt_sum_pol {dt}: a component is zero: {comp}")
        for i, z in enumerate(sel):
            err, r = close(got[i], want[i], rtol, atol, f"voigt_sum_pol {dt} level {z}")
            log(f"voigt_sum_pol {str(dt)[6:]} level {z:2d}: max|diff| {err:.3e} ({r:.2e} of "
                f"scale; held at rtol {rtol}, atol {atol} * scale)")
            if dt == torch.float32:
                max_abs = max(max_abs, err)
    L = int(kin[1].shape[1])
    log(f"voigt_sum_pol inputs: {sum(int(i.numel()) for i in zin[torch.float32]['zcat'].idx)} "
        f"pseudo-lines ({L} padded), max visits per tile {int(kin[4].max())}")

    # its path: all 60 levels in float32 under the benchmark's geometry
    d = zin[torch.float32]
    kw = dict(device=dev, dtype=torch.float32)

    def path():
        return zeeman_propmat(d["f_grid"], d["zcat"], d["pf"], d["T"], d["P"], d["vmr"],
                              d["mag"], d["los_za_deg"], backend="pallas", **kw)

    path()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    pm = path()
    torch.cuda.synchronize()
    path_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    log(f"zeeman_propmat(backend='pallas') path, float32, {d['T'].shape[0]} levels: {path_ms:.1f} ms, "
        f"launches {launches}")
    require(launches["voigt_sum_pol"] > 0, "voigt_sum_pol was not launched on its path")
    require(tuple(pm.shape) == (d["T"].shape[0], d["f_grid"].shape[0], 7),
            f"propmat shape {tuple(pm.shape)}")
    require(bool(torch.isfinite(pm).all()), "non-finite propagation matrices")

    args, _ = voigt_sum_pol_args(d["f_grid"], d["zcat"], d["pf"], d["T"], d["P"], d["vmr"],
                                 d["mag"], d["los_za_deg"])
    kin, _ = V.voigt_inputs(*args[:9], polidx=args[9], table=args[10], res=args[11])
    require(torch.equal(V.voigt_kernel_pol(*kin), V.voigt_kernel_pol(*kin)),
            "voigt_sum_pol float32: two runs differ")
    ms = cuda_ms(lambda: V.voigt_kernel_pol(*kin), 10)
    by_split = {sp: round(cuda_ms(lambda: V.voigt_kernel_pol(*kin, split=sp), 10), 4)
                for sp in SPLITS}
    plain_ms = cuda_ms(lambda: V.voigt_kernel_pol_plain(*kin), 1)
    counts = V.pair_counts(*kin[:5])
    pf = {k: v + POL_PAIR_EXTRA for k, v in V.pair_flops(torch.float32).items()}
    Z, F = kin[1].shape[0], kin[0].shape[0]
    flops = sum(counts["in_window"][k] * pf[k] for k in pf) + Z * F * POL_EPILOGUE
    b_ms, b_by = bound(flops, nbytes(*kin) + Z * 7 * F * 4)
    nl = kin[2].shape[-1]
    log(f"voigt_sum_pol float32, {Z} levels, {nl} line blocks "
        f"({[int((kin[6] == p).sum()) for p in range(3)]} pi/sigma-/sigma+), "
        f"{int(kin[4].sum())} visits: {ms:.3f} ms at split {V.default_split(nl)} beside "
        f"bound {b_ms:.4f} ms ({b_by}); by split {by_split}; two runs bit-identical; "
        f"plain {plain_ms:.1f} ms; visited pairs {counts['visited']}; in-window pairs "
        f"{counts['in_window']}; {flops / 1e9:.2f} GFLOP in window")
    log_ptxas("voigt_sum_kernel<float, 3>", "voigt_sum_kernel<double, 3>",
              "combine_kernel<float, 3>")
    return dict(
        name="voigt_sum_pol", route="cuda", source="arts_tpu_torch/csrc/voigt_sum.cu",
        replaces="arts_tpu/ops/voigt_kernel.py:975", launches=launches["voigt_sum_pol"],
        max_abs_err=max_abs, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
    )


def hold_components(got, want, rtol, atol, what):
    """Each of the 7 components [Z, 7, F] within atol of its own scale plus
    rtol of |want| (close); a component that is 0 throughout must come out
    0.  Returns each component's largest difference over its scale."""
    shares = []
    for c in range(want.shape[1]):
        scale = float(want[:, c].double().abs().max())
        if scale == 0:
            require(not bool(got[:, c].any()), f"{what} component {c}: not 0 where the plain "
                    "version is 0 throughout")
            shares.append(0.0)
        else:
            shares.append(close(got[:, c], want[:, c], rtol, atol, f"{what} component {c}",
                                scale)[1])
    return shares


# the random pole records of phase 6: not a multiple of 32 parents nor of a
# block's 256 frequencies
MP_CASE = dict(Z=60, NP=2061, F=4173, seed=9)


def phase_zeeman_mp(zin, dev):
    """The zeeman_mp kernel against its plain version at the full shape, on
    the bench's pole records and on random ones (build_zeeman_mp_case),
    overall and per component; two float32 runs bit-identical; the near
    correction's points against the kernel's near pairs, level by level;
    its time, and its two kernels' device times from a profiled run."""
    from torch.profiler import ProfilerActivity, profile

    from arts_tpu_torch.lbl.zeeman import zeeman_mp_args
    from arts_tpu_torch.ops import zeeman_mp_kernel as MP
    from arts_tpu_torch.scene import build_zeeman_mp_case

    max_abs = 0.0
    for dt, atol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
        d = zin[dt]
        poles, near, _ = zeeman_mp_args(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"],
                                        d["vmr"], d["mag"], d["los_za_deg"],
                                        mp_kappa=d["tune"]["mp_kappa"])
        bench = (poles[0], MP.pole_records(*poles[1:]))
        for label, (f, rec) in (("bench", bench),
                                ("random", build_zeeman_mp_case(**MP_CASE, device=dev, dtype=dt))):
            got = MP.zeeman_mp_kernel(f, rec)
            want = MP.zeeman_mp_plain(f, rec)
            torch.cuda.synchronize()
            what = f"zeeman_mp {str(dt)[6:]} {label}"
            err, r = close(got, want, 0.0, atol, what)
            shares = hold_components(got, want, 0.0, atol, what)
            if dt == torch.float32:
                require(torch.equal(got, MP.zeeman_mp_kernel(f, rec)), f"{what}: two runs differ")
                max_abs = max(max_abs, err)
            log(f"{what} [{rec.shape[0]} levels, {rec.shape[1]} poles, {f.shape[0]} freqs, "
                f"P={MP._terms(rec)}]: max|diff| {err:.3e} ({r:.2e} of scale; per component "
                f"{', '.join(f'{x:.2e}' for x in shares)} of its own; held at {atol} of "
                f"scale, overall and per component)"
                + ("; two runs bit-identical" if dt == torch.float32 else ""))
    f, rec = bench
    Z = rec.shape[0]
    # every in-window pair the kernel leaves out as near is one of the
    # near correction's points: the two masks are complements
    fixed = sum(MP.near_points(f, *args[:4], d["tune"]["noff"])[0].sum((1, 2)) for args in near)
    kernel_near = [MP.pair_counts(f, rec[z:z + 1])["near"] for z in range(Z)]
    require(fixed.tolist() == kernel_near, f"near points per level {fixed.tolist()} != the "
            f"kernel's near pairs {kernel_near}")
    log(f"zeeman_mp near pairs = near-correction points on each of the {Z} levels "
        f"({sum(kernel_near)} in all)")
    ms = cuda_ms(lambda: MP.zeeman_mp_kernel(f, rec), 20)
    # the wrapper's two kernels: the sum over the parents, then the combine
    # of the SPLIT parts' slabs; mean device time per launch the trace shows
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            MP.zeeman_mp_kernel(f, rec)
        torch.cuda.synchronize()
    dev_ms = {k: e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
              for k in ("zeeman_mp_kernel<float, 5>", "combine_kernel<float>(")
              if k in e.key and e.self_device_time_total > 0}
    require(len(dev_ms) == 2, f"zeeman_mp profiled run: kernels not both seen ({dev_ms})")
    plain_ms = cuda_ms(lambda: MP.zeeman_mp_plain(f, rec), 1)
    counts = MP.pair_counts(f, rec)
    pf = MP.pair_flops(MP._terms(rec))
    flops = sum(counts[k] * pf[k] for k in pf)
    b_ms, b_by = bound(flops, nbytes(f, rec) + Z * 7 * f.shape[0] * 4)
    log(f"zeeman_mp float32: {ms:.3f} ms (plain {plain_ms:.1f} ms); profiled, per launch: "
        f"zeeman_mp_kernel {dev_ms['zeeman_mp_kernel<float, 5>']:.4f} ms, combine_kernel of "
        f"{MP.SPLIT} parts {dev_ms['combine_kernel<float>(']:.4f} ms; pairs {counts}; "
        f"{flops / 1e9:.2f} GFLOP -> bound {b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it)")
    log_ptxas("zeeman_mp_kernel<float, 5>", "zeeman_mp_kernel<double, 5>", "combine_kernel<float>")
    return dict(
        name="zeeman_mp", route="cuda", source="arts_tpu_torch/csrc/zeeman_mp.cu",
        replaces="arts_tpu/ops/zeeman_mp_kernel.py:256", max_abs_err=max_abs, ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


def phase_zeeman_stage(zin, dev, _cuda, reps=5):
    """bench.py's Zeeman stage: zeeman_propmat_profile timed, guarded
    against the dense route at the top and bottom levels."""
    from arts_tpu_torch.lbl.zeeman import zeeman_propmat, zeeman_propmat_profile

    d = zin[torch.float32]
    kw = dict(device=dev, dtype=torch.float32)
    F = d["f_grid"].shape[0]

    def stage():
        return zeeman_propmat_profile(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"],
                                      d["vmr"], d["mag"], d["los_za_deg"], **d["tune"], **kw)

    stage()  # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times, outs = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = stage()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        outs.append(out)
    launches = dict(_cuda.LAUNCHES)
    log(f"Zeeman stage launches over {reps} runs: {launches}")
    require(all(torch.equal(o, outs[0]) for o in outs), "repeated Zeeman stage runs differ")
    log(f"Zeeman stage: the {reps} float32 runs are bit-identical")
    del outs
    require(launches["zeeman_mp"] > 0, "zeeman_mp was not launched on the Zeeman stage")
    require(tuple(out.shape) == (d["T"].shape[0], F, 7), f"profile shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite Zeeman stage output")
    med = float(np.median(times))
    log(f"zeeman points/s = {F / med:.1f} (float32, {d['T'].shape[0]} levels x {F} freqs x "
        f"{d['zcat'].cat.n_lines} lines; median of {reps} runs, {med * 1e3:.2f} ms; runs "
        f"{[round(t * 1e3, 3) for t in times]} ms) on {card_line()}")

    log_profile("Zeeman stage run", stage, 10)

    # the stage's parts, each ending in a synchronize: pole moments (tensor
    # code), the zeeman_mp kernel, the near corrections (tensor code)
    from arts_tpu_torch.lbl.zeeman import zeeman_mp_args
    from arts_tpu_torch.ops.voigt_kernel import weideman_order
    from arts_tpu_torch.ops.zeeman_mp_kernel import near_correction, zeeman_mp_eval

    parts = {"moments": [], "zeeman_mp": [], "near_correction": []}
    for _ in range(reps):
        t0 = time.perf_counter()
        poles, near, _ = zeeman_mp_args(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"],
                                        d["vmr"], d["mag"], d["los_za_deg"],
                                        mp_kappa=d["tune"]["mp_kappa"])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        field = zeeman_mp_eval(*poles)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for args in near:
            field = near_correction(poles[0], field, *args, noff=d["tune"]["noff"],
                                    wofz_n=weideman_order(torch.float32))
        torch.cuda.synchronize()
        for k, t in zip(parts, (t1 - t0, t2 - t1, time.perf_counter() - t2)):
            parts[k].append(t * 1e3)
    log("Zeeman stage parts (median ms of " + str(reps) + "): " + ", ".join(
        f"{k} {np.median(v):.2f} {[round(t, 3) for t in v]}" for k, v in parts.items()))

    g = 0.0
    for z in (0, d["T"].shape[0] - 1):
        ref = zeeman_propmat(d["f_grid"], d["zcat"], d["pf"], d["T"][z], d["P"][z], d["vmr"][z],
                             d["mag"], d["los_za_deg"], **kw)
        g = max(g, rel(out[z], ref))
    log(f"zeeman profile vs dense route (top and bottom levels): {g:.3e} of scale (limit 1e-4)")
    require(g <= 1e-4, f"Zeeman stage guard {g:.3e} > 1e-4")
    return launches


def phase_clearsky_polarized(dev):
    """simulate_clearsky_polarized on the 2_zeeman scene, card against CPU."""
    from arts_tpu_torch import ZeemanScene, simulate_clearsky_polarized
    from arts_tpu_torch.atm import Atmosphere1D, hydrostatic_pressure
    from arts_tpu_torch.lbl.catalog import build_catalog
    from arts_tpu_torch.lbl.partfun import rigid_rotor_table
    from arts_tpu_torch.lbl.tmodel import Law
    from arts_tpu_torch.lbl.zeeman import expand_zeeman
    from arts_tpu_torch.path import geometric_path_1d

    z = np.linspace(0.0, 100e3, 51)
    t = 288.0 - 6.5e-3 * np.minimum(z, 12e3) + 2e-3 * np.maximum(z - 50e3, 0)
    line = [dict(f0=118.7503e9, a=5e-9, e0=0.0, gu=5.0, gl=3.0, iso_mass=32.0,
                 iso_ratio=0.995, spec_idx=0, iso_idx=0, band_idx=0, t0=296.0,
                 cutoff=np.inf, ls={"bath": {"G0": (Law.T1, [22000.0, 0.8])}})]
    path = geometric_path_1d(0.0, 0.0, 0.0, 100e3, 2000.0)
    f = 118.7503e9 + np.linspace(-5e6, 5e6, 401)
    out = {}
    for d in ("cpu", dev):
        T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64, device=d)
        cat = build_catalog(line, device=d, dtype=torch.float64)
        scene = ZeemanScene(
            atm=Atmosphere1D(z=T(z), t=T(t), p=hydrostatic_pressure(T(z), T(t), 101325.0),
                             vmr=T(np.full((1, 51), 0.2095)),
                             mag=T(np.repeat([[0.0], [3e-5], [3e-5]], 51, 1))),
            zcat=expand_zeeman(cat, ju=[1.0], jl=[1.0], gu_z=[-2.8], gl_z=[-2.77]),
            pf=rigid_rotor_table(1, 150.0, 1.0, device=d, dtype=torch.float64))
        t0 = time.perf_counter()
        out[d] = simulate_clearsky_polarized(scene, f, path.alt, path.za, path.dr,
                                             device=d, dtype=torch.float64)
        torch.cuda.synchronize()
        log(f"simulate_clearsky_polarized float64 on {d}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    got, want = out[dev].cpu(), out["cpu"]
    require(tuple(got.shape) == (401, 4), f"Stokes shape {tuple(got.shape)}")
    r, rv = rel(got, want), rel(got[:, 3], want[:, 3])
    vmax = float(got[:, 3].abs().max())
    log(f"simulate_clearsky_polarized card vs CPU: {r:.3e} of scale, V {rv:.3e} of its scale "
        f"(limit 1e-10); max |V|/I {vmax / float(got[:, 0].max()):.3e}")
    require(r <= 1e-10 and rv <= 1e-10, f"card vs CPU {r:.3e}, V {rv:.3e} > 1e-10")
    require(vmax > 0, "no circular polarization")


# the top levels of the bench Zeeman inputs, where a Doppler width is a few
# float32 spacings of a line centre
TOP_LEVELS = 5


def phase_zeeman_centres(zin, dev):
    """Float32 against float64 on identical inputs (the float32 inputs cast
    to float64) at the top TOP_LEVELS levels of the bench Zeeman inputs,
    each level against its own largest value: kernel 5's route
    (zeeman_propmat(backend="pallas")) and the float32 dense route at
    1e-5, the profile route (kernel 6 and the near correction) at 1e-4,
    all against the float64 dense route.  Forming f0 + shift + H split in
    float32 before f - f0 moved the profile route by 1.1e-2 at these
    levels on the CPU before the centres were formed exactly."""
    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.lbl.zeeman import zeeman_propmat, zeeman_propmat_profile

    d = zin[torch.float32]
    top = slice(0, TOP_LEVELS)
    ins = {k: d[k] for k in ("f_grid", "zcat", "pzcat", "pf", "mag")}
    ins.update({k: d[k][top] for k in ("T", "P", "vmr")})
    ins64 = {k: move(v, dev, torch.float64) for k, v in ins.items()}

    def route(x, dt, name):
        args = (x["f_grid"], x["pzcat" if name == "profile" else "zcat"], x["pf"], x["T"],
                x["P"], x["vmr"], x["mag"], d["los_za_deg"])
        kw = dict(device=dev, dtype=dt)
        if name == "profile":
            return zeeman_propmat_profile(*args, **d["tune"], **kw)
        return zeeman_propmat(*args, backend="pallas" if name == "kernel" else "xla", **kw)

    t0 = time.perf_counter()
    ref = route(ins64, torch.float64, "dense")
    torch.cuda.synchronize()
    log(f"Zeeman float64 dense route, top {TOP_LEVELS} levels: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, lim in (("kernel", 1e-5), ("profile", 1e-4), ("dense", 1e-5)):
        got = route(ins, torch.float32, name)
        gaps = ((got.double() - ref).abs().amax((-2, -1))
                / ref.abs().amax((-2, -1))).tolist()
        log(f"Zeeman {name} route float32 vs float64 dense, top {TOP_LEVELS} levels (share "
            f"of each level's largest value): {', '.join(f'{g:.3e}' for g in gaps)} "
            f"(limit {lim})")
        require(max(gaps) <= lim, f"Zeeman {name} route float32: {max(gaps):.3e} > {lim}")


# the float64 comparisons of phase_zeeman_nlte: every 16th frequency (256)
# on the card, every NLTE_CPU_EVERY-th of those (8) against the CPU, whose
# dense route takes ~3 s per frequency at float64 (755 s for all 256)
NLTE_SUBSET = 16
NLTE_CPU_EVERY = 32


def phase_zeeman_nlte(dev, reps=3):
    """simulate_clearsky_polarized(background="surface_reflect",
    rte_option="linprop") on scene.build_zeeman_nlte_scene at full width in
    float32: its median time, two runs bit-identical, a profiled call;
    float32 against float64 on a frequency subset, the float64 card
    against the CPU, the non-LTE population fit on the card against the
    CPU, and igrf13 and add_faraday on the card against the CPU."""
    from arts_tpu_torch import simulate_clearsky_polarized
    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.atm.igrf import igrf13
    from arts_tpu_torch.lbl.faraday import add_faraday
    from arts_tpu_torch.lbl.nlte import nlte_fit_profile
    from arts_tpu_torch.scene import build_zeeman_nlte_scene

    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    b = build_zeeman_nlte_scene(device=dev, dtype=f32)
    torch.cuda.synchronize()
    scene, fg, path = b["scene"], b["f_grid"], b["path"]
    n_comp = sum(int(i.numel()) for i in scene.zcat.idx)
    log(f"build_zeeman_nlte_scene: {time.perf_counter() - t0:.1f} s (non-LTE fit, float64 on "
        f"the card: {b['fit_iterations']} iterations); {len(path.alt)} path points x "
        f"{fg.numel()} freqs x {scene.zcat.cat.n_lines} lines ({n_comp} components) + "
        f"{scene.nlte.cat.n_lines} non-LTE lines")

    def run(sc, f, d, dt):
        return simulate_clearsky_polarized(sc, f, path.alt, path.za, path.dr,
                                           background="surface_reflect", rte_option="linprop",
                                           device=d, dtype=dt)

    outs, times = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        outs.append(run(scene, fg, dev, f32))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = outs[0]
    require(tuple(out.shape) == (fg.numel(), 4), f"Stokes shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite Stokes vector")
    require(all(torch.equal(o, out) for o in outs), "simulate_clearsky_polarized float32: "
            "two runs differ")
    log(f"simulate_clearsky_polarized(surface_reflect, linprop, non-LTE band) float32: "
        f"median {np.median(times):.2f} ms of {reps} calls {[round(t, 3) for t in times]}, "
        f"the {reps} runs bit-identical, on {card_line()}")
    log_profile("simulate_clearsky_polarized float32 call", lambda: run(scene, fg, dev, f32), 8)

    sub = slice(None, None, NLTE_SUBSET)
    scene64 = move(scene, dev, f64)
    fs = fg[sub].double()
    ref = run(scene64, fs, dev, f64)
    scale = float(ref[:, 0].abs().max())
    comps = [float((out[sub, c].double() - ref[:, c]).abs().max()) / scale for c in range(4)]
    v_own = rel(out[sub, 3], ref[:, 3])
    log(f"simulate_clearsky_polarized float32 vs float64 on {fs.numel()} frequencies: "
        f"I, Q, U, V {', '.join(f'{c:.3e}' for c in comps)} of I's scale (limit 1e-4); V "
        f"{v_own:.3e} of its own scale; max |V|/I {float(ref[:, 3].abs().max()) / scale:.3e}")
    require(max(comps) <= 1e-4, f"float32 vs float64 {max(comps):.3e} > 1e-4 of I's scale")

    cs = slice(None, None, NLTE_CPU_EVERY)
    t0 = time.perf_counter()
    cpu = run(move(scene64, "cpu", f64), fs[cs].cpu(), "cpu", f64)
    t_cpu = time.perf_counter() - t0
    r = rel(ref[cs].cpu(), cpu)
    rv = rel(ref[cs, 3].cpu(), cpu[:, 3])
    log(f"simulate_clearsky_polarized float64 card vs CPU on {cpu.shape[0]} frequencies: "
        f"{r:.3e} of scale, V {rv:.3e} of its own (limit 1e-10); CPU {t_cpu:.1f} s")
    require(r <= 1e-10, f"float64 card vs CPU {r:.3e} > 1e-10")

    fit = b["fit"]
    runs = []
    for d in (dev, torch.device("cpu")):
        args = {k: move(v, d, f64) for k, v in fit.items()}
        t0 = time.perf_counter()
        runs.append(nlte_fit_profile(**args, device=d, dtype=f64))
        torch.cuda.synchronize()
        runs[-1] += (time.perf_counter() - t0,)
    (rg, ng, mg, tg), (rc, nc, mc, tc) = runs
    dr = float((rg.cpu() - rc).abs().max())
    log(f"nlte_fit_profile float64 ({rg.shape[0]} levels, {fit['cat'].n_lines} lines, "
        f"{fit['f_grid'].numel()} freqs): card {ng} iterations in {tg:.2f} s, CPU {nc} in "
        f"{tc:.2f} s; last changes {mg:.2e} / {mc:.2e}; ratios differ by {dr:.2e} (limit 1e-8)")
    require(ng == nc, f"nlte_fit_profile iterations: card {ng}, CPU {nc}")
    require(dr <= 1e-8, f"nlte_fit_profile ratios differ by {dr:.2e} > 1e-8")

    lat, lon = np.meshgrid(np.linspace(-89.5, 89.5, 37), np.linspace(-180.0, 175.0, 72))
    alt = np.linspace(0.0, 8e5, lat.size).reshape(lat.shape)
    Bg, Bc = (igrf13(lat, lon, alt, year=2017.5, device=d, dtype=f64) for d in (dev, "cpu"))
    rb = rel(Bg.cpu(), Bc)
    mag = scene64.atm.mag.T[:, None, :]  # [NZ, 1, 3]
    pm = torch.randn(mag.shape[0], 64, 7, dtype=f64, generator=torch.Generator().manual_seed(3))
    fa = torch.linspace(1e9, 4e9, 64, dtype=f64)
    ne = torch.logspace(9, 12, mag.shape[0], dtype=f64)[:, None]
    Pg, Pc = (add_faraday(pm.to(d), fa.to(d), ne.to(d), mag.to(d), 150.0, 20.0)
              for d in (dev, "cpu"))
    rf = rel(Pg.cpu() - pm, Pc - pm)
    log(f"igrf13 ({lat.size} points, 2017.5) card vs CPU {rb:.3e} of scale; add_faraday "
        f"(U component) {rf:.3e} (limit 1e-12)")
    require(rb <= 1e-12 and rf <= 1e-12, f"igrf13 {rb:.3e} / add_faraday {rf:.3e} > 1e-12")


def sync_ms(fn, reps=3):
    """Median wall time of fn over reps calls, each ending in a synchronize."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out)), [round(x, 3) for x in out]


def phase_retrieval(dev, _cuda):
    """The OEM cloud retrieval at full width (scene.build_cloud_retrieval:
    51 levels, 4096 frequencies, 16 streams, float32): Jacobians against
    the float64 plain route on the same inputs, then the Gauss-Newton
    retrieval with the counts set to 0 just before and read just after."""
    from arts_tpu_torch.retrieval import oem
    from arts_tpu_torch.scene import build_cloud_retrieval

    t0 = time.perf_counter()
    case = build_cloud_retrieval(device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"cloud retrieval case built in {time.perf_counter() - t0:.1f} s: state {case.x_a.numel()}, "
        f"measurement {case.y_obs.numel()}, cloud levels at {case.cloud_z.tolist()} m")
    case64 = case.astype(torch.float64)
    jac = lambda c, plain=False: torch.func.jacfwd(lambda x: c.forward(x, plain=plain))(c.x_a)
    J32 = jac(case).double()
    J64p = jac(case64, plain=True)
    J64k = jac(case64)
    col = J64p.abs().amax(0)
    r32 = ((J32 - J64p).abs().amax(0) / col).tolist()
    r64 = ((J64k - J64p).abs().amax(0) / col).tolist()
    log(f"Jacobian column scales (float64 plain): {col.tolist()}")
    log(f"Jacobian float32 kernel route vs float64 plain route, per column of max: "
        f"{[f'{x:.2e}' for x in r32]} (held at 5e-3)")
    log(f"Jacobian float64 kernel route vs float64 plain route, per column of max: "
        f"{[f'{x:.2e}' for x in r64]} (held at 1e-9)")
    require(bool((col > 0).all()), "a Jacobian column is zero")
    require(max(r32) <= 5e-3, f"float32 Jacobian {max(r32):.3e} > 5e-3")
    require(max(r64) <= 1e-9, f"float64 kernel-route Jacobian {max(r64):.3e} > 1e-9")
    del case64, J32, J64p, J64k

    args = (case.x_a, case.y_obs, case.S_a, case.S_e)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    res = oem(case.forward, *args, method="gn", max_iter=10, device=dev)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    nc = case.cloud_z.numel()
    d = (res.x - case.x_true).tolist()
    log(f"GN retrieval (float32 forward, float64 normal equations): {res.n_iter} iterations, "
        f"converged {res.converged}, cost {res.cost:.4e}, {run_s:.2f} s; launches {launches}")
    log(f"retrieved - truth: log extinction {d[:nc]}, ssa {d[nc:2 * nc]}, surface {d[-1]:.4e} K; "
        f"averaging-kernel diagonal {torch.diagonal(res.averaging_kernel).tolist()}")
    require(res.converged and res.n_iter <= 10, f"GN did not converge in 10 ({res.n_iter})")
    require(max(abs(x) for x in d[:nc]) <= 0.02, f"log extinction off by {d[:nc]}")
    require(max(abs(x) for x in d[nc:2 * nc]) <= 0.01, f"ssa off by {d[nc:2 * nc]}")
    require(abs(d[-1]) <= 0.2, f"surface temperature off by {d[-1]:.3e} K")
    require(launches["eigh_jacobi"] > 0 and launches["voigt_sum"] == 0,
            f"retrieval launches {launches}")

    # one forward, one Jacobian, one Gauss-Newton iteration (the Jacobian,
    # the normal equations and the forward at the new state)
    x = case.x_a
    fwd_ms, fwd_runs = sync_ms(lambda: case.forward(x))
    jac_ms, jac_runs = sync_ms(lambda: torch.func.jacfwd(case.forward)(x))
    Se_inv = 1.0 / case.S_e
    Sa_inv = torch.linalg.inv(case.S_a)

    def gn_iteration():
        J = torch.func.jacfwd(case.forward)(x).double()
        H = (J.T * Se_inv) @ J + Sa_inv
        g = (J.T * Se_inv) @ (case.y_obs - y0) - Sa_inv @ (x - case.x_a)
        return case.forward(x + torch.linalg.solve(H, g))

    y0 = case.forward(x).double()
    _cuda.reset_launches()
    gn_ms, gn_runs = sync_ms(gn_iteration)
    per_iter = {k: v // 3 for k, v in _cuda.LAUNCHES.items() if v}
    F, Z = case.f_grid.numel(), case.scene.atm.z.numel()
    log(f"retrieval timings, float32, {F} freqs x {Z} levels: forward {fwd_ms:.2f} ms {fwd_runs}, "
        f"Jacobian ({x.numel()} columns, jacfwd) {jac_ms:.2f} ms {jac_runs}, one GN iteration "
        f"{gn_ms:.2f} ms {gn_runs}; launches per GN iteration {per_iter}")

    # one profiled GN iteration: device busy share and time by kernel
    log_profile("GN iteration", gn_iteration, 12)
    return launches


# the measurement Jacobian: lines per block of the dense route under
# forward mode, state columns per chunk, the bound of the columns held
# against the float64 route (of each column's largest entry), and the
# relative step and bound of the float64 columns' central differences
JAC_BLOCK = 16
JAC_CHUNK = 15
JAC_CHECK_TOL = 1e-4
JAC_FD_STEP = 1e-4
JAC_FD_TOL = 1e-5


def phase_clearsky_measurement(dev, _cuda, reps=5):
    """The clear-sky measurement path at full width (see 11. above);
    returns the launches per kernel of the timed calls."""
    from arts_tpu_torch._cuda import move
    from arts_tpu_torch.ops.planck import inv_planck
    from arts_tpu_torch.retrieval import RetrievalTarget, StateMapping, oem
    from arts_tpu_torch.scene import build_clearsky_measurement, build_clearsky_retrieval
    from arts_tpu_torch.sensor import (clearsky_observer, clearsky_observer_cached,
                                       measurement_jacobian, measurement_vector)

    f32, f64 = torch.float32, torch.float64
    t0 = time.perf_counter()
    case = build_clearsky_measurement(device=dev, dtype=f32)
    torch.cuda.synchronize()
    paths, F = list(case.paths), case.f_grid.numel()
    G, npts = len(paths), [p.n_points for p in case.paths]
    log(f"clear-sky measurement case built in {time.perf_counter() - t0:.1f} s: {G} beam "
        f"positions ({min(npts)}-{max(npts)} path points), {F} frequencies x "
        f"{case.scene.cat.n_lines} lines x {case.scene.atm.z.numel()} levels, "
        f"{case.sensor.n_elements} elements")

    def y_of(observer, dtype):
        return measurement_vector(case.scene, case.sensor, case.f_grid, paths,
                                  observer=observer, device=dev, dtype=dtype)

    # float32 kernel route, float64 kernel and plain routes, same inputs
    y32 = y_of(clearsky_observer_cached(backend="pallas"), f32)
    require(torch.equal(y32, y_of(clearsky_observer_cached(backend="pallas"), f32)),
            "clear-sky y float32: two runs differ")
    y64p = y_of(clearsky_observer_cached(backend="pallas", plain=True), f64)
    y64k = y_of(clearsky_observer_cached(backend="pallas"), f64)
    require(tuple(y32.shape) == (case.sensor.n_elements,), f"y shape {tuple(y32.shape)}")
    e32, r32 = close(y32, y64p, 0.0, 1e-4, "clear-sky y float32 vs float64 plain route")
    e64, r64 = close(y64k, y64p, 0.0, 1e-9, "clear-sky y float64 kernel vs plain route")
    f_el = case.sensor.apply(case.f_grid.double().expand(G, F).contiguous())
    dbt = float((inv_planck(y32.double(), f_el) - inv_planck(y64p, f_el)).abs().max())
    log(f"clear-sky y float32 kernel route vs float64 plain route: {r32:.3e} of scale "
        f"(limit 1e-4), max |dTb| {dbt:.4e} K; two float32 runs bit-identical; float64 "
        f"kernel vs plain: {r64:.3e} of scale (limit 1e-9); Tb "
        f"{float(inv_planck(y64p, f_el).min()):.2f}-{float(inv_planck(y64p, f_el).max()):.2f} K")

    # the cached observer against the direct one, level-aligned paths
    sc64, fg64 = move(case.scene, dev, f64), case.f_grid.double()
    z = sc64.atm.z
    alts = torch.stack([z.flip(0), z])
    drs = torch.stack([-torch.diff(z.flip(0)), torch.diff(z)])
    zas = torch.zeros_like(alts)
    t0 = time.perf_counter()
    direct = clearsky_observer(block=64)(sc64, fg64, alts, drs, zas, "surface")
    torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    cached = clearsky_observer_cached(backend="pallas")(sc64, fg64, alts, drs, zas, "surface")
    _, rc = close(cached, direct, 2e-6, 5e-7, "cached (pallas) vs direct observer")
    log(f"cached observer (pallas) vs direct (xla), nadir and zenith level-aligned paths, "
        f"float64: {rc:.3e} of scale (atol 5e-7 * scale, rtol 2e-6); direct route "
        f"{t_direct:.2f} s")
    del direct, cached, y64p, y64k

    # the path's timings and counts, float32
    obs = clearsky_observer_cached(backend="pallas")
    y_of(obs, f32)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        y = y_of(obs, f32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(_cuda.LAUNCHES)
    log(f"clear-sky measurement launches over {reps} calls: {launches}")
    require(launches["voigt_sum"] == reps, f"voigt_sum launched {launches['voigt_sum']} "
            f"times in {reps} calls (expected one per call)")
    require(bool(torch.isfinite(y).all() and (y > 0).all()), "non-finite or non-positive y")
    med = float(np.median(times))
    log(f"clear-sky measurement, float32, {G} geometries x {F} freqs: {G * F / med:.1f} "
        f"geometry-frequencies/s (median of {reps} calls, {med * 1e3:.2f} ms; calls "
        f"{[round(t * 1e3, 3) for t in times]} ms); voigt_sum launches per call "
        f"{launches['voigt_sum'] / reps:g}")
    log_profile("clear-sky measurement call", lambda: y_of(obs, f32), 10)

    # d y / d H2O VMR (60 columns) through the dense route, forward mode
    def with_field(s, field, v):
        if field == "vmr":
            v = torch.cat([v[None], s.atm.vmr[1:]], 0)
        return dataclasses.replace(s, atm=dataclasses.replace(s.atm, **{field: v}))

    def profile(s, field):
        return s.atm.vmr[0] if field == "vmr" else s.atm.t

    def jacobian(dtype, field="vmr", levels=None):
        """d y / d (H2O VMR or T) at `levels` (None: every level)."""
        if levels is None:
            target = RetrievalTarget(field, lambda s: profile(s, field),
                                     lambda s, v: with_field(s, field, v))
        else:
            idx = torch.tensor(levels, device=dev)
            target = RetrievalTarget(
                field, lambda s: profile(s, field)[idx],
                lambda s, v: with_field(s, field, profile(s, field).index_put((idx,), v)))
        mapping = StateMapping([target], case.scene, device=dev, dtype=dtype)
        return measurement_jacobian(
            case.scene, case.sensor, case.f_grid.to(dtype), paths, mapping,
            observer=clearsky_observer_cached(backend="xla", block=JAC_BLOCK),
            chunk_size=JAC_CHUNK, device=dev, dtype=dtype)[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    K = jacobian(f32)
    torch.cuda.synchronize()
    t_jac, m_jac = time.perf_counter() - t0, torch.cuda.max_memory_allocated() - base
    Z = case.scene.atm.z.numel()
    require(tuple(K.shape) == (case.sensor.n_elements, Z), f"Jacobian shape {tuple(K.shape)}")
    require(bool(torch.isfinite(K).all()) and float(K.abs().max()) > 0, "bad Jacobian")
    # the three columns with the largest entries against the float64 route
    # on the same inputs (the lowest levels' columns are below float32's
    # range: the 183 GHz line hides them)
    colmax = K.abs().amax(0)
    check = sorted(torch.topk(colmax, 3).indices.tolist())
    K64 = {f: jacobian(f64, f, check) for f in ("vmr", "t")}
    errs = [float((K[:, i].double() - K64["vmr"][:, j]).abs().max()
                  / K64["vmr"][:, j].abs().max()) for j, i in enumerate(check)]

    # the float64 columns of VMR and T at those levels against central
    # differences of the float64 route (steps of JAC_FD_STEP of the value):
    # comparing two dtypes cannot see a derivative rule that both share,
    # and only T reaches wofz's
    def y64(field, i, dv):
        v = profile(sc64, field).clone()
        v[i] += dv
        return measurement_vector(
            with_field(sc64, field, v), case.sensor, fg64, paths,
            observer=clearsky_observer_cached(backend="xla", block=JAC_BLOCK), device=dev,
            dtype=f64)

    fd_errs = {}
    for field in K64:
        for j, i in enumerate(check):
            dv = JAC_FD_STEP * float(profile(sc64, field)[i])
            fd = (y64(field, i, dv) - y64(field, i, -dv)) / (2 * dv)
            fd_errs[f"{field}{i}"] = float((K64[field][:, j] - fd).abs().max()
                                           / fd.abs().max())
    log(f"measurement Jacobian d y / d H2O VMR ({Z} columns, forward mode in chunks of "
        f"{JAC_CHUNK}, dense route in blocks of {JAC_BLOCK} lines), float32, all {F} "
        f"frequencies: {t_jac:.2f} s, peak {m_jac / 2**30:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2**30:.1f}; columns at levels "
        f"{check} (largest entry {float(colmax[check].min() / colmax.max()):.3g}-1 of K's; "
        f"level 0's {float(colmax[0] / colmax.max()):.3g}) against the float64 route: "
        f"{[f'{e:.3e}' for e in errs]} of each column's largest entry "
        f"(limit {JAC_CHECK_TOL:g}); float64 VMR and T columns at those levels against "
        f"central differences: { {k: f'{e:.3e}' for k, e in fd_errs.items()} } "
        f"(limit {JAC_FD_TOL:g})")
    require(max(errs) <= JAC_CHECK_TOL,
            f"Jacobian float32 vs float64 columns {errs} > {JAC_CHECK_TOL:g}")
    require(max(fd_errs.values()) <= JAC_FD_TOL,
            f"Jacobian float64 columns vs central differences {fd_errs} > {JAC_FD_TOL:g}")
    del K, K64

    # the clear-sky water-vapour retrieval, float64, card against CPU
    cpu = torch.device("cpu")
    rets = {d: build_clearsky_retrieval(device=d, dtype=f64) for d in (dev, cpu)}

    def gn(d, max_iter):
        c = rets[d]
        return oem(c.forward, c.x_a, c.y_obs, c.S_a, c.S_e, method="gn", max_iter=max_iter,
                   device=d)

    gn(dev, 1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = gn(dev, 8)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    diffs = []
    for k in range(1, res.n_iter + 1):
        x_card, x_cpu = gn(dev, k).x.cpu(), gn(cpu, k).x
        diffs.append(float((x_card - x_cpu).abs().max() / x_cpu.abs().max()))
    zc = rets[cpu].scene.atm.z
    err = float((res.x.cpu() - rets[cpu].x_true).abs()[zc < 12e3].max())
    log(f"clear-sky retrieval (float64): {res.n_iter} GN iterations, converged "
        f"{res.converged}, max error below 12 km {err:.4e} (limit 0.02), {run_s:.3f} s, "
        f"{run_s / res.n_iter * 1e3:.1f} ms per GN iteration; card vs CPU per iterate "
        f"{[f'{d:.2e}' for d in diffs]} of scale (limit 1e-10)")
    require(res.converged and err < 0.02, f"retrieval: converged {res.converged}, error {err}")
    require(max(diffs) <= 1e-10, f"retrieval card vs CPU {max(diffs):.3e} > 1e-10")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import arts_tpu_torch  # noqa: F401  (fails alone, outside the repository)
    from arts_tpu_torch.scene import build_scene

    from arts_tpu_torch.scene import build_zeeman_inputs

    t_start = time.perf_counter()
    _cuda = phase_build()
    dev = torch.device("cuda")
    scenes = {dt: build_scene(device=dev, dtype=dt) for dt in (torch.float64, torch.float32)}
    kernels = [phase_voigt(scenes, dev)] + phase_disort(scenes, dev)
    launches = phase_main_path(scenes, dev, _cuda)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    hs = {dt: bench_hsym(*scenes[dt], dev, dt) for dt in scenes}
    eigh = phase_eigh(hs, dev)
    fused_eigen = phase_fused_eigen(hs, dev, _cuda)
    del hs
    phase_differentiable_allsky(scenes, dev, _cuda)
    del scenes
    t0 = time.perf_counter()
    zin = {dt: build_zeeman_inputs(device=dev, dtype=dt) for dt in (torch.float64, torch.float32)}
    log(f"Zeeman inputs built in {time.perf_counter() - t0:.1f} s")
    kernels.append(phase_zeeman_pol(zin, dev, _cuda))
    mp = phase_zeeman_mp(zin, dev)
    mp["launches"] = phase_zeeman_stage(zin, dev, _cuda)["zeeman_mp"]
    kernels.append(mp)
    phase_zeeman_centres(zin, dev)
    phase_clearsky_polarized(dev)
    del zin
    torch.cuda.empty_cache()
    phase_zeeman_nlte(dev)
    torch.cuda.empty_cache()
    kernels[0]["launches_on"] = {
        "allsky_main_path": kernels[0]["launches"],
        "clearsky_measurement": phase_clearsky_measurement(dev, _cuda)["voigt_sum"]}
    eigh["launches"] = phase_retrieval(dev, _cuda)["eigh_jacobi"]
    kernels += [eigh, fused_eigen]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
