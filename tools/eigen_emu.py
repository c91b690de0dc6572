"""Run the eigen kernels of csrc/disort_fused.cu, the batched eigh of
csrc/eigh_jacobi.cu and the Zeeman parent-pole kernel of csrc/zeeman_mp.cu
on the CPU and hold them against their plain versions, without a card or
nvcc.

    python3 tools/eigen_emu.py [--disort SRC] [--eigh SRC] [--zeeman SRC]
                               [--only disort|eigh|zeeman]

The kernels are cut from the sources (default: the package's), compiled
with g++ against CPU stand-ins for the CUDA built-ins they use
(tools/eigen_emu/: threads, barriers, shuffles, cp.async; the PTX
approximations of csrc/jacobi.cuh become the IEEE operations) and run
block by block.

* disort: stage1_kernel (both instances) and fused_eigen_kernel (and the
  device code they call) on scene.build_stage1_case problems: n = 8 and 4,
  float64 and float32, 37 lanes x 2 layers, 5 x 1 and 9 x 7 (the beam
  instance on build_beam_case's sources for them, the sun at mu0 = 0.5,
  0.92 and 0.15), against stage1_plain / eigen_lanes_plain, each output's largest difference as a share of its
  scale (limits: the chip checks' tolerances, float64 2e-5, float32 1e-4).
* eigh: eigh_team_kernel for every n = 1..16, float64 and float32, on
  random symmetric batches of B = 70 (not a multiple of any instance's
  matrices per block; the shared tiles start as NaN), against
  eigh_jacobi_plain: eigenvalues within the chip checks' tolerances of
  scale (float64 1e-12, float32 2e-6), V elementwise within 1e3 of them
  (the same rounds and rotations), and A V = V diag(w), V^T V = I within
  4 of them.  (The float32 instances
  with the plain version's arithmetic, n >= 9, come within rounding, not
  bit for bit: PyTorch's float32 sqrt on the CPU is not always correctly
  rounded.)
* zeeman: zeeman_mp_kernel, float64 and float32, on
  scene.build_zeeman_mp_case (3 levels, 301 or 3 parents, 1100 frequencies:
  ragged chunks, tiles and parts of the parents, one part empty at 3,
  parents in random order, near points, windows that miss whole tiles),
  and on the pole records of a small bench-shaped Zeeman catalog, against
  zeeman_mp_plain: each of the 7 components within the chip checks'
  tolerance of its own scale (float64 1e-12, float32 2e-6; exactly 0
  where the plain version's component is 0 throughout).

Exits non-zero beyond a limit.  It checks the kernels' logic (indices, the
team's schedule, padding, shuffles, synchronisation points in order); what
the card's compiler and hardware do, and every time, only a chip run
shows.  Needs g++ with C++20; about a minute for each part.
"""

import argparse
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from arts_tpu_torch.disort import eigen_kernel as EK  # noqa: E402
from arts_tpu_torch.disort import fused_kernel as FK  # noqa: E402
from arts_tpu_torch.ops import eigh_jacobi as E  # noqa: E402
from arts_tpu_torch.ops import zeeman_mp_kernel as MP  # noqa: E402
from arts_tpu_torch.scene import (  # noqa: E402
    build_beam_case, build_stage1_case, build_zeeman_inputs, build_zeeman_mp_case)

HERE = pathlib.Path(__file__).resolve().parent / "eigen_emu"
CSRC = ROOT / "arts_tpu_torch" / "csrc"
# PTX that g++ cannot take, and its IEEE counterpart
PTX = {
    'asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));': "r = 1.0f / x;",
    'asm("sqrt.approx.f32 %0, %1;" : "=f"(root) : "f"(d * d + 4.0f * apq * apq));':
        "root = sqrtf(d * d + 4.0f * apq * apq);",
    'asm("rsqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(u));': "r = 1.0f / sqrtf(u);",
}
CASES = ((37, 2), (5, 1), (9, 7))
BEAM_MU0 = (0.5, 0.92, 0.15)  # the beam instance's sun, one per case


def sources(src, d, end, main):
    """kernels.cpp in d: src up to `end`, the shared memory on the host,
    main appended; jacobi.cuh beside it; PTX replaced in both."""
    text = pathlib.Path(src).read_text()
    text = text[: text.index(end)]
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu_smem;")
    for old, new in PTX.items():
        text = text.replace(old, new)
    head = (CSRC / "jacobi.cuh").read_text()
    for old, new in PTX.items():
        if old not in head:
            raise SystemExit(f"PTX not in jacobi.cuh: {old!r}")
        head = head.replace(old, new)
    (d / "jacobi.cuh").write_text(head)
    (d / "kernels.cpp").write_text(text + "}  // namespace\n" + (HERE / main).read_text())


def build(src, d, end, main):
    """The emulator binary for `src` in directory d."""
    sources(src, d, end, main)
    exe = d / "emu"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(HERE),
                    "-I", str(d), str(d / "kernels.cpp"), "-o", str(exe)], check=True)
    return exe


def run(exe, mode, ins, sweeps, d, beam=None):
    """The kernel's outputs on the stage 1 inputs `ins` (CPU tensors), with
    mode "beam" on beam = (qp, qm, ebt, ebb, mu0) too."""
    for name, x in zip(("pp", "pm", "om", "dtau", "tb0", "tb1", "qtab"), ins):
        x.numpy().tofile(d / f"{name}.bin")
    extra = []
    if beam is not None:
        for name, x in zip(("qp", "qm", "ebt", "ebb"), beam):
            x.numpy().tofile(d / f"{name}.bin")
        extra = [repr(float(beam[4]))]
    L, nn, B = ins[0].shape
    n = int(round(nn**0.5))
    f32 = ins[0].dtype == torch.float32
    subprocess.run([str(exe), mode, "f32" if f32 else "f64", str(n), str(L), str(B),
                    str(sweeps), str(d)] + extra, check=True)
    vec, mat = (L, n, B), (L, nn, B)
    names = ((("ek", vec), ("gp", mat), ("gm", mat), ("ut", vec), ("vt", vec), ("ub", vec),
              ("vb", vec)) if mode != "eigen" else
             (("k", vec), ("ek", vec), ("gp", mat), ("gm", mat)))
    dt = np.float32 if f32 else np.float64
    return tuple(torch.from_numpy(np.fromfile(d / f"{nm}.out", dt).reshape(shape))
                 for nm, shape in names)


def disort(src, d):
    """stage 1 and fused_eigen against their plain versions; the worst share
    of a tolerance."""
    exe = build(src, d, "// stages 2+3\n", "main.cpp")
    worst = 0.0
    for nquad in (16, 8):
        for dt, sweeps, tol in ((torch.float64, 8, 2e-5), (torch.float32, 6, 1e-4)):
            for (B, L), mu0 in zip(CASES, BEAM_MU0):
                ins = build_stage1_case(nquad, B, L, seed=B + L, device="cpu", dtype=dt)
                _, beam = build_beam_case(nquad, B, L, seed=B + L, mu0=mu0, device="cpu",
                                          dtype=dt)
                pairs = (("stage 1", run(exe, "stage1", ins, sweeps, d),
                          FK.stage1_plain(*ins, sweeps)),
                         (f"stage 1 beam mu0={mu0}", run(exe, "beam", ins, sweeps, d, beam),
                          FK.stage1_plain(*ins, sweeps, beam)),
                         ("fused_eigen", run(exe, "eigen", ins, sweeps, d),
                          EK.eigen_lanes_plain(*ins[:4], ins[6], sweeps)))
                for what, got, want in pairs:
                    errs = [float((g.double() - w.double()).abs().max() / w.double().abs().max())
                            for g, w in zip(got, want)]
                    worst = max(worst, max(errs) / tol)
                    print(f"n={nquad // 2} {str(dt)[6:]} B={B} L={L} {what}: "
                          + " ".join(f"{e:.1e}" for e in errs), flush=True)
    return worst


def eigh(src, d, B=70):
    """eigh_team_kernel against eigh_jacobi_plain for n = 1..16; the worst
    share of a tolerance."""
    exe = build(src, d, "template <typename T, int N>\nint launch(", "eigh_main.cpp")
    worst = 0.0
    for n in range(1, 17):
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
            X = np.random.default_rng(n).normal(size=(B, n, n))
            A = torch.tensor(X + X.transpose(0, 2, 1), dtype=dt)
            A.numpy().tofile(d / "a.bin")
            sweeps = E._default_sweeps(dt)
            subprocess.run([str(exe), "f32" if dt == torch.float32 else "f64", str(n), str(B),
                            str(sweeps), str(d)], check=True)
            npdt = np.float32 if dt == torch.float32 else np.float64
            w = torch.from_numpy(np.fromfile(d / "w.out", npdt).reshape(B, n))
            V = torch.from_numpy(np.fromfile(d / "v.out", npdt).reshape(B, n, n))
            w_p, V_p = E.eigh_jacobi_plain(A)
            scale = float(A.abs().max())
            A64, w64, V64 = A.double(), w.double(), V.double()
            errs = (float((w64 - w_p).abs().max()) / scale / tol,
                    float((V64 - V_p).abs().max()) / (1e3 * tol),
                    float((A64 @ V64 - V64 * w64[:, None, :]).abs().max()) / scale / (4 * tol),
                    float((V64.mT @ V64 - torch.eye(n, dtype=torch.float64)).abs().max())
                    / (4 * tol))
            errs = tuple(float("inf") if e != e else e for e in errs)
            same = torch.equal(w, w_p.to(dt)) and torch.equal(V, V_p.to(dt))
            worst = max(worst, *errs)
            print(f"eigh n={n} {str(dt)[6:]} B={B}: share of the limit: eigenvalues "
                  f"{errs[0]:.2e}, V {errs[1]:.2e}, reconstruction {errs[2]:.2e}, "
                  f"orthogonality {errs[3]:.2e}{'; bit for bit the plain version' if same else ''}",
                  flush=True)
    return worst


def share(got, want, tol):
    """max |got - want| as a share of tol * max |want|; a component that is
    0 throughout (two of the bench's) must come out exactly 0."""
    err, scale = float((got.double() - want).abs().max()), float(want.abs().max())
    return err / (tol * scale) if scale > 0 else (0.0 if err == 0 else float("inf"))


def zeeman_cases(dt):
    """[(label, f, rec)] for the zeeman part."""
    from arts_tpu_torch.lbl.zeeman import zeeman_mp_args

    cases = [("random", *build_zeeman_mp_case(3, n, 1100, seed=4, device="cpu", dtype=dt))
             for n in (301, 3)]
    d = build_zeeman_inputs(n_lev=3, n_freq=1000, n_lines=128, device="cpu", dtype=dt)
    poles, _, _ = zeeman_mp_args(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"], d["vmr"],
                                 d["mag"], d["los_za_deg"], mp_kappa=d["tune"]["mp_kappa"])
    return cases + [("bench-shaped", poles[0], MP.pole_records(*poles[1:]))]


def zeeman(src, d):
    """zeeman_mp_kernel against zeeman_mp_plain; the worst share of a
    tolerance."""
    exe = build(src, d, "// out [n] = the slabs", "zeeman_main.cpp")
    worst = 0.0
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 2e-6)):
        npdt = np.float32 if dt == torch.float32 else np.float64
        for label, f, rec in zeeman_cases(dt):
            Z, NP, _ = rec.shape
            F = f.shape[0]
            f.numpy().tofile(d / "f.bin")
            rec.numpy().tofile(d / "rec.bin")
            want = MP.zeeman_mp_plain(f, rec).double()
            subprocess.run([str(exe), "f32" if dt == torch.float32 else "f64", str(Z), str(F),
                            str(NP), str(d)], check=True)
            got = torch.from_numpy(np.fromfile(d / "out.bin", npdt).reshape(Z, MP.NCOMP, F))
            errs = [share(got[:, c], want[:, c], tol) for c in range(MP.NCOMP)]
            worst = max(worst, *errs)
            print(f"zeeman_mp {str(dt)[6:]} {label} [{Z}, {NP}, {F}]: share of the limit per "
                  f"component " + " ".join(f"{e:.2e}" for e in errs), flush=True)
    return worst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--disort", default=CSRC / "disort_fused.cu")
    ap.add_argument("--eigh", default=CSRC / "eigh_jacobi.cu")
    ap.add_argument("--zeeman", default=CSRC / "zeeman_mp.cu")
    ap.add_argument("--only", choices=("disort", "eigh", "zeeman"))
    args = ap.parse_args()
    worst = 0.0
    for part, fn, src in (("disort", disort, args.disort), ("eigh", eigh, args.eigh),
                          ("zeeman", zeeman, args.zeeman)):
        if args.only in (None, part):
            with tempfile.TemporaryDirectory() as tmp:
                worst = max(worst, fn(src, pathlib.Path(tmp)))
    print(f"largest difference {worst:.3f} of the tolerance")
    if worst > 1.0:
        raise SystemExit("beyond tolerance")


if __name__ == "__main__":
    main()
