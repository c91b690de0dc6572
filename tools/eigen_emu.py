"""Run the eigen kernels of csrc/disort_fused.cu on the CPU and hold them
against their plain versions, without a card or nvcc.

    python3 tools/eigen_emu.py [source.cu]

The stage 1 and fused_eigen kernels (stage1_kernel, fused_eigen_kernel and
the device code they call) are cut from the source (default: the
package's), compiled with g++ against CPU stand-ins for the CUDA built-ins
they use (tools/eigen_emu/: threads, barriers, shuffles, cp.async; the PTX
approximations become the IEEE operations) and run block by block on
scene.build_stage1_case problems: n = 8 and 4, float64 and float32, 37
lanes x 2 layers, 5 x 1 and 9 x 7.  Prints each output's largest
difference from stage1_plain / eigen_lanes_plain as a share of its scale
and exits non-zero beyond the chip checks' tolerances (float64 2e-5,
float32 1e-4).  It checks the kernels' logic (indices, the team's
schedule, shuffles, synchronisation points in order); what the card's
compiler and hardware do, and every time, only a chip run shows.  Needs
g++ with C++20; a minute or so.
"""

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
from arts_tpu_torch.scene import build_stage1_case  # noqa: E402

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


def build(src, d):
    """The emulator binary for `src` in directory d."""
    text = pathlib.Path(src).read_text()
    text = text[: text.index("// stages 2+3\n")]
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu_smem;")
    for old, new in PTX.items():
        text = text.replace(old, new)
    (d / "kernels.cpp").write_text(text + "}  // namespace\n" + (HERE / "main.cpp").read_text())
    (d / "jacobi.cuh").write_text((CSRC / "jacobi.cuh").read_text())
    exe = d / "emu"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-I", str(HERE),
                    "-I", str(d), str(d / "kernels.cpp"), "-o", str(exe)], check=True)
    return exe


def run(exe, mode, ins, sweeps, d):
    """The kernel's outputs on the stage 1 inputs `ins` (CPU tensors)."""
    for name, x in zip(("pp", "pm", "om", "dtau", "tb0", "tb1", "qtab"), ins):
        x.numpy().tofile(d / f"{name}.bin")
    L, nn, B = ins[0].shape
    n = int(round(nn**0.5))
    f32 = ins[0].dtype == torch.float32
    subprocess.run([str(exe), mode, "f32" if f32 else "f64", str(n), str(L), str(B),
                    str(sweeps), str(d)], check=True)
    vec, mat = (L, n, B), (L, nn, B)
    names = ((("ek", vec), ("gp", mat), ("gm", mat), ("ut", vec), ("vt", vec), ("ub", vec),
              ("vb", vec)) if mode == "stage1" else
             (("k", vec), ("ek", vec), ("gp", mat), ("gm", mat)))
    dt = np.float32 if f32 else np.float64
    return tuple(torch.from_numpy(np.fromfile(d / f"{nm}.out", dt).reshape(shape))
                 for nm, shape in names)


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else CSRC / "disort_fused.cu"
    worst = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        exe = build(src, d)
        for nquad in (16, 8):
            for dt, sweeps, tol in ((torch.float64, 8, 2e-5), (torch.float32, 6, 1e-4)):
                for B, L in CASES:
                    ins = build_stage1_case(nquad, B, L, seed=B + L, device="cpu", dtype=dt)
                    pairs = (("stage 1", run(exe, "stage1", ins, sweeps, d),
                              FK.stage1_plain(*ins, sweeps)),
                             ("fused_eigen", run(exe, "eigen", ins, sweeps, d),
                              EK.eigen_lanes_plain(*ins[:4], ins[6], sweeps)))
                    for what, got, want in pairs:
                        errs = [float((g.double() - w.double()).abs().max() / w.double().abs().max())
                                for g, w in zip(got, want)]
                        worst = max(worst, max(errs) / tol)
                        print(f"n={nquad // 2} {str(dt)[6:]} B={B} L={L} {what}: "
                              + " ".join(f"{e:.1e}" for e in errs), flush=True)
    print(f"largest difference {worst:.3f} of the tolerance")
    if worst > 1.0:
        raise SystemExit("beyond tolerance")


if __name__ == "__main__":
    main()
