"""The port's CUDA kernels against their plain PyTorch versions at small
shapes.  They need a CUDA card: marked `cuda`, they skip without one.  On a
machine with the card (which has no JAX), run them without the repository's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype, rtol, atol", [(torch.float64, 0.0, 1e-9),
                                               (torch.float32, 2e-6, 5e-7)])
def test_voigt_kernel_matches_plain(dev, dtype, rtol, atol):
    """A 512-line, 8-level bench-shaped profile: f64 at 1e-9 * scale, f32
    at the JAX interpret test's bounds (tests/test_tpu_kernels.py:55)."""
    from arts_tpu_torch.lbl.voigt import voigt_sum_args
    from arts_tpu_torch.ops import voigt_kernel as V
    from arts_tpu_torch.scene import build_scene

    scene, f = build_scene(n_lev=8, n_freq=1024, n_lines=512, device=dev, dtype=dtype)
    pts = scene.atm.at(scene.atm.z.flip(0))
    kin, _ = V.voigt_inputs(*voigt_sum_args(f, scene.cat, scene.pf, pts.t, pts.p, pts.vmr))
    got = V.voigt_kernel(*kin).double()
    want = V.voigt_kernel_plain(*kin).double()
    scale = want.abs().max()
    assert bool(((got - want).abs() <= atol * scale + rtol * want.abs()).all())


@pytest.mark.parametrize("nquad", [8, 16])
def test_disort_kernels_match_plain(dev, nquad):
    """300 random thermal problems of 7 layers in float64: the kernels'
    fused solve against the plain one at rtol 2e-5, the JAX fused test's
    tolerance (tests/test_fused_disort.py:54)."""
    from arts_tpu_torch.disort import DisortInput, disort

    rng = np.random.default_rng(1)
    F, L = 300, 7
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    inp = DisortInput(
        tau=t(rng.uniform(0.05, 2.0, (F, L))), omega=t(rng.uniform(0.0, 0.9, (F, L))),
        leg=t(0.6 ** np.arange(nquad) * np.ones((F, L, 1))), f=t(np.zeros((F, L))),
        b_levels=t(np.linspace(1.0, 2.0, L + 1) * np.ones((F, 1))), fisot=t(np.zeros(F)),
        albedo=t(np.full(F, 0.1)), b_surf=t(np.full(F, 2.5)), b_top=t(np.full(F, 0.01)),
    )
    kw = dict(nquad=nquad, device=dev, dtype=torch.float64)
    got, want = disort(inp, **kw), disort(inp, plain=True, **kw)
    for key in ("flux_up", "u0"):
        a, b = getattr(got, key), getattr(want, key)
        assert bool(((a - b).abs() <= 2e-5 * (b.abs().max() + b.abs())).all()), key
