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


@pytest.mark.parametrize("dtype, rtol, atol", [(torch.float64, 0.0, 1e-12),
                                               (torch.float32, 2e-5, 2e-6)])
def test_voigt_pol_kernel_matches_plain(dev, dtype, rtol, atol):
    """The polarized Voigt kernel on a 256-line bench-shaped Zeeman
    catalog (~7800 pseudo-lines) at 4 levels and an oblique field: f64 at
    1e-12 * scale, f32 at the JAX package's Pallas-vs-XLA bound
    (tests/test_zeeman.py:146)."""
    from arts_tpu_torch.lbl.zeeman import voigt_sum_pol_args
    from arts_tpu_torch.ops import voigt_kernel as V
    from arts_tpu_torch.scene import build_zeeman_inputs

    d = build_zeeman_inputs(n_lev=4, n_freq=1024, n_lines=256, device=dev, dtype=dtype)
    mag = torch.tensor([10e-6, -20e-6, 40e-6], dtype=dtype, device=dev)
    args, _ = voigt_sum_pol_args(d["f_grid"], d["zcat"], d["pf"], d["T"], d["P"], d["vmr"],
                                 mag, 65.0, 30.0)
    kin, _ = V.voigt_inputs(*args[:9], polidx=args[9], table=args[10])
    got = V.voigt_kernel_pol(*kin).double()
    want = V.voigt_kernel_pol_plain(*kin).double()
    scale = want.abs().max()
    assert bool(((got - want).abs() <= atol * scale + rtol * want.abs()).all())


@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_zeeman_mp_kernel_matches_plain(dev, dtype, atol):
    """The zeeman_mp kernel on the parent poles of a 256-line bench-shaped
    catalog at 6 levels: f64 at 1e-12 * scale, f32 at 2e-6 * scale (the
    same full-precision arithmetic summed in another order)."""
    from arts_tpu_torch.lbl.zeeman import zeeman_mp_args
    from arts_tpu_torch.ops import zeeman_mp_kernel as MP
    from arts_tpu_torch.scene import build_zeeman_inputs

    d = build_zeeman_inputs(n_lev=6, n_freq=1024, n_lines=256, device=dev, dtype=dtype)
    poles, _, _ = zeeman_mp_args(d["f_grid"], d["pzcat"], d["pf"], d["T"], d["P"], d["vmr"],
                                 d["mag"], d["los_za_deg"], mp_kappa=d["tune"]["mp_kappa"])
    f, rec = poles[0], MP.pole_records(*poles[1:])
    got = MP.zeeman_mp_kernel(f, rec).double()
    want = MP.zeeman_mp_plain(f, rec).double()
    assert bool(((got - want).abs() <= atol * want.abs().max()).all())
