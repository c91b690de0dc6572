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


def _edge_case(dev, dtype, npol):
    """3 levels, 1000 frequencies (4 tiles, the last padded), 245 lines (not
    a multiple of 128) at -7..-2 GHz with 4 GHz cutoffs, so the last tile
    has no visits; npol = 3: 95 sigma+ lines drawn from those below -4.5
    GHz, the other 150 pi, no sigma-, and a random [3, 7] table per level.
    Returns voigt_inputs' kernel inputs."""
    from arts_tpu_torch.ops import voigt_kernel as V

    rng = np.random.default_rng(11)
    Z, F, L = 3, 1000, 245
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    lev = lambda a: t(a[None] * np.linspace(1.0, 0.6, Z)[:, None])
    f = np.linspace(-8e9, 8e9, F)
    f0 = np.sort(rng.uniform(-7e9, -2e9, L))
    cols = [t(f), t(np.broadcast_to(f0, (Z, L)).copy()), lev(10 ** rng.uniform(-9, -5.4, L)),
            lev(rng.uniform(0.05, 20.0, L)), lev(rng.uniform(0.1, 1.0, L)),
            lev(0.05 * rng.normal(size=L)), t(np.full((Z, L), 4e9)),
            lev(1e-3 * rng.normal(size=L)), lev(1e-3 * rng.normal(size=L))]
    if npol == 1:
        kin, _ = V.voigt_inputs(*cols)
    else:
        polidx = np.zeros(L, np.int64)
        polidx[rng.choice(np.flatnonzero(f0 < -4.5e9), 95, replace=False)] = 2
        kin, _ = V.voigt_inputs(*cols, polidx=torch.as_tensor(polidx, device=dev),
                                table=t(rng.normal(size=(Z, 3, 7))))
        assert kin[6].tolist() == [0, 0, 2]
    nvisit = kin[4]
    assert bool((nvisit[:, -1] == 0).all()) and bool((nvisit % 3 != 0).any())
    return kin


@pytest.mark.parametrize("split", [1, 3, None])
@pytest.mark.parametrize("npol, dtype, rtol, atol", [
    (1, torch.float64, 0.0, 1e-9), (1, torch.float32, 2e-6, 5e-7),
    (3, torch.float64, 0.0, 1e-12), (3, torch.float32, 2e-5, 2e-6)])
def test_voigt_kernel_edge_cases_match_plain(dev, npol, dtype, rtol, atol, split):
    """Both instances against their plain versions, at the tolerances of the
    bench-shaped tests above, on _edge_case: a partial line block, an empty
    polarization, a (level, tile) without visits, and visit lists cut into
    1, 3 (not a divisor of the visit counts) and the default number of
    chunks; two runs are bit-identical."""
    from arts_tpu_torch.ops import voigt_kernel as V

    kin = _edge_case(dev, dtype, npol)
    kernel, plain = ((V.voigt_kernel, V.voigt_kernel_plain) if npol == 1 else
                     (V.voigt_kernel_pol, V.voigt_kernel_pol_plain))
    got = kernel(*kin, split=split)
    assert torch.equal(got, kernel(*kin, split=split))
    got, want = got.double(), plain(*kin).double()
    scale = want.abs().max()
    assert float(scale) > 0
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


@pytest.mark.parametrize("n", [3, 4, 8, 12, 16])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_eigh_kernel_matches_plain(dev, n, dtype, tol):
    """The Jacobi eigh kernel against its plain version on 3000 random
    symmetric matrices (the unrolled instance for n <= 8, the run-time-n
    instance above): eigenvalues within tol of scale, A V = V diag(w) and
    V^T V = I within 4 tol (of scale)."""
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi_kernel, eigh_jacobi_plain

    X = torch.tensor(np.random.default_rng(n).normal(size=(3000, n, n)), dtype=dtype, device=dev)
    A = X + X.mT
    w, V = eigh_jacobi_kernel(A)
    w_ref, _ = eigh_jacobi_plain(A)
    scale = float(A.abs().max())
    assert float((w - w_ref).abs().max()) <= tol * scale
    assert float((A @ V - V * w[..., None, :]).abs().max()) <= 4 * tol * scale
    eye = torch.eye(n, dtype=dtype, device=dev)
    assert float((V.mT @ V - eye).abs().max()) <= 4 * tol


def test_eigh_vmap_rule_launches_the_kernel_once(dev):
    """torch.func.vmap over A (mapped axis in the middle) on the card: the
    vmap rule folds the mapped axis into the batch of one kernel launch,
    bit for bit the launches on each mapped slice."""
    from arts_tpu_torch import _cuda
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi

    X = torch.tensor(np.random.default_rng(5).normal(size=(300, 7, 8, 8)), device=dev)
    A = (X + X.mT).permute(0, 2, 1, 3).contiguous()  # [300, 8, 7, 8], A[:, :, i] symmetric
    _cuda.reset_launches()
    w, V = torch.func.vmap(lambda a: eigh_jacobi(a, device=dev), in_dims=2)(A)
    assert _cuda.LAUNCHES["eigh_jacobi"] == 1 and tuple(V.shape) == (7, 300, 8, 8)
    for i in range(7):
        wi, Vi = eigh_jacobi(A[:, :, i], device=dev)
        assert torch.equal(w[i], wi) and torch.equal(V[i], Vi)


@pytest.mark.parametrize("nquad", [8, 16])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-4)])
def test_fused_eigen_kernel_matches_plain(dev, nquad, dtype, tol):
    """The standalone eigen-stage kernel against its plain version on 300
    random layers: k, Ek and G+- mode for mode (the same Jacobi schedule
    leaves the same order) within tol of scale; float32 at stage 1's
    1e-4 (chip_smoke.py)."""
    from arts_tpu_torch.disort.eigen_kernel import eigen_lanes, eigen_lanes_plain
    from arts_tpu_torch.disort.fused_kernel import stage1_inputs
    from arts_tpu_torch.disort.quadrature import double_gauss, lambda_tables

    rng = np.random.default_rng(nquad)
    n, B, L = nquad // 2, 300, 7
    mu, w = double_gauss(n)
    lam, sign = lambda_tables(1, nquad, n)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    g = rng.uniform(0.0, 0.85, (B, L))
    legs = t((2 * np.arange(nquad) + 1) * g[..., None] ** np.arange(nquad))
    zero = t(np.zeros((B, 1, L)))
    pp, pm, om, dtau, _, _, q = stage1_inputs(
        legs, t(rng.uniform(0.05, 0.95, (B, L))), t(rng.uniform(1e-3, 1.5, (B, L))), zero, zero,
        lam=lam, sign=sign, mu=mu, w=w)
    sweeps = 8 if dtype == torch.float64 else 6
    for got, want in zip(eigen_lanes(pp, pm, om, dtau, q, sweeps),
                         eigen_lanes_plain(pp, pm, om, dtau, q, sweeps)):
        assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_differentiable_route_kernel_matches_plain(dev):
    """simulate-style problems through disort(fast_linalg=False) in
    float64: the eigh kernel route against the plain route to 1e-10 of
    scale, and its Jacobian (torch.func.jacfwd over tau) to 1e-9 of scale."""
    from arts_tpu_torch.disort import DisortInput, disort

    rng = np.random.default_rng(3)
    F, L = 64, 6
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    base = dict(omega=t(rng.uniform(0.0, 0.9, (F, L))), leg=t(0.6 ** np.arange(16) * np.ones((F, L, 1))),
                f=t(np.zeros((F, L))), b_levels=t(np.linspace(1.0, 2.0, L + 1) * np.ones((F, 1))),
                fisot=t(np.zeros(F)), albedo=t(np.full(F, 0.1)), b_surf=t(np.full(F, 2.5)),
                b_top=t(np.full(F, 0.01)))

    def run(tau, plain):
        out = disort(DisortInput(tau=tau, **base), nquad=16, fast_linalg=False, plain=plain,
                     device=dev, dtype=torch.float64)
        return torch.cat([out.flux_up[:, 0], out.u0[:, 0, -1]])

    tau = t(rng.uniform(0.05, 2.0, (F, L)))
    a, b = run(tau, False), run(tau, True)
    assert float((a - b).abs().max()) <= 1e-10 * float(b.abs().max())
    Ja = torch.func.jacfwd(lambda x: run(x, False))(tau)
    Jb = torch.func.jacfwd(lambda x: run(x, True))(tau)
    assert float((Ja - Jb).abs().max()) <= 1e-9 * float(Jb.abs().max())
