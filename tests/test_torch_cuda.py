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
    kin, _ = V.voigt_inputs(*args[:9], polidx=args[9], table=args[10], res=args[11])
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
    _hold_components(got, want, atol)


def _hold_components(got, want, atol):
    """Each component [:, c] within atol of its own scale; a component that
    is 0 throughout (two of the bench's) exactly 0."""
    for c in range(want.shape[1]):
        scale = want[:, c].abs().max()
        assert bool(((got[:, c] - want[:, c]).abs() <= atol * scale).all()), c


@pytest.mark.parametrize("n_parents", [301, 3])
@pytest.mark.parametrize("dtype, atol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_zeeman_mp_kernel_random_case(dev, dtype, atol, n_parents):
    """The zeeman_mp kernel on scene.build_zeeman_mp_case (3 levels, 301 or
    3 parents in random order, 1100 frequencies: ragged chunks, tiles and
    parts of the parents, one part empty at 3, near points, windows that
    miss whole tiles, M_re and M_im nonzero on all 7 components): overall
    and each component within atol of its scale of the plain version; two
    runs bit-identical."""
    from arts_tpu_torch.ops import zeeman_mp_kernel as MP
    from arts_tpu_torch.scene import build_zeeman_mp_case

    f, rec = build_zeeman_mp_case(3, n_parents, 1100, seed=4, device=dev, dtype=dtype)
    got = MP.zeeman_mp_kernel(f, rec)
    assert torch.equal(got, MP.zeeman_mp_kernel(f, rec))
    got, want = got.double(), MP.zeeman_mp_plain(f, rec).double()
    assert bool(((got - want).abs() <= atol * want.abs().max()).all())
    _hold_components(got, want, atol)


def test_zeeman_mp_kernel_raises(dev):
    """No fallback: the wrapper raises on records it was not built for (P =
    4, unpadded width), on float16 and on unaligned records."""
    from arts_tpu_torch.ops import zeeman_mp_kernel as MP
    from arts_tpu_torch.scene import build_zeeman_mp_case

    f, rec = build_zeeman_mp_case(2, 40, 300, seed=1, device=dev, dtype=torch.float32)
    W = rec.shape[-1]
    unaligned = torch.empty(rec.numel() + 1, device=dev)[1:].view(rec.shape).copy_(rec)
    bad = [(f, torch.zeros(2, 40, MP.record_width(4), device=dev)), (f, rec[..., :82].contiguous()),
           (f.half(), rec.half()), (f, unaligned)]
    for args in bad:
        with pytest.raises(ValueError):
            MP.zeeman_mp_kernel(*args)
    assert W == MP.record_width(MP.MP_TERMS) == 84


def _sym(rng, shape, n, dtype, dev):
    X = torch.tensor(rng.normal(size=shape + (n, n)), dtype=dtype, device=dev)
    return X + X.mT


def _hold_eigh(A, w, V, w_ref, tol):
    """Eigenvalues within tol of scale (max |A|) of w_ref; A V = V diag(w)
    within 4 tol of scale and V^T V = I within 4 tol."""
    n = A.shape[-1]
    scale = float(A.abs().max())
    assert float((w - w_ref).abs().max()) <= tol * scale
    assert float((A @ V - V * w[..., None, :]).abs().max()) <= 4 * tol * scale
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    assert float((V.mT @ V - eye).abs().max()) <= 4 * tol


@pytest.mark.parametrize("n", list(range(1, 17)))
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_eigh_kernel_matches_plain(dev, n, dtype, tol):
    """The Jacobi eigh kernel against its plain version on 3000 random
    symmetric matrices, every n of the kernel (one instance per even
    number of players, odd n with a zero dummy): eigenvalues within tol of
    scale, A V = V diag(w) and V^T V = I within 4 tol (of scale)."""
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi_kernel, eigh_jacobi_plain

    X = torch.tensor(np.random.default_rng(n).normal(size=(3000, n, n)), dtype=dtype, device=dev)
    A = X + X.mT
    w, V = eigh_jacobi_kernel(A)
    w_ref, _ = eigh_jacobi_plain(A)
    _hold_eigh(A, w, V, w_ref, tol)


@pytest.mark.parametrize("B", [1, 63, 65, 64 * 37 + 1])
@pytest.mark.parametrize("n", [8, 13, 16])
@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_eigh_kernel_tail_blocks(dev, n, B, dtype, tol):
    """Batches that end inside a block (64 matrices per block at n = 8, 32
    or 16 at n = 13 and 16): launched on the first B of B + 1 matrices
    into outputs of B + 1 filled with NaN, the kernel holds against its
    plain version as in test_eigh_kernel_matches_plain and writes nothing
    past B."""
    from arts_tpu_torch import _cuda
    from arts_tpu_torch.ops.eigh_jacobi import _default_sweeps, eigh_jacobi_plain

    A = _sym(np.random.default_rng(B + n), (B + 1,), n, dtype, dev)
    w = torch.full((B + 1, n), float("nan"), dtype=dtype, device=dev)
    V = torch.full((B + 1, n, n), float("nan"), dtype=dtype, device=dev)
    _cuda.launch("eigh_jacobi", dtype, *map(_cuda.ptr, (A, w, V)), n, B, _default_sweeps(dtype))
    torch.cuda.synchronize()
    assert bool(torch.isnan(w[B]).all() and torch.isnan(V[B]).all())
    w_ref, _ = eigh_jacobi_plain(A[:B])
    _hold_eigh(A[:B], w[:B], V[:B], w_ref, tol)


@pytest.mark.parametrize("n", [3, 8, 16])
def test_eigh_kernel_leading_dimensions(dev, n):
    """A [3, 5, 7, n, n]: w [3, 5, 7, n] and V [3, 5, 7, n, n], bit for bit
    the kernel on the flattened batch."""
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi_kernel

    A = _sym(np.random.default_rng(n), (3, 5, 7), n, torch.float32, dev)
    w, V = eigh_jacobi_kernel(A)
    wf, Vf = eigh_jacobi_kernel(A.reshape(-1, n, n))
    assert tuple(w.shape) == (3, 5, 7, n) and tuple(V.shape) == (3, 5, 7, n, n)
    assert torch.equal(w.reshape(-1, n), wf) and torch.equal(V.reshape(-1, n, n), Vf)


@pytest.mark.parametrize("n", [8, 13, 16])
def test_eigh_kernel_float32_runs_bit_identical(dev, n):
    """Two float32 runs of the kernel on the same batch are bit-identical."""
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi_kernel

    A = _sym(np.random.default_rng(n), (5000,), n, torch.float32, dev)
    w1, V1 = eigh_jacobi_kernel(A)
    w2, V2 = eigh_jacobi_kernel(A)
    assert torch.equal(w1, w2) and torch.equal(V1, V2)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 2e-6)])
def test_eigh_kernel_eigenvectors_match_plain(dev, dtype, tol):
    """At n = 8 the kernel runs the plain version's rounds and rotations, so
    on matrices whose eigenvalue gaps exceed 1e-2 of scale (Q diag(l) Q^T,
    Q random orthogonal) V agrees entry by entry with the plain version's
    within 200 tol: the eigenvalue tolerance over the smallest gap,
    doubled."""
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi_kernel, eigh_jacobi_plain

    rng = np.random.default_rng(8)
    Q = np.linalg.qr(rng.normal(size=(3000, 8, 8)))[0]
    lam = np.cumsum(rng.uniform(0.02, 0.3, size=(3000, 8)), axis=1)
    lam = rng.permuted(lam - lam.mean(1, keepdims=True), axis=1)
    A = torch.tensor((Q * lam[:, None, :]) @ Q.transpose(0, 2, 1), dtype=dtype, device=dev)
    A = 0.5 * (A + A.mT)
    w, V = eigh_jacobi_kernel(A)
    w_ref, V_ref = eigh_jacobi_plain(A)
    _hold_eigh(A, w, V, w_ref, tol)
    assert float((V - V_ref).abs().max()) <= 200 * tol


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


@pytest.mark.parametrize("L", [1, 2, 7])
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("nquad", [8, 16])
@pytest.mark.parametrize("dtype, rtol", [(torch.float64, 2e-5), (torch.float32, 1e-4)])
def test_stage23_kernel_matches_plain(dev, dtype, rtol, nquad, B, L):
    """The stage 2+3 kernel against its plain version, B lanes (1 and 7 are
    less than a block's 16 lanes, 300 not a multiple of them) and L layers
    (at L = 1 the one layer is also the surface layer), at chip_smoke's
    rtol (2e-5 float64, 1e-4 float32).  The four level radiances are held
    together, at rtol of |want| plus rtol of the largest of them: at L = 1
    vtop is the top boundary value alone, which the solve returns through
    a cancellation of terms of the radiances' scale."""
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.scene import build_stage23_case

    ins = build_stage23_case(nquad, B, L, seed=100 * B + L, device=dev, dtype=dtype)
    assert float(ins[4].abs().max()) > 0  # a reflecting surface
    got, want = FK.stage23(*ins), FK.stage23_plain(*ins)
    scale = max(float(w.double().abs().max()) for w in want)
    assert scale > 0
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        assert tuple(g.shape) == (L, nquad // 2, B) and bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= rtol * (scale + w.abs())).all())


def test_stage23_kernel_float32_runs_bit_identical(dev):
    """Two float32 runs of the stage 2+3 kernel on the same inputs (300
    lanes, 7 layers, 16 streams) give the same bits: no atomics, a fixed
    order of every sum."""
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.scene import build_stage23_case

    ins = build_stage23_case(16, 300, 7, seed=5, device=dev, dtype=torch.float32)
    for a, b in zip(FK.stage23(*ins), FK.stage23(*ins)):
        assert torch.equal(a, b)


def _hold_stage1(got, want, rtol, floor):
    """Every output mode for mode within rtol of its own scale; G+ and G-
    (outputs 1, 2) also within `floor` of their shared scale, for the
    cancellation in (Y -+ D)/2 (chip_smoke.py:phase_fused_eigen)."""
    g_scale = max(float(want[i].double().abs().max()) for i in (1, 2))
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.double(), w.double()
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        lim = rtol * float(w.abs().max()) + (floor * g_scale if i in (1, 2) else 0.0)
        assert float((g - w).abs().max()) <= lim


@pytest.mark.parametrize("L", [1, 7])
@pytest.mark.parametrize("B", [1, 7, 300])
@pytest.mark.parametrize("nquad", [8, 16])
@pytest.mark.parametrize("dtype, rtol, floor", [(torch.float64, 2e-5, 1e-13),
                                                (torch.float32, 1e-4, 1e-6)])
def test_stage1_kernel_matches_plain(dev, dtype, rtol, floor, nquad, B, L):
    """The stage 1 kernel against its plain version on random scattering
    problems (scene.build_stage1_case: far from diagonal, so the Jacobi
    sweeps turn every eigenvector), B lanes (1 and 7 fill no team's block,
    300 is not a multiple of one) and L layers: all seven outputs (Ek, G+,
    G-, ut, vt, ub, vb) mode for mode at chip_smoke's tolerances (2e-5
    float64, 1e-4 float32, of each output's scale)."""
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.scene import build_stage1_case

    ins = build_stage1_case(nquad, B, L, seed=10 * B + L, device=dev, dtype=dtype)
    sweeps = 8 if dtype == torch.float64 else 6
    got, want = FK.stage1(*ins, sweeps), FK.stage1_plain(*ins, sweeps)
    assert tuple(got[1].shape) == (L, (nquad // 2) ** 2, B)
    _hold_stage1(got, want, rtol, floor)


def test_stage1_kernel_float32_runs_bit_identical(dev):
    """Two float32 runs of the stage 1 and fused_eigen kernels on the same
    random scattering problems (300 lanes, 7 layers, 16 streams) give the
    same bits: no atomics, a fixed order of every sum."""
    from arts_tpu_torch.disort import eigen_kernel as EK
    from arts_tpu_torch.disort import fused_kernel as FK
    from arts_tpu_torch.scene import build_stage1_case

    ins = build_stage1_case(16, 300, 7, seed=5, device=dev, dtype=torch.float32)
    for a, b in zip(FK.stage1(*ins, 6), FK.stage1(*ins, 6)):
        assert torch.equal(a, b)
    eig = ins[:4] + (ins[6], 6)
    for a, b in zip(EK.eigen_lanes(*eig), EK.eigen_lanes(*eig)):
        assert torch.equal(a, b)


def _clearsky_case(dev, dtype):
    from arts_tpu_torch.scene import build_clearsky_measurement

    return build_clearsky_measurement(n_lev=12, n_freq=1024, n_lines=256, n_scan=6,
                                      max_step=4000.0, device=dev, dtype=dtype)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_cached_clearsky_kernel_route_matches_plain(dev, dtype, tol):
    """The level-cached observer's kernel route against the float64 plain
    route on the same inputs (a small ATMS scan line): float64 within 1e-9
    of scale, float32 within 1e-4, chip_smoke's bounds; the kernel is
    launched once per measurement vector."""
    from arts_tpu_torch import _cuda
    from arts_tpu_torch.sensor import clearsky_observer_cached, measurement_vector

    case = _clearsky_case(dev, torch.float32)
    run = lambda dt, **kw: measurement_vector(
        case.scene, case.sensor, case.f_grid, list(case.paths),
        observer=clearsky_observer_cached(backend="pallas", **kw), device=dev, dtype=dt)
    want = run(torch.float64, plain=True)
    _cuda.reset_launches()
    got = run(dtype).double()
    assert _cuda.LAUNCHES["voigt_sum"] == 1
    assert float((got - want).abs().max()) <= tol * float(want.abs().max())


def test_sensor_contraction_float32_runs_bit_identical(dev):
    """SensorArray.apply sums each element's weights in a fixed order (no
    atomics): two float32 contractions of the same radiances, and two
    measurement vectors, give the same bits."""
    from arts_tpu_torch.sensor import clearsky_observer_cached, measurement_vector

    case = _clearsky_case(dev, torch.float32)
    G, F = len(case.paths), case.f_grid.numel()
    I = torch.rand(G, F, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
    assert torch.equal(case.sensor.apply(I), case.sensor.apply(I))
    run = lambda: measurement_vector(case.scene, case.sensor, case.f_grid, list(case.paths),
                                     observer=clearsky_observer_cached(backend="pallas"),
                                     device=dev)
    assert torch.equal(run(), run())
