"""The port's DISORT (arts_tpu_torch.disort) against arts_tpu and the cdisort
goldens on the CPU at float64.  On CPU tensors the fused solve runs the
kernels' plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.disort.solver as j_solver
from arts_tpu.disort import DisortInput as JInput
from arts_tpu.disort.quadrature import double_gauss, lambda_tables
from arts_tpu_torch.disort import DisortInput, disort
from arts_tpu_torch.disort import fused_kernel as FK
from test_disort import band_planck, golden_case

CPU64 = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(F=3, L=5, nleg=8, seed=0):
    """F thermal problems as numpy: scattering layers with delta-M, one
    optically thin layer (the constant-source switch, dtau < 1e-5), one
    layer at omega = 1 (the clip below 1), a Lambertian surface and
    isotropic illumination at the top."""
    rng = np.random.default_rng(seed)
    tau = rng.uniform(0.05, 1.5, (F, L))
    tau[:, 1] = 3e-6
    omega = rng.uniform(0.1, 0.9, (F, L))
    omega[:, 2] = 1.0
    g = rng.uniform(0.0, 0.8, (F, L))
    return dict(
        tau=tau, omega=omega, leg=g[..., None] ** np.arange(nleg),
        f=0.5 * g**nleg, b_levels=np.linspace(1.0, 2.0, L + 1) * rng.uniform(0.5, 1.5, (F, 1)),
        fisot=rng.uniform(0.0, 0.2, F), albedo=rng.uniform(0.0, 0.4, F),
        b_surf=rng.uniform(2.0, 3.0, F), b_top=rng.uniform(0.0, 0.05, F),
    )


def _port_input(d):
    return DisortInput(**{k: torch.tensor(np.asarray(v, np.float64)) for k, v in d.items()})


@pytest.fixture
def force_fused(monkeypatch):
    monkeypatch.setattr(j_solver, "_FORCE_FUSED_INTERPRET", True)
    j_solver.disort.clear_cache()
    yield
    j_solver.disort.clear_cache()


def test_fused_solve_matches_jax_fused_interpret(force_fused):
    """The port's fused solve against JAX's fused Pallas path in interpret
    mode (vmapped over frequency into its lanes), at the JAX fused test's
    tolerance, rtol 2e-5 (tests/test_fused_disort.py:54)."""
    d = _inputs()
    jinp = JInput(fbeam=jnp.zeros(3), **{k: jnp.asarray(v) for k, v in d.items()})
    ref = jax.vmap(lambda i: j_solver.disort(i, nquad=8, phis=(0.0, 90.0)))(jinp)
    out = disort(_port_input(d), nquad=8, phis=(0.0, 90.0), **CPU64)
    for key in ("flux_up", "flux_down_diffuse", "u0", "u"):
        want = np.asarray(getattr(ref, key))
        scale = max(np.abs(want).max(), 1e-12)
        np.testing.assert_allclose(getattr(out, key).numpy(), want, rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=key)


@pytest.mark.parametrize("name", ["thermal_abs", "thermal_scat", "iso_isotropic_top"])
def test_cdisort_goldens(name):
    """cdisort goldens at their own tolerances: fluxes 2e-5, intensities
    5e-4 (tests/test_disort.py:86)."""
    c = golden_case(name)
    L, nstr = c["nlyr"], c["nstr"]
    g = np.asarray(c["g"], np.float64)
    if c["planck"]:
        b_levels = [band_planck(c["wvnmlo"], c["wvnmhi"], t) for t in c["temper"][: L + 1]]
        b_surf = band_planck(c["wvnmlo"], c["wvnmhi"], c["btemp"])
        b_top = band_planck(c["wvnmlo"], c["wvnmhi"], c["ttemp"]) * c["temis"]
    else:
        b_levels, b_surf, b_top = np.zeros(L + 1), 0.0, 0.0
    one = lambda x: np.asarray([x], np.float64)
    inp = _port_input(dict(
        tau=one(c["dtauc"]), omega=one(c["ssalb"]),
        leg=(g[:, None] ** np.arange(c["nmom"] + 1))[None], f=(g**nstr)[None],
        b_levels=one(b_levels), fisot=one(c["fisot"]), albedo=one(c["albedo"]),
        b_surf=one(b_surf), b_top=one(b_top),
    ))
    out = disort(inp, nquad=nstr, phis=(0.0,), **CPU64)
    np.testing.assert_allclose(out.mu.numpy(), c["umu"], rtol=1e-10)
    scale = max(np.abs(c["flup"]).max(), np.abs(c["rfldn"]).max())
    for key, ref in (("flux_up", c["flup"]), ("flux_down_diffuse", c["rfldn"])):
        np.testing.assert_allclose(getattr(out, key)[0].numpy(), ref, rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=key)
    u0_ref = np.asarray(c["u0u"]).T
    uscale = np.abs(u0_ref).max()
    np.testing.assert_allclose(out.u0[0].numpy(), u0_ref, rtol=5e-4, atol=5e-4 * uscale)
    np.testing.assert_allclose(out.u[0, ..., 0].numpy(), np.asarray(c["uu"]).T,
                               rtol=5e-4, atol=5e-4 * uscale)


def test_stage1_plain_eigenvalues_match_lapack():
    """The plain stage 1 (Cholesky, Hsym, tournament Jacobi, 8 sweeps)
    against JAX's LAPACK eigen stage: sorted k at rtol 1e-10, as the JAX
    fused-eigen test holds its kernel (tests/test_tpu_kernels.py:117)."""
    rng = np.random.default_rng(4)
    B, L, nq, N = 6, 13, 8, 4
    mu, w = double_gauss(N)
    lam, sign = lambda_tables(1, nq, N)
    g = rng.uniform(0.0, 0.85, (B, L))
    legs = (2.0 * np.arange(nq) + 1.0) * g[..., None] ** np.arange(nq)
    omega = rng.uniform(0.05, 0.95, (B, L))
    dtau = rng.uniform(1e-3, 1.5, (B, L))
    Pp = np.einsum("blk,ki,kj->lijb", legs, lam[0], lam[0])
    Pm = np.einsum("blk,k,ki,kj->lijb", legs, sign[0], lam[0], lam[0])
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    z = torch.zeros((L, B), dtype=torch.float64)
    ek, *_ = FK.stage1_plain(t(Pp.reshape(L, N * N, B)), t(Pm.reshape(L, N * N, B)),
                             t(omega.T), t(dtau.T), z, z,
                             FK.quad_table(mu, w, torch.float64, "cpu"), sweeps=8)
    k = -np.log(ek.numpy()) / dtau.T[:, None, :]  # [L, N, B]
    k_ref = np.asarray(jax.vmap(lambda a, b, om: j_solver._eigen(
        a[None], b[None], om, jnp.asarray(mu), jnp.asarray(w))[0])(
        jnp.asarray(np.moveaxis(Pp, -1, 0)), jnp.asarray(np.moveaxis(Pm, -1, 0)),
        jnp.asarray(omega)))[:, 0]  # [B, L, N]
    np.testing.assert_allclose(np.sort(np.moveaxis(k, -1, 0), -1), np.sort(k_ref, -1),
                               rtol=1e-10)


def test_build_stage1_case_is_a_scattering_case():
    """scene.build_stage1_case gives stage 1's inputs in lane layout, and
    its problems scatter: in every (layer, lane) the plain G+ reaches at
    least 1e-3 of G-'s largest entry (in build_scene's gas-only layers G+
    is zero up to rounding), so the kernel's G+ is held to something."""
    from arts_tpu_torch.scene import build_stage1_case

    B, L, nq = 7, 3, 8
    n = nq // 2
    ins = build_stage1_case(nq, B, L, seed=2, device="cpu", dtype=torch.float32)
    shapes = [(L, n * n, B)] * 2 + [(L, B)] * 4 + [(5 * n + 2 * n * n,)]
    assert [tuple(x.shape) for x in ins] == shapes
    assert all(x.dtype == torch.float32 and x.is_contiguous() for x in ins)
    _, gp, gm, *_ = FK.stage1_plain(*(x.double() for x in ins), 8)
    assert bool(torch.isfinite(gp).all())
    assert float((gp.abs().amax(1) / gm.abs().amax(1)).min()) >= 1e-3


def test_beam_and_brdf_are_not_ported():
    inp = _port_input(_inputs(F=1, L=3))
    with pytest.raises(NotImplementedError):
        disort(inp, nquad=8, mu0=0.5, **CPU64)
    with pytest.raises(NotImplementedError):
        disort(inp, nquad=8, brdf=object(), **CPU64)
