"""The port's differentiable DISORT route (disort(fast_linalg=False)) and its
standalone eigen stage (fused_eigen) on the CPU at float64: against the
JAX package's LAPACK route, the port's fused route, the cdisort goldens,
JAX's eigen stage, and central differences."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.disort.solver as j_solver
from arts_tpu.disort import DisortInput as JInput
from arts_tpu.disort.quadrature import double_gauss, lambda_tables
from arts_tpu_torch.disort import DisortInput, disort
from arts_tpu_torch.disort.eigen_kernel import fused_eigen
from test_disort import band_planck, golden_case
from test_torch_disort import _inputs, _port_input

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


@pytest.mark.parametrize("omega2, tol", [(0.95, 1e-9), (1.0, 1e-6)])
def test_matches_jax_lapack_route_and_fused_route(omega2, tol):
    """Thermal problems with delta-M and an optically thin layer: fluxes
    and intensities within tol of scale of JAX's disort(fast_linalg=False)
    (LAPACK eigh on the CPU) and of the port's fused route.  With a third
    layer at omega = 1 (clipped to 1 - 1e-9), -H1 is nearly singular
    (condition ~1e9) and LAPACK and the Jacobi sweep differ by up to
    ~3e-7 of scale on that input, JAX's own routes alike; 1e-6 there,
    1e-9 at omega = 0.95."""
    d = _inputs(F=3, L=4)
    d["omega"][:, 2] = omega2
    jinp = JInput(fbeam=jnp.zeros(3), **{k: jnp.asarray(v) for k, v in d.items()})
    ref = jax.vmap(lambda i: j_solver.disort(i, nquad=8, fast_linalg=False,
                                             phis=(0.0, 90.0)))(jinp)
    inp = _port_input(d)
    got = disort(inp, nquad=8, fast_linalg=False, phis=(0.0, 90.0), **CPU64)
    fused = disort(inp, nquad=8, phis=(0.0, 90.0), **CPU64)
    for key in ("flux_up", "flux_down_diffuse", "u0", "u"):
        want = np.asarray(getattr(ref, key))
        scale = np.abs(want).max()
        for out in (got, fused):
            np.testing.assert_allclose(getattr(out, key).numpy(), want, rtol=0,
                                       atol=tol * scale, err_msg=key)


@pytest.mark.parametrize("name", ["thermal_abs", "thermal_scat", "iso_isotropic_top"])
def test_cdisort_goldens(name):
    """The differentiable route on the cdisort goldens at their own
    tolerances: fluxes 2e-5, intensities 5e-4 (tests/test_disort.py:86)."""
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
    out = disort(inp, nquad=nstr, phis=(0.0,), fast_linalg=False, **CPU64)
    scale = max(np.abs(c["flup"]).max(), np.abs(c["rfldn"]).max())
    for key, ref in (("flux_up", c["flup"]), ("flux_down_diffuse", c["rfldn"])):
        np.testing.assert_allclose(getattr(out, key)[0].numpy(), ref, rtol=2e-5,
                                   atol=2e-5 * scale, err_msg=key)
    u0_ref = np.asarray(c["u0u"]).T
    uscale = np.abs(u0_ref).max()
    np.testing.assert_allclose(out.u0[0].numpy(), u0_ref, rtol=5e-4, atol=5e-4 * uscale)
    np.testing.assert_allclose(out.u[0, ..., 0].numpy(), np.asarray(c["uu"]).T,
                               rtol=5e-4, atol=5e-4 * uscale)


def test_fused_eigen_plain_matches_jax_eigen():
    """fused_eigen's plain version against JAX's _eigen (LAPACK) as
    tests/test_tpu_kernels.py:88 holds the JAX kernel: sorted k at rtol
    1e-10 and the order-invariant sums sum_i Ek_i A[:, i] B[:, i]^T at
    1e-9 of scale (rtol 1e-8), for (A, B) = (G+, G-), (G+, G+), (G-, G-)."""
    rng = np.random.default_rng(4)
    F, L, nq, N = 2, 3, 8, 4
    mu, w = double_gauss(N)
    lam, sign = lambda_tables(1, nq, N)
    g = rng.uniform(0.0, 0.85, (F, L))
    legs = (2.0 * np.arange(nq) + 1.0) * g[..., None] ** np.arange(nq)
    omega = rng.uniform(0.05, 0.95, (F, L))
    dtau = rng.uniform(1e-3, 1.5, (F, L))
    Pp = np.einsum("flk,mki,mkj->fmlij", legs, lam, lam)
    Pm = np.einsum("flk,mk,mki,mkj->fmlij", legs, sign, lam, lam)

    k_r, Gp_r, Gm_r = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda a, b, om: j_solver._eigen(a, b, om, jnp.asarray(mu), jnp.asarray(w), False)
    ))(jnp.asarray(Pp), jnp.asarray(Pm), jnp.asarray(omega)))
    Ek_r = np.exp(-k_r * dtau[:, None, :, None])
    t = lambda a: torch.tensor(np.ascontiguousarray(a))
    k_f, Ek_f, Gp_f, Gm_f = (x.numpy() for x in fused_eigen(
        t(Pp), t(Pm), t(omega[:, None, :]), t(dtau[:, None, :]), mu, w, device="cpu"))
    np.testing.assert_allclose(np.sort(k_f, -1), np.sort(k_r, -1), rtol=1e-10)
    np.testing.assert_allclose(Ek_f, np.exp(-k_f * dtau[:, None, :, None]), rtol=1e-14)
    for A_r, B_r, A_f, B_f in ((Gp_r, Gm_r, Gp_f, Gm_f), (Gp_r, Gp_r, Gp_f, Gp_f),
                               (Gm_r, Gm_r, Gm_f, Gm_f)):
        inv_r = np.einsum("...i,...ji,...ki->...jk", Ek_r, A_r, B_r)
        inv_f = np.einsum("...i,...ji,...ki->...jk", Ek_f, A_f, B_f)
        np.testing.assert_allclose(inv_f, inv_r, atol=1e-9 * np.abs(inv_r).max(), rtol=1e-8)


def test_gradient_through_solver_matches_central_differences():
    """d(TOA flux_up)/d(tau) by autograd through the differentiable route
    (Cholesky, the eigh Function's backward, the Thomas solve) against
    central differences, rtol 2e-4 (tests/test_disort.py:186, thermal)."""
    L = 3

    def loss(tau):
        inp = DisortInput(
            tau=tau[None], omega=torch.tensor([[0.3, 0.5, 0.7]], dtype=torch.float64),
            leg=torch.tensor(0.6 ** np.arange(8) * np.ones((1, L, 1))),
            f=torch.zeros(1, L, dtype=torch.float64),
            b_levels=torch.tensor([[1.0, 1.2, 1.4, 1.6]], dtype=torch.float64),
            fisot=torch.zeros(1, dtype=torch.float64),
            albedo=torch.full((1,), 0.2, dtype=torch.float64),
            b_surf=torch.full((1,), 1.7, dtype=torch.float64),
            b_top=torch.zeros(1, dtype=torch.float64))
        return disort(inp, nquad=8, fast_linalg=False, **CPU64).flux_up[0, 0]

    t0 = torch.tensor([0.2, 0.5, 1.0], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(t0), t0)
    assert torch.isfinite(g).all() and float(g.abs().max()) > 0
    h = 1e-6
    for i in range(L):
        e = torch.zeros(L, dtype=torch.float64)
        e[i] = h
        with torch.no_grad():
            fd = (float(loss(t0 + e)) - float(loss(t0 - e))) / (2 * h)
        np.testing.assert_allclose(float(g[i]), fd, rtol=2e-4, atol=1e-10)
