"""The port's cloud retrieval case (scene.build_cloud_retrieval) against
the JAX package on the CPU at float64: the covariances, the case's arrays
against the JAX recipe, and the Jacobian and one Gauss-Newton step of the
slice as a whole (simulate_allsky(fast_linalg=False) with the
Voigt-kernel gas absorption).  test_torch_oem.py holds the state
mappings and the OEM methods."""

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.retrieval.covariance as j_cov
import arts_tpu.retrieval.targets as j_tg
from arts_tpu.fwd_allsky import AllskyScene as JScene
from arts_tpu.fwd_allsky import gas_absorption_profile as j_gas
from arts_tpu.fwd_allsky import simulate_allsky as j_allsky
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu_torch.retrieval import covariance as t_cov
from arts_tpu_torch.retrieval import oem as t_oem
from arts_tpu_torch.scene import build_cloud_retrieval
from test_clearsky import make_scene
from test_torch_oem import CPU64, one_thread, ref_jit  # noqa: F401 (fixture)

# the slice as a whole, at a small size: 16 levels (one cloud level, at
# 5.3 km), 32 frequencies, nquad = 8
N_LEV, N_FREQ, NQUAD = 16, 32, 8


def test_covariances_match_jax():
    g = np.linspace(0.0, 5e3, 5)
    for name in ("exponential", "gaussian"):
        np.testing.assert_allclose(getattr(t_cov, name)(g, 0.5, 2e3).numpy(),
                                   np.asarray(getattr(j_cov, name)(g, 0.5, 2e3)), rtol=1e-14)
    blocks = (np.asarray(j_cov.diagonal([0.1, 0.2])), np.asarray(j_cov.exponential(g, 1.0, 1e3)))
    np.testing.assert_allclose(t_cov.block_diag(t_cov.diagonal([0.1, 0.2]),
                                                t_cov.exponential(g, 1.0, 1e3)).numpy(),
                               np.asarray(j_cov.block_diag(*blocks)), rtol=1e-14)


@pytest.fixture(scope="module")
def case():
    return build_cloud_retrieval(n_lev=N_LEV, n_freq=N_FREQ, nquad=NQUAD, **CPU64)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX recipe: tests/test_clearsky.py's make_scene with the HG
    cloud of tests/test_allsky.py:58, the state of tests/test_oem.py's
    cloud retrieval with extinction and albedo in place of water content."""
    ck = make_scene(N_LEV)
    z = np.asarray(ck.atm.z)
    in_cloud = (ck.atm.z > 4e3) & (ck.atm.z < 8e3)
    cloud = JHG(ext=jnp.where(in_cloud, 5e-4, 0.0), ssa=jnp.full(z.shape, 0.9),
                g=jnp.full(z.shape, 0.7))
    scene = JScene(atm=ck.atm, cat=ck.cat, pf=ck.pf, scatterers=(cloud,),
                   surface_temperature=ck.surface_temperature)
    idx = np.nonzero((z > 4e3) & (z < 8e3))[0]

    def put(name):
        def set_(s, v):
            hg = s.scatterers[0]
            new = dataclasses.replace(hg, **{name: getattr(hg, name).at[idx].set(v)})
            return dataclasses.replace(s, scatterers=(new,))
        return set_

    targets = [
        j_tg.RetrievalTarget("ext", lambda s: s.scatterers[0].ext[idx], put("ext"), "log"),
        j_tg.RetrievalTarget("ssa", lambda s: s.scatterers[0].ssa[idx], put("ssa"), "id"),
        j_tg.RetrievalTarget("ts", lambda s: s.surface_temperature[None],
                             lambda s, v: dataclasses.replace(s, surface_temperature=v[0])),
    ]
    f = jnp.linspace(170e9, 240e9, N_FREQ)
    return scene, f, j_tg.StateMapping(targets, scene), z[idx]


def test_cloud_case_arrays_match_jax_recipe(case, jax_case):
    """The port's own copy of the recipe: atmosphere, catalog, partition
    function, cloud, grid, prior state and covariance equal to 1e-13."""
    scene, f, mapping, zc = jax_case
    ts = case.scene
    pairs = [(ts.atm.z, scene.atm.z), (ts.atm.t, scene.atm.t), (ts.atm.p, scene.atm.p),
             (ts.atm.vmr, scene.atm.vmr), (ts.pf.t_grid, scene.pf.t_grid),
             (ts.pf.q_grid, scene.pf.q_grid), (ts.surface_temperature, scene.surface_temperature),
             (case.f_grid, f), (case.cloud_z, zc), (case.x_a, mapping.to_vector(scene))]
    pairs += [(getattr(ts.scatterers[0], k), getattr(scene.scatterers[0], k))
              for k in ("ext", "ssa", "g")]
    pairs += [(getattr(ts.cat, k.name), getattr(scene.cat, k.name))
              for k in dataclasses.fields(ts.cat)]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0)
    nc = len(zc)
    S_a = np.zeros((2 * nc + 1, 2 * nc + 1))
    S_a[:nc, :nc] = np.asarray(j_cov.exponential(zc, 0.5, 3e3))
    S_a[nc:2 * nc, nc:2 * nc] = 0.1**2 * np.eye(nc)
    S_a[-1, -1] = 25.0
    np.testing.assert_allclose(case.S_a.numpy(), S_a, rtol=1e-14)
    assert case.x_a.numel() == 3 and float(case.cloud_z[0]) == pytest.approx(16e3 / 3)


def test_slice_jacobian_and_gauss_newton_step_match_jax(case, jax_case):
    """The slice as a whole on the cloud case at x_a: the Jacobian of the
    port's forward model (float64, differentiable route, CPU) against
    jax.jacfwd of the JAX package's simulate_allsky(fast_linalg=False,
    k_gas=...) (LAPACK eigh) on the JAX recipe, column by column, to 1e-7
    of each column's largest entry (LAPACK against 8 Jacobi sweeps: the
    eigenvector derivative amplifies their ~1e-15 difference by the
    inverse eigenvalue gaps).  Then one Gauss-Newton step of the port's
    oem against the same step formed from JAX's J and y (the nform
    normal equations the JAX oem solves), to 1e-7 of the state's scale;
    the JAX oem itself would add a second compile of the model."""
    scene, f, mapping, _ = jax_case
    k_gas = j_gas(scene, f)
    np.testing.assert_allclose(case.k_gas.numpy(), np.asarray(k_gas), rtol=0,
                               atol=1e-12 * float(jnp.abs(k_gas).max()))

    def forward(x):
        out = j_allsky(mapping.to_scene(x), f, nquad=NQUAD, k_gas=k_gas, fast_linalg=False)
        y = jnp.concatenate([out.flux_up[:, 0], out.u0[:, 0, -1]])
        return y, y

    jac = ref_jit(jax.jacfwd(forward, has_aux=True))
    x_a = case.x_a.numpy()
    _, y_true = jac(jnp.asarray(case.x_true.numpy()))
    y_obs = case.y_obs.numpy()
    np.testing.assert_allclose(y_obs, np.asarray(y_true), rtol=0, atol=1e-12 * np.abs(y_obs).max())
    Jj, y_a = (np.asarray(a) for a in jac(jnp.asarray(x_a)))
    Jt = torch.func.jacfwd(case.forward)(case.x_a).numpy()
    col = np.abs(Jj).max(0)
    assert np.all(col > 0)
    np.testing.assert_array_less(np.abs(Jt - Jj).max(0), 1e-7 * col)

    S_a, S_e = case.S_a.numpy(), case.S_e.numpy()
    JtSe = Jj.T / S_e
    x1 = x_a + np.linalg.solve(JtSe @ Jj + np.linalg.inv(S_a), JtSe @ (y_obs - y_a))
    res = t_oem(case.forward, case.x_a, case.y_obs, case.S_a, case.S_e, method="gn",
                max_iter=1, device="cpu")
    np.testing.assert_allclose(res.x.numpy(), x1, rtol=0, atol=1e-7 * np.abs(x1).max())
