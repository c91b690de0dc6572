"""The port's retrieval package (arts_tpu_torch.retrieval) and its cloud
retrieval case (scene.build_cloud_retrieval) against the JAX package on the
CPU at float64: state mappings and covariances, every OEM method on a
cheap quadratic forward model, the case's arrays against the JAX recipe,
and the Jacobian and one Gauss-Newton step of the slice as a whole
(simulate_allsky(fast_linalg=False) with the Voigt-kernel gas absorption)."""

import dataclasses
import functools

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
from arts_tpu.retrieval.oem import oem as j_oem
from arts_tpu.retrieval.oem import retrieval_error_covariance as j_rec
from arts_tpu.retrieval.oem import smoothing_error_covariance as j_sec
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu_torch.retrieval import covariance as t_cov
from arts_tpu_torch.retrieval import oem as t_oem
from arts_tpu_torch.retrieval import targets as t_tg
from arts_tpu_torch.retrieval.oem import retrieval_error_covariance as t_rec
from arts_tpu_torch.retrieval.oem import smoothing_error_covariance as t_sec
from arts_tpu_torch.scene import build_cloud_retrieval
from test_clearsky import make_scene

CPU64 = dict(device="cpu", dtype=torch.float64)
# jax.jit with LLVM's optimizations off: the slice's Jacobian compiles in a
# fraction of the time of the default jit
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class _Atm:
    t: object
    p: object


@dataclasses.dataclass(frozen=True)
class _Toy:
    atm: _Atm
    vmr: object
    a: object
    b: object
    c: object
    d: object
    poly: object


def _toy(lib):
    z = np.linspace(0.0, 10e3, 6)
    arr = (lambda v: jnp.asarray(v)) if lib == "jax" else (lambda v: torch.tensor(v))
    return _Toy(
        atm=_Atm(t=arr(288.0 - 6.5e-3 * z), p=arr(101325.0 * np.exp(-z / 8e3))),
        vmr=arr(0.01 * np.exp(-z / 2e3)), a=arr(np.linspace(1.0, 2.0, 6)),
        b=arr(np.linspace(3.0, 4.0, 6)), c=arr(np.linspace(0.5, 1.5, 6)),
        d=arr(np.linspace(-1.0, 1.0, 6)), poly=arr(np.cos(z / 3e3)))


def _targets(tg):
    rep = dataclasses.replace
    fields = ("vmr", "a", "b", "c", "d", "poly")
    poly = tg.PolyFitTransform(grid=np.linspace(150e9, 250e9, 6), order=2)
    tfs = ("rh", "log", "rel", "logrel", "id", poly)
    return [tg.RetrievalTarget(f, (lambda s, f=f: getattr(s, f)),
                               (lambda s, v, f=f: rep(s, **{f: v})), transform=tf)
            for f, tf in zip(fields, tfs)]


def test_state_mapping_matches_jax():
    """Every transform (id, log, rel, logrel, rh with the Murphy-Koop
    saturation pressure, a 2nd-order polyfit): n_state, to_vector and
    to_scene of a perturbed state, to 1e-12 relative (rh holds the
    saturation pressure at the six temperatures of the toy scene)."""
    jm = j_tg.StateMapping(_targets(j_tg), _toy("jax"))
    tm = t_tg.StateMapping(_targets(t_tg), _toy("torch"), **CPU64)
    assert tm.n_state == jm.n_state == 5 * 6 + 3
    xj = np.asarray(jm.to_vector(_toy("jax")))
    xt = tm.to_vector(tm.ref_scene).numpy()
    np.testing.assert_allclose(xt, xj, rtol=1e-12, atol=1e-12)
    x = xj + 0.01 * np.sin(np.arange(xj.size))
    sj, st = jm.to_scene(jnp.asarray(x)), tm.to_scene(torch.tensor(x))
    for f in ("vmr", "a", "b", "c", "d", "poly"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   rtol=1e-12, atol=1e-14, err_msg=f)


def test_covariances_match_jax():
    g = np.linspace(0.0, 5e3, 5)
    for name in ("exponential", "gaussian"):
        np.testing.assert_allclose(getattr(t_cov, name)(g, 0.5, 2e3).numpy(),
                                   np.asarray(getattr(j_cov, name)(g, 0.5, 2e3)), rtol=1e-14)
    blocks = (np.asarray(j_cov.diagonal([0.1, 0.2])), np.asarray(j_cov.exponential(g, 1.0, 1e3)))
    np.testing.assert_allclose(t_cov.block_diag(t_cov.diagonal([0.1, 0.2]),
                                                t_cov.exponential(g, 1.0, 1e3)).numpy(),
                               np.asarray(j_cov.block_diag(*blocks)), rtol=1e-14)


def _quadratic_problem():
    """y = K x + 0.05 (x_0^2 + x_1 x_2) over 24 measurements and 4 states."""
    rng = np.random.default_rng(5)
    K = rng.normal(size=(24, 4))
    x_true = np.array([0.8, -0.4, 1.2, 0.3])
    y_of = lambda x, lib: lib["K"] @ x + 0.05 * (x[0] ** 2 + x[1] * x[2])
    libs = {"jax": dict(K=jnp.asarray(K)), "torch": dict(K=torch.tensor(K))}
    y_obs = y_of(x_true, dict(K=K)) + 0.01 * rng.normal(size=24)
    S_a = np.asarray(j_cov.exponential(np.arange(4.0), 1.0, 2.0))
    return y_of, libs, np.zeros(4), y_obs, S_a, np.full(24, 0.01**2)


@pytest.mark.parametrize("method, formulation", [
    ("li", "nform"), ("gn", "nform"), ("lm", "nform"), ("gn_cg", "nform"),
    ("gn", "mform"), ("lm", "mform")])
def test_oem_matches_jax_on_quadratic_model(method, formulation):
    """x, gain, averaging kernel, iterations, convergence and the LM
    damping history against the JAX oem, x to 1e-10 relative to its scale
    and the matrices to 1e-8 (the CG variants stop at |r| <= 1e-5 |b|
    by the same rule in both)."""
    y_of, libs, x_a, y_obs, S_a, S_e = _quadratic_problem()
    kw = dict(method=method, formulation=formulation, max_iter=8)
    rj = j_oem(lambda x: y_of(x, libs["jax"]), jnp.asarray(x_a), jnp.asarray(y_obs),
               jnp.asarray(S_a), jnp.asarray(S_e), **kw)
    rt = t_oem(lambda x: y_of(x, libs["torch"]), x_a, y_obs, S_a, S_e, device="cpu", **kw)
    assert (rt.n_iter, rt.converged) == (rj.n_iter, rj.converged)
    assert rt.lm_gamma_history == rj.lm_gamma_history
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(rj.x)).max())
    for key in ("gain", "averaging_kernel", "jac", "y_fit"):
        want = np.asarray(getattr(rj, key))
        np.testing.assert_allclose(getattr(rt, key).numpy(), want, rtol=0,
                                   atol=1e-8 * np.abs(want).max(), err_msg=key)
    np.testing.assert_allclose(rt.cost, rj.cost, rtol=1e-10)
    A, G = rt.averaging_kernel, rt.gain
    np.testing.assert_allclose(t_sec(A, torch.tensor(S_a)).numpy(),
                               np.asarray(j_sec(jnp.asarray(A.numpy()), S_a)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(t_rec(G, torch.diag(torch.tensor(S_e))).numpy(),
                               np.asarray(j_rec(jnp.asarray(G.numpy()), jnp.diag(jnp.asarray(S_e)))),
                               rtol=1e-12, atol=1e-20)


# the slice as a whole, at a small size: 16 levels (one cloud level, at
# 5.3 km), 32 frequencies, nquad = 8
N_LEV, N_FREQ, NQUAD = 16, 32, 8


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
