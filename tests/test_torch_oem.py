"""The port's retrieval package (arts_tpu_torch.retrieval) against the JAX
package on the CPU at float64: state mappings, and every OEM method on a
cheap quadratic forward model.  test_torch_oem_cloud.py holds the
covariances and the cloud retrieval case as a whole."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.retrieval.covariance as j_cov
import arts_tpu.retrieval.targets as j_tg
from arts_tpu.retrieval.oem import oem as j_oem
from arts_tpu.retrieval.oem import retrieval_error_covariance as j_rec
from arts_tpu.retrieval.oem import smoothing_error_covariance as j_sec
from arts_tpu_torch.retrieval import oem as t_oem
from arts_tpu_torch.retrieval import targets as t_tg
from arts_tpu_torch.retrieval.oem import retrieval_error_covariance as t_rec
from arts_tpu_torch.retrieval.oem import smoothing_error_covariance as t_sec

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


