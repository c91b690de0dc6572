"""The port's polarized clear-sky path (arts_tpu_torch) against arts_tpu on
the CPU at float64: the rtepack algebra, the polarized emission recursion
and the 1D path geometry, on identical inputs made with numpy
(test_torch_zeeman_path.py holds simulate_clearsky_polarized)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from arts_tpu.path.geometry import geometric_path_1d as j_geometric_path_1d
from arts_tpu.rtepack import emission as JE
from arts_tpu.rtepack import propmat as JP
from arts_tpu_torch.path import geometric_path_1d
from arts_tpu_torch.rtepack import emission as E
from arts_tpu_torch.rtepack import propmat as PM

T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
# jax.jit with LLVM's optimizations off: a quarter less compile time than
# the JAX function's own jit
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


def _propmats(rng, n, scale=1.0):
    """Random physical propagation matrices (A dominates), with
    unpolarized and nearly unpolarized rows for the degenerate limits."""
    k = rng.normal(size=(n, 7)) * scale
    k[:, 0] = np.abs(k[:, 0]) + 1.0
    k[0, 1:] = 0.0
    k[1, 1:] = [1e-14, 0, 0, 1e-15, 0, 0]
    return k


def test_expm_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    k = _propmats(rng, 64)
    r = np.abs(rng.normal(size=64)) * 0.5
    got = PM.expm(T(k), T(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.expm(jnp.asarray(k), jnp.asarray(r))),
                               rtol=1e-12, atol=1e-15)
    for i in range(0, 64, 7):
        ref = scipy.linalg.expm(-r[i] * PM.to_matrix(T(k[i])).numpy())
        np.testing.assert_allclose(got[i], ref, rtol=1e-10, atol=1e-12)


def test_inv_matvec_matmul_match_jax():
    rng = np.random.default_rng(1)
    k = _propmats(rng, 16)
    s = rng.normal(size=(16, 4))
    m2 = rng.normal(size=(16, 4, 4))
    inv = PM.inv(T(k))
    np.testing.assert_allclose(inv.numpy(), np.asarray(JP.inv(jnp.asarray(k))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(PM.matvec(inv, T(s)).numpy(),
                               np.asarray(JP.matvec(JP.inv(jnp.asarray(k)), jnp.asarray(s))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(PM.matmul(inv, T(m2)).numpy(),
                               np.asarray(JP.matmul(JP.inv(jnp.asarray(k)), jnp.asarray(m2))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(PM.propmat(1.0, T(k[:, 1]), w=2.0).numpy(),
                                  np.asarray(JP.propmat(1.0, jnp.asarray(k[:, 1]), w=2.0)))


def test_emission_polarized_matches_jax():
    """A 30-point path, 12 frequencies, polarized layers of optical depth
    ~0.1-1: the layer loop against JAX's reverse scan."""
    rng = np.random.default_rng(2)
    npts, F = 30, 12
    k = rng.normal(size=(npts, F, 7)) * 2e-5
    k[..., 0] = np.abs(k[..., 0]) + 5e-5
    J = np.zeros((npts, F, 4))
    J[..., 0] = rng.uniform(1.0, 3.0, (npts, F))
    J[..., 1:] = rng.normal(size=(npts, F, 3)) * 1e-2
    r = rng.uniform(500.0, 3000.0, npts - 1)
    I0 = rng.uniform(0.1, 0.5, (F, 4))
    got = E.emission_polarized(T(k), T(J), T(r), T(I0)).numpy()
    want = np.asarray(JE.emission_polarized(*(jnp.asarray(a) for a in (k, J, r, I0))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("alt, za, top", [(0.0, 0.0, 100e3), (800e3, 180.0, 80e3),
                                         (800e3, 116.5, 80e3), (10e3, 95.0, 60e3)])
def test_geometric_path_1d_matches_jax(alt, za, top):
    """Up-looking, nadir, limb (space behind) and a slant path to the
    surface: the same numpy, point for point."""
    got = geometric_path_1d(alt, za, 0.0, top, 2000.0)
    want = j_geometric_path_1d(alt, za, 0.0, top, 2000.0)
    assert got.background == want.background
    for name in ("alt", "s", "za", "dr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
