"""The port's batched Jacobi eigh (arts_tpu_torch/ops/eigh_jacobi.py) at
float64 against the JAX package's plain tier, eigh_jacobi_soa (the Pallas
kernel has no interpret switch), and numpy.linalg.eigh, and the plain
version with an odd n's zero dummy; test_torch_eigh_ad.py holds float32
and the derivative and vmap rules."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.ops.eigh_jacobi import eigh_jacobi_soa
from arts_tpu_torch.ops import eigh_jacobi as E
from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sym_batch(rng, b, n, dtype):
    X = rng.normal(size=(b, n, n))
    return (X + X.transpose(0, 2, 1)).astype(dtype)


def check_plain(n, dtype, tol):
    """test_plain_matches_jax_soa_and_numpy (its float32 cases in
    test_torch_eigh_ad.py).  Against eigh_jacobi_soa after 2 sweeps (the same rounds, rotations
    and sort; 2 sweeps keep the JAX package's op-by-op run short, and a
    state mid-way to convergence shows the schedule as well as a converged
    one): eigenvalues within tol of scale, eigenvectors within 10 tol; at
    float64 for every n, at float32 for n = 8, the DISORT size (each JAX
    run compiles its own ops, ~1.5 s, and the port's code is the same for
    both types).  After the default sweeps (6 at float32, 8 at float64):
    eigenvalues within 4 tol of scale of LAPACK, A V = V diag(w) and
    V^T V = I."""
    A = _sym_batch(np.random.default_rng(n), 4, n, dtype)
    scale = np.abs(A).max()
    if dtype == np.float64 or n == 8:
        w2, V2 = (t.numpy() for t in eigh_jacobi(torch.tensor(A), sweeps=2, device="cpu"))
        wj, Vj = (np.asarray(a) for a in eigh_jacobi_soa(jnp.asarray(A), sweeps=2))
        np.testing.assert_allclose(w2, wj, rtol=0, atol=tol * scale)
        np.testing.assert_allclose(V2, Vj, rtol=0, atol=10 * tol)

    w, V = (t.numpy() for t in eigh_jacobi(torch.tensor(A), device="cpu"))
    assert w.dtype == dtype and V.dtype == dtype
    w_np = np.linalg.eigh(A.astype(np.float64))[0]
    np.testing.assert_allclose(w, w_np, rtol=0, atol=4 * tol * scale)
    A64, V64 = A.astype(np.float64), V.astype(np.float64)
    np.testing.assert_allclose(A64 @ V64, V64 * w[:, None, :], rtol=0, atol=4 * tol * scale)
    np.testing.assert_allclose(V64.transpose(0, 2, 1) @ V64, np.broadcast_to(np.eye(n), A.shape),
                               rtol=0, atol=4 * tol)


@pytest.mark.parametrize("n", [3, 4, 8, 16])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12)])
def test_plain_matches_jax_soa_and_numpy(n, dtype, tol):
    check_plain(n, dtype, tol)


@pytest.mark.parametrize("n", [3, 5, 15])
def test_one_zero_dummy_leaves_plain_bit_identical(n):
    """The eigh kernel takes odd n with a zero row and column as the dummy
    player: the plain sweeps on A so padded, the dummy dropped by position,
    give w and V bit for bit those of the unpadded plain version (a
    rotation against a zero off-diagonal is the identity)."""
    A = torch.tensor(_sym_batch(np.random.default_rng(n), 3, n, np.float32))
    w, V = E.eigh_jacobi_plain(A)
    M, Vd = E.jacobi_sweeps(torch.nn.functional.pad(A, (0, 1, 0, 1)).permute(1, 2, 0), 6)
    wd = torch.diagonal(M[:n, :n], dim1=0, dim2=1)  # [B, n]
    order = torch.argsort(wd, dim=1, stable=True)
    assert torch.equal(torch.take_along_dim(wd, order, 1), w)
    assert torch.equal(torch.take_along_dim(Vd[:n, :n].permute(2, 0, 1), order[:, None], 2), V)
