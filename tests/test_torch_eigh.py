"""The port's batched Jacobi eigh (arts_tpu_torch/ops/eigh_jacobi.py) against
the JAX package's plain tier, eigh_jacobi_soa (the Pallas kernel has no
interpret switch), and numpy.linalg.eigh; its derivative rules by
gradcheck; torch.func.jacfwd through a batched call against single calls;
and torch.func.vmap through its vmap rule against single calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.ops.eigh_jacobi import eigh_jacobi_soa
from arts_tpu_torch.ops import eigh_jacobi as E
from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi


def _sym_batch(rng, b, n, dtype):
    X = rng.normal(size=(b, n, n))
    return (X + X.transpose(0, 2, 1)).astype(dtype)


@pytest.mark.parametrize("n", [3, 4, 8, 16])
@pytest.mark.parametrize("dtype, tol", [(np.float64, 1e-12), (np.float32, 2e-6)])
def test_plain_matches_jax_soa_and_numpy(n, dtype, tol):
    """Against eigh_jacobi_soa after 2 sweeps (the same rounds, rotations
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


def test_gradcheck_backward_and_forward_ad():
    """The Function's backward and jvp against finite differences of the
    sweeps (float64, distinct eigenvalues; the input is symmetrized)."""
    X = torch.tensor(np.random.default_rng(1).normal(size=(2, 3, 3)), requires_grad=True)
    f = lambda X: eigh_jacobi(X + X.mT, device="cpu")
    assert torch.autograd.gradcheck(f, (X,), check_forward_ad=True, fast_mode=True)


def test_jacobian_of_batched_call_matches_single_calls():
    """torch.func.jacfwd through one batched call (the primal is unbatched,
    so the jvp rule runs on the batched tangents) against a loop of single
    calls, to 1e-13; no cross terms between matrices."""
    X = torch.tensor(np.random.default_rng(2).normal(size=(3, 4, 4)))
    f = lambda X: torch.cat([t.reshape(-1) for t in eigh_jacobi(X + X.mT, device="cpu")])
    J = torch.func.jacfwd(f)(X)  # [3 * 4 + 3 * 16, 3, 4, 4]
    w_rows, v_rows = J[:12].reshape(3, 4, 3, 4, 4), J[12:].reshape(3, 16, 3, 4, 4)
    for i in range(3):
        Ji = torch.func.jacfwd(f)(X[i : i + 1])
        np.testing.assert_allclose(w_rows[i, :, i].numpy(), Ji[:4, 0].numpy(), atol=1e-13)
        np.testing.assert_allclose(v_rows[i, :, i].numpy(), Ji[4:, 0].numpy(), atol=1e-13)
        others = [j for j in range(3) if j != i]
        assert float(w_rows[i][:, others].abs().max()) == 0.0


def test_vmap_rule_folds_the_mapped_axis_into_one_call(monkeypatch):
    """torch.func.vmap over A with the mapped axis in the middle, and vmap
    of vmap: the Function's vmap rule runs once per level and hands the
    whole batch to one call; bit for bit the loop of single calls."""
    calls = []
    rule = E.EighJacobi.vmap

    def counting(info, in_dims, A, sweeps, plain):
        calls.append(in_dims[0])
        return rule(info, in_dims, A, sweeps, plain)

    monkeypatch.setattr(E.EighJacobi, "vmap", staticmethod(counting))
    f = lambda A: eigh_jacobi(A, device="cpu")
    X = np.random.default_rng(3).normal(size=(4, 5, 4))
    A = torch.tensor(X + X.transpose(2, 1, 0))  # A[:, i] symmetric
    w, V = torch.func.vmap(f, in_dims=1)(A)
    assert calls == [1] and w.shape == (5, 4) and V.shape == (5, 4, 4)
    for i in range(5):
        wi, Vi = f(A[:, i])
        assert torch.equal(w[i], wi) and torch.equal(V[i], Vi)

    calls.clear()
    A2 = A.permute(1, 0, 2).reshape(5, 1, 4, 4).expand(5, 2, 4, 4)
    w2, V2 = torch.func.vmap(torch.func.vmap(f))(A2)
    assert calls == [0, 0]
    assert torch.equal(w2, w[:, None].expand(5, 2, 4)) and torch.equal(V2[:, 1], V)
