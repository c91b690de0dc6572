"""The port's batched Jacobi eigh (arts_tpu_torch/ops/eigh_jacobi.py) at
float32 against the JAX package's plain tier and numpy.linalg.eigh; its
derivative rules by gradcheck; torch.func.jacfwd through a batched call
against single calls; and torch.func.vmap through its vmap rule against
single calls."""

import numpy as np
import pytest
import torch

from arts_tpu_torch.ops import eigh_jacobi as E
from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi
from test_torch_eigh import check_plain, one_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("n", [3, 4, 8, 16])
@pytest.mark.parametrize("dtype, tol", [(np.float32, 2e-6)])
def test_plain_matches_jax_soa_and_numpy(n, dtype, tol):
    check_plain(n, dtype, tol)


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
