"""Batched eigendecomposition of complex symmetric matrices by Jacobi
with complex-orthogonal rotations (port of arts_tpu/ops/eig_comp_sym.py).

The ECS line-mixing band matrix diag(f0 + D0) + i W is similar, by a real
diagonal detailed-balance scaling, to a complex symmetric matrix.  Such a
matrix has A = Q diag(w) Q^T with a complex orthogonal Q (Q^T Q = I, not
unitary), and the classical Jacobi iteration carries over with complex
arithmetic: the rotation angles come from the same formulas.  It
converges for diagonalizable matrices (distinct eigenvalues, generic for
line mixing).

The schedule is the JAX package's: 12 sweeps of tournament rounds
(ops/eigh_jacobi._tournament), every round's disjoint rotations applied
at once as A <- R^T A R, Q <- Q R by matrix products, then a sort by
real part.  R is assembled from the round's (c, s) by products with
fixed one-hot tensors: no in-place write, no branch on values, so the
whole solve runs under autograd, torch.func.vmap and torch.func.jvp.
It is plain tensor code on every device; a round is ~40 small
operations whatever the batch, so a call is bound by their launches.

Every round of _tournament(n) holds the same number of pairs (odd n
drops exactly one pair per round, the dummy player's), so the JAX
package's padding of uneven rounds with two extra rows never applies;
the row an odd n's round leaves idle keeps R's unit diagonal.
"""

import numpy as np
import torch

from .eigh_jacobi import _tournament


def _rotation(a, mag):
    """(c, s) [..., k] of the complex-orthogonal rotations zeroing the
    round's a_pq, from a = [a_pp..., a_qq..., a_pq...] and mag = |a|, with
    the operands of every division and square root sanitized first, so
    that no NaN or inf enters an untaken branch of torch.where (its
    gradient would leak through it)."""
    app, aqq, apq = a.chunk(3, -1)
    mpp, mqq, mpq = mag.chunk(3, -1)
    zero = mpq < 1e-30 * (mpp + mqq + 1.0)
    theta = (aqq - app) / (2.0 * torch.where(zero, 1.0, apq))
    big = torch.abs(theta) > 1e8
    theta_s = torch.where(big, 1.0, theta)
    root = torch.sqrt(theta_s * theta_s + 1.0)
    # the branch with the larger |theta +- root|, for stability
    tp, tm = theta_s + root, theta_s - root
    den = torch.where(torch.abs(tp) >= torch.abs(tm), tp, tm)
    t = torch.where(big, 1.0 / (2.0 * torch.where(big, theta, 1.0)), 1.0 / den)
    t = torch.where(zero, 0.0, t)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    return torch.cat([c, t * c], -1)


def _rounds(n, dtype, device):
    """Per round: the gather indices (rows, cols) of [a_pp..., a_qq...,
    a_pq...], the one-hot matrix [2k, n * n] placing each pair's c at
    (p, p) and (q, q) and its s at (p, q) and -s at (q, p), and R's unit
    diagonal at the idle row of an odd n."""
    out = []
    for r in _tournament(n):
        p = np.array([a for a, _ in r])
        q = np.array([b for _, b in r])
        k = np.arange(p.size)
        onehot = np.zeros((2, p.size, n, n))
        onehot[0, k, p, p] = onehot[0, k, q, q] = 1.0
        onehot[1, k, p, q], onehot[1, k, q, p] = 1.0, -1.0
        idle = np.eye(n)
        idle[p, p] = idle[q, q] = 0.0
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        out.append((torch.as_tensor(np.concatenate([p, q, p]), device=device),
                    torch.as_tensor(np.concatenate([p, q, q]), device=device),
                    t(onehot.reshape(2 * p.size, n * n)), t(idle)))
    return out


def eig_comp_sym(A, sweeps: int = 12):
    """(w, Q) with A = Q diag(w) Q^T and Q^T Q = I, for A [..., n, n]
    complex symmetric; eigenvalues sorted by real part, ascending."""
    n = A.shape[-1]
    batch = A.shape[:-2]
    if n == 1:  # one line: no rotation
        return A[..., 0, :], torch.ones(batch + (1, 1), dtype=A.dtype, device=A.device)
    rounds = _rounds(n, A.dtype, A.device)
    Q = torch.eye(n, dtype=A.dtype, device=A.device).expand(batch + (n, n))
    for _ in range(sweeps):
        for rows, cols, onehot, idle in rounds:
            a = A[..., rows, cols]
            R = (_rotation(a, torch.abs(a)) @ onehot).unflatten(-1, (n, n)) + idle
            A = R.mT @ (A @ R)
            Q = Q @ R
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w.real, dim=-1, stable=True)
    w = torch.take_along_dim(w, order, dim=-1)
    Q = torch.take_along_dim(Q, order[..., None, :], dim=-1)
    return w, Q
