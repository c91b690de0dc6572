"""Batched symmetric eigendecomposition of small matrices by tournament
cyclic Jacobi (port of arts_tpu/ops/eigh_jacobi.py).

  * `jacobi_sweeps`: the plain PyTorch sweeps on a struct-of-arrays
    [n, n, B] layout (every rotation is one elementwise operation over the
    batch), shared with the DISORT eigen stage's plain version;
  * `eigh_jacobi_plain`: the plain version of the kernel, the sweeps and
    an ascending (stable) sort;
  * `eigh_jacobi_kernel`: csrc/eigh_jacobi.cu, the hand-written kernel for
    n <= 16 (the counterpart of the TPU's eigh_jacobi_pallas), on the
    caller's row-major [..., n, n];
  * `eigh_jacobi`: the entry point, a torch.autograd.Function with a
    forward-mode rule (jvp), a reverse-mode rule (backward) and a vmap
    rule, so that torch.func.jacfwd / jacrev / vmap pass through a kernel
    that PyTorch cannot trace.

csrc/jacobi.cuh carries the same schedule and rotation for the kernels.
The kernel pads n with zero rows and columns to an even number of
players, at least 4: a rotation against a zero off-diagonal is the
identity, so its rounds are those of the plain version.
"""

import functools

import torch

from .. import _cuda

KERNEL_MAX_N = 16


@functools.lru_cache(maxsize=None)
def _tournament(n: int):
    """Round-robin schedule: rounds of disjoint (p, q) pairs covering every
    pair once.  Odd n schedules n+1 players and drops the dummy's pairs."""
    if n % 2:
        return [[(p, q) for (p, q) in r if p < n and q < n]
                for r in _tournament(n + 1)]
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append([
            (min(players[i], players[n - 1 - i]), max(players[i], players[n - 1 - i]))
            for i in range(n // 2)
        ])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _rot_cs(app, aqq, apq):
    """(c, s) of the Jacobi rotation zeroing apq, never dividing by apq:
    t = 2 apq sign(d) / (|d| + sqrt(d^2 + 4 apq^2)), d = aqq - app."""
    d = aqq - app
    denom = torch.abs(d) + torch.sqrt(d * d + 4.0 * apq * apq)
    pos = denom > 0.0
    t = torch.where(pos, 2.0 * apq * torch.sign(d) / torch.where(pos, denom, 1.0), 0.0)
    c = 1.0 / torch.sqrt(t * t + 1.0)
    return c, t * c


def _default_sweeps(dtype):
    return 6 if dtype == torch.float32 else 8


def jacobi_sweeps(M, sweeps):
    """(M', V) after `sweeps` tournament sweeps on M [n, n, B]: M' nearly
    diagonal, M = V M' V^T.  Per round the angles of all its disjoint pairs
    come first, then the row rotations, then the column rotations of M and
    V, as in the kernels."""
    n = M.shape[0]
    V = torch.eye(n, dtype=M.dtype, device=M.device)[..., None].expand_as(M).clone()
    M = M.clone()
    rounds = [(torch.tensor([p for p, _ in r], device=M.device),
               torch.tensor([q for _, q in r], device=M.device))
              for r in _tournament(n) if r]
    for _ in range(sweeps):
        for p, q in rounds:
            c, s = _rot_cs(M[p, p], M[q, q], M[p, q])  # [pairs, B]
            cr, sr = c[:, None], s[:, None]  # rows [pairs, n, B]
            Mp, Mq = M[p], M[q]
            M[p] = cr * Mp - sr * Mq
            M[q] = sr * Mp + cr * Mq
            cc, sc = c[None], s[None]  # columns [n, pairs, B]
            Mp, Mq = M[:, p], M[:, q]
            M[:, p] = cc * Mp - sc * Mq
            M[:, q] = sc * Mp + cc * Mq
            Vp, Vq = V[:, p], V[:, q]
            V[:, p] = cc * Vp - sc * Vq
            V[:, q] = sc * Vp + cc * Vq
    return M, V


def _from_lanes(w, V, batch):
    """(w [*batch, n], V [*batch, n, n]) as fresh contiguous tensors from
    the lane layouts w [n, B] and V [n, n, B] (the autograd Function's
    outputs must not be views)."""
    n = w.shape[0]
    w_out = torch.empty(batch + (n,), dtype=w.dtype, device=w.device)
    V_out = torch.empty(batch + (n, n), dtype=V.dtype, device=V.device)
    w_out.view(-1, n).copy_(w.t())
    V_out.view(-1, n, n).copy_(V.permute(2, 0, 1))
    return w_out, V_out


def eigh_jacobi_plain(A, sweeps=None):
    """The plain version of the kernel: (w [..., n], V [..., n, n]) of the
    symmetric A [..., n, n], eigenvalues ascending (stable order)."""
    if sweeps is None:
        sweeps = _default_sweeps(A.dtype)
    n = A.shape[-1]
    batch = A.shape[:-2]
    M, V = jacobi_sweeps(A.reshape(-1, n, n).permute(1, 2, 0), sweeps)
    w = torch.diagonal(M, dim1=0, dim2=1).t()  # [n, B]
    order = torch.argsort(w, dim=0, stable=True)
    w = torch.take_along_dim(w, order, 0)
    V = torch.take_along_dim(V, order[None], 1)
    return _from_lanes(w, V, batch)


def eigh_jacobi_kernel(A, sweeps=None):
    """csrc/eigh_jacobi.cu on the CUDA tensor A [..., n, n], n <= 16:
    (w, V) as eigh_jacobi_plain returns them.  The kernel reads A row-major
    and writes the fresh tensors w [..., n] and V [..., n, n]."""
    if sweeps is None:
        sweeps = _default_sweeps(A.dtype)
    n = A.shape[-1]
    if A.device.type != "cuda" or A.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"eigh_jacobi kernel: unsupported {A.dtype} on {A.device}")
    if not 1 <= n <= KERNEL_MAX_N or A.shape[-2] != n:
        raise ValueError(f"eigh_jacobi kernel: takes [..., n, n] with n <= {KERNEL_MAX_N}, "
                         f"got {tuple(A.shape)}")
    batch = A.shape[:-2]
    a = A.contiguous()  # a copy only for a strided view (the vmap rule's movedim)
    w = torch.empty(batch + (n,), dtype=A.dtype, device=A.device)
    V = torch.empty(batch + (n, n), dtype=A.dtype, device=A.device)
    B = w.numel() // n
    if B:
        _cuda.launch("eigh_jacobi", A.dtype, *map(_cuda.ptr, (a, w, V)), n, B, int(sweeps))
    return w, V


def _eigh_forward(A, sweeps, plain):
    """Routing by device and shape: the kernel for a CUDA tensor with
    n <= 16, the plain version for a CPU tensor, for n > 16 (as the JAX
    eigh_jacobi sends n > 16 to eigh_jacobi_soa) or when plain is set."""
    if plain or A.device.type == "cpu" or A.shape[-1] > KERNEL_MAX_N:
        return eigh_jacobi_plain(A, sweeps)
    return eigh_jacobi_kernel(A, sweeps)


def _sym(X):
    return 0.5 * (X + X.mT)


def _inv_gaps(w):
    """F_ij = 1 / (w_j - w_i) off the diagonal, 0 on it (JAX's eigh JVP)."""
    eye = torch.eye(w.shape[-1], dtype=w.dtype, device=w.device)
    return 1.0 / (eye + w[..., None, :] - w[..., :, None]) - eye


class EighJacobi(torch.autograd.Function):
    """(w, V) = eigh(A) with the derivative of JAX's LAPACK eigh:
    dw = diag(V^T dA V), dV = V (F o (V^T dA V)), dA symmetrized first."""

    @staticmethod
    def forward(A, sweeps, plain):
        return _eigh_forward(A, sweeps, plain)

    @staticmethod
    def setup_context(ctx, inputs, output):
        w, V = output
        ctx.save_for_backward(w, V)
        ctx.save_for_forward(w, V)

    @staticmethod
    def jvp(ctx, dA, _sweeps, _plain):
        w, V = ctx.saved_tensors
        X = V.mT @ _sym(dA) @ V
        return torch.diagonal(X, dim1=-2, dim2=-1), V @ (_inv_gaps(w) * X)

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        inner = torch.diag_embed(gw) + _inv_gaps(w) * (V.mT @ gV)
        return _sym(V @ inner @ V.mT), None, None

    @staticmethod
    def vmap(info, in_dims, A, sweeps, plain):
        # fold the mapped dimension into the kernel's flat batch (A is the
        # only tensor input, so it is the one mapped)
        return EighJacobi.apply(A.movedim(in_dims[0], 0), sweeps, plain), (0, 0)


def eigh_jacobi(A, sweeps=None, plain=False, device=None):
    """(w, V) with A = V diag(w) V^T for symmetric A [..., n, n]; w
    ascending.  Differentiable (jvp, backward and vmap rules).

    Runs on `device` (None: the card).  On a CUDA tensor with n <= 16 it
    launches csrc/eigh_jacobi.cu; for n > 16, for a CPU tensor, or with
    plain=True it runs the plain version (6 sweeps at float32, 8 at
    float64, unless `sweeps` is given)."""
    dev, _ = _cuda.resolve(device)
    A = A.to(dev)
    if sweeps is None:
        sweeps = _default_sweeps(A.dtype)
    return EighJacobi.apply(A, int(sweeps), bool(plain))
