"""The DISORT eigen stage on its own (port of arts_tpu/disort/eigen_kernel.py):
per (mode, layer) problem, from the phase matrices to the homogeneous
solutions

    H1/H2 scaling -> Cholesky(-H1) -> Hsym = -Lc^T H2 Lc -> tournament
    cyclic Jacobi -> k, Ek = exp(-k dtau), Y = diag(1/E) Lc V, G+/G-

  * `fused_eigen`: the entry point, (k, Ek, G+, G-) for a batch of layers;
  * `eigen_lanes`: csrc/disort_fused.cu:fused_eigen_kernel on the lane
    layout [layer, entry, lane] (the counterpart of the TPU's fused_eigen
    kernel; stage 1 of the fused solve runs the same device code);
  * `eigen_lanes_plain` / `eigen_plain`: the plain version, which
    disort/fused_kernel.py's stage1_plain shares.

Eigenmode order is whatever the Jacobi sweep leaves (no sort), as in the
JAX kernel: the boundary-value problem treats modes symmetrically.
"""

import math

import numpy as np
import torch

from .. import _cuda
from ..ops.eigh_jacobi import _default_sweeps, jacobi_sweeps


def quad_table(mu, w, dtype, device):
    """Quadrature constants of the eigen stage and stage 1, computed in
    float64 as the JAX kernel computes them on the host: rows 1/mu, 1/E
    (E = sqrt(w mu)), 1/(mu F) (F = sqrt(w/mu)), F^2/w, w/F, then the n x n
    tables F_i F_j and -w_j/(F_i F_j mu_i).  [5n + 2n^2]."""
    mu = np.asarray(mu, np.float64)
    w = np.asarray(w, np.float64)
    Fq = np.sqrt(w / mu)
    E = np.sqrt(w * mu)
    rows = [1.0 / mu, 1.0 / E, 1.0 / (mu * Fq), (1.0 / w) * Fq * Fq, w / Fq,
            (Fq[:, None] * Fq[None, :]).ravel(),
            (-w[None, :] / (Fq[:, None] * Fq[None, :] * mu[:, None])).ravel()]
    return torch.as_tensor(np.concatenate(rows), dtype=dtype, device=device)


def split_qtab(qtab, n):
    """(1/mu, 1/E, 1/(mu F), F^2/w, w/F, F_i F_j, the ApB/AmB scale)."""
    imu, ei, ri, dg, wF = qtab[: 5 * n].view(5, n)
    ff = qtab[5 * n : 5 * n + n * n].view(n, n)
    sc = qtab[5 * n + n * n :].view(n, n)
    return imu, ei, ri, dg, wF, ff, sc


def h12_plain(pp, pm, om, qtab):
    """(H1, H2) [L, B, n, n] = F (c (Pp -/+ Pm) - diag(1/w)) F, c = om/2,
    from the lane-layout phase matrices pp/pm [L, n*n, B] and om [L, B]."""
    L, nn, B = pp.shape
    n = math.isqrt(nn)
    _, _, _, dg, _, ff, _ = split_qtab(qtab, n)
    mat = lambda x: x.view(L, n, n, B).permute(0, 3, 1, 2)
    ffc = ff * (0.5 * om)[..., None, None]
    D = torch.diag(dg)
    return ffc * (mat(pp) - mat(pm)) - D, ffc * (mat(pp) + mat(pm)) - D


def eigen_plain(H1, H2, dtau, qtab, sweeps):
    """(k, Ek [..., n], G+, G- [..., n, n]) from H1/H2 [..., n, n] and
    dtau [...]: the arithmetic of the kernels' eigen_core, batched."""
    n = H1.shape[-1]
    _, ei, ri, _, wF, _, _ = split_qtab(qtab, n)

    # Lc = cholesky(-H1), lower; the clamp keeps an (unphysical) omega -> 1
    # layer finite
    Lc = torch.zeros_like(H1)
    for j in range(n):
        s = -H1[..., j, j]
        for k in range(j):
            s = s - Lc[..., j, k] * Lc[..., j, k]
        d = torch.sqrt(torch.clamp(s, min=1e-30))
        Lc[..., j, j] = d
        s = -H1[..., j + 1 :, j]
        for k in range(j):
            s = s - Lc[..., j + 1 :, k] * Lc[..., j, k, None]
        Lc[..., j + 1 :, j] = s * (1.0 / d)[..., None]

    # Hsym = -Lc^T (H2 Lc)
    Tm = torch.empty_like(H1)
    for l in range(n):
        s = H2[..., :, l] * Lc[..., l, l, None]
        for k in range(l + 1, n):
            s = s + H2[..., :, k] * Lc[..., k, l, None]
        Tm[..., :, l] = s
    M = torch.empty_like(H1)
    for i in range(n):
        s = Lc[..., i, i, None] * Tm[..., i, i:]
        for j in range(i + 1, n):
            s = s + Lc[..., j, i, None] * Tm[..., j, i:]
        M[..., i, i:] = -s
        M[..., i:, i] = -s

    # tournament cyclic Jacobi on the struct-of-arrays layout [n, n, batch]
    batch = M.shape[:-2]
    Md, V = jacobi_sweeps(M.reshape(-1, n, n).permute(1, 2, 0), sweeps)
    diag = torch.diagonal(Md, dim1=0, dim2=1).reshape(batch + (n,))
    V = V.permute(2, 0, 1).reshape(batch + (n, n))

    kk = torch.sqrt(torch.clamp(diag, min=1e-24))
    ek = torch.exp(-kk * dtau[..., None])

    # Y = diag(1/E) Lc V; D = diag(1/(mu F)) H2 diag(w/F) Y / k; G+- = (Y +- D)/2
    Y = torch.empty_like(H1)
    for i in range(n):
        s = Lc[..., i, i, None] * V[..., i, :]
        for l in range(i):
            s = s + Lc[..., i, l, None] * V[..., l, :]
        Y[..., i, :] = ei[i] * s
    Gp = torch.empty_like(H1)
    Gm = torch.empty_like(H1)
    for i in range(n):
        s = wF[0] * H2[..., i, 0, None] * Y[..., 0, :]
        for l in range(1, n):
            s = s + wF[l] * H2[..., i, l, None] * Y[..., l, :]
        Dv = ri[i] * s / kk
        Gp[..., i, :] = 0.5 * (Y[..., i, :] + Dv)
        Gm[..., i, :] = 0.5 * (Y[..., i, :] - Dv)
    return kk, ek, Gp, Gm


def _lane(x):
    return x.permute(0, 2, 1).contiguous()  # [L, B, n] -> [L, n, B]


def _lane_mat(x):
    L, B, n, _ = x.shape
    return x.permute(0, 2, 3, 1).reshape(L, n * n, B).contiguous()


def eigen_lanes_plain(pp, pm, om, dtau, qtab, sweeps):
    """The plain version of eigen_lanes."""
    H1, H2 = h12_plain(pp, pm, om, qtab)
    kk, ek, Gp, Gm = eigen_plain(H1, H2, dtau, qtab, sweeps)
    return _lane(kk), _lane(ek), _lane_mat(Gp), _lane_mat(Gm)


def eigen_lanes(pp, pm, om, dtau, qtab, sweeps):
    """(k, ek [L, n, B], gp, gm [L, n*n, B]) from pp/pm [L, n*n, B], om and
    dtau [L, B] and quad_table's qtab.  On a CUDA tensor this launches
    csrc/disort_fused.cu:fused_eigen_kernel (n = 4 or 8); on a CPU tensor
    it runs the plain version."""
    if pp.device.type == "cpu":
        return eigen_lanes_plain(pp, pm, om, dtau, qtab, sweeps)
    dev, dt = pp.device, pp.dtype
    L, nn, B = pp.shape
    n = math.isqrt(nn)
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"fused_eigen: unsupported {dt}")
    if n not in (4, 8):
        raise ValueError(f"fused_eigen: the kernel is built for n = 4 or 8 streams per "
                         f"hemisphere (nquad 8 or 16), got n = {n}")
    for name, t, shape in (("pp", pp, (L, nn, B)), ("pm", pm, (L, nn, B)),
                           ("om", om, (L, B)), ("dtau", dtau, (L, B)),
                           ("qtab", qtab, (5 * n + 2 * nn,))):
        _cuda.check(name, t, dev, dt, shape)
    k = torch.empty((L, n, B), dtype=dt, device=dev)
    ek = torch.empty_like(k)
    gp = torch.empty((L, nn, B), dtype=dt, device=dev)
    gm = torch.empty_like(gp)
    if L and B:
        _cuda.launch("fused_eigen", dt, *map(_cuda.ptr, (pp, pm, om, dtau, qtab, k, ek, gp, gm)),
                     n, L, B, int(sweeps))
    return k, ek, gp, gm


def fused_eigen(Pp, Pm, omega, dtau, mu, w, sweeps=None, device=None):
    """(k, Ek [..., N], G+, G- [..., N, N]) for phase matrices Pp/Pm
    [..., N, N] and omega/dtau broadcastable to [...]; mu, w the quadrature
    nodes and weights (1D numpy).  Eigenmode order is arbitrary but the
    same across the outputs.  Runs on `device` (None: the card) through
    the kernel, or its plain version on the CPU."""
    dev, _ = _cuda.resolve(device)
    Pp, Pm = Pp.to(dev), Pm.to(dev)
    dt = Pp.dtype
    n = Pp.shape[-1]
    batch = Pp.shape[:-2]
    if sweeps is None:
        sweeps = _default_sweeps(dt)
    lanes = lambda X: X.reshape(-1, n * n).t().contiguous()[None]  # [1, n*n, B]
    vec = lambda x: torch.as_tensor(x, dtype=dt, device=dev).expand(batch).reshape(1, -1).contiguous()
    args = (lanes(Pp), lanes(Pm), vec(omega), vec(dtau), quad_table(mu, w, dt, dev), sweeps)
    k, ek, gp, gm = eigen_lanes(*args)
    unvec = lambda x: x[0].t().reshape(batch + (n,))
    unmat = lambda x: x[0].t().reshape(batch + (n, n))
    return unvec(k), unvec(ek), unmat(gp), unmat(gm)
