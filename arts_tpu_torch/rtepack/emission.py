"""Layer-recursion emission (port of arts_tpu/rtepack/emission.py, after
ARTS's rte_emission and its TransmittanceOption discretizations).

From the background radiance at the far end of the path,

    constant:  I_i = T (I_{i+1} - Jbar) + Jbar,   Jbar = 0.5 (J_i + J_{i+1}),
    lintau / linprop:
               I_i = T (I_{i+1} - J_{i+1}) + L (J_{i+1} - J_i) + J_i,

T = exp(-0.5 (K_i + K_{i+1}) r) the layer's transmittance and L its
linear-source weight.  JAX scans over layers; here each recursion is a
Python loop over layers with the whole batch in every step.

Conventions: path point 0 is the observer, point np-1 the background.
The layer axis comes first: k and J [np, ...] with any batch axes before
the frequency axis (scalar: k [np, ..., F]; polarized: k [np, ..., F, 7],
J [np, ..., F, 4]); r [np-1, ...] layer lengths over the batch axes (one
length per layer and path); I0 the background [..., F] (or [..., F, 4]).
Zero-length (padded) layers are exact no-ops, and their Jacobians stay
finite.
"""

import math

import torch

from ..ops.voigt_kernel import _wofz_parts as _wofz_pair
from ..ops.wofz import _weideman_coeffs
from .propmat import expm, matvec, to_matrix


def _per_layer(r, ndim):
    """r [np-1, *batch] with trailing unit axes up to `ndim` axes."""
    return r.reshape(r.shape + (1,) * (ndim - r.ndim))


def _recursion(t_lay, L, J, I0):
    """I_i = t (I - J_{i+1}) + L (J_{i+1} - J_i) + J_i, from the far end."""
    I = I0
    for i in reversed(range(t_lay.shape[0])):
        j0, j1 = J[i + 1], J[i]
        I = t_lay[i] * (I - j0) + L[i] * (j0 - j1) + j1
    return I


def emission_unpolarized(k, J, r, I0):
    """Scalar "constant" recursion: radiance at point 0 [..., F]."""
    k_lay = 0.5 * (k[:-1] + k[1:])
    t_lay = torch.exp(-k_lay * _per_layer(r, k.ndim))
    j_lay = 0.5 * (J[:-1] + J[1:])
    I = I0
    for i in reversed(range(t_lay.shape[0])):
        I = t_lay[i] * (I - j_lay[i]) + j_lay[i]
    return I


def emission_unpolarized_pscan(k, J, r, I0):
    """The "constant" recursion as one composition of the layers' affine
    maps I -> a_i I + b_i: the observer radiance is A I0 + B with
    A = prod_i a_i and B = sum_i (prod_{j<i} a_j) b_i (an exclusive
    cumulative product; no loop over layers)."""
    k_lay = 0.5 * (k[:-1] + k[1:])
    t_lay = torch.exp(-k_lay * _per_layer(r, k.ndim))
    b = (1.0 - t_lay) * (0.5 * (J[:-1] + J[1:]))
    P = torch.cumprod(t_lay, 0)
    before = torch.cat([torch.ones_like(P[:1]), P[:-1]], 0)
    return P[-1] * I0 + (before * b).sum(0)


def _linsrc_weight(tau, t):
    """L = (1 - e^-tau)/tau with a series head for tau < 1e-6."""
    small = tau < 1e-6
    safe = torch.where(small, 1.0, tau)
    series = 1.0 - tau / 2.0 + tau * tau / 6.0
    return torch.where(small, series, (1.0 - t) / safe)


def emission_unpolarized_linsrc(k, J, r, I0):
    """Scalar "lintau" recursion: the source linear in optical depth
    across each layer, weight L = (1 - T)/tau."""
    tau = 0.5 * (k[:-1] + k[1:]) * _per_layer(r, k.ndim)
    t_lay = torch.exp(-tau)
    return _recursion(t_lay, _linsrc_weight(tau, t_lay), J, I0)


def _wofz_parts(x):
    """(erfcx(x), D(x)) for real x >= 0, the scaled complementary error
    function and Dawson's integral: erfcx(x) = Re w(ix) and
    D(x) = sqrt(pi)/2 Im w(x), from the real-pair Faddeeva (Weideman order
    64 blended with the 4-term series), evaluated in float64 whatever the
    dtype of x and cast back."""
    xd = x.to(torch.float64)
    Lw, a = _weideman_coeffs(64)
    zero = torch.zeros_like(xd)
    erfcx, _ = _wofz_pair(zero, xd, Lw, a, 4)
    _, dawson2 = _wofz_pair(xd, zero, Lw, a, 4)
    return erfcx.to(x.dtype), ((0.5 * math.sqrt(math.pi)) * dawson2).to(x.dtype)


def emission_unpolarized_linprop(k, J, r, I0):
    """Scalar "linprop" recursion: K linear along each layer, from k1 at
    the near point to k2 at the far point.  The linear-source weight
    L = (1/r) int_0^r exp(-(k1 s + alpha^2 s^2)) ds has the closed forms
      k2 > k1 (alpha^2 = (k2 - k1)/(2 r)):
          L = sqrt(pi) (erfcx(u0) - T erfcx(u1)) / (2 r alpha), u = k/(2 alpha);
      k2 < k1 (beta^2 = (k1 - k2)/(2 r)):
          L = (D(q0) - T D(q1)) / (r beta), q = k/(2 beta),
    exact for both slope signs, as in the JAX package.  Below a slope gate
    (extra optical depth |k2 - k1| r / 2 of 1e-6 at float64, 1e-3 at
    float32), or where k is negative, the lintau weight is used.  The
    closed form's divisors are made safe where it is not taken, so that
    zero-length layers keep finite derivatives.
    """
    k1, k2 = k[:-1], k[1:]
    rr = _per_layer(r, k.ndim)
    tau = 0.5 * (k1 + k2) * rr
    t_lay = torch.exp(-tau)
    dtau_grad = 0.5 * torch.abs(k2 - k1) * rr
    gate = 1e-6 if k.dtype == torch.float64 else 1e-3
    graded = (dtau_grad > gate) & (torch.minimum(k1, k2) >= 0.0)
    r_safe = torch.where(graded, rr, 1.0)
    a2 = torch.where(graded, torch.abs(k2 - k1), 1.0) / (2.0 * r_safe)
    alpha = torch.sqrt(a2)
    # clamp so the untaken branch stays in wofz's supported domain
    e0, d0 = _wofz_parts(torch.clamp(k1, min=0.0) / (2.0 * alpha))
    e1, d1 = _wofz_parts(torch.clamp(k2, min=0.0) / (2.0 * alpha))
    L_up = (0.5 * math.sqrt(math.pi)) * (e0 - t_lay * e1) / (r_safe * alpha)
    L_dn = (d0 - t_lay * d1) / (r_safe * alpha)
    L = torch.where(graded, torch.where(k2 > k1, L_up, L_dn), _linsrc_weight(tau, t_lay))
    return _recursion(t_lay, L, J, I0)


def emission_polarized(k, J, r, I0):
    """Polarized "constant" recursion: Stokes radiance at point 0 [..., F, 4]."""
    k_lay = 0.5 * (k[:-1] + k[1:])
    T = expm(k_lay, _per_layer(r, k.ndim - 1))
    j_lay = 0.5 * (J[:-1] + J[1:])
    I = I0
    for i in reversed(range(T.shape[0])):
        I = matvec(T[i], I - j_lay[i]) + j_lay[i]
    return I


def emission_polarized_linsrc(k, J, r, I0):
    """Polarized "lintau" recursion: the matrix weight
    L = (r Kbar)^-1 (I - T), with the series I - M/2 + M^2/6 - M^3/24 for
    layers thinner than 1e-4 in the A component."""
    k_lay = 0.5 * (k[:-1] + k[1:])
    rr = _per_layer(r, k.ndim - 1)
    T = expm(k_lay, rr)
    M = rr[..., None, None] * to_matrix(k_lay)
    eye = torch.eye(4, dtype=k.dtype, device=k.device)
    thin = (rr * k_lay[..., 0]) < 1e-4
    M2 = M @ M
    M3 = M2 @ M
    L_series = eye - M / 2.0 + M2 / 6.0 - M3 / 24.0
    M_safe = torch.where(thin[..., None, None], eye, M)
    L_solve = torch.linalg.solve(M_safe, eye - T)
    L = torch.where(thin[..., None, None], L_series, L_solve)
    I = I0
    for i in reversed(range(T.shape[0])):
        j0, j1 = J[i + 1], J[i]
        I = matvec(T[i], I - j0) + matvec(L[i], j0 - j1) + j1
    return I


def _refine_path(k, J, r, substeps):
    """Each layer cut into `substeps` sublayers with K and J linear inside
    it: (k', J', r') with (np-1) substeps + 1 points."""
    f = torch.linspace(0.0, 1.0, substeps + 1, dtype=k.dtype, device=k.device)[:-1]

    def refine(x):
        shape = (1, -1) + (1,) * (x.ndim - 1)
        mid = (1.0 - f).reshape(shape) * x[:-1, None] + f.reshape(shape) * x[1:, None]
        return torch.cat([mid.reshape((-1,) + x.shape[1:]), x[-1:]], 0)

    return refine(k), refine(J), torch.repeat_interleave(r / substeps, substeps, 0)


def emission_polarized_linprop(k, J, r, I0, substeps: int = 4):
    """Polarized "linprop" recursion: each layer refined into `substeps`
    sublayers with K and J linear along it, then the lintau recursion (no
    assumption that K1 and K2 commute)."""
    return emission_polarized_linsrc(*_refine_path(k, J, r, substeps), I0)


def cumulative_transmittance(k, r):
    """Cumulative transmittance from the observer, Pi_i = T_1 ... T_i
    (identity at i = 0): [np, ..., F, 4, 4], by a doubling scan (log2(np)
    batched products)."""
    k_lay = 0.5 * (k[:-1] + k[1:])
    P = expm(k_lay, _per_layer(r, k.ndim - 1))
    d = 1
    while d < P.shape[0]:
        P = torch.cat([P[:d], P[:-d] @ P[d:]], 0)
        d *= 2
    eye = torch.eye(4, dtype=k.dtype, device=k.device).expand(P.shape[1:])
    return torch.cat([eye[None], P], 0)
