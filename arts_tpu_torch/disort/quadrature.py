"""Host-side quadrature and associated-Legendre tables for DISORT (numpy;
copied from arts_tpu/disort/quadrature.py so the port imports nothing of
arts_tpu).  They depend only on (nstr, nleg)."""

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def double_gauss(n: int):
    """Gauss-Legendre nodes/weights on (0, 1), ascending. n = NQuad/2."""
    x, w = np.polynomial.legendre.leggauss(n)
    mu = 0.5 * (x + 1.0)
    w = 0.5 * w
    order = np.argsort(mu)
    return mu[order], w[order]


def norm_assoc_legendre(m: int, lmax: int, x):
    """Lambda_l^m(x) = sqrt((l-m)!/(l+m)!) P_l^m(x) for l = 0..lmax-1.

    Returns [lmax, len(x)]; rows l < m are zero.  Uses the stable
    normalized recurrence (no factorial overflow).
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.zeros((lmax, x.size))
    if m >= lmax:
        return out
    # Lambda_m^m = (-1)^m? — we omit the Condon-Shortley phase; it cancels
    # in all products Lambda(mu_i) Lambda(mu_j) used by the solver.
    # Lambda_m^m = sqrt((2m-1)!!/(2m)!!) (1-x^2)^{m/2}
    pmm = np.ones_like(x)
    if m > 0:
        s = np.sqrt(np.maximum(1.0 - x * x, 0.0))
        for k in range(1, m + 1):
            pmm = pmm * s * math.sqrt((2.0 * k - 1.0) / (2.0 * k))
    out[m] = pmm
    if m + 1 < lmax:
        out[m + 1] = x * math.sqrt(2.0 * m + 1.0) * pmm
    # recurrence for Lambda_l^m = sqrt((l-m)!/(l+m)!) P_l^m:
    # Lambda_l = x (2l-1)/sqrt((l-m)(l+m)) Lambda_{l-1}
    #            - sqrt((l-m-1)(l+m-1)/((l-m)(l+m))) Lambda_{l-2}
    for l in range(m + 2, lmax):
        denom = math.sqrt((l - m) * (l + m))
        a = (2.0 * l - 1.0) / denom
        b = math.sqrt((l - m - 1.0) * (l + m - 1.0)) / denom
        out[l] = a * x * out[l - 1] - b * out[l - 2]
    return out


@functools.lru_cache(maxsize=None)
def _lambda_table_cached(nmodes: int, nleg: int, n: int):
    mu, _ = double_gauss(n)
    lam = np.zeros((nmodes, nleg, n))
    for m in range(nmodes):
        lam[m] = norm_assoc_legendre(m, nleg, mu)
    return lam


def lambda_tables(nmodes: int, nleg: int, n: int):
    """Lambda[m, l, i] at the n quadrature nodes, plus the parity sign
    table sign[m, l] = (-1)^(l+m) for Lambda_l^m(-x) = sign * Lambda_l^m(x)."""
    lam = _lambda_table_cached(nmodes, nleg, n)
    ls = np.arange(nleg)
    ms = np.arange(nmodes)[:, None]
    sign = np.where((ls[None, :] + ms) % 2 == 0, 1.0, -1.0)
    # zero out l < m rows of sign too (cosmetic; lam rows are zero there)
    return lam, sign


def lambda_at(nmodes: int, nleg: int, x: float):
    """Lambda[m, l] at a single (host-side) direction cosine x (e.g. mu0)."""
    out = np.zeros((nmodes, nleg))
    for m in range(nmodes):
        out[m] = norm_assoc_legendre(m, nleg, np.asarray([x]))[:, 0]
    return out
