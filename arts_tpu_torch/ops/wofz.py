"""Faddeeva function w(z) = exp(-z^2) erfc(-iz) for Im z >= 0 (port of
arts_tpu/ops/wofz.py).

A Weideman (1994) rational approximation of order n near the real axis,
blended with the asymptotic Laurent series for |z|^2 > 512; both are
evaluated densely and selected with torch.where.

The derivative is JAX's custom_jvp rule, not the series' own:
dw/dz = -2 z w + 2i/sqrt(pi) inside, and the differentiated Laurent series
in the far wing, where the identity cancels catastrophically.  `wofz` is a
torch.autograd.Function with jvp, backward and vmap rules, so autograd and
torch.func.jacfwd / jacrev / vmap all take that derivative.
"""

import functools
import math

import numpy as np
import torch

_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_ASYM_R2 = 512.0  # |z|^2 above which the asymptotic series is used


@functools.lru_cache(maxsize=None)
def _weideman_coeffs(n: int):
    """(L, a): scale and polynomial coefficients (highest degree first)."""
    m = 2 * n
    L = math.sqrt(n / math.sqrt(2.0))
    k = np.arange(-m + 1, m, dtype=np.float64)
    theta = k * math.pi / m
    t = L * np.tan(0.5 * theta)
    f = np.concatenate([[0.0], (L * L + t * t) * np.exp(-t * t)])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / (2.0 * m)
    a = np.flipud(a[1 : n + 1])
    return L, tuple(a.tolist())


def _wofz_weideman(z, L, a):
    iz = 1j * z
    Zden = L - iz
    Z = (L + iz) / Zden
    p = torch.zeros_like(z)
    for c in a:
        p = p * Z + c
    return (2.0 * p / Zden + _INV_SQRT_PI) / Zden


def _wofz_asymptotic(z):
    zi2 = 1.0 / (z * z)
    s = torch.full_like(z, 945.0 / 32.0)
    for c in (105.0 / 16.0, 15.0 / 8.0, 3.0 / 4.0, 1.0 / 2.0, 1.0):
        s = s * zi2 + c
    return (1j * _INV_SQRT_PI) * s / z


def _wofz_impl(z, n):
    L, a = _weideman_coeffs(n)
    big = z.real * z.real + z.imag * z.imag > _ASYM_R2
    w_small = _wofz_weideman(torch.where(big, torch.full_like(z, 1.0 + 1.0j), z), L, a)
    w_big = _wofz_asymptotic(torch.where(big, z, torch.full_like(z, 100.0 + 100.0j)))
    return torch.where(big, w_big, w_small)


def _dwofz(z, w):
    """dw/dz, stable for all |z|: the analytic identity inside, the
    differentiated Laurent series sum (2k+1) c_k z^(-2k-2) beyond the far
    gate."""
    big = z.real * z.real + z.imag * z.imag > _ASYM_R2
    dw_in = -2.0 * z * w + 2j * _INV_SQRT_PI
    zs = torch.where(big, z, torch.full_like(z, 100.0 + 100.0j))
    zi2 = 1.0 / (zs * zs)
    s = torch.full_like(z, 945.0 / 16.0)
    for c in (105.0 / 8.0, 15.0 / 4.0, 3.0 / 2.0, 1.0):
        s = s * zi2 + c
    return torch.where(big, (-1j * _INV_SQRT_PI) * s * zi2, dw_in)


class Wofz(torch.autograd.Function):
    """w = wofz(z) with dw = w'(z) dz (w holomorphic: the vector-Jacobian
    product is g conj(w'(z)), PyTorch's convention for complex inputs)."""

    @staticmethod
    def forward(z, n):
        return _wofz_impl(z, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)
        ctx.save_for_forward(inputs[0], output)

    @staticmethod
    def jvp(ctx, dz, _n):
        z, w = ctx.saved_tensors
        return _dwofz(z, w) * dz

    @staticmethod
    def backward(ctx, g):
        z, w = ctx.saved_tensors
        return g * _dwofz(z, w).conj(), None

    @staticmethod
    def vmap(info, in_dims, z, n):
        # elementwise: the mapped dimension passes through where it is
        return Wofz.apply(z, n), in_dims[0]


def wofz(z, n: int = 64):
    """Faddeeva w(z) of a complex tensor with Im z >= 0; n is the Weideman
    order.  Differentiable with JAX's derivative rule."""
    return Wofz.apply(z, n)
