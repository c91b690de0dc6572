"""Planck radiance (port of arts_tpu/ops/planck.py).

float32: the grouping keeps every constant product representable
(2h/c^2 ~ 1.5e-50 would flush to zero); PyTorch runs the expression as
written, so it needs no barrier against reassociation.
"""

import torch

from .. import constants as const


def planck(f, t):
    """Spectral radiance B(f, T) [W / (m^2 Hz sr)]."""
    x = f / const.c
    return (2.0 * const.h * f) * x * x / torch.expm1(const.h * f / (const.k * t))


def inv_planck(b, f):
    """Planck brightness temperature T_B such that planck(f, T_B) = b."""
    x = f / const.c
    num = (2.0 * const.h * f) * x * x
    return (const.h * f / const.k) / torch.log1p(num / b)


def rayleigh_jeans(b, f):
    """Rayleigh-Jeans brightness temperature of radiance b."""
    x = const.c / f
    return b * x * x / (2.0 * const.k)
