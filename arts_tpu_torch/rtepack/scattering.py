"""Rayleigh scattering: the phase (Mueller) matrix and the scattering
coefficient of air (port of arts_tpu/rtepack/scattering.py, after ARTS's
rtepack::rayleigh_scattering, the Mishchenko frame-rotation form with
depolarization, and spectral_propmat_scatAirSimple).

The degenerate geometries of ARTS's if/else ladder are torch.where
selects, as in the JAX package.  Each arccos and division whose untaken
branch would be infinite takes a safe argument there, so the derivatives
stay finite everywhere.
"""

import math

import torch

from .. import constants as const
from .._cuda import resolve, tensor
from ..sun import _acos

ANGTOL = 1e-6


def rayleigh_scattering(los_in, los_out, depolarization_factor=0.0, device=None, dtype=None):
    """4 x 4 Rayleigh phase matrices [..., 4, 4] for line-of-sight pairs
    [..., 2] of (za, aa) in degrees, broadcast: los_in looks toward the
    source (the sun's direction at the scatter point), los_out is the path's
    line of sight.  The (0, 0) element integrates to 4 pi over the
    sphere."""
    dev, dt = resolve(device, dtype)
    t = lambda v: tensor(v, dev, dt)
    los_in, los_out = t(los_in), t(los_out)
    za_in, aa_in = torch.deg2rad(los_in[..., 0]), torch.deg2rad(los_in[..., 1])
    za_out, aa_out = torch.deg2rad(los_out[..., 0]), torch.deg2rad(los_out[..., 1])

    cos_t = torch.cos(za_out) * torch.cos(za_in) + (
        torch.sin(za_out) * torch.sin(za_in) * torch.cos(aa_out - aa_in))
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    theta = _acos(cos_t)
    sin_t = torch.sin(theta)

    d = depolarization_factor
    delta = (1.0 - d) / (1.0 + 0.5 * d)
    delta_p = (1.0 - 2.0 * d) / (1.0 - d) if d != 0.5 else 0.0
    F11 = 0.75 * delta * (1.0 + cos_t * cos_t) + 1.0 - delta
    F12 = -0.75 * delta * sin_t * sin_t
    F22 = 0.75 * delta * (1.0 + cos_t * cos_t)
    F33 = 1.5 * delta * cos_t
    F44 = 1.5 * delta * delta_p * cos_t

    pi = math.pi
    # the meridian plane and the fore and aft directions need no rotation
    daa = aa_in - aa_out
    simple = ((theta.abs() < ANGTOL) | ((theta - pi).abs() < ANGTOL) | (daa.abs() < ANGTOL)
              | ((daa.abs() - 2.0 * pi).abs() < ANGTOL) | ((daa.abs() - pi).abs() < ANGTOL))

    # the rotation angles sigma1, sigma2 with their polar limits
    one = torch.ones_like(cos_t)
    safe = lambda x: torch.where(x > ANGTOL, x, one)
    sin_t_safe = safe(sin_t)
    szi, szo = safe(torch.sin(za_in)), safe(torch.sin(za_out))
    s1 = (torch.cos(za_out) - torch.cos(za_in) * cos_t) / (szi * sin_t_safe)
    s2 = (torch.cos(za_in) - torch.cos(za_out) * cos_t) / (szo * sin_t_safe)
    sig1, sig2 = _acos(s1), _acos(s2)
    dphi = aa_out - aa_in
    full = lambda v: torch.full_like(cos_t, v)
    sig1 = torch.where(za_in < ANGTOL, pi + dphi, sig1)
    sig2 = torch.where(za_in < ANGTOL, full(0.0), sig2)
    sig1 = torch.where(za_in > pi - ANGTOL, dphi, sig1)
    sig2 = torch.where(za_in > pi - ANGTOL, full(pi), sig2)
    sig1 = torch.where(za_out < ANGTOL, full(0.0), sig1)
    sig2 = torch.where(za_out < ANGTOL, pi + dphi, sig2)
    sig1 = torch.where(za_out > pi - ANGTOL, full(pi), sig1)
    sig2 = torch.where(za_out > pi - ANGTOL, dphi, sig2)
    C1, C2 = torch.cos(2.0 * sig1), torch.cos(2.0 * sig2)
    S1, S2 = torch.sin(2.0 * sig1), torch.sin(2.0 * sig2)

    # Mishchenko's sign by the wrapped azimuth difference
    daa_deg = torch.rad2deg(dphi)
    daa_w = daa_deg + torch.where(daa_deg < -180.0, 360.0, 0.0) - torch.where(
        daa_deg > 180.0, 360.0, 0.0)
    sgn = torch.where(daa_w >= 0.0, 1.0, -1.0)

    z = torch.zeros_like(F11)
    p01 = torch.where(simple, F12, C1 * F12)
    p10 = torch.where(simple, F12, C2 * F12)
    p11 = torch.where(simple, F22, C1 * C2 * F22 - S1 * S2 * F33)
    p02 = torch.where(simple, z, sgn * S1 * F12)
    p12 = torch.where(simple, z, sgn * (S1 * C2 * F22 + C1 * S2 * F33))
    p20 = torch.where(simple, z, -sgn * S2 * F12)
    p21 = torch.where(simple, z, -sgn * (C1 * S2 * F22 + S1 * C2 * F33))
    p22 = torch.where(simple, F33, -S1 * S2 * F22 + C1 * C2 * F33)
    rows = [(F11, p01, p02, z), (p10, p11, p12, z), (p20, p21, p22, z), (z, z, z, F44)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


# the simple-air Rayleigh cross-section polynomial (ARTS's m_sun.cc: the
# standard (n - 1) dispersion fit, wavelength in micrometres)
_AIR_COEFS = (3.9729066, 4.6547659e-2, 4.5055995e-4, 2.3229848e-5)


def rayleigh_scat_airsimple(f_grid, p, t, device=None, dtype=None):
    """Rayleigh scattering coefficient of air [1/m] (ARTS's
    spectral_propmat_scatAirSimple): 1e-32 n sum_k c_k lambda^-2k /
    lambda^4, lambda in micrometres, n = p / (k T); f_grid, p, t
    broadcast."""
    dev, dt = resolve(device, dtype)
    f, p, t = (tensor(x, dev, dt) for x in (f_grid, p, t))
    nd = p / (const.k * t)
    wavelen_um = (const.c / f) * 1e6
    inv_l2 = 1.0 / (wavelen_um * wavelen_um)
    s = torch.zeros_like(inv_l2)
    pw = torch.ones_like(inv_l2)
    for c_ in _AIR_COEFS:
        s = s + c_ * pw
        pw = pw * inv_l2
    return 1e-32 * nd * s * inv_l2 * inv_l2
