"""Geomagnetic field (port of arts_tpu/atm/igrf.py): the IGRF-13
spherical-harmonic model and a centred dipole, on tensors.

After ARTS's core/igrf/igrf13.cpp: degree-13 Schmidt-normalized Gauss
coefficients (the port's own copy of the published tables, _igrf13_data),
epochs 2000-2020 blended linearly in time and held at the nearest epoch
outside them, evaluated in geocentric coordinates and rotated to the
geodetic frame.  Fields come out as (east, north, up) [T].  Each function
computes on `device` in `dtype` (the card and float32 unless the caller
says otherwise).
"""

import numpy as np
import torch

from .._cuda import resolve
from ..path.geodesy import WGS84_A, WGS84_B, geodetic2ecef

# IGRF-13 epoch 2020 degree-1 Schmidt coefficients [nT]
G10, G11, H11 = -29404.8, -1450.9, 4652.5
EARTH_RADIUS_IGRF = 6371200.0  # [m] IGRF reference sphere


def _tensors(dev, dt, *xs):
    return tuple(torch.as_tensor(x).to(device=dev, dtype=dt) for x in xs)


def dipole_field(lat_deg, lon_deg, alt, g10=G10, g11=G11, h11=H11, device=None,
                 dtype=None):
    """(B_east, B_north, B_up) [..., 3] [T] of the centred dipole at
    geocentric latitude, longitude [deg] and height [m] (spherical)."""
    dev, dt = resolve(device, dtype)
    lat_deg, lon_deg, alt = _tensors(dev, dt, lat_deg, lon_deg, alt)
    a = EARTH_RADIUS_IGRF
    r = a + alt
    th = torch.deg2rad(90.0 - lat_deg)  # colatitude
    ph = torch.deg2rad(lon_deg)
    ar3 = (a / r) ** 3
    ct, st = torch.cos(th), torch.sin(th)
    cp, sp = torch.cos(ph), torch.sin(ph)
    m1 = g11 * cp + h11 * sp
    Br = 2.0 * ar3 * (g10 * ct + m1 * st)
    Bth = ar3 * (g10 * st - m1 * ct)
    Bph = ar3 * (g11 * sp - h11 * cp)
    # up = B_r, north = -B_theta (colatitude grows southward), east = B_phi
    return torch.stack(torch.broadcast_tensors(Bph * 1e-9, -Bth * 1e-9, Br * 1e-9), -1)


def magnetic_profile(z, lat_deg=0.0, lon_deg=0.0, model="igrf13", year=2020.0, device=None,
                     dtype=None):
    """[3, NZ] (east, north, up) field [T] along a vertical profile at
    heights z [NZ], for Atmosphere1D.mag.  model "igrf13" or "dipole"."""
    dev, dt = resolve(device, dtype)
    (z,) = _tensors(dev, dt, z)
    lat, lon = torch.full_like(z, lat_deg), torch.full_like(z, lon_deg)
    if model == "igrf13":
        B = igrf13(lat, lon, z, year, device=dev, dtype=dt)
    else:
        B = dipole_field(lat, lon, z, device=dev, dtype=dt)
    return torch.movedim(B, -1, 0)


def _schmidt_legendre(nmax, ct, st):
    """Schmidt semi-normalized associated Legendre functions P_n^m(cos t)
    and dP_n^m/dtheta of tensors ct = cos(theta), st = sin(theta):
    [..., nmax+1, nmax+1] (degree, order), by the standard geomagnetic
    recurrences
      P_n^n = sqrt((2n-1)/(2n)) st P_{n-1}^{n-1},
      P_n^m = ((2n-1) ct P_{n-1}^m - K P_{n-2}^m) / sqrt(n^2 - m^2),
      K = sqrt((n-1)^2 - m^2),
    with P_1^1 = st (no Condon-Shortley phase)."""
    ct, st = torch.broadcast_tensors(ct, st)
    P = torch.zeros(ct.shape + (nmax + 1, nmax + 1), dtype=ct.dtype, device=ct.device)
    dP = torch.zeros_like(P)
    P[..., 0, 0] = 1.0
    for n in range(1, nmax + 1):
        if n == 1:
            P[..., 1, 1] = st
            dP[..., 1, 1] = ct
        else:
            f = np.sqrt((2.0 * n - 1.0) / (2.0 * n))
            P[..., n, n] = f * st * P[..., n - 1, n - 1]
            dP[..., n, n] = f * (ct * P[..., n - 1, n - 1] + st * dP[..., n - 1, n - 1])
        for m in range(0, n):
            denom = np.sqrt(float(n * n - m * m))
            k = np.sqrt(float((n - 1) ** 2 - m * m))
            P[..., n, m] = ((2.0 * n - 1.0) * ct * P[..., n - 1, m] - k * P[..., n - 2, m]) / denom
            dP[..., n, m] = ((2.0 * n - 1.0) * (ct * dP[..., n - 1, m] - st * P[..., n - 1, m])
                             - k * dP[..., n - 2, m]) / denom
    return P, dP


def _coeffs_at(year, device=None, dtype=None):
    """Epoch-blended (g, h) [nT] [14, 14] at a decimal year; the first or
    last epoch outside [2000, 2020], as ARTS's igrf13.cpp does."""
    from ._igrf13_data import EPOCHS, G, H

    dev, dt = resolve(device, dtype)
    ep = np.asarray(EPOCHS)
    y = float(year)
    if y <= ep[0]:
        g, h = G[0], H[0]
    elif y >= ep[-1]:
        g, h = G[-1], H[-1]
    else:
        i = int(np.searchsorted(ep, y) - 1)
        w = (y - ep[i]) / (ep[i + 1] - ep[i])
        g, h = (1 - w) * G[i] + w * G[i + 1], (1 - w) * H[i] + w * H[i + 1]
    return _tensors(dev, dt, g, h)


def igrf13(lat_deg, lon_deg, alt, year=2020.0, nmax=13, ell=None, device=None, dtype=None):
    """(B_east, B_north, B_up) [..., 3] [T] of the IGRF-13 field at geodetic
    latitude, longitude [deg] and height [m] (broadcast together), at a
    decimal `year` for the epoch blend.

    The geodetic position goes to geocentric (r, latitude) through ECEF,
    the field is evaluated in the geocentric spherical frame, and its
    (north, up) components are rotated back by the difference of the two
    latitudes (ARTS's igrf_impl).  ell: (a, b) of the ellipsoid, WGS-84 by
    default."""
    dev, dt = resolve(device, dtype)
    a_ell, b_ell = (WGS84_A, WGS84_B) if ell is None else ell
    lat, lon, alt = torch.broadcast_tensors(*_tensors(dev, dt, lat_deg, lon_deg, alt))

    ecef = geodetic2ecef(lat, lon, alt, a_ell, b_ell)
    r = torch.linalg.vector_norm(ecef, dim=-1)
    lat_gc = torch.rad2deg(torch.arcsin(torch.clamp(ecef[..., 2] / r, -1.0, 1.0)))

    g, h = _coeffs_at(year, dev, dt)
    g, h = g[: nmax + 1, : nmax + 1], h[: nmax + 1, : nmax + 1]

    th = torch.deg2rad(90.0 - lat_gc)
    ct, st = torch.cos(th), torch.sin(th)
    P, dP = _schmidt_legendre(nmax, ct, st)

    n = torch.arange(nmax + 1, dtype=dt, device=dev)
    m = n
    ph = torch.deg2rad(lon)
    cmph = torch.cos(m * ph[..., None])  # [..., m]
    smph = torch.sin(m * ph[..., None])
    ar = (EARTH_RADIUS_IGRF / r)[..., None] ** (n + 2)  # [..., n]

    gc_hs = g * cmph[..., None, :] + h * smph[..., None, :]  # [..., n, m]
    gs_hc = g * smph[..., None, :] - h * cmph[..., None, :]

    B_r = torch.einsum("...n,...nm->...", ar * (n + 1), gc_hs * P)
    B_th = -torch.einsum("...n,...nm->...", ar, gc_hs * dP)
    # m P_n^m / sin(theta) at the poles: a guarded sin(theta)
    st_safe = torch.where(st.abs() < 1e-12, torch.full_like(st, 1e-12), st)
    B_ph = torch.einsum("...n,...nm->...", ar, gs_hc * (m * P)) / st_safe

    # geocentric spherical -> east, north, up at the geocentric latitude,
    # then (north, up) rotated by psi = lat_gd - lat_gc to the geodetic frame
    B_e, B_n, B_u = B_ph, -B_th, B_r
    psi = torch.deg2rad(lat - lat_gc)
    cpsi, spsi = torch.cos(psi), torch.sin(psi)
    return 1e-9 * torch.stack([B_e, B_n * cpsi - B_u * spsi, B_u * cpsi + B_n * spsi], -1)
