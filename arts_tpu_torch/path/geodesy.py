"""Ellipsoidal geodesy (port of arts_tpu/path/geodesy.py): geodetic <->
ECEF conversions and line-of-sight <-> ECEF direction vectors, after
ARTS's core/geodesy/geodetic.cpp.

Each function computes on the device and in the dtype of its first tensor
argument (the others are converted to it), or in float64 on the CPU when
none is a tensor.
"""

import numpy as np
import torch

# WGS-84
WGS84_A = 6378137.0
WGS84_B = 6356752.314245


# (a, b, GM) per body: semi-axes [m] and the gravitational parameter
# GM [m^3/s^2].  Io carries the spherical radius ARTS uses in surf_fieldIo.
BODIES = {
    "Earth": (WGS84_A, WGS84_B, 3.98600435507e14),
    "Jupiter": (71492e3, 66854e3, 1.267127641e17),
    "Mars": (3396.19e3, 3376.20e3, 4.2828375816e13),
    "Moon": (1738.1e3, 1736.0e3, 4.902800118e12),
    "Mercury": (2439.7e3, 2439.7e3, 2.2031868551e13),
    "Venus": (6051.8e3, 6051.8e3, 3.24858592e14),
    "Saturn": (60268e3, 54364e3, 3.79405848418e16),
    "Io": (1821.6e3, 1821.6e3, 5.959916e12),
}


def _tensors(*xs):
    """xs as tensors on the first tensor's device and in its dtype, or in
    float64 on the CPU when none is a tensor."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dt, dev = (torch.float64, "cpu") if ref is None else (ref.dtype, ref.device)
    return tuple(torch.as_tensor(x if isinstance(x, torch.Tensor) else np.asarray(x),
                                 dtype=dt, device=dev) for x in xs)


def ellipsoid_radii(planet="Earth"):
    """(a, b) semi-axes [m] of a body in BODIES."""
    a, b, _ = BODIES[planet]
    return a, b


def ellipsoid_gravity(planet=None, GM=None, a=None, b=None):
    """g(h, lat_deg) [m/s^2] on the ellipsoid normal at geodetic height h:
    GM / r^2 with r the geocentric distance of the geodetic point (ARTS's
    EllipsoidGravity).  Pass a body name from BODIES, or GM, a and b."""
    if planet is not None:
        a, b, GM = BODIES[planet]
    e2 = 1.0 - (b / a) ** 2

    def g(h, lat_deg=0.0, lon_deg=0.0):
        h, lat_deg = _tensors(h, lat_deg)
        lat = torch.deg2rad(lat_deg)
        sl = torch.sin(lat)
        cl = torch.cos(lat)
        N = a / torch.sqrt(1.0 - e2 * sl * sl)
        r2 = ((N + h) * cl) ** 2 + ((N * (1.0 - e2) + h) * sl) ** 2
        return GM / r2

    return g


def geodetic2ecef(lat_deg, lon_deg, alt, a=WGS84_A, b=WGS84_B):
    """ECEF position [..., 3] [m] of geodetic latitude, longitude [deg] and
    height [m]."""
    lat_deg, lon_deg, alt = _tensors(lat_deg, lon_deg, alt)
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    e2 = 1.0 - (b / a) ** 2
    N = a / torch.sqrt(1.0 - e2 * torch.sin(lat) ** 2)
    x = (N + alt) * torch.cos(lat) * torch.cos(lon)
    y = (N + alt) * torch.cos(lat) * torch.sin(lon)
    z = (N * (1.0 - e2) + alt) * torch.sin(lat)
    return torch.stack([x, y, z], -1)


def ecef2geodetic(xyz, a=WGS84_A, b=WGS84_B, iters=5):
    """(lat [deg], lon [deg], alt [m]) of ECEF positions [..., 3]: Bowring's
    iteration, mm accuracy in a few iterations."""
    (xyz,) = _tensors(xyz)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = torch.arctan2(y, x)
    p = torch.hypot(x, y)
    e2 = 1.0 - (b / a) ** 2
    lat = torch.arctan2(z, p * (1.0 - e2))
    for _ in range(iters):
        N = a / torch.sqrt(1.0 - e2 * torch.sin(lat) ** 2)
        alt = p / torch.cos(lat) - N
        lat = torch.arctan2(z, p * (1.0 - e2 * N / (N + alt)))
    N = a / torch.sqrt(1.0 - e2 * torch.sin(lat) ** 2)
    alt = p / torch.cos(lat) - N
    return torch.rad2deg(lat), torch.rad2deg(lon), alt


def enu_basis(lat_deg, lon_deg):
    """(east, north, up) unit vectors [..., 3] in ECEF at a geodetic
    position."""
    lat_deg, lon_deg = _tensors(lat_deg, lon_deg)
    lat = torch.deg2rad(lat_deg)
    lon = torch.deg2rad(lon_deg)
    e = torch.stack([-torch.sin(lon), torch.cos(lon), torch.zeros_like(lon)], -1)
    n = torch.stack([-torch.sin(lat) * torch.cos(lon), -torch.sin(lat) * torch.sin(lon), torch.cos(lat)], -1)
    u = torch.stack([torch.cos(lat) * torch.cos(lon), torch.cos(lat) * torch.sin(lon), torch.sin(lat)], -1)
    return e, n, u


def los2ecef(lat_deg, lon_deg, za_deg, aa_deg):
    """ECEF unit direction [..., 3] of a line of sight (zenith and azimuth
    angles in degrees; ARTS's convention: azimuth from north, east
    positive)."""
    lat_deg, lon_deg, za_deg, aa_deg = _tensors(lat_deg, lon_deg, za_deg, aa_deg)
    e, n, u = enu_basis(lat_deg, lon_deg)
    za = torch.deg2rad(za_deg)
    aa = torch.deg2rad(aa_deg)
    return (torch.sin(za)[..., None] * (torch.sin(aa)[..., None] * e + torch.cos(aa)[..., None] * n)
            + torch.cos(za)[..., None] * u)


def ecef2los(pos_ecef, dir_ecef, a=WGS84_A, b=WGS84_B):
    """(za, aa) [deg] of a propagation direction at an ECEF position."""
    pos_ecef, dir_ecef = _tensors(pos_ecef, dir_ecef)
    lat, lon, _ = ecef2geodetic(pos_ecef, a, b)
    e, n, u = enu_basis(lat, lon)
    de = torch.sum(dir_ecef * e, -1)
    dn = torch.sum(dir_ecef * n, -1)
    du = torch.sum(dir_ecef * u, -1)
    za = torch.rad2deg(torch.arccos(torch.clip(du, -1.0, 1.0)))
    aa = torch.rad2deg(torch.arctan2(de, dn))
    return za, aa
