"""Pencil-beam propagation-path geometry in a spherically symmetric
atmosphere (port of arts_tpu/path/geometry.py: PathGeometry and
geometric_path_1d).

Host-side numpy, as in the JAX package: the path is scene construction,
computed once from the observer position and line of sight, terminated at
the surface or the top of the atmosphere and refined to a maximum step
length (after ARTS's path_point set_geometric_extremes and
fill_geometric_stepwise).  No refraction.  Not ported yet: the 3D path.
"""

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PathGeometry:
    """A single pencil-beam path, observer first.

    alt: [np] altitudes; s: [np] distance from observer; za: [np] local
    zenith angle of the propagation direction (degrees, ARTS convention:
    0 = upward); background: "space" | "surface".
    """

    alt: np.ndarray
    s: np.ndarray
    za: np.ndarray
    background: str
    aa: np.ndarray | float | None = None  # line-of-sight azimuth [deg]

    @property
    def n_points(self):
        return self.alt.shape[0]

    @property
    def dr(self):
        """Layer lengths between consecutive points [np-1]."""
        return np.diff(self.s)


EARTH_RADIUS = 6_371_000.0  # mean sphere; full ellipsoid via geodesy module


def geometric_path_1d(
    alt_obs: float,
    za_obs: float,
    z_surf: float,
    z_toa: float,
    max_step: float = 1000.0,
    radius: float = EARTH_RADIUS,
) -> PathGeometry:
    """Geometric path for a 1D (spherically symmetric) atmosphere.

    za_obs: observer line-of-sight zenith angle in degrees
    (180 = straight down, 0 = straight up). Observer may be inside or
    above the atmosphere; the returned points span only [z_surf, z_toa].
    """
    r_obs = radius + alt_obs
    r_surf = radius + z_surf
    r_toa = radius + z_toa
    za = np.deg2rad(za_obs)
    # impact parameter (conserved in spherical geometry)
    pconst = r_obs * np.sin(za)

    def r_of_s(s):
        # distance s along LOS from the observer; angle za from local zenith
        return np.sqrt(r_obs**2 + s**2 + 2.0 * r_obs * s * np.cos(za))

    def s_of_r(r, branch):
        # solutions of r(s) = r: s = -r_obs cos(za) ± sqrt(r^2 - pconst^2)
        root = np.sqrt(np.maximum(r**2 - pconst**2, 0.0))
        return -r_obs * np.cos(za) + branch * root

    looking_down = za_obs > 90.0
    if looking_down:
        r_tan = pconst  # tangent radius
        if r_tan >= r_toa:
            raise ValueError("path misses the atmosphere entirely")
        if r_tan <= r_surf:
            background = "surface"
            s_end = s_of_r(r_surf, -1.0)  # first (near) surface intersection
        else:
            background = "space"  # limb: down through tangent, back out to TOA
            s_end = s_of_r(r_toa, +1.0)
        s_start = 0.0 if r_obs <= r_toa else s_of_r(r_toa, -1.0)
    else:
        background = "space"
        if r_obs >= r_toa:
            raise ValueError("upward-looking observer above TOA sees no atmosphere")
        s_start = 0.0
        s_end = s_of_r(r_toa, +1.0)

    n = int(np.ceil((s_end - s_start) / max_step)) + 1
    n = max(n, 2)
    s = np.linspace(s_start, s_end, n)
    r = r_of_s(s)
    alt = r - radius
    # local zenith angle of propagation: sin(za_local) = pconst / r, with the
    # branch picked by whether we are before or past the tangent point
    sin_za = np.clip(pconst / r, 0.0, 1.0)
    za_local = np.rad2deg(np.arcsin(sin_za))
    if looking_down:
        s_tan = -r_obs * np.cos(za)  # distance to the tangent point
        za_local = np.where(s < s_tan, 180.0 - za_local, za_local)
    # numerical cleanup at the endpoints
    alt = np.clip(alt, z_surf, z_toa)
    return PathGeometry(alt=alt, s=s - s_start, za=za_local, background=background)
