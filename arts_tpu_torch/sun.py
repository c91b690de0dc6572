"""The sun as a source in the pencil beam (port of arts_tpu/sun.py, after
ARTS's sun.{h,cc} and m_sun.cc): its spectrum and geometry, the hit test
of a line of sight against the solar disk, and the sun-or-cosmic
background at the end of a path.

Convention, as in the JAX package: `spectrum` is the RADIANCE at the
photosphere [W/(m^2 Hz sr)] (ARTS stores pi times it, the outgoing flux),
and toa_flux() is DISORT's fbeam.

The hit test compares the angle between two directions with the sun's
angular radius, 4.65e-3 rad.  float32's arccos of a cosine near 1 resolves
that angle only to ~1e-5 rad, so the separation and the mask are
evaluated in float64 whatever the scene's dtype; only the background
radiance takes the scene's dtype.
"""

import dataclasses
import math

import torch

from . import constants as const
from ._cuda import resolve, tensor
from .ops.planck import planck

SUN_RADIUS = 6.963242e8  # [m] (ARTS default)
AU = 1.495978707e11  # [m]
SUN_TEMPERATURE = 5772.0  # [K]

_f64 = lambda v: torch.tensor(v, dtype=torch.float64)


@dataclasses.dataclass(frozen=True)
class Sun:
    """The sun seen from the scene: photosphere radiance [F] and geometry
    (radius and distance [m], the sub-solar latitude and longitude
    [deg])."""

    spectrum: torch.Tensor
    radius: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(SUN_RADIUS))
    distance: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(AU))
    latitude: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(0.0))
    longitude: torch.Tensor = dataclasses.field(default_factory=lambda: _f64(0.0))

    def toa_flux(self):
        """Beam flux at the top of the atmosphere, perpendicular to the beam
        [W/(m^2 Hz)]: radiance times the solid angle of the disk."""
        return self.spectrum * math.pi * (self.radius / self.distance) ** 2

    def sin_alpha_squared(self):
        """sin^2 of the angular radius, radius^2 / (radius^2 + distance^2);
        pi times it turns radiance into irradiance."""
        r2 = self.radius * self.radius
        return r2 / (r2 + self.distance * self.distance)

    def angular_radius(self):
        """Apparent angular radius [rad]."""
        return torch.atan2(self.radius, self.distance)


def _sun(spectrum, radius, distance, latitude, longitude, dev, dt):
    t = lambda v: tensor(v, dev, dt)
    return Sun(spectrum=spectrum, radius=t(radius), distance=t(distance), latitude=t(latitude),
               longitude=t(longitude))


def sun_blackbody(f_grid, t=SUN_TEMPERATURE, radius=SUN_RADIUS, distance=AU, latitude=0.0,
                  longitude=0.0, device=None, dtype=None):
    """A blackbody sun at temperature t on f_grid [F] (ARTS's
    sunBlackbody)."""
    dev, dt = resolve(device, dtype)
    f = tensor(f_grid, dev, dt)
    return _sun(planck(f, tensor(t, dev, dt)), radius, distance,
                latitude, longitude, dev, dt)


def sun_from_grid(f_grid, spectrum_f, spectrum_vals, temperature=SUN_TEMPERATURE,
                  radius=SUN_RADIUS, distance=AU, latitude=0.0, longitude=0.0, device=None,
                  dtype=None):
    """A sun from a gridded photosphere spectrum (ARTS's sunFromGrid):
    spectrum_vals is the outgoing FLUX at the photosphere [W/(m^2 Hz)] on
    the ascending spectrum_f, interpolated linearly onto f_grid and divided
    by pi; outside the gridded range the blackbody at `temperature` fills
    in."""
    dev, dt = resolve(device, dtype)
    t = lambda v: tensor(v, dev, dt)
    f, sf, sv = t(f_grid), t(spectrum_f), t(spectrum_vals)
    inside = (f >= sf[0]) & (f <= sf[-1])
    i1 = torch.clamp(torch.searchsorted(sf, f), 1, sf.shape[0] - 1)
    w = torch.clamp((f - sf[i1 - 1]) / (sf[i1] - sf[i1 - 1]), 0.0, 1.0)
    rad = (sv[i1 - 1] * (1.0 - w) + sv[i1] * w) / math.pi
    spectrum = torch.where(inside, rad, planck(f, t(temperature)))
    return _sun(spectrum, radius, distance, latitude, longitude, dev, dt)


def _acos(x):
    """arccos(clip(x, -1, 1)) whose derivative stays finite where the clip
    takes over (there it is 0, as the value is constant)."""
    inside = x.abs() < 1.0
    return torch.where(inside, torch.acos(torch.where(inside, x, torch.zeros_like(x))),
                       torch.where(x > 0, torch.zeros_like(x), torch.full_like(x, math.pi)))


def angular_separation(za1_deg, aa1_deg, za2_deg, aa2_deg):
    """Angle [rad] between two directions given as (zenith, azimuth)
    angles in degrees; tensors broadcast."""
    za1, za2 = torch.deg2rad(za1_deg), torch.deg2rad(za2_deg)
    daa = torch.deg2rad(aa1_deg) - torch.deg2rad(aa2_deg)
    c = torch.cos(za1) * torch.cos(za2) + torch.sin(za1) * torch.sin(za2) * torch.cos(daa)
    return _acos(c)


def hit_sun_los(sun: Sun, los_za_deg, los_aa_deg, sun_za_deg, sun_aa_deg, device=None):
    """(beta [rad], hit): is the sun inside the beam looking along (za, aa)?

    The 1-D form of ARTS's hit test: beta is the angle between the viewing
    direction and the direction to the sun (both local (za, aa) in
    degrees), hit where beta <= the sun's angular radius.  Both are
    computed in float64 whatever the inputs' dtype; beta is float64."""
    dev, _ = resolve(device)
    d = lambda v: tensor(v, dev, torch.float64)
    beta = angular_separation(d(los_za_deg), d(los_aa_deg), d(sun_za_deg), d(sun_aa_deg))
    return beta, beta <= torch.atan2(d(sun.radius), d(sun.distance))


def _sph2cart(r, lat_deg, lon_deg):
    lat, lon = torch.deg2rad(lat_deg), torch.deg2rad(lon_deg)
    return torch.stack([r * torch.cos(lat) * torch.cos(lon), r * torch.cos(lat) * torch.sin(lon),
                        r * torch.sin(lat)], -1)


def hit_sun(sun: Sun, pos_alt_lat_lon, los_za_aa, ellipsoid_radius, device=None):
    """(beta [rad], hit): the geodetic hit test (ARTS's hit_sun): beta
    between the line of sight from pos = (alt [m], lat, lon [deg]) along
    (za, aa) [deg] and the line to the sun's centre, hit where beta <= the
    disk's angular radius seen from pos; a spherical planet of radius
    ellipsoid_radius [m].  float64 throughout, as hit_sun_los."""
    dev, _ = resolve(device)
    d = lambda v: tensor(v, dev, torch.float64)
    alt, lat, lon = map(d, pos_alt_lat_lon)
    za, aa = map(d, los_za_aa)
    p_sun = _sph2cart(d(sun.distance), d(sun.latitude), d(sun.longitude))
    p_rte = _sph2cart(d(ellipsoid_radius) + alt, lat, lon)
    latr, lonr = torch.deg2rad(lat), torch.deg2rad(lon)
    zar, aar = torch.deg2rad(za), torch.deg2rad(aa)
    up = torch.stack([torch.cos(latr) * torch.cos(lonr), torch.cos(latr) * torch.sin(lonr),
                      torch.sin(latr)], -1)
    north = torch.stack([-torch.sin(latr) * torch.cos(lonr), -torch.sin(latr) * torch.sin(lonr),
                         torch.cos(latr)], -1)
    east = torch.stack([-torch.sin(lonr), torch.cos(lonr), torch.zeros_like(lonr)], -1)
    k = (torch.cos(zar)[..., None] * up + (torch.sin(zar) * torch.cos(aar))[..., None] * north
         + (torch.sin(zar) * torch.sin(aar))[..., None] * east)
    dv = p_sun - p_rte
    r_ps = torch.linalg.vector_norm(dv, dim=-1)
    beta = _acos((dv * k).sum(-1) / (r_ps * torch.linalg.vector_norm(k, dim=-1)))
    return beta, beta <= torch.atan2(d(sun.radius), r_ps)


def sun_background_radiance(sun: Sun, f_grid, hit, cmb=None):
    """The sun-or-cosmic background [..., F] (ARTS's
    spectral_radSunOrCosmicBackground): the photosphere radiance where hit
    [...], the cosmic background (or `cmb` [..., F]) elsewhere, in the
    dtype and on the device of the sun's spectrum."""
    spec = sun.spectrum
    f = tensor(f_grid, spec.device, spec.dtype)
    if cmb is None:
        cmb = planck(f, torch.tensor(const.cosmic_microwave_background_temperature,
                                     dtype=spec.dtype, device=spec.device))
    cmb = tensor(cmb, spec.device, spec.dtype) * torch.ones_like(f)
    return torch.where(torch.as_tensor(hit, device=spec.device)[..., None], spec, cmb)


def solar_geometry(sun_zenith_deg, sun_azimuth_deg=0.0):
    """(mu0, phi0) of the DISORT beam from the solar angles [deg]; mu0 is
    0 for a sun below the horizon."""
    mu0 = math.cos(math.radians(float(sun_zenith_deg)))
    return max(mu0, 0.0), float(sun_azimuth_deg)
