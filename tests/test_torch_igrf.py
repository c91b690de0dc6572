"""The port's geodesy, IGRF-13 field and Faraday rotation (arts_tpu_torch
path.geodesy, atm.igrf, lbl.faraday) against arts_tpu on the CPU at
float64, on identical inputs made with numpy: each at 1e-12 relative, with
a floor of 1e-12 of the largest value for entries that cross zero."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.atm import igrf as JI
from arts_tpu.lbl import faraday as JFR
from arts_tpu.path import geodesy as JG
from arts_tpu_torch.atm import igrf as I
from arts_tpu_torch.lbl import faraday as FR
from arts_tpu_torch.path import geodesy as G

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
# the points of tests/test_geo_3d.py's IGRF checks (0 N 0 E, 45 N, the
# South Atlantic Anomaly, 85 N, 40 N 10 E) at the surface and aloft
LAT = np.array([0.0, 45.0, -25.0, 85.0, 40.0, 40.0])
LON = np.array([0.0, 0.0, -50.0, 0.0, 10.0, 10.0])
ALT = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 80e3])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under parallel test workers the thread pool's
    waits after each small operation cost more than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_geodesy_matches_jax_and_round_trips():
    """geodetic2ecef, ecef2geodetic, enu_basis, los2ecef, ecef2los and the
    ellipsoid gravity of every body, on tensors and on numpy, against the
    JAX package's numpy; the geodetic and line-of-sight round trips close
    to 1e-6 m and 1e-9 deg."""
    rng = np.random.default_rng(3)
    lat, lon = rng.uniform(-89, 89, 50), rng.uniform(-180, 180, 50)
    alt, za, aa = rng.uniform(-400, 9e5, 50), rng.uniform(1, 179, 50), rng.uniform(-179, 179, 50)
    for ell in ((G.WGS84_A, G.WGS84_B), G.ellipsoid_radii("Mars")):
        want = JG.geodetic2ecef(lat, lon, alt, *ell)
        for args in ((lat, lon, alt), (T(lat), T(lon), T(alt))):
            xyz = G.geodetic2ecef(*args, *ell)
            close(xyz, want)
            back = G.ecef2geodetic(xyz, *ell)
            for g, w, truth in zip(back, JG.ecef2geodetic(want, *ell), (lat, lon, alt)):
                close(g, w)
                np.testing.assert_allclose(np.asarray(g), truth, rtol=0,
                                           atol=1e-6 if truth is alt else 1e-9)
    for g, w in zip(G.enu_basis(T(lat), T(lon)), JG.enu_basis(lat, lon)):
        close(g, w)
    d = G.los2ecef(T(lat), T(lon), T(za), T(aa))
    close(d, JG.los2ecef(lat, lon, za, aa))
    pos = JG.geodetic2ecef(lat, lon, alt)
    for g, w, truth in zip(G.ecef2los(T(pos), d), JG.ecef2los(pos, np.asarray(d)), (za, aa)):
        close(g, w)
        np.testing.assert_allclose(g.numpy(), truth, rtol=0, atol=1e-9)
    for body in JG.BODIES:
        assert G.BODIES[body] == JG.BODIES[body]
        for h in (alt, T(alt)):
            close(G.ellipsoid_gravity(body)(h, lat), JG.ellipsoid_gravity(body)(alt, lat))


def test_dipole_field_matches_jax():
    rng = np.random.default_rng(4)
    lat, lon, alt = rng.uniform(-90, 90, 40), rng.uniform(-180, 180, 40), rng.uniform(0, 1e6, 40)
    close(I.dipole_field(lat, lon, alt, **CPU64), JI.dipole_field(lat, lon, alt))
    close(I.dipole_field(lat, lon, alt, g10=-3e4, g11=-2e3, h11=5e3, **CPU64),
          JI.dipole_field(lat, lon, alt, g10=-3e4, g11=-2e3, h11=5e3))


def test_schmidt_legendre_matches_jax():
    """P_n^m and dP_n^m/dtheta to degree 13 at colatitudes from the pole
    (sin theta = 0) to the south, batched."""
    th = np.array([0.0, 1e-7, 0.6, 1.36, 1.88, 2.9, np.pi])
    P, dP = I._schmidt_legendre(13, T(np.cos(th)), T(np.sin(th)))
    jP, jdP = JI._schmidt_legendre(13, np.cos(th), np.sin(th))
    close(P, jP)
    close(dP, jdP)


def test_igrf13_matches_jax_at_the_epochs():
    """igrf13 at tests/test_geo_3d.py's points in 2015, 2017.5 (the blend),
    2020 and 2035 (held at 2020), 1995 (held at 2000), and at degree 1;
    the epoch coefficients themselves."""
    for year in (1995.0, 2015.0, 2017.5, 2020.0, 2035.0):
        g, h = I._coeffs_at(year, **CPU64)
        jg, jh = JI._coeffs_at(year)
        close(g, jg)
        close(h, jh)
        close(I.igrf13(LAT, LON, ALT, year=year, **CPU64), JI.igrf13(LAT, LON, ALT, year=year))
    close(I.igrf13(LAT, LON, ALT, nmax=1, **CPU64), JI.igrf13(LAT, LON, ALT, nmax=1))
    close(I.igrf13(30.0, 20.0, 1e3, ell=G.ellipsoid_radii("Mars"), **CPU64),
          JI.igrf13(30.0, 20.0, 1e3, ell=G.ellipsoid_radii("Mars")))


def test_magnetic_profile_matches_jax():
    """The profile of examples/2_zeeman.py (60 N, 51 levels to 100 km) in
    both models, and one at 20 S, 120 W in 2012."""
    z = np.linspace(0.0, 100e3, 51)
    for kw in (dict(lat_deg=60.0), dict(lat_deg=60.0, model="dipole"),
               dict(lat_deg=-20.0, lon_deg=-120.0, year=2012.0)):
        got = I.magnetic_profile(z, **kw, **CPU64)
        assert tuple(got.shape) == (3, 51)
        close(got, JI.magnetic_profile(z, **kw))


def test_faraday_matches_jax():
    """faraday_propmat_u at a point and along a path (field [np, 3],
    per-point angles), and add_faraday on a random [np, F, 7] matrix:
    only the U component changes."""
    rng = np.random.default_rng(5)
    f = np.linspace(1e9, 12e9, 23)
    mag = rng.normal(size=(9, 3)) * 3e-5
    za, aa, n_e = rng.uniform(0, 180, 9), rng.uniform(-180, 180, 9), rng.uniform(1e9, 1e12, 9)
    close(FR.faraday_propmat_u(T(f), 1e11, T(mag[0]), 35.0, 20.0),
          JFR.faraday_propmat_u(jnp.asarray(f), 1e11, jnp.asarray(mag[0]), 35.0, 20.0))
    args = (n_e[:, None], mag[:, None, :], za[:, None], aa[:, None])
    got = FR.faraday_propmat_u(T(f), *map(T, args))
    close(got, JFR.faraday_propmat_u(jnp.asarray(f), *map(jnp.asarray, args)))
    pm = rng.normal(size=(9, 23, 7))
    out = FR.add_faraday(T(pm), T(f), *map(T, args))
    close(out, JFR.add_faraday(jnp.asarray(pm), jnp.asarray(f), *map(jnp.asarray, args)))
    keep = [0, 1, 2, 3, 5, 6]
    np.testing.assert_array_equal(out[..., keep].numpy(), pm[..., keep])
    assert FR.FRCONST == JFR.FRCONST
