"""The port's sun (arts_tpu_torch/sun.py) and Rayleigh scattering
(rtepack/scattering.py) against arts_tpu on the CPU at float64, on the
same inputs: the sun's constructors and geometry, the hit tests (also
float32 against float64 across the limb of the disk), the sun-or-cosmic
background, the Rayleigh phase matrix over every degenerate geometry and
the scattering coefficient of air."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import sun as JS
from arts_tpu.rtepack import scattering as JR
from arts_tpu_torch import sun as S
from arts_tpu_torch.convert import sun_from_numpy
from arts_tpu_torch.rtepack import scattering as R

CPU64 = dict(device="cpu", dtype=torch.float64)
F = np.linspace(170e9, 200e9, 31)
ALPHA = math.atan2(S.SUN_RADIUS, S.AU)  # the disk's angular radius [rad]
# the arccos of a cosine near 1 resolves an angle to ~sqrt(2 eps) ~ 2e-8
# rad in float64: beta is held there, the masks exactly
BETA_ATOL = 2e-8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small operations under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_sun_constructors_match_jax():
    """sun_blackbody, sun_from_grid inside and outside its grid (the Planck
    fill), toa_flux, sin_alpha_squared, angular_radius and sun_from_numpy
    at 1e-12."""
    geo = dict(radius=7.0e8, distance=1.5e11, latitude=10.0, longitude=-20.0)
    pairs = [(S.sun_blackbody(F, **CPU64), JS.sun_blackbody(jnp.asarray(F))),
             (S.sun_blackbody(F, t=6000.0, **geo, **CPU64),
              JS.sun_blackbody(jnp.asarray(F), t=6000.0, **geo))]
    sf = np.linspace(180e9, 190e9, 7)
    sv = np.pi * np.linspace(1.0, 2.0, 7) * 1e-11
    ps = S.sun_from_grid(F, sf, sv, temperature=5000.0, **geo, **CPU64)
    js = JS.sun_from_grid(jnp.asarray(F), sf, sv, temperature=5000.0, **geo)
    inside = (F >= sf[0]) & (F <= sf[-1])
    assert inside.any() and (~inside).any()
    close(ps.spectrum.numpy()[inside], np.interp(F[inside], sf, sv) / np.pi)
    pairs.append((ps, js))
    for p, j in pairs:
        for name in ("toa_flux", "sin_alpha_squared", "angular_radius"):
            close(getattr(p, name)(), getattr(j, name)())
        close(p.spectrum, j.spectrum)
        q = sun_from_numpy({f.name: np.asarray(getattr(j, f.name))
                            for f in dataclasses.fields(j)}, **CPU64)
        for f in dataclasses.fields(q):
            close(getattr(q, f.name), getattr(j, f.name))


def _straddle(za_s, aa_s):
    """Lines of sight around the sun's direction at 0, 0.5, 0.999, 1.001, 1.5
    and 3 times the disk's angular radius, off in zenith and in azimuth,
    every angle a float32 number (the same inputs in both dtypes)."""
    fac = np.array([0.0, 0.5, 0.999, 1.001, 1.5, 3.0])
    a = np.degrees(ALPHA) * fac
    za = np.concatenate([za_s + a, za_s - a, np.full(a.size, za_s)])
    aa = np.concatenate([np.full(2 * a.size, aa_s), aa_s + a / np.sin(np.radians(za_s))])
    f32 = lambda x: np.asarray(x, np.float32).astype(np.float64)
    return f32(za), f32(aa), f32(za_s), f32(aa_s)


def test_hit_sun_los_masks_match_across_the_limb():
    """hit_sun_los against the JAX package (beta at BETA_ATOL, masks equal)
    and its float32 inputs against float64 ones: the same masks, the disk's
    edge straddled at 1e-3 of its radius."""
    sun = S.sun_blackbody(F, **CPU64)
    jsun = JS.sun_blackbody(jnp.asarray(F))
    for za_s, aa_s in ((113.72, 40.0), (54.0, 0.0), (91.5, 350.0)):
        za, aa, zs, as_ = _straddle(za_s, aa_s)
        jb, jh = JS.hit_sun_los(jsun, za, aa, zs, as_)
        b64, h64 = S.hit_sun_los(sun, za, aa, zs, as_, device="cpu")
        b32, h32 = S.hit_sun_los(sun, *(torch.tensor(x, dtype=torch.float32)
                                        for x in (za, aa, zs, as_)), device="cpu")
        np.testing.assert_allclose(b64.numpy(), np.asarray(jb), rtol=0, atol=BETA_ATOL)
        assert b64.dtype == b32.dtype == torch.float64
        np.testing.assert_array_equal(h64.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(h32.numpy(), h64.numpy())
        n = za.size // 3
        want = np.tile([True, True, True, False, False, False], 3)
        want[2 * n] = True  # zero offset in azimuth
        np.testing.assert_array_equal(h64.numpy(), want)


def test_hit_sun_geodetic_matches_jax():
    """The geodetic hit test against the JAX package from a point under the
    sub-solar point's meridian, looking at the sun and around the limb; the
    float32 inputs give the float64 masks."""
    geo = dict(latitude=20.0, longitude=30.0)
    sun = S.sun_blackbody(F, **geo, **CPU64)
    jsun = JS.sun_blackbody(jnp.asarray(F), **geo)
    pos = (5e3, 20.0, 30.0)
    za, aa, _, _ = _straddle(0.01, 0.0)
    jb, jh = JS.hit_sun(jsun, pos, (za, aa), 6.371e6)
    b, h = S.hit_sun(sun, pos, (za, aa), 6.371e6, device="cpu")
    b32, h32 = S.hit_sun(sun, pos, tuple(torch.tensor(x, dtype=torch.float32)
                                         for x in (za, aa)), 6.371e6, device="cpu")
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=BETA_ATOL)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(h32.numpy(), h.numpy())
    assert h.any() and (~h).any()


def test_sun_background_radiance_and_solar_geometry():
    """sun_background_radiance hit and missed, with the default and a given
    cosmic background, per path (hit [G]); solar_geometry."""
    sun = S.sun_blackbody(F, **CPU64)
    jsun = JS.sun_blackbody(jnp.asarray(F))
    cmb = np.linspace(1e-20, 2e-20, F.size)
    for hit in (True, False):
        close(S.sun_background_radiance(sun, F, torch.tensor(hit)),
              JS.sun_background_radiance(jsun, jnp.asarray(F), hit))
        close(S.sun_background_radiance(sun, F, torch.tensor(hit), cmb),
              JS.sun_background_radiance(jsun, jnp.asarray(F), hit, jnp.asarray(cmb)))
    per_path = S.sun_background_radiance(sun, F, torch.tensor([True, False]))
    close(per_path[0], sun.spectrum)
    close(per_path[1], JS.sun_background_radiance(jsun, jnp.asarray(F), False))
    for za, aa in ((30.0, 10.0), (90.0, 0.0), (120.0, 200.0)):
        assert S.solar_geometry(za, aa) == JS.solar_geometry(za, aa)


def _los_pairs():
    """Pairs of (za, aa) [deg] through every branch of the phase matrix:
    the polar limits of either direction, the meridian plane (azimuth
    differences 0, 180, 360 and -180), fore and aft scattering, and random
    general pairs."""
    special = [
        ((0.0, 10.0), (40.0, 70.0)), ((180.0, 10.0), (40.0, 70.0)),
        ((40.0, 70.0), (0.0, 10.0)), ((40.0, 70.0), (180.0, 10.0)),
        ((30.0, 20.0), (60.0, 20.0)), ((30.0, 20.0), (60.0, 200.0)),
        ((30.0, 20.0), (60.0, 380.0)), ((30.0, 200.0), (60.0, 20.0)),
        ((50.0, 80.0), (50.0, 80.0)), ((50.0, 80.0), (130.0, 260.0)),
        ((0.0, 0.0), (0.0, 0.0)), ((0.0, 0.0), (180.0, 0.0)),
        ((89.9, 359.0), (90.1, 1.0)), ((120.0, 10.0), (60.0, 300.0)),
    ]
    rng = np.random.default_rng(3)
    rand = np.stack([rng.uniform(0, 180, 40), rng.uniform(-360, 360, 40)], -1)
    los_in = np.concatenate([np.array([p[0] for p in special]), rand])
    los_out = np.concatenate([np.array([p[1] for p in special]), rand[::-1]])
    return los_in, los_out


@pytest.mark.parametrize("d", [0.0, 0.0279])
def test_rayleigh_scattering_matches_jax(d):
    """The phase matrices at 1e-12 of their scale over every branch, without
    and with air's depolarization; the derivative of every element with
    respect to both directions stays finite in every branch."""
    los_in, los_out = _los_pairs()
    want = np.asarray(JR.rayleigh_scattering(jnp.asarray(los_in), jnp.asarray(los_out), d))
    a = torch.tensor(los_in, requires_grad=True)
    b = torch.tensor(los_out, requires_grad=True)
    got = R.rayleigh_scattering(a, b, d, **CPU64)
    close(got.detach(), want)
    np.testing.assert_allclose(got.detach()[..., 0, :].sum(-1), want[..., 0, :].sum(-1),
                               rtol=1e-12)
    ga, gb = torch.autograd.grad(got.sum(), (a, b))
    assert torch.isfinite(ga).all() and torch.isfinite(gb).all()


def test_rayleigh_scat_airsimple_matches_jax():
    """The scattering coefficient of air at 1e-12 over the visible and the
    microwave, at three (p, T) points."""
    f = np.concatenate([np.linspace(4.3e14, 7.5e14, 17), [1e11, 1e12]])
    for p, t in ((101325.0, 288.0), (5e3, 220.0), (1.0, 250.0)):
        close(R.rayleigh_scat_airsimple(f, p, t, **CPU64),
              JR.rayleigh_scat_airsimple(jnp.asarray(f), p, t))
