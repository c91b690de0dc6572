"""The sun in the port's clear-sky radiance (fwd.simulate_clearsky's sun
arguments, fwd.sun_leg_tau) against arts_tpu on the CPU at float64, on the
same inputs: the sun legs, geometric and refracted, also float32 against
float64; the occultation (the sun as the path's background), the
first-order Rayleigh scattered sun with and without the refracted leg, a
batch of padded paths with a sun per path, the gradients of the radiance
with respect to the surface temperature and the water profile, and the
occultation and almucantar scenes at a small size.

The JAX references are compiled with `ref_jit`, all as one function, so
that they are traced and compiled once for the module."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import fwd as JF
from arts_tpu.atm.standard import standard_atmosphere
from arts_tpu.lbl.catalog import build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table
from arts_tpu.lbl.tmodel import Law
from arts_tpu.path.geometry import geometric_path_1d
from arts_tpu.path.refraction import microwave_refractivity as j_refractivity
from arts_tpu.sun import sun_blackbody as j_sun_blackbody
from arts_tpu_torch import fwd as F
from arts_tpu_torch import scene as S
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.sensor.measurement import stack_paths
from arts_tpu_torch.sun import sun_blackbody

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
F_MW = np.linspace(180e9, 184e9, 17)
F_VIS = np.linspace(4.9996e14, 5.0004e14, 9)
SUN_ZA = (30.0, 85.0, 89.5, 90.5, 91.0, 92.0)
DEPOL = 0.0279  # air's depolarization factor


def _line(f0, a):
    return dict(f0=f0, a=a, e0=2.0e-21, gu=5.0, gl=3.0, iso_mass=18.0, iso_ratio=1.0,
                spec_idx=0, iso_idx=0, band_idx=0, t0=296.0, cutoff=np.inf,
                ls={"bath": {"G0": (Law.T1, [1.2e4, 0.7])}})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small operations under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(f0, a):
    atm = standard_atmosphere(n_levels=30, z_top=80e3, species=("H2O",))
    return JF.ClearskyScene(atm=atm, cat=build_catalog([_line(f0, a)]),
                            pf=rigid_rotor_table(1, 174.6, 1.5), species_names=("H2O",),
                            surface_emissivity=jnp.asarray(0.9))


def _port(js):
    leaves = lambda o: {f.name: np.asarray(getattr(o, f.name))
                        for f in dataclasses.fields(o) if getattr(o, f.name) is not None}
    return clearsky_scene_from_numpy(
        {"atm": leaves(js.atm), "cat": leaves(js.cat), "pf": leaves(js.pf),
         "surface_temperature": np.asarray(js.surface_temperature),
         "surface_emissivity": np.asarray(js.surface_emissivity),
         "species_names": js.species_names}, **CPU64)


def _args(p):
    return tuple(np.asarray(x) for x in (p.alt, p.dr, p.za))


# the paths: a limb path from 600 km (the occultation), three limb paths of
# different lengths (the batch), a ground observer looking up, and a path
# from 600 km down to the surface
LIMB = geometric_path_1d(600e3, 113.2, 0.0, 80e3, 4e3)
BATCH = [geometric_path_1d(600e3, za, 0.0, 80e3, 6e3) for za in (113.2, 112.9, 112.6)]
UP = geometric_path_1d(0.0, 30.0, 0.0, 80e3, 4e3)
DOWN = geometric_path_1d(600e3, 160.0, 0.0, 80e3, 4e3)
UP_SUN = ((50.0, 120.0), (91.0, 200.0))  # (sun_za, sun_aa): day and twilight
BATCH_SUN = [p.za[-1] + d for p, d in zip(BATCH, (0.0, 2.0, 0.0))]


def _j(x):
    return jnp.asarray(x)


@ref_jit
def _occultation_refs(mw, za_sun):
    """The occultation, the sun at zenith angles za_sun [2] (hit, missed)."""
    alt, dr, za = map(_j, _args(LIMB))
    sun = j_sun_blackbody(_j(F_MW))
    return jax.vmap(lambda s: JF.simulate_clearsky(mw, _j(F_MW), alt, dr, path_za=za, sun=sun,
                                                   sun_za=s, sun_aa=0.0))(za_sun)


@functools.partial(ref_jit, static_argnames="refraction")
def _up_refs(vis, refraction):
    """The scattered sun seen looking up, by day and at twilight (UP_SUN)."""
    alt, dr, za = map(_j, _args(UP))
    sun = j_sun_blackbody(_j(F_VIS))
    return jax.vmap(lambda s, a: JF.simulate_clearsky(
        vis, _j(F_VIS), alt, dr, path_za=za, sun=sun, sun_za=s, sun_aa=a, scattered_sun=True,
        depolarization=DEPOL if refraction else 0.0, sun_refraction=refraction))(
            *_j(np.array(UP_SUN).T))


@ref_jit
def _batch_refs(mw, alt, dr, za, sun_za):
    """Each batch path on its own (the padded arrays, vmapped)."""
    sun = j_sun_blackbody(_j(F_MW))
    return jax.vmap(lambda a, d, z, s: JF.simulate_clearsky(
        mw, _j(F_MW), a, d, path_za=z, path_aa=jnp.full(z.shape, 30.0), sun=sun, sun_za=s,
        sun_aa=30.0, scattered_sun=True))(alt, dr, za, sun_za)


def _loss(mw, vis, ts, v):
    """The down-looking 183 GHz radiance with the refracted scattered sun
    plus the up-looking one through the visible line, each scaled to ~1."""
    m = dataclasses.replace(mw, surface_temperature=ts, atm=dataclasses.replace(mw.atm, vmr=v))
    s = dataclasses.replace(vis, atm=dataclasses.replace(vis.atm, vmr=v))
    a, b, c = map(_j, _args(DOWN))
    i_down = JF.simulate_clearsky(m, _j(F_MW), a, b, background="surface", path_za=c,
                                  sun=j_sun_blackbody(_j(F_MW)), sun_za=40.0,
                                  scattered_sun=True, sun_refraction=True)
    a, b, c = map(_j, _args(UP))
    i_up = JF.simulate_clearsky(s, _j(F_VIS), a, b, path_za=c, sun=j_sun_blackbody(_j(F_VIS)),
                                sun_za=50.0, sun_aa=120.0, scattered_sun=True)
    return jnp.sum(i_down) / 1e-15 + jnp.sum(i_up) / 1e-14


@ref_jit
def _grad_refs(mw, vis):
    """The loss and its gradient with respect to (surface temperature, vmr)."""
    return jax.value_and_grad(lambda ts, v: _loss(mw, vis, ts, v), (0, 1))(
        mw.surface_temperature, mw.atm.vmr)


@pytest.fixture(scope="module")
def case():
    """Both packages' scenes (one 183 GHz line of a strength that leaves the
    surface in view, and one visible line) and every JAX reference of the
    module, each group compiled once."""
    mw, vis = _scene(183.31e9, 2e-7), _scene(5.0e14, 1e-2)
    alt, dr, za, _ = stack_paths(BATCH, **CPU64)
    ref = {"occ": _occultation_refs(mw, _j([LIMB.za[-1], LIMB.za[-1] + 2.0])),
           "up/False": _up_refs(vis, False), "up/True": _up_refs(vis, True),
           "batch": _batch_refs(mw, *(_j(x.numpy()) for x in (alt, dr, za)), _j(BATCH_SUN)),
           "grad": _grad_refs(mw, vis)}
    return _port(mw), _port(vis), jax.tree_util.tree_map(np.asarray, ref)


def close(got, want, rtol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _legs():
    """sun_leg_tau's inputs: 41 levels to 80 km, an exponential extinction at
    three strengths, points at 1, 10 and 30 km, and the levels' refractive
    index of an exponential dry atmosphere."""
    zg = np.linspace(0.0, 80e3, 41)
    zm = 0.5 * (zg[1:] + zg[:-1])
    k_mid = 1e-5 * np.exp(-zm / 8e3)[:, None] * np.array([0.3, 1.0, 3.0])
    n_lvl = 1.0 + j_refractivity(101325.0 * np.exp(-zg / 7.5e3), 280.0)
    return zg, k_mid, np.array([1e3, 10e3, 30e3]), n_lvl


def test_sun_leg_tau_matches_jax_and_float32():
    """tau at 1e-10 of each leg's own and the visibility equal to the JAX
    package's, geometric and refracted, at the sun zenith angles SUN_ZA
    (three legs from 1 km are blocked by the planet); and the port's float32
    tau within 1e-6 of float64 on the same inputs: its geometry is float64
    (the JAX package's float32, computed in float32, loses ~1e-4)."""
    zg, k_mid, alts, n_lvl = _legs()
    blocked = 0
    for za in SUN_ZA:
        for n in (None, n_lvl):
            jt, jv = JF.sun_leg_tau(jnp.asarray(zg), jnp.asarray(k_mid), jnp.asarray(alts),
                                    jnp.asarray(za), n_levels=None if n is None else
                                    jnp.asarray(n))
            t64, v64 = F.sun_leg_tau(zg, torch.tensor(k_mid), alts, za, n_levels=n)
            np.testing.assert_array_equal(v64.numpy(), np.asarray(jv))
            np.testing.assert_allclose(t64.numpy(), np.asarray(jt), rtol=1e-10)
            blocked += int((~v64).sum())
            f32 = lambda x: torch.tensor(np.asarray(x, np.float32))
            t32, v32 = F.sun_leg_tau(f32(zg), f32(k_mid), f32(alts), za,
                                     n_levels=None if n is None else f32(n))
            t64s, v64s = F.sun_leg_tau(f32(zg).double(), f32(k_mid).double(),
                                       f32(alts).double(), za, n_levels=None if n is None
                                       else f32(n).double())
            assert t32.dtype == torch.float32
            np.testing.assert_array_equal(v32.numpy(), v64s.numpy())
            np.testing.assert_allclose(t32.double().numpy(), t64s.numpy(), rtol=1e-6)
    # 92 deg from 1 km, geometric and refracted, and 91 deg from 1 km
    # refracted: the bent leg meets the ground
    assert blocked == 3


def test_occultation_matches_jax(case):
    """The sun as the limb path's background, hit and missed by 2 deg, at
    1e-10 of scale; the hit adds the transmitted photosphere."""
    mw, _, ref = case
    sun = sun_blackbody(F_MW, **CPU64)
    alt, dr, za = _args(LIMB)
    got = {name: F.simulate_clearsky(mw, F_MW, alt, dr, path_za=za, sun=sun,
                                     sun_za=float(LIMB.za[-1]) + dza, **CPU64)
           for name, dza in (("hit", 0.0), ("miss", 2.0))}
    for i, name in enumerate(got):
        close(got[name], ref["occ"][i])
    assert bool((got["hit"] - got["miss"] > 0).all())


@pytest.mark.parametrize("refraction", [False, True])
def test_scattered_sun_matches_jax(case, refraction):
    """The Rayleigh-scattered sun seen from the ground looking up through a
    visible line, by day and at twilight (the sun 1 deg below the horizon,
    its leg passing above the surface), at 1e-10 of scale; refracted with
    air's depolarization, geometric without."""
    _, vis, ref = case
    sun = sun_blackbody(F_VIS, **CPU64)
    alt, dr, za = _args(UP)
    plain = F.simulate_clearsky(vis, F_VIS, alt, dr, path_za=za, **CPU64)
    for i, (sza, saa) in enumerate(UP_SUN):
        got = F.simulate_clearsky(vis, F_VIS, alt, dr, path_za=za, sun=sun, sun_za=sza,
                                  sun_aa=saa, scattered_sun=True,
                                  depolarization=DEPOL if refraction else 0.0,
                                  sun_refraction=refraction, **CPU64)
        close(got, ref[f"up/{refraction}"][i])
        assert bool((got > plain).all())


def test_batched_paths_with_a_sun_per_path(case):
    """Three limb paths of different lengths padded by sensor.stack_paths
    (its padding repeats each path's last point, which the hit test reads)
    with a sun direction per path (on the axis, 2 deg off, on the axis) and
    the scattered sun: each row equals the path's own call at 1e-12 and the
    JAX package's at 1e-10 of scale."""
    mw, _, ref = case
    sun = sun_blackbody(F_MW, **CPU64)
    alt, dr, za, _ = stack_paths(BATCH, **CPU64)
    n = [p.n_points for p in BATCH]
    assert len(set(n)) == 3
    for i, p in enumerate(BATCH):
        assert bool((za[i, n[i] - 1:] == float(p.za[-1])).all())
        assert bool((alt[i, n[i] - 1:] == float(p.alt[-1])).all())
    kw = dict(sun=sun, sun_aa=30.0, scattered_sun=True, **CPU64)
    got = F.simulate_clearsky(mw, F_MW, alt, dr, path_za=za, path_aa=30.0,
                              sun_za=torch.tensor(BATCH_SUN), **kw)
    for i, (p, sza) in enumerate(zip(BATCH, BATCH_SUN)):
        a, d, z = _args(p)
        one = F.simulate_clearsky(mw, F_MW, a, d, path_za=z, path_aa=np.full(z.shape, 30.0),
                                  sun_za=sza, **kw)
        close(got[i], one, rtol=1e-12)
        close(got[i], ref["batch"][i])
    assert float(got[0].min()) > 10 * float(got[1].max())  # hit, missed


def test_gradients_match_jax_grad(case):
    """d/d(surface temperature, H2O profile) of the down-looking radiance
    with the refracted scattered sun (183 GHz) plus the up-looking one
    through the visible line (the sun legs' absorption), against jax.grad
    at 1e-8 of each gradient's scale."""
    mw, vis, ref = case
    ts = mw.surface_temperature.clone().requires_grad_()
    v = mw.atm.vmr.clone().requires_grad_()
    m = dataclasses.replace(mw, surface_temperature=ts, atm=dataclasses.replace(mw.atm, vmr=v))
    s = dataclasses.replace(vis, atm=dataclasses.replace(vis.atm, vmr=v))
    a, b, c = _args(DOWN)
    i_down = F.simulate_clearsky(m, F_MW, a, b, background="surface", path_za=c,
                                 sun=sun_blackbody(F_MW, **CPU64), sun_za=40.0,
                                 scattered_sun=True, sun_refraction=True, **CPU64)
    a, b, c = _args(UP)
    i_up = F.simulate_clearsky(s, F_VIS, a, b, path_za=c, sun=sun_blackbody(F_VIS, **CPU64),
                               sun_za=50.0, sun_aa=120.0, scattered_sun=True, **CPU64)
    loss = i_down.sum() / 1e-15 + i_up.sum() / 1e-14
    (want, (want_ts, want_v)) = ref["grad"]
    close(loss.detach(), want, rtol=1e-10)
    g_ts, g_v = torch.autograd.grad(loss, (ts, v))
    close(g_ts, want_ts, rtol=1e-8)
    close(g_v, want_v, rtol=1e-8)
    assert float(g_ts) > 0 and float(np.abs(want_v).max()) > 0


def test_scene_builders_small():
    """build_occultation_scan and build_sky_almucantar at a small size on the
    CPU: float32 against float64 on the same inputs (the float32 data cast
    up) within 1e-4 of each path's scale, as chip_smoke.py holds them; the
    183.31 GHz transmittance below the window's on every limb path; in the
    sky the blue end above the red, and the azimuth-0 pixel on the
    photosphere."""
    f32, f64 = torch.float32, torch.float64
    for build, kw in ((S.build_occultation_scan, dict(n_lev=30, n_freq=65, n_tan=4,
                                                        max_step=8e3)),
                      (S.build_sky_almucantar, dict(n_lev=30, n_freq=16, n_az=6,
                                                      max_step=8e3))):
        c = build(**kw, device="cpu", dtype=f32)
        args = (c.scene, c.f_grid, c.path_alt, c.path_dr)
        got = F.simulate_clearsky(*args, **c.kwargs(), device="cpu", dtype=f32)
        want = F.simulate_clearsky(*args, **c.kwargs(), device="cpu", dtype=f64)
        assert got.dtype == f32 and torch.isfinite(got).all()
        np.testing.assert_array_less((got.double() - want).abs().amax(-1).numpy(),
                                     1e-4 * want.abs().amax(-1).numpy())
        ratio = want / c.sun.spectrum.double()
        if build is S.build_occultation_scan:
            i183 = int(np.argmin(np.abs(c.f_grid.double().numpy() - 183.31e9)))
            assert bool((ratio[:, i183] < ratio[:, 0]).all())
        else:
            assert bool((ratio[1:, -1] > ratio[1:, 0]).all())  # blue above red
            assert float(ratio[0].min()) > 0.3
            assert float(want[0].min()) > 1e3 * float(want[1:].max())
