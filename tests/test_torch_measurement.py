"""The port's measurement pipeline (arts_tpu_torch.sensor) against arts_tpu
on the CPU at float64, on identical inputs made with numpy: the sensor
builders and contraction, measurement vectors over mixed backgrounds and
deduplicated obsels, and the level-cached observer against the direct
one; test_torch_measurement_observers.py holds the measurement Jacobians
and the polarized and all-sky observers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import sensor as JS
from arts_tpu.path import geometric_path_1d
from arts_tpu.sensor import measurement as JM
from arts_tpu_torch import fwd as F
from arts_tpu_torch import sensor as S
from arts_tpu_torch.convert import clearsky_scene_from_numpy, sensor_from_numpy
from arts_tpu_torch.sensor import measurement as M
from arts_tpu_torch.sensor import observers as O
from test_clearsky import make_scene
from test_torch_clearsky import ref_jit, scene_numpy

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
N_LEV = 21
FREQ = np.linspace(170e9, 240e9, 21)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the recursions' many small operations wait on
    the whole thread pool after each one when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, atol_scale=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_scale * np.abs(want).max())


def make_paths():
    """Nadir, up-looking (space behind) and slant to the surface, in 4 km
    steps: mixed backgrounds, the space path in the middle."""
    return (geometric_path_1d(100e3, 180.0, 0.0, 80e3, 4000.0),
            geometric_path_1d(0.0, 0.0, 0.0, 80e3, 4000.0),
            geometric_path_1d(100e3, 150.0, 0.0, 80e3, 4000.0))


@pytest.fixture(scope="module")
def scenes():
    js = make_scene(N_LEV)
    return js, clearsky_scene_from_numpy(scene_numpy(js), **CPU64)


def _sensor_pair(builder, *args, **kw):
    """The builder's SensorArray from both packages."""
    return getattr(JS, builder)(*args, **kw), getattr(S, builder)(*args, **kw, **CPU64)


BUILDERS = {
    "gaussian_channels": (FREQ, np.tile([180e9, 200e9, 226.3e9], 3), [3e9, 1e9, 4e9] * 3,
                          np.repeat(np.arange(3), 3)),
    "raw_channels": (21, 2),
    "gaussian_zenith_channels": (np.linspace(-1.0, 1.0, 5), 0.5, 21, 1),
    "camera_channels": (2, 3, 4, 1),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_sensor_builders_and_contraction_match_jax(builder):
    """The same index arrays and weights within 1e-15; the fixed-order
    contraction of random radiances (and Stokes vectors) within 1e-14."""
    args = BUILDERS[builder]
    j, p = _sensor_pair(builder, *args)
    for name in ("row", "geo", "freq"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(j, name)))
    np.testing.assert_allclose(p.w.numpy(), np.asarray(j.w), rtol=1e-15, atol=0)
    assert p.n_elements == j.n_elements and p.row.dtype == torch.int64
    rng = np.random.default_rng(1)
    G = int(np.asarray(j.geo).max()) + 1
    Is = [rng.uniform(0.5, 2.0, shape) for shape in ((G, 21), (G, 21, 4))]
    wants = ref_jit(lambda Is: [j.apply(I) for I in Is])([jnp.asarray(I) for I in Is])
    for I, want in zip(Is, wants):
        np.testing.assert_allclose(p.apply(T(I)).numpy(), np.asarray(want), rtol=1e-14)
    q = sensor_from_numpy({k: np.asarray(getattr(j, k)) for k in ("row", "geo", "freq", "w")}
                          | {"n_elements": j.n_elements}, **CPU64)
    np.testing.assert_array_equal(q.slots.numpy(), p.slots.numpy())


def test_camera_pixels_match_jax():
    want = JS.camera_pixels(3, 4, 0.01, 0.02, 0.05, 10.0)
    np.testing.assert_array_equal(S.camera_pixels(3, 4, 0.01, 0.02, 0.05, 10.0), want)


def test_mixed_backgrounds_and_obsels_match_jax(scenes):
    """measurement_vector_from_obsels over three obsels (the second and
    third share the first's simulation batch, the third by value only) on
    paths ending at the surface, in space and at the surface again, against
    the JAX package: one batch, y within 1e-10 of scale; measurement_vector
    gives each obsel's part; and the paths' first line-of-sight azimuths
    stack as JAX stacks them."""
    js, ps = scenes
    paths = make_paths()
    s1 = ("gaussian_channels", FREQ, np.tile([183.31e9, 200e9, 226e9], 3), 4e9,
          np.repeat(np.arange(3), 3))
    s2 = ("raw_channels", 21, 1)
    (j1, p1), (j2, p2) = _sensor_pair(*s1), _sensor_pair(*s2)
    f2 = FREQ.copy()
    p3 = tuple(make_paths())
    jobs = [JM.Obsel(j1, jnp.asarray(FREQ), paths), JM.Obsel(j2, jnp.asarray(FREQ), paths),
            JM.Obsel(j1, jnp.asarray(f2), p3)]
    pobs = [M.Obsel(p1, FREQ, paths), M.Obsel(p2, FREQ, paths), M.Obsel(p1, f2, p3)]
    want = ref_jit(lambda js: JM.measurement_vector_from_obsels(js, jobs)[0])(js)
    ng = len(JM.collect_simulations(jobs)[0])
    got, ngp = M.measurement_vector_from_obsels(ps, pobs, **CPU64)
    assert ng == ngp == 1 and M.collect_simulations(pobs)[1] == [0, 0, 0]
    close(got.numpy(), np.asarray(want))
    n1 = p1.n_elements
    y1 = M.measurement_vector(ps, p1, FREQ, list(paths), **CPU64)
    np.testing.assert_array_equal(y1.numpy(), got[:n1].numpy())
    y2 = M.measurement_vector(ps, p2, FREQ, list(paths), **CPU64)
    np.testing.assert_array_equal(y2.numpy(), got[n1 : n1 + 21].numpy())
    aimed = [dataclasses.replace(p, aa=a) for p, a in zip(paths, (30.0, None, [-45.0, 0.0]))]
    np.testing.assert_array_equal(M.stack_azimuths(aimed, **CPU64).numpy(),
                                  np.asarray(JM.stack_azimuths(aimed)))


def _level_paths(ps):
    z = ps.atm.z
    alts = torch.stack([z.flip(0), z])
    drs = torch.stack([-torch.diff(z.flip(0)), torch.diff(z)])
    return alts, drs, torch.zeros_like(alts)


def test_cached_observer_matches_direct(scenes, monkeypatch):
    """On level-aligned paths (nadir down, zenith up) the level cache gives
    the direct observer's radiances within 1e-12 (the JAX package's own
    bound), by either route ("pallas": the kernel's plain version, at the
    Pallas-vs-XLA bound); its memo computes the levels once for a batch's
    background groups and is bypassed under torch.func: jacfwd and jacrev
    through it give the direct observer's Jacobian within 1e-12."""
    _, ps = scenes
    alts, drs, zas = _level_paths(ps)
    f = T(FREQ)
    direct = O.clearsky_observer()(ps, f, alts, drs, zas, "surface")
    cached = O.clearsky_observer_cached()(ps, f, alts, drs, zas, "surface")
    np.testing.assert_allclose(cached.numpy(), direct.numpy(), rtol=1e-12)
    pallas = O.clearsky_observer_cached(backend="pallas")(ps, f, alts, drs, zas, "surface")
    np.testing.assert_allclose(pallas.numpy(), direct.numpy(), rtol=2e-6,
                               atol=5e-7 * float(direct.abs().max()))

    calls = []
    levels = F.gas_absorption_levels
    monkeypatch.setattr(F, "gas_absorption_levels",
                        lambda *a, **k: calls.append(1) or levels(*a, **k))
    obs = O.clearsky_observer_cached()
    sensor = S.raw_channels(21, 1, **CPU64)
    y = M.measurement_vector(ps, sensor, FREQ, list(make_paths()), observer=obs, **CPU64)
    assert len(calls) == 1 and torch.isfinite(y).all()
    def at(observer):
        return lambda t: observer(dataclasses.replace(ps, atm=dataclasses.replace(ps.atm, t=t)),
                                  f, alts, drs, zas, "surface")

    want = torch.func.jacrev(at(O.clearsky_observer()))(ps.atm.t)
    for jac in (torch.func.jacfwd, torch.func.jacrev, torch.func.jacfwd):
        got = jac(at(obs))(ps.atm.t)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(want.abs().max()))
    assert len(calls) == 4
