"""The port's measurement pipeline (arts_tpu_torch.sensor) against arts_tpu
on the CPU at float64, on identical inputs made with numpy: the sensor
builders and contraction, measurement vectors over mixed backgrounds and
deduplicated obsels, the level-cached observer against the direct one,
measurement Jacobians against jax.jacrev, and the polarized and thermal
all-sky observers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import sensor as JS
from arts_tpu.fwd import ZeemanScene as JZeemanScene
from arts_tpu.fwd_allsky import AllskyScene as JAllskyScene
from arts_tpu.fwd_allsky import gas_absorption_profile as j_gas_absorption_profile
from arts_tpu.lbl.zeeman import expand_zeeman as j_expand_zeeman
from arts_tpu.path import geometric_path_1d
from arts_tpu.retrieval import RetrievalTarget as JRetrievalTarget
from arts_tpu.retrieval import StateMapping as JStateMapping
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu.sensor import measurement as JM
from arts_tpu.sensor import observers as JO
from arts_tpu_torch import fwd as F
from arts_tpu_torch import sensor as S
from arts_tpu_torch.atm import Atmosphere1D
from arts_tpu_torch.convert import clearsky_scene_from_numpy, scene_from_numpy, sensor_from_numpy
from arts_tpu_torch.lbl.catalog import catalog_from_arrays
from arts_tpu_torch.lbl.partfun import PartFunTable
from arts_tpu_torch.lbl.zeeman import expand_zeeman
from arts_tpu_torch.retrieval import RetrievalTarget, StateMapping
from arts_tpu_torch.scene import build_clearsky_measurement
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


def _targets(pkg_target, replace_vmr):
    """H2O VMR relative to the reference and the temperature profile."""
    vmr = pkg_target("vmr0", lambda s: s.atm.vmr[0],
                     lambda s, v: dataclasses.replace(s, atm=replace_vmr(s.atm, v)),
                     transform="rel")
    t = pkg_target("t", lambda s: s.atm.t,
                   lambda s, v: dataclasses.replace(s, atm=dataclasses.replace(s.atm, t=v)))
    return [vmr, t]


def test_measurement_jacobian_matches_jax_jacrev(scenes):
    """d y / d (H2O VMR, T) of two nadir-ish geometries and 8 channels by
    measurement_jacobian (jacfwd) against the JAX package's (jax.jacrev):
    each column within 1e-8 of its largest entry plus 1e-14 of its field's
    block (float64 roundoff, see test_torch_clearsky), also in chunks of
    7 columns; and through the
    level cache on level-aligned paths, the direct observer's within
    1e-12."""
    js, ps = scenes
    paths = [make_paths()[0], make_paths()[2]]
    args = ("gaussian_channels", FREQ, np.tile(np.linspace(180e9, 230e9, 4), 2), 4e9,
            np.repeat(np.arange(2), 4))
    jsens, psens = _sensor_pair(*args)
    jmap = lambda js: JStateMapping(_targets(JRetrievalTarget, lambda a, v: dataclasses.replace(
        a, vmr=a.vmr.at[0].set(v))), js)
    pmap = StateMapping(_targets(RetrievalTarget, lambda a, v: dataclasses.replace(
        a, vmr=torch.cat([v[None], a.vmr[1:]]))), ps, **CPU64)
    yw, Kw = ref_jit(lambda js, f: JM.measurement_jacobian(js, jsens, f, paths, jmap(js)))(
        js, jnp.asarray(FREQ))
    y, K = M.measurement_jacobian(ps, psens, FREQ, paths, pmap, **CPU64)
    close(y.numpy(), np.asarray(yw))
    _, K7 = M.measurement_jacobian(ps, psens, FREQ, paths, pmap, chunk_size=7, **CPU64)
    np.testing.assert_allclose(K7.numpy(), K.numpy(), rtol=1e-13,
                               atol=1e-14 * float(K.abs().max()))
    Kw, K = np.asarray(Kw), K.numpy()
    for blk in (slice(0, N_LEV), slice(N_LEV, 2 * N_LEV)):
        col = np.abs(Kw[:, blk]).max(0)
        assert (col > 0).all()
        np.testing.assert_array_less(np.abs(K[:, blk] - Kw[:, blk]).max(0),
                                     1e-8 * col + 1e-14 * col.max())

    # cached against direct through the whole pipeline, level-aligned paths
    z = ps.atm.z.numpy()
    lvl = [dataclasses.replace(paths[0], alt=z[::-1], s=z[-1] - z[::-1],
                               za=np.full(N_LEV, 180.0))]
    sens = S.raw_channels(21, 0, **CPU64)
    _, Kd = M.measurement_jacobian(ps, sens, FREQ, lvl, pmap, **CPU64)
    _, Kc = M.measurement_jacobian(ps, sens, FREQ, lvl, pmap,
                                   observer=O.clearsky_observer_cached(), **CPU64)
    np.testing.assert_allclose(Kc.numpy(), Kd.numpy(), rtol=1e-12,
                               atol=1e-12 * float(Kd.abs().max()))


def _zeeman_pair(n_lev=11):
    """The 2_zeeman example's scene (one O2 118.75 GHz line, a constant
    [0, 3e-5, 3e-5] T field) at n_lev levels to 100 km, both packages."""
    from tests.test_torch_rtepack import _line, _zeeman_scene_arrays
    from arts_tpu.atm import Atmosphere1D as JAtmosphere1D
    from arts_tpu.atm.field import hydrostatic_pressure as j_hp
    from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
    from arts_tpu.lbl.partfun import rigid_rotor_table as j_rrt
    from arts_tpu.lbl.tmodel import Law as JLaw

    z, t, vmr, mag = _zeeman_scene_arrays(n_lev)
    kw = dict(ju=[1.0], jl=[1.0], gu_z=[-2.8], gl_z=[-2.77])
    jz = jnp.asarray(z)
    jatm = JAtmosphere1D(z=jz, t=jnp.asarray(t), p=j_hp(jz, jnp.asarray(t), 101325.0),
                         vmr=jnp.asarray(vmr), mag=jnp.asarray(mag))
    jcat = j_build_catalog(_line(JLaw))
    jpf = j_rrt(1, 150.0, 1.0)
    js = JZeemanScene(atm=jatm, zcat=j_expand_zeeman(jcat, **kw), pf=jpf,
                      surface_temperature=jnp.asarray(275.0))
    catd = {f.name: np.asarray(getattr(jcat, f.name)) for f in dataclasses.fields(jcat)}
    atm = Atmosphere1D(z=T(z), t=T(t), p=T(jatm.p), vmr=T(vmr), mag=T(mag))
    ps = F.ZeemanScene(atm=atm, zcat=expand_zeeman(catalog_from_arrays(catd, "cpu",
                                                                       torch.float64), **kw),
                       pf=PartFunTable(t_grid=T(jpf.t_grid), q_grid=T(jpf.q_grid)),
                       surface_temperature=T(275.0))
    return js, ps


def test_polarized_observer_matches_jax():
    """A polarized obsel (all four Stokes components of a nadir and a slant
    geometry on the 2_zeeman scene, contracted as [elements, 4]) through
    the dedup and contraction, against the JAX package's
    polarized_observer: I within 1e-10 of scale, V within 1e-10 of its
    own."""
    js, ps = _zeeman_pair()
    f = 118.7503e9 + np.linspace(-4e6, 4e6, 17)
    paths = (geometric_path_1d(100e3, 180.0, 0.0, 100e3, 10e3),
             geometric_path_1d(100e3, 140.0, 0.0, 100e3, 10e3))
    args = ("gaussian_channels", f, np.tile(118.7503e9 + np.array([-2e6, 0.0, 2e6]), 2), 1e6,
            np.repeat(np.arange(2), 3))
    jsens, psens = _sensor_pair(*args)
    jo, po = JO.polarized_observer(component=None), O.polarized_observer(component=None)
    jobs = [JM.Obsel(jsens, jnp.asarray(f), paths, observer=jo)]
    want = ref_jit(lambda js: JM.measurement_vector_from_obsels(js, jobs)[0])(js)
    got, _ = M.measurement_vector_from_obsels(
        ps, [M.Obsel(psens, f, paths, observer=po)], **CPU64)
    want = np.asarray(want)
    assert got.shape == (6, 4) and np.abs(want[:, 3]).max() > 0
    for comp in (0, 3):
        close(got[:, comp].numpy(), want[:, comp])


def test_allsky_observer_matches_jax(scenes):
    """The thermal DISORT observer (4 streams, a cloud at 4-9 km, the gas
    absorption given) read at 5 viewing angles from the top and from the
    surface, against the JAX package's, within 1e-10 of scale; a solar beam
    raises NotImplementedError."""
    js, _ = scenes
    z = js.atm.z
    cloud = JHG(ext=jnp.where((z > 4e3) & (z < 9e3), 3e-4, 0.0),
                ssa=jnp.full(z.shape, 0.85), g=jnp.full(z.shape, 0.7))
    jsc = JAllskyScene(atm=js.atm, cat=js.cat, pf=js.pf, scatterers=(cloud,),
                       surface_temperature=jnp.asarray(288.0))
    f = jnp.asarray(FREQ[::4])
    d = scene_numpy(dataclasses.replace(js, surface_emissivity=jnp.asarray(1.0)))
    d["scatterers"] = [{n: np.asarray(getattr(cloud, n)) for n in ("ext", "ssa", "g")}]
    psc = scene_from_numpy(d, **CPU64)
    zas = np.array([[180.0], [160.0], [135.0], [100.0], [95.0]])
    levels = {"toa": zas, "surface": 180.0 - zas}

    @ref_jit
    def refs(jsc, f):
        k = j_gas_absorption_profile(jsc, f, backend="xla")
        return k, {level: JO.allsky_observer(nquad=4, level=level, fast_linalg=False, k_gas=k)(
            jsc, f, None, None, jnp.asarray(za), None) for level, za in levels.items()}

    k, wants = refs(jsc, f)
    for level, za in levels.items():
        kw = dict(nquad=4, level=level, fast_linalg=False)
        got = O.allsky_observer(**kw, k_gas=T(k))(psc, T(f), None, None, T(za), None)
        assert got.shape == (5, f.shape[0])
        close(got.numpy(), np.asarray(wants[level]))
    O.allsky_observer(nquad=4, fbeam=1.0)
    with pytest.raises(ValueError, match="level"):
        O.allsky_observer(nquad=4, level="limb")


def test_clearsky_measurement_case_on_the_cpu():
    """build_clearsky_measurement at a small size: 10 elements per beam
    position, paths to the surface, and the cached observer's kernel route
    (its plain version here) against its dense route at the Pallas-vs-XLA
    bound."""
    case = build_clearsky_measurement(n_lev=8, n_freq=128, n_lines=32, n_scan=3,
                                      max_step=10e3, **CPU64)
    assert case.sensor.n_elements == 30 and all(p.background == "surface" for p in case.paths)
    ys = [M.measurement_vector(case.scene, case.sensor, case.f_grid, list(case.paths),
                               observer=O.clearsky_observer_cached(backend=b), **CPU64)
          for b in ("pallas", "xla")]
    assert torch.isfinite(ys[0]).all() and (ys[0] > 0).all()
    np.testing.assert_allclose(ys[0].numpy(), ys[1].numpy(), rtol=2e-6,
                               atol=5e-7 * float(ys[1].abs().max()))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_entry_points_default_to_the_card(scenes):
    """Without a card, the entry points raise unless asked for the CPU."""
    _, ps = scenes
    p = make_paths()[0]
    for call in (lambda: F.simulate_clearsky(ps, FREQ, p.alt, p.dr),
                 lambda: F.gas_absorption_levels(ps, FREQ),
                 lambda: M.stack_paths([p]),
                 lambda: S.raw_channels(4),
                 lambda: build_clearsky_measurement(n_lev=4, n_freq=8, n_lines=4, n_scan=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
