"""The port's measurement pipeline against arts_tpu on the CPU at float64
(test_torch_measurement.py's fixtures): measurement Jacobians against
jax.jacrev (also in chunks and through the level cache), the polarized
and thermal all-sky observers, the ATMS scan-line case at a small size,
and the entry points' refusal without a card."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from arts_tpu_torch.convert import scene_from_numpy
from arts_tpu_torch.lbl.catalog import catalog_from_arrays
from arts_tpu_torch.lbl.partfun import PartFunTable
from arts_tpu_torch.lbl.zeeman import expand_zeeman
from arts_tpu_torch.retrieval import RetrievalTarget, StateMapping
from arts_tpu_torch.scene import build_clearsky_measurement
from arts_tpu_torch.sensor import measurement as M
from arts_tpu_torch.sensor import observers as O
from test_torch_clearsky import ref_jit, scene_numpy

from test_torch_measurement import (  # noqa: F401 (fixtures)
    CPU64,
    FREQ,
    N_LEV,
    T,
    _sensor_pair,
    close,
    make_paths,
    one_thread,
    scenes,
)


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
    from test_torch_zeeman_path import _line, _zeeman_scene_arrays
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
