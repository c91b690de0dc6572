"""The predefined models wired into the port's scenes, against arts_tpu on
the CPU at float64: species_absorption with lines and continua on both
backends (the dense route also on one Doppler-shifted grid per point),
the JAX package's example 1 (simulate_clearsky_bt over predefined models
alone) at reduced levels, example 3's all-sky scene without a catalog
through simulate_allsky, an ECS band beside them (and the sun's refusal),
and the new scene builders.

The JAX references are compiled with `ref_jit`, each fixture's as one
function."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from arts_tpu.atm.standard import standard_atmosphere as j_standard_atmosphere
from arts_tpu.fwd import ClearskyScene as JClearsky
from arts_tpu.fwd import simulate_clearsky_bt as j_simulate_clearsky_bt
from arts_tpu.fwd import species_absorption as j_species_absorption
from arts_tpu.fwd_allsky import AllskyScene as JScene
from arts_tpu.fwd_allsky import gas_absorption_profile as j_gas_absorption_profile
from arts_tpu.fwd_allsky import simulate_allsky as j_simulate_allsky
from arts_tpu.io.hitran import read_par as j_read_par
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.path import geometric_path_1d
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu_torch import fwd as F
from arts_tpu_torch import gas_absorption_profile, simulate_allsky
from arts_tpu_torch.convert import clearsky_scene_from_numpy, scene_from_numpy
from arts_tpu_torch.predefined import predefined_absorption
from arts_tpu_torch.scene import (
    CONTINUA,
    EXAMPLE_GAS_MODELS,
    build_continuum_scene,
    build_lookup_case,
    build_predef_scene,
)

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
N_LEV, N_FREQ, N_LINES = 8, 128, 64
SPECIES = ("H2O", "O2", "N2")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _scene_numpy(js):
    d = {"atm": _leaves(js.atm), "surface_temperature": np.asarray(js.surface_temperature),
         "predef": js.predef, "species_names": js.species_names}
    if js.cat is not None:
        d.update(cat=_leaves(js.cat), pf=_leaves(js.pf))
    if hasattr(js, "scatterers"):
        d.update(scatterers=[_leaves(s) for s in js.scatterers],
                 surface_albedo=np.asarray(js.surface_albedo))
    return d


def close(got, want, rtol=0.0, atol_scale=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max(),
                               err_msg=what)


# the Doppler factors of the per-point grids: a wind of up to 60 m/s
SHIFT = 1.0 + np.linspace(-2e-7, 2e-7, N_LEV)


@ref_jit
def _lines_refs(js, f):
    z = js.atm.z[::-1]
    pts = js.atm.at(z)
    per_point = jax.vmap(lambda d, t, p, v: j_species_absorption(js, f * d, t, p, v))(
        jnp.asarray(SHIFT), pts.t, pts.p, pts.vmr)
    return j_gas_absorption_profile(js, f, backend="xla"), per_point


@pytest.fixture(scope="module")
def lines_case():
    """The benchmark recipe at 64 lines, 128 frequencies and 8 levels with
    an N2 row and the continua of scene.build_continuum_scene, in both
    packages, and the JAX package's absorption profile (dense route) and
    its absorption on one Doppler-shifted grid per level."""
    atm = j_standard_atmosphere(n_levels=N_LEV, z_top=80e3, species=SPECIES)
    lines = j_read_par(bench.synth_par_rows(n_lines=N_LINES), ["H2O", "O2"],
                       strength_option="A", cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    cloud = JHG(ext=jnp.where((atm.z > 4e3) & (atm.z < 9e3), 3e-4, 0.0),
                ssa=jnp.full(atm.z.shape, 0.85), g=jnp.full(atm.z.shape, 0.7))
    js = JScene(atm=atm, cat=j_build_catalog(lines),
                pf=j_rigid_rotor_table(2, [174.6, 215.7], 1.5), scatterers=(cloud,),
                surface_temperature=jnp.asarray(288.0), predef=CONTINUA,
                species_names=SPECIES)
    f = np.linspace(160e9, 260e9, N_FREQ)
    k, per_point = _lines_refs(js, jnp.asarray(f))
    return scene_from_numpy(_scene_numpy(js), **CPU64), torch.tensor(f), np.asarray(k), \
        np.asarray(per_point)


def test_species_absorption_with_continua(lines_case):
    """Lines + continua on the dense route at 1e-10 of scale (also with one
    Doppler-shifted grid per level), and through the Voigt kernel's plain
    version at the bound test_torch_allsky.py holds it to against the
    dense route (3e-6 * scale, rtol 1e-4); the continua's part exactly
    predefined_absorption's."""
    ps, f, k_ref, per_point_ref = lines_case
    pts = ps.atm.at(ps.atm.z.flip(0))
    dense = F.species_absorption(ps, f, pts.t, pts.p, pts.vmr)
    close(dense.T, k_ref, atol_scale=1e-10, what="dense")
    fg = f * torch.tensor(SHIFT)[:, None]
    close(F.species_absorption(ps, fg, pts.t, pts.p, pts.vmr), per_point_ref,
          atol_scale=1e-10, what="per-point grids")
    kern = gas_absorption_profile(ps, f, **CPU64)
    close(kern, k_ref, rtol=1e-4, atol_scale=3e-6, what="kernel route")
    lines_only = gas_absorption_profile(dataclasses.replace(ps, predef=()), f, **CPU64)
    vmrs = {s: pts.vmr[:, i] for i, s in enumerate(SPECIES)}
    cont = predefined_absorption(CONTINUA, f, pts.t, pts.p, vmrs, **CPU64)
    close(kern - lines_only, cont.T, atol_scale=1e-12, what="continua part")
    assert float(cont.min()) >= 0.0 and float(cont.max()) > 0.0


EX1_LEVELS, EX1_FREQ, EX1_STEP = 21, 96, 4000.0


@ref_jit
def _example1_ref(js, f, alt, dr):
    return j_simulate_clearsky_bt(js, f, alt, dr, background="surface")


def test_example1_clearsky_bt():
    """examples/1_clearsky_radiance.py (PWR98 H2O and O2 and the standard N2
    continuum, no catalog, nadir from 850 km onto a 288.15 K surface) at
    21 levels, 96 frequencies over 10-200 GHz and 4 km steps: brightness
    temperatures at 1e-10 of scale."""
    atm = j_standard_atmosphere(n_levels=EX1_LEVELS, z_top=80e3, species=("N2", "O2", "H2O"))
    js = JClearsky(atm=atm, cat=None, pf=None, surface_temperature=jnp.asarray(288.15),
                   predef=EXAMPLE_GAS_MODELS, species_names=("N2", "O2", "H2O"))
    f = np.linspace(10e9, 200e9, EX1_FREQ)
    path = geometric_path_1d(850e3, 180.0, 0.0, 80e3, EX1_STEP)
    want = np.asarray(_example1_ref(js, jnp.asarray(f), jnp.asarray(path.alt),
                                    jnp.asarray(path.dr)))
    ps = clearsky_scene_from_numpy(_scene_numpy(js), **CPU64)
    assert ps.cat is None and ps.predef == EXAMPLE_GAS_MODELS
    got = F.simulate_clearsky_bt(ps, f, path.alt, path.dr, background="surface", **CPU64)
    close(got, want, atol_scale=1e-10)
    assert 2.0 < want.min() and want.max() < 320.0


EX3_NQUAD = 8


@ref_jit
def _example3_ref(js, f):
    out = j_simulate_allsky(js, f, nquad=EX3_NQUAD, nfourier=1)
    return out.flux_up, out.u0


def test_allsky_without_catalog():
    """The synthetic branch of examples/3_allsky_disort.py (49 levels to 12
    km, a 1-4 km HG rain cloud, example 1's gas models, no catalog) at 31.5
    and 165 GHz with 8 streams: flux_up and u0 at the fused-vs-LAPACK
    tolerance of test_torch_allsky.py (rtol 2e-5, 2e-5 of scale)."""
    atm = j_standard_atmosphere(n_levels=49, z_top=12e3, species=("N2", "O2", "H2O"))
    cloud = JHG(ext=jnp.where((atm.z > 1e3) & (atm.z < 4e3), 1e-3, 0.0),
                ssa=jnp.full(atm.z.shape, 0.9), g=jnp.full(atm.z.shape, 0.7))
    js = JScene(atm=atm, cat=None, pf=None, scatterers=(cloud,),
                surface_temperature=jnp.asarray(288.15), predef=EXAMPLE_GAS_MODELS,
                species_names=("N2", "O2", "H2O"))
    f = np.asarray([31.5e9, 165e9])
    flux_up, u0 = (np.asarray(a) for a in _example3_ref(js, jnp.asarray(f)))
    ps = scene_from_numpy(_scene_numpy(js), **CPU64)
    assert ps.cat is None and ps.pf is None
    out = simulate_allsky(ps, torch.tensor(f), nquad=EX3_NQUAD, nfourier=1, **CPU64)
    close(out.flux_up, flux_up, rtol=2e-5, atol_scale=2e-5, what="flux_up")
    close(out.u0, u0, rtol=2e-5, atol_scale=2e-5, what="u0")


def test_ecs_scene_still_raises():
    """A scene with an ECS band no longer raises: its band adds to the
    predefined models' absorption.  Nor does the sun in the pencil beam
    (ported since): a path whose far end looks at the sun adds the
    photosphere's radiance."""
    from arts_tpu_torch.lbl.ecs import make_o2_band, o2_erot
    from arts_tpu_torch.lbl.partfun import rigid_rotor_table
    from arts_tpu_torch.sun import sun_blackbody

    ps, f = build_predef_scene(n_lev=4, n_freq=4, **CPU64)
    band = make_o2_band([dict(f0=56.26e9, a=1e-9, e0=o2_erot(1, 2), gu=3.0, Ju=1.0, Jl=2.0,
                              Nu=1.0, Nl=1.0, g0=(2e4, 0.8))], device="cpu")
    o2 = ps.species_names.index("O2")
    scene = F.ClearskyScene(atm=ps.atm, cat=None, pf=rigid_rotor_table(1, 215.7, **CPU64),
                            predef=ps.predef, species_names=ps.species_names,
                            ecs_bands=((band, o2, 0, 1.0),))
    path = ([0.0, 1e3], [1e3])
    I = F.simulate_clearsky(scene, f, *path, **CPU64)
    I0 = F.simulate_clearsky(dataclasses.replace(scene, ecs_bands=()), f, *path, **CPU64)
    assert bool(torch.isfinite(I).all()) and bool((I != I0).any())
    I_sun = F.simulate_clearsky(scene, f, *path, path_za=[0.0, 0.0],
                                sun=sun_blackbody(f, **CPU64), sun_za=0.0, **CPU64)
    assert bool((I_sun > I).all())


def test_scene_builders():
    """build_continuum_scene, build_predef_scene and build_lookup_case at
    small sizes: the continua add to the lines, the predefined-only scene
    runs through simulate_allsky to finite radiances, and the lookup
    case's check points lie between the levels, off the training grid."""
    scene, f = build_continuum_scene(n_lev=6, n_freq=64, n_lines=16, **CPU64)
    assert scene.species_names == SPECIES and scene.predef == CONTINUA
    assert scene.atm.vmr.shape == (3, 6)
    k = gas_absorption_profile(scene, f, **CPU64)
    k_lines = gas_absorption_profile(dataclasses.replace(scene, predef=()), f, **CPU64)
    assert bool((k >= k_lines).all()) and float((k - k_lines).min()) > 0.0

    scene, f = build_predef_scene(n_lev=6, n_freq=16, **CPU64)
    assert scene.cat is None and float(f[0]) == 10e9 and float(f[-1]) == 200e9
    out = simulate_allsky(scene, f, nquad=4, nfourier=1, **CPU64)
    assert out.u0.shape == (16, 6, 4) and bool(torch.isfinite(out.u0).all())

    case = build_lookup_case(n_lev=6, n_freq=16, n_lines=16, **CPU64)
    assert case.T.shape == (5,) and case.vmr.shape == (5, 2)
    p = case.p_grid
    assert bool(((case.P < p[:-1]) & (case.P > p[1:])).all())
    assert int(case.cat.spec_idx.max()) == 0  # the H2O lines alone
