"""ECS line mixing through the port's clear-sky path against arts_tpu on the
CPU at float64: simulate_clearsky on tests/test_ecs.py's ECS scene,
species_absorption at batched points against single points, the
measurement vector and its forward-mode Jacobian on a small ECS
measurement against the JAX package's, and the full-width ECS scene's
builders (scene.build_ecs_scene, build_ecs_measurement) at small sizes:
the band read back from its .par rows equal to the JAX package's, and its
area at the surface within 10 % of O2-MPM2020's.

The JAX references are built once, in module fixtures."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import fwd as JF
from arts_tpu import sensor as JS
from arts_tpu.atm.field import Atmosphere1D as JAtmosphere1D
from arts_tpu.io.hitran import o2_lines_from_par as j_o2_lines_from_par
from arts_tpu.io.hitran import read_par_records as j_read_par_records
from arts_tpu.lbl.ecs import make_o2_band as j_make_o2_band
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.path import geometric_path_1d
from arts_tpu.retrieval import RetrievalTarget as JRetrievalTarget
from arts_tpu.retrieval import StateMapping as JStateMapping
from arts_tpu.sensor import measurement as JM
from arts_tpu_torch import fwd as F
from arts_tpu_torch import sensor as S
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.predefined import predefined_absorption
from arts_tpu_torch.retrieval import RetrievalTarget, StateMapping
from arts_tpu_torch.scene import build_ecs_measurement, build_ecs_scene, o2_ecs_par_rows
from arts_tpu_torch.sensor import measurement as M
from arts_tpu_torch.sensor import observers as O
from test_ecs import o2_like_lines

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
N_LEV = 16
FREQ = np.linspace(50e9, 70e9, 101)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, atol_scale=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol_scale * np.abs(want).max())


@pytest.fixture(scope="module")
def scenes():
    """tests/test_ecs.py's ECS scene (three N+- pairs, 16 levels to 30 km,
    O2 at 0.2095) in both packages, the port's carried across from the
    JAX scene's leaves."""
    band = j_make_o2_band(o2_like_lines(3))
    z = jnp.linspace(0.0, 30e3, N_LEV)
    atm = JAtmosphere1D(z=z, t=288.0 - 6.5e-3 * jnp.clip(z, 0, 11e3),
                        p=101325.0 * jnp.exp(-z / 7.5e3), vmr=jnp.full((1, N_LEV), 0.2095))
    js = JF.ClearskyScene(atm=atm, cat=None, pf=j_rigid_rotor_table(1, 150.0, 1.0),
                          ecs_bands=((band, 0, 0, 1.0),))
    leaves = lambda o: {f.name: np.asarray(getattr(o, f.name)) for f in dataclasses.fields(o)
                        if getattr(o, f.name) is not None}
    d = {"atm": leaves(js.atm), "pf": leaves(js.pf),
         "surface_temperature": np.asarray(js.surface_temperature),
         "ecs_bands": [(dict(leaves(band), direct_at_ji=band.direct_at_ji), 0, 0, 1.0)]}
    return js, clearsky_scene_from_numpy(d, **CPU64)


def test_simulate_clearsky_with_ecs_matches_jax(scenes):
    """The scene of tests/test_ecs.py:240-273 (a down-looking path from 30
    km in 1 km steps over the surface, 101 frequencies over 50-70 GHz):
    radiances and brightness temperatures within 1e-10 of scale."""
    js, ps = scenes
    alt, dr = np.linspace(30e3, 0.0, 31), np.full(30, 1e3)
    want = ref_jit(lambda js, f, a, r: (
        JF.simulate_clearsky(js, f, a, r, background="surface"),
        JF.simulate_clearsky_bt(js, f, a, r, background="surface")))(
        js, *map(jnp.asarray, (FREQ, alt, dr)))
    got = F.simulate_clearsky(ps, FREQ, alt, dr, background="surface", **CPU64)
    close(got.numpy(), want[0])
    bt = F.simulate_clearsky_bt(ps, FREQ, alt, dr, background="surface", **CPU64)
    close(bt.numpy(), want[1])
    i60 = np.argmin(np.abs(FREQ - 60.3e9))
    assert 200.0 < float(bt[i60]) < 265.0 and float(bt[0]) > 280.0


def test_batched_points_match_single_points(scenes):
    """species_absorption with the ECS band at points batched [2, 8]
    against one call per point, within 1e-12 of each spectrum's largest
    value (float64 roundoff: the batched call's matrix products through
    the Jacobi's 444 rounds sum in another order)."""
    _, ps = scenes
    pts = ps.atm.at(ps.atm.z)
    t, p, v = pts.t.reshape(2, 8), pts.p.reshape(2, 8), pts.vmr.reshape(2, 8, 1)
    fg = T(FREQ)
    got = F.species_absorption(ps, fg, t, p, v)
    assert got.shape == (2, 8, FREQ.size)
    for i in range(2):
        for j in range(8):
            one = F.species_absorption(ps, fg, t[i, j], p[i, j], v[i, j])
            close(got[i, j].numpy(), one.numpy(), 1e-12)


def _targets(pkg_target, replace_vmr):
    """O2 VMR relative to the reference and the temperature profile."""
    vmr = pkg_target("vmr0", lambda s: s.atm.vmr[0],
                     lambda s, v: dataclasses.replace(s, atm=replace_vmr(s.atm, v)),
                     transform="rel")
    t = pkg_target("t", lambda s: s.atm.t,
                   lambda s, v: dataclasses.replace(s, atm=dataclasses.replace(s.atm, t=v)))
    return [vmr, t]


def test_measurement_vector_and_jacobian_match_jax(scenes):
    """A nadir and a slant geometry to the surface in 4 km steps, 21
    frequencies over 54-66 GHz and 4 Gaussian channels each: y within
    1e-10 of scale; d y / d (O2 VMR, T) by measurement_jacobian (forward
    mode, vmap over jvp) against the JAX package's (jax.jacrev), each
    column within 1e-8 of its largest entry plus 1e-14 of its field's
    block, as tests/test_torch_measurement_observers.py holds the line
    catalog's."""
    js, ps = scenes
    f = np.linspace(54e9, 66e9, 21)
    paths = [geometric_path_1d(40e3, 180.0, 0.0, 30e3, 4000.0),
             geometric_path_1d(40e3, 150.0, 0.0, 30e3, 4000.0)]
    args = (f, np.tile(np.linspace(55e9, 65e9, 4), 2), 2e9, np.repeat(np.arange(2), 4))
    jsens, psens = JS.gaussian_channels(*args), S.gaussian_channels(*args, **CPU64)
    jmap = lambda js: JStateMapping(_targets(JRetrievalTarget, lambda a, v: dataclasses.replace(
        a, vmr=a.vmr.at[0].set(v))), js)
    pmap = StateMapping(_targets(RetrievalTarget, lambda a, v: dataclasses.replace(
        a, vmr=torch.cat([v[None], a.vmr[1:]]))), ps, **CPU64)
    yw, Kw = ref_jit(lambda js, f: JM.measurement_jacobian(js, jsens, f, paths, jmap(js)))(
        js, jnp.asarray(f))
    y = M.measurement_vector(ps, psens, f, paths, **CPU64)
    close(y.numpy(), np.asarray(yw))
    y, K = M.measurement_jacobian(ps, psens, f, paths, pmap, chunk_size=16, **CPU64)
    close(y.numpy(), np.asarray(yw))
    Kw, K = np.asarray(Kw), K.numpy()
    for blk in (slice(0, N_LEV), slice(N_LEV, 2 * N_LEV)):
        col = np.abs(Kw[:, blk]).max(0)
        assert (col > 0).all()
        np.testing.assert_array_less(np.abs(K[:, blk] - Kw[:, blk]).max(0),
                                     1e-8 * col + 1e-14 * col.max())


def test_ecs_scene_band_matches_jax_and_mpm2020_area():
    """build_ecs_scene's band: o2_ecs_par_rows read back by the JAX
    package's reader into its make_o2_band gives the port's band to 1e-14
    relative; in float64 on 4 levels and 2048 frequencies the band's
    absorption summed over the grid at the surface lies within 10 % of
    O2-MPM2020's (line mixing conserves the area, so a units slip in the
    strength conversion shows here)."""
    scene, f = build_ecs_scene(n_lev=4, n_freq=2048, **CPU64)
    band, sidx, iidx, irat = scene.ecs_bands[0]
    lines, _, _ = j_o2_lines_from_par(j_read_par_records(o2_ecs_par_rows()), 215.7)
    want = j_make_o2_band(lines)
    assert band.f0.numel() == len(lines) == 38
    for fld in dataclasses.fields(band):
        if fld.name != "direct_at_ji":
            np.testing.assert_allclose(getattr(band, fld.name).numpy(),
                                       np.asarray(getattr(want, fld.name)), rtol=1e-14,
                                       err_msg=fld.name)
    pts = scene.atm.at(scene.atm.z[:1])
    k = F.species_absorption(dataclasses.replace(scene, predef=()), f, pts.t, pts.p, pts.vmr)
    mpm = predefined_absorption(("O2-MPM2020",), f, pts.t, pts.p, {"O2": pts.vmr[..., sidx]},
                                **CPU64)
    ratio = float(k.sum() / (irat * mpm.sum()))
    assert abs(ratio - 1.0) < 0.1, ratio


def test_ecs_measurement_case_on_the_cpu():
    """build_ecs_measurement at a small size: 8 elements per beam position
    (ATMS channels 3-9, channel 7's passbands apart), paths to the
    surface, finite positive measurements whose brightness temperature
    falls from the 50.3 GHz channel to the opaque 55.5 GHz one; and the
    level-cached observer against the direct one on a level-aligned nadir
    path, where the cache is exact, within 1e-12 of scale."""
    from arts_tpu_torch.ops.planck import inv_planck

    case = build_ecs_measurement(n_lev=8, n_freq=512, n_scan=3, max_step=10e3, **CPU64)
    assert case.sensor.n_elements == 24 and all(p.background == "surface" for p in case.paths)
    y = M.measurement_vector(case.scene, case.sensor, case.f_grid, list(case.paths),
                             observer=O.clearsky_observer_cached(), **CPU64)
    assert torch.isfinite(y).all() and (y > 0).all()
    centers = case.sensor.apply(case.f_grid.expand(3, -1).contiguous())
    bt = inv_planck(y, centers).reshape(3, 8)
    assert bool((bt[:, 0] > bt[:, -1]).all())

    z = case.scene.atm.z
    alts, drs = z.flip(0)[None], -torch.diff(z.flip(0))[None]
    args = (case.scene, case.f_grid, alts, drs, torch.zeros_like(alts), "surface")
    close(O.clearsky_observer_cached()(*args).numpy(), O.clearsky_observer()(*args).numpy(),
          1e-12)
