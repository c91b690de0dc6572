"""The sun-lit all-sky slice on the CPU at float64: simulate_allsky with a
solar beam, its azimuth-resolved field and the TMS/IMS corrections, and
the azimuth-resolved allsky_observer through the measurement pipeline,
against arts_tpu; and the float32 line centres of the Voigt kernel's
route."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from arts_tpu.atm.standard import standard_atmosphere as j_standard_atmosphere
from arts_tpu.fwd_allsky import AllskyScene as JScene
from arts_tpu.fwd_allsky import gas_absorption_profile as j_gas_absorption_profile
from arts_tpu.fwd_allsky import simulate_allsky as j_simulate_allsky
from arts_tpu.io.hitran import read_par as j_read_par
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.path.geometry import PathGeometry as JPath
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu.sensor import measurement as JM
from arts_tpu.sensor.obsel import camera_channels as j_camera_channels
from arts_tpu.sensor.observers import allsky_observer as j_allsky_observer
from arts_tpu_torch import simulate_allsky
from arts_tpu_torch._cuda import move
from arts_tpu_torch.convert import scene_from_numpy
from arts_tpu_torch.lbl.voigt import absorption_kernel
from arts_tpu_torch.scene import build_scene, build_solar_scene, build_sun_camera
from arts_tpu_torch.sensor import measurement as M
from arts_tpu_torch.sensor.obsel import camera_channels

CPU64 = dict(device="cpu", dtype=torch.float64)
N_LEV, N_FREQ, N_LINES = 10, 32, 64
# jax.jit with LLVM's optimizations off, as in tests/test_torch_clearsky.py
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
SUN = dict(nquad=8, nleg=16, nfourier=4, mu0=0.5, fbeam=float(np.pi), phi0=20.0,
           phis=(0.0, 90.0, 180.0), intensity_correction=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


@pytest.fixture(scope="module")
def jax_run():
    """bench.build_scene's recipe at 64 lines, 32 frequencies, 10 levels,
    with the JAX package: its absorption, and its sun-lit solves (XLA
    route, LAPACK) with and without the thermal emission."""
    atm = j_standard_atmosphere(n_levels=N_LEV, z_top=80e3, species=("H2O", "O2"))
    lines = j_read_par(bench.synth_par_rows(n_lines=N_LINES), ["H2O", "O2"],
                       strength_option="A", cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    cloud = JHG(ext=jnp.where((atm.z > 4e3) & (atm.z < 9e3), 3e-4, 0.0),
                ssa=jnp.full(atm.z.shape, 0.85), g=jnp.full(atm.z.shape, 0.7))
    scene = JScene(atm=atm, cat=j_build_catalog(lines),
                   pf=j_rigid_rotor_table(2, [174.6, 215.7], 1.5),
                   scatterers=(cloud,), surface_temperature=jnp.asarray(288.0),
                   surface_albedo=jnp.asarray(0.2))
    f = jnp.linspace(160e9, 260e9, N_FREQ)

    @ref_jit
    def refs(scene, f):
        k = j_gas_absorption_profile(scene, f, backend="xla")
        return k, {th: j_simulate_allsky(scene, f, backend="xla", fast_linalg=False, k_gas=k,
                                         thermal=th, **SUN) for th in (False, True)}

    k, outs = refs(scene, f)
    d = {
        "atm": _leaves(atm), "cat": _leaves(scene.cat), "pf": _leaves(scene.pf),
        "scatterers": [_leaves(cloud)],
        "surface_temperature": np.asarray(scene.surface_temperature),
        "surface_albedo": np.asarray(scene.surface_albedo),
    }
    return d, np.asarray(f), np.asarray(k), outs


@pytest.mark.parametrize("thermal", [False, True])
def test_sunlit_simulate_allsky_matches_jax(jax_run, thermal):
    """The sun at 60 degrees zenith over a cloud and a surface of albedo
    0.2, 4 Fourier modes, u at three azimuths with the TMS/IMS
    corrections, a solar-band run (thermal=False) and one with the
    thermal emission: the fused route (its plain versions) and the
    differentiable route, from JAX's k_gas, against arts_tpu's XLA route
    at rtol 2e-5, atol 2e-5 of scale (tests/test_fused_disort.py:54)."""
    d, f, k, outs = jax_run
    ref = outs[thermal]
    scene = scene_from_numpy(d, **CPU64)
    for route in (None, False):
        out = simulate_allsky(scene, torch.tensor(f), k_gas=torch.tensor(k), thermal=thermal,
                              fast_linalg=route, **SUN, **CPU64)
        for key in ("flux_up", "flux_down_diffuse", "flux_direct", "u0", "u"):
            want = np.asarray(getattr(ref, key))
            np.testing.assert_allclose(getattr(out, key).numpy(), want, rtol=2e-5,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=f"thermal={thermal} fast_linalg={route} {key}")


def test_sun_camera_matches_jax():
    """The JAX package's examples/12_sun_camera_allsky.py: a ring of 7
    camera pixels through the azimuth-resolved allsky_observer (16
    streams, 16 Fourier modes, 32 phase moments, the TMS/IMS corrections),
    by _simulate_batch with the pixels' azimuths and by measurement_vector
    with camera channels, against arts_tpu at 1e-10 of scale; and the
    example's own checks: the forward-scattering halo is brightest toward
    the sun's azimuth and falls off monotonically away from it."""
    scene, f, paths, obs = build_sun_camera(**CPU64)
    atm = j_standard_atmosphere(n_levels=40, z_top=60e3, species=("N2",))
    z = np.asarray(atm.z)
    haze = JHG(ext=jnp.asarray(np.where(z < 3e3, 2e-5, 0.0)), ssa=jnp.full(z.shape, 0.85),
               g=jnp.full(z.shape, 0.7))
    jscene = JScene(atm=atm, cat=None, pf=None, scatterers=(haze,),
                    surface_temperature=jnp.asarray(290.0))
    jpaths = [JPath(alt=p.alt, s=p.s, za=p.za, background=p.background, aa=p.aa) for p in paths]
    jobs = j_allsky_observer(nquad=16, nfourier=16, nleg=32, mu0=0.5, fbeam=float(np.pi),
                             phi0=0.0, thermal=False)
    assert obs.wants_azimuth and jobs.wants_azimuth
    jf = jnp.asarray([230e9])
    alts, drs, zas, _ = JM.stack_paths(jpaths)
    want = np.asarray(JM._simulate_batch(jscene, jf, alts, drs, zas, ["surface"] * 7,
                                         observer=jobs, aas=JM.stack_azimuths(jpaths)))[:, 0]
    y_want = np.asarray(JM.measurement_vector(jscene, j_camera_channels(1, 7, 1), jf, jpaths,
                                              observer=jobs))
    alts, drs, zas, _ = M.stack_paths(paths, **CPU64)
    got = M._simulate_batch(scene, f, alts, drs, zas, ["surface"] * 7, observer=obs,
                            aas=M.stack_azimuths(paths, **CPU64))[:, 0].numpy()
    y = M.measurement_vector(scene, camera_channels(1, 7, 1, **CPU64), f, paths, observer=obs,
                             **CPU64).numpy()
    for what, x, w in (("_simulate_batch", got, want), ("measurement_vector", y, y_want)):
        np.testing.assert_allclose(x, w, rtol=0, atol=1e-10 * np.abs(w).max(), err_msg=what)
    assert got[0] == got.max() and got[0] > 2.0 * got[-1] and np.all(np.diff(got) < 0)


def test_float32_line_centres_match_float64():
    """The Voigt kernel's route (its plain version here) in float32 against
    float64 on the same inputs (the float32 scene cast up), at the top 4
    levels of a small bench scene: within 1e-6 of each level's largest
    value.  Before each centre's rounding remainder went into the
    kernel's records, (f0 - anchor) + shift rounded to the float32 spacing
    of |f0 - anchor| (up to 4 kHz 50 GHz from the anchor) and read ~1e-3
    on the bench scene (tools/zeeman_f32_gap.py --routes scalar)."""
    scene, f = build_scene(n_lev=20, n_freq=512, n_lines=64, device="cpu", dtype=torch.float32)
    pts = scene.atm.at(scene.atm.z.flip(0))
    top = slice(0, 4)
    args = (f, scene.cat, scene.pf, pts.t[top], pts.p[top], pts.vmr[top])
    a32 = absorption_kernel(*args, device="cpu", dtype=torch.float32).double()
    a64 = absorption_kernel(*move(args, torch.device("cpu"), torch.float64), **CPU64)
    gap = (a32 - a64).abs().amax(-1) / a64.abs().amax(-1)
    assert float(gap.max()) <= 1e-6, gap.tolist()


def test_solar_scene_is_the_sunlit_bench_scene():
    """build_solar_scene is build_scene's scene and grid with the sun of
    example 12 (mu0 0.5, fbeam pi), thermal emission, 16 streams and
    Fourier modes and 32 phase moments; a small one runs, finite, with
    the beam's direct flux attenuated from mu0 fbeam at the top."""
    scene, f, kw = build_solar_scene(n_lev=8, n_freq=16, n_lines=16, **CPU64)
    ref, f_ref = build_scene(n_lev=8, n_freq=16, n_lines=16, **CPU64)
    assert torch.equal(f, f_ref) and torch.equal(scene.atm.t, ref.atm.t)
    assert kw["nquad"] == kw["nfourier"] == 16 and kw["nleg"] == 32 and kw["thermal"]
    assert kw["mu0"] == 0.5 and kw["fbeam"] == float(np.pi) and kw["intensity_correction"]
    out = simulate_allsky(scene, f, **kw, **CPU64)
    assert out.u.shape == (16, 8, 16, 3) and bool(torch.isfinite(out.u).all())
    np.testing.assert_allclose(out.flux_direct[:, 0].numpy(), 0.5 * np.pi, rtol=1e-14)
    assert bool((out.flux_direct.diff(dim=1) <= 0).all())
