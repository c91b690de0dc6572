"""The port's polarized clear-sky path (arts_tpu_torch) against arts_tpu on
the CPU at float64: the rtepack algebra, the polarized emission recursion,
the 1D path geometry and simulate_clearsky_polarized on the 2_zeeman
example's scene, on identical inputs made with numpy."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from arts_tpu.atm import Atmosphere1D as JAtmosphere1D
from arts_tpu.atm.field import hydrostatic_pressure as j_hydrostatic_pressure
from arts_tpu.fwd import ZeemanScene as JZeemanScene
from arts_tpu.fwd import simulate_clearsky_polarized as j_simulate_clearsky_polarized
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.lbl.tmodel import Law as JLaw
from arts_tpu.lbl.zeeman import expand_zeeman as j_expand_zeeman
from arts_tpu.path.geometry import geometric_path_1d as j_geometric_path_1d
from arts_tpu.rtepack import emission as JE
from arts_tpu.rtepack import propmat as JP
from arts_tpu_torch.atm import Atmosphere1D, hydrostatic_pressure
from arts_tpu_torch.fwd import ZeemanScene, simulate_clearsky_polarized
from arts_tpu_torch.lbl.catalog import build_catalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.lbl.tmodel import Law
from arts_tpu_torch.lbl.zeeman import expand_zeeman
from arts_tpu_torch.path import geometric_path_1d
from arts_tpu_torch.rtepack import emission as E
from arts_tpu_torch.rtepack import propmat as PM

T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
# jax.jit with LLVM's optimizations off: a quarter less compile time than
# the JAX function's own jit
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _propmats(rng, n, scale=1.0):
    """Random physical propagation matrices (A dominates), with
    unpolarized and nearly unpolarized rows for the degenerate limits."""
    k = rng.normal(size=(n, 7)) * scale
    k[:, 0] = np.abs(k[:, 0]) + 1.0
    k[0, 1:] = 0.0
    k[1, 1:] = [1e-14, 0, 0, 1e-15, 0, 0]
    return k


def test_expm_matches_jax_and_scipy():
    rng = np.random.default_rng(0)
    k = _propmats(rng, 64)
    r = np.abs(rng.normal(size=64)) * 0.5
    got = PM.expm(T(k), T(r)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.expm(jnp.asarray(k), jnp.asarray(r))),
                               rtol=1e-12, atol=1e-15)
    for i in range(0, 64, 7):
        ref = scipy.linalg.expm(-r[i] * PM.to_matrix(T(k[i])).numpy())
        np.testing.assert_allclose(got[i], ref, rtol=1e-10, atol=1e-12)


def test_inv_matvec_matmul_match_jax():
    rng = np.random.default_rng(1)
    k = _propmats(rng, 16)
    s = rng.normal(size=(16, 4))
    m2 = rng.normal(size=(16, 4, 4))
    inv = PM.inv(T(k))
    np.testing.assert_allclose(inv.numpy(), np.asarray(JP.inv(jnp.asarray(k))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(PM.matvec(inv, T(s)).numpy(),
                               np.asarray(JP.matvec(JP.inv(jnp.asarray(k)), jnp.asarray(s))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(PM.matmul(inv, T(m2)).numpy(),
                               np.asarray(JP.matmul(JP.inv(jnp.asarray(k)), jnp.asarray(m2))),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(PM.propmat(1.0, T(k[:, 1]), w=2.0).numpy(),
                                  np.asarray(JP.propmat(1.0, jnp.asarray(k[:, 1]), w=2.0)))


def test_emission_polarized_matches_jax():
    """A 30-point path, 12 frequencies, polarized layers of optical depth
    ~0.1-1: the layer loop against JAX's reverse scan."""
    rng = np.random.default_rng(2)
    npts, F = 30, 12
    k = rng.normal(size=(npts, F, 7)) * 2e-5
    k[..., 0] = np.abs(k[..., 0]) + 5e-5
    J = np.zeros((npts, F, 4))
    J[..., 0] = rng.uniform(1.0, 3.0, (npts, F))
    J[..., 1:] = rng.normal(size=(npts, F, 3)) * 1e-2
    r = rng.uniform(500.0, 3000.0, npts - 1)
    I0 = rng.uniform(0.1, 0.5, (F, 4))
    got = E.emission_polarized(T(k), T(J), T(r), T(I0)).numpy()
    want = np.asarray(JE.emission_polarized(*(jnp.asarray(a) for a in (k, J, r, I0))))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14 * np.abs(want).max())


@pytest.mark.parametrize("alt, za, top", [(0.0, 0.0, 100e3), (800e3, 180.0, 80e3),
                                         (800e3, 116.5, 80e3), (10e3, 95.0, 60e3)])
def test_geometric_path_1d_matches_jax(alt, za, top):
    """Up-looking, nadir, limb (space behind) and a slant path to the
    surface: the same numpy, point for point."""
    got = geometric_path_1d(alt, za, 0.0, top, 2000.0)
    want = j_geometric_path_1d(alt, za, 0.0, top, 2000.0)
    assert got.background == want.background
    for name in ("alt", "s", "za", "dr"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _zeeman_scene_arrays(n_lev=51):
    """The 2_zeeman example's scene as numpy: one O2 118.75 GHz line,
    51 levels to 100 km, with a constant [0, 3e-5, 3e-5] T field."""
    z = np.linspace(0.0, 100e3, n_lev)
    t = 288.0 - 6.5e-3 * np.minimum(z, 12e3) + 2e-3 * np.maximum(z - 50e3, 0)
    vmr = np.full((1, n_lev), 0.2095)
    mag = np.broadcast_to(np.array([0.0, 3e-5, 3e-5])[:, None], (3, n_lev)).copy()
    return z, t, vmr, mag


def _line(law):
    return [dict(
        f0=118.7503e9, a=5e-9, e0=0.0, gu=5.0, gl=3.0, iso_mass=32.0,
        iso_ratio=0.995, spec_idx=0, iso_idx=0, band_idx=0, t0=296.0,
        cutoff=np.inf, ls={"bath": {"G0": (law.T1, [22000.0, 0.8])}},
    )]


def _paths():
    """The up-looking path from the ground and the nadir path from 100 km,
    in 2 km steps, per background."""
    return {"space": geometric_path_1d(0.0, 0.0, 0.0, 100e3, 2000.0),
            "surface": geometric_path_1d(100e3, 180.0, 0.0, 100e3, 2000.0)}


F_POL = 118.7503e9 + np.linspace(-5e6, 5e6, 41)
ZEEMAN_KW = dict(ju=[1.0], jl=[1.0], gu_z=[-2.8], gl_z=[-2.77])


@pytest.fixture(scope="module")
def polarized_refs():
    """JAX's simulate_clearsky_polarized on the 2_zeeman scene for both
    backgrounds, compiled as one function."""
    z, t, vmr, mag = _zeeman_scene_arrays()
    jz = jnp.asarray(z)
    jatm = JAtmosphere1D(z=jz, t=jnp.asarray(t),
                         p=j_hydrostatic_pressure(jz, jnp.asarray(t), 101325.0),
                         vmr=jnp.asarray(vmr), mag=jnp.asarray(mag))
    jscene = JZeemanScene(atm=jatm,
                          zcat=j_expand_zeeman(j_build_catalog(_line(JLaw)), **ZEEMAN_KW),
                          pf=j_rigid_rotor_table(1, 150.0, 1.0),
                          surface_temperature=jnp.asarray(275.0))
    paths = {bg: tuple(jnp.asarray(getattr(p, k)) for k in ("alt", "za", "dr"))
             for bg, p in _paths().items()}
    refs = ref_jit(lambda sc, f, paths: {
        bg: j_simulate_clearsky_polarized(sc, f, *paths[bg], background=bg) for bg in paths})
    return {bg: np.asarray(w) for bg, w in refs(jscene, jnp.asarray(F_POL), paths).items()}


@pytest.mark.parametrize("background", ["space", "surface"])
def test_simulate_clearsky_polarized_matches_jax(polarized_refs, background):
    """The 2_zeeman scene at 41 frequencies over +-5 MHz, an up-looking
    path in 2 km steps (and, for the surface background, a nadir path
    from 100 km): Stokes I..V within 1e-10 of scale, V within 1e-10 of
    its own scale, and |V| > 0."""
    z, t, vmr, mag = _zeeman_scene_arrays()
    path = _paths()[background]
    p = hydrostatic_pressure(T(z), T(t), 101325.0)
    atm = Atmosphere1D(z=T(z), t=T(t), p=p, vmr=T(vmr), mag=T(mag))
    cat = build_catalog(_line(Law), device="cpu", dtype=torch.float64)
    scene = ZeemanScene(atm=atm, zcat=expand_zeeman(cat, **ZEEMAN_KW),
                        pf=rigid_rotor_table(1, 150.0, 1.0, device="cpu", dtype=torch.float64),
                        surface_temperature=T(275.0))
    got = simulate_clearsky_polarized(scene, F_POL, path.alt, path.za, path.dr,
                                      background=background, device="cpu",
                                      dtype=torch.float64).numpy()
    want = polarized_refs[background]
    assert got.shape == (41, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    vmax = np.abs(want[:, 3]).max()
    assert vmax > 0
    np.testing.assert_allclose(got[:, 3], want[:, 3], rtol=0, atol=1e-10 * vmax)
