"""The port's polarized clear-sky path as a whole against arts_tpu on the
CPU at float64: simulate_clearsky_polarized on the 2_zeeman example's
scene, and the bench's Zeeman stage at a small size (the profile and
kernel routes against the dense one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.atm import Atmosphere1D as JAtmosphere1D
from arts_tpu.atm.field import hydrostatic_pressure as j_hydrostatic_pressure
from arts_tpu.fwd import ZeemanScene as JZeemanScene
from arts_tpu.fwd import simulate_clearsky_polarized as j_simulate_clearsky_polarized
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.lbl.tmodel import Law as JLaw
from arts_tpu.lbl.zeeman import expand_zeeman as j_expand_zeeman
from arts_tpu_torch import _cuda
from arts_tpu_torch.atm import Atmosphere1D, hydrostatic_pressure
from arts_tpu_torch.fwd import ZeemanScene, simulate_clearsky_polarized
from arts_tpu_torch.lbl import zeeman as Z
from arts_tpu_torch.lbl.catalog import build_catalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.lbl.tmodel import Law
from arts_tpu_torch.lbl.zeeman import expand_zeeman
from arts_tpu_torch.path import geometric_path_1d
from arts_tpu_torch.scene import build_zeeman_inputs
from test_torch_rtepack import T, one_thread, ref_jit  # noqa: F401 (fixture)

CPU64 = dict(device="cpu", dtype=torch.float64)
F_POL = 118.7503e9 + np.linspace(-5e6, 5e6, 41)
ZEEMAN_KW = dict(ju=[1.0], jl=[1.0], gu_z=[-2.8], gl_z=[-2.77])


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


def test_build_zeeman_inputs_profile_against_dense():
    """The bench's Zeeman stage at a small size (3 levels, 64 frequencies,
    16 lines): the profile route equals the dense route to 1e-4 of scale
    and the kernel wrappers on CPU tensors run their plain versions and
    count no launch."""
    d = build_zeeman_inputs(n_lev=3, n_freq=64, n_lines=16, **CPU64)
    pts = [d[k] for k in ("T", "P", "vmr", "mag")]
    before = dict(_cuda.LAUNCHES)
    prof = Z.zeeman_propmat_profile(d["f_grid"], d["pzcat"], d["pf"], *pts, d["los_za_deg"],
                                    **d["tune"], **CPU64)
    dense = Z.zeeman_propmat(d["f_grid"], d["zcat"], d["pf"], *pts, d["los_za_deg"], **CPU64)
    kern = Z.zeeman_propmat(d["f_grid"], d["zcat"], d["pf"], *pts, d["los_za_deg"],
                            backend="pallas", **CPU64)
    assert _cuda.LAUNCHES == before
    assert prof.shape == dense.shape == kern.shape == (3, 64, 7)
    scale = dense.abs().max()
    assert float((prof - dense).abs().max()) <= 1e-4 * scale
    assert float((kern - dense).abs().max()) <= 1e-5 * scale
