"""The whole all-sky slice: a small bench-shaped scene built with arts_tpu,
carried across with scene_from_numpy, through the port's
gas_absorption_profile and simulate_allsky on the CPU at float64, against
arts_tpu's XLA route (dense absorption, LAPACK DISORT)."""

import dataclasses

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
from arts_tpu.scattering import HenyeyGreenstein as JHG
from arts_tpu_torch import gas_absorption_profile, simulate_allsky
from arts_tpu_torch.convert import scene_from_numpy
from arts_tpu_torch.scene import build_scene

CPU64 = dict(device="cpu", dtype=torch.float64)
N_LEV, N_FREQ, N_LINES, NQUAD = 10, 256, 64, 8


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
    """bench.build_scene's recipe at 64 lines, 256 frequencies, 10 levels,
    with the JAX package; its XLA-route absorption and DISORT solve."""
    atm = j_standard_atmosphere(n_levels=N_LEV, z_top=80e3, species=("H2O", "O2"))
    lines = j_read_par(bench.synth_par_rows(n_lines=N_LINES), ["H2O", "O2"],
                       strength_option="A", cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    cloud = JHG(ext=jnp.where((atm.z > 4e3) & (atm.z < 9e3), 3e-4, 0.0),
                ssa=jnp.full(atm.z.shape, 0.85), g=jnp.full(atm.z.shape, 0.7))
    scene = JScene(atm=atm, cat=j_build_catalog(lines),
                   pf=j_rigid_rotor_table(2, [174.6, 215.7], 1.5),
                   scatterers=(cloud,), surface_temperature=jnp.asarray(288.0))
    f = jnp.linspace(160e9, 260e9, N_FREQ)
    k = j_gas_absorption_profile(scene, f, backend="xla")
    out = j_simulate_allsky(scene, f, nquad=NQUAD, nfourier=1, backend="xla",
                            fast_linalg=False, k_gas=k)
    d = {
        "atm": _leaves(atm), "cat": _leaves(scene.cat), "pf": _leaves(scene.pf),
        "scatterers": [_leaves(cloud)],
        "surface_temperature": np.asarray(scene.surface_temperature),
        "surface_albedo": np.asarray(scene.surface_albedo),
    }
    return d, np.asarray(f), np.asarray(k), out


def test_build_scene_matches_the_jax_recipe(jax_run):
    """The port's own build_scene reproduces the carried-across scene."""
    d, f, _, _ = jax_run
    mine, f_t = build_scene(n_lev=N_LEV, n_freq=N_FREQ, n_lines=N_LINES, **CPU64)
    ref = scene_from_numpy(d, **CPU64)
    np.testing.assert_allclose(f_t.numpy(), f, rtol=1e-15)  # jnp vs np linspace
    for part in ("atm", "cat", "pf"):
        a, b = getattr(mine, part), getattr(ref, part)
        for fld in dataclasses.fields(a):
            x, y = getattr(a, fld.name), getattr(b, fld.name)
            if x is not None:
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-14,
                                           err_msg=f"{part}.{fld.name}")
    for fld in ("ext", "ssa", "g"):
        np.testing.assert_array_equal(getattr(mine.scatterers[0], fld).numpy(),
                                      getattr(ref.scatterers[0], fld).numpy())


def test_gas_absorption_profile_matches_jax(jax_run):
    """k_gas [F, Z] through the Voigt kernel's route (its plain version on
    the CPU) against the JAX dense path, at the multipole bound of the JAX
    package (3e-6 * scale, rtol 1e-4, tests/test_tpu_kernels.py:131)."""
    d, f, k_ref, _ = jax_run
    k = gas_absorption_profile(scene_from_numpy(d, **CPU64), torch.tensor(f), **CPU64)
    np.testing.assert_allclose(k.numpy(), k_ref, rtol=1e-4, atol=3e-6 * np.abs(k_ref).max())


def test_simulate_allsky_matches_jax_given_k_gas(jax_run):
    """The DISORT part alone, from JAX's k_gas: the port's fused solve
    against JAX's LAPACK solve at the fused-vs-XLA tolerance, rtol 2e-5
    (tests/test_fused_disort.py:54)."""
    d, f, k_ref, ref = jax_run
    out = simulate_allsky(scene_from_numpy(d, **CPU64), torch.tensor(f), nquad=NQUAD,
                          nfourier=1, k_gas=torch.tensor(k_ref), **CPU64)
    for key in ("flux_up", "flux_down_diffuse", "u0"):
        want = np.asarray(getattr(ref, key))
        np.testing.assert_allclose(getattr(out, key).numpy(), want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max(), err_msg=key)


def test_allsky_slice_matches_jax(jax_run):
    """End to end, absorption included: flux_up and u0 at rtol 1e-4,
    atol 2e-5 * scale.  The kernel route's k_gas differs from the dense
    one by up to 3e-6 * scale (the multipole far field), which moves the
    radiances by less than that; 2e-5 is the fused-vs-XLA DISORT bound."""
    d, f, _, ref = jax_run
    out = simulate_allsky(scene_from_numpy(d, **CPU64), torch.tensor(f), nquad=NQUAD,
                          nfourier=1, **CPU64)
    for key in ("flux_up", "u0"):
        want = np.asarray(getattr(ref, key))
        np.testing.assert_allclose(getattr(out, key).numpy(), want, rtol=1e-4,
                                   atol=2e-5 * np.abs(want).max(), err_msg=key)
