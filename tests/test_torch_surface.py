"""The Fresnel half of the port's rtepack/surface.py, its surface field
(atm/surface.py) and its refracted paths (path/refraction.py) against
arts_tpu on the CPU at float64, on the same inputs: the Fresnel
amplitudes at normal incidence, the Brewster angle and under total
internal reflection (and complex64 against complex128), the Mueller
matrices in the surface frame and rotated, the specular direction and
radiance, the non-specular radiance over surface patches, the bilinear
surface field, and the refractivity profile and refracted paths against
the JAX package's numpy."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.atm.standard import standard_atmosphere as j_standard_atmosphere
from arts_tpu.atm.surface import SurfaceField as JSurfaceField
from arts_tpu.path import refraction as JP
from arts_tpu.rtepack import surface as JS
from arts_tpu_torch.atm.standard import standard_atmosphere
from arts_tpu_torch.atm.surface import SurfaceField
from arts_tpu_torch.convert import surface_field_from_numpy
from arts_tpu_torch.path import refraction as P
from arts_tpu_torch.rtepack import surface as S

CPU64 = dict(device="cpu", dtype=torch.float64)
N2 = (1.33, 1.5, 3.2 + 0.5j, 8.0 + 2.0j)
THETA = np.array([0.0, 10.0, 30.0, 53.06, 56.31, 60.0, 85.0, 89.9])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small operations under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_fresnel_matches_jax():
    """The amplitudes at 1e-12 over media and angles, with their normal
    incidence and Brewster limits, total internal reflection's (1, 1),
    complex64 from float32 within 1e-6 of complex128, and finite
    derivatives with respect to n2 and the angle in every branch."""
    for n2 in N2:
        rv, rh = S.fresnel(1.0, n2, THETA, **CPU64)
        jv, jh = JS.fresnel(1.0, n2, jnp.asarray(THETA))
        assert rv.dtype == torch.complex128
        close(rv, jv)
        close(rh, jh)
        r0 = (n2 - 1.0) / (n2 + 1.0)
        np.testing.assert_allclose(rv[0].numpy(), r0, rtol=1e-14)
        np.testing.assert_allclose(rh[0].numpy(), -r0, rtol=1e-14)
        v32, h32 = S.fresnel(1.0, n2, THETA, device="cpu", dtype=torch.float32)
        assert v32.dtype == torch.complex64
        np.testing.assert_allclose(v32.numpy(), rv.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(h32.numpy(), rh.numpy(), rtol=0, atol=1e-6)
    rv, _ = S.fresnel(1.0, 1.33, np.degrees(np.arctan(1.33)), **CPU64)
    assert float(rv.abs()) < 1e-12  # Brewster
    th = np.array([10.0, 41.0, 41.9, 60.0])
    rv, rh = S.fresnel(1.5, 1.0, th, **CPU64)
    jv, jh = JS.fresnel(1.5, 1.0, jnp.asarray(th))
    close(rv, jv)
    close(rh, jh)
    np.testing.assert_array_equal(rv[2:].numpy(), [1.0, 1.0])
    n = torch.tensor(1.5, dtype=torch.float64, requires_grad=True)
    t = torch.tensor([0.0, 30.0, 60.0], dtype=torch.float64, requires_grad=True)
    rv, rh = S.fresnel(1.0, n, t, **CPU64)
    g = torch.autograd.grad((rv.abs() ** 2 + rh.abs() ** 2).sum(), (n, t))
    rv, rh = S.fresnel(n, 1.0, t, **CPU64)  # 60 deg: total internal reflection
    g2 = torch.autograd.grad((rv.abs() ** 2 + rh.abs() ** 2).sum(), (n, t))
    assert all(bool(torch.isfinite(x).all()) for x in g + g2)


def _directions():
    """Incoming directions toward the surface (normal, oblique, grazing) and
    outward normals (flat and tilted)."""
    k = np.array([[0.0, 0.0, -1.0], [0.5, 0.3, -0.8], [-0.2, 0.9, -0.1], [0.0, 0.6, -0.8]])
    n = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.1, -0.2, 0.97], [0.0, 0.0, 1.0]])
    unit = lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True)
    return unit(k), unit(n)


def test_fresnel_mueller_matrices_match_jax():
    """fresnel_reflectance, its specular and non-specular rotations (at
    normal incidence too, and a general outgoing direction) and the
    specular direction at 1e-12, batched; over a flat surface the two
    rotations agree on the specular direction."""
    rv, rh = JS.fresnel(1.0, 2.0 + 0.1j, jnp.asarray([0.0, 40.0, 75.0, 20.0]))
    close(S.fresnel_reflectance(np.asarray(rv), np.asarray(rh), **CPU64),
          JS.fresnel_reflectance(rv, rh))
    k, n = _directions()
    k_out = np.array([0.3, -0.4, 0.866])
    k_out /= np.linalg.norm(k_out)
    jk, jn = jnp.asarray(k), jnp.asarray(n)
    want_dir = np.asarray(JS.specular_reflected_direction(jk, jn))
    got_dir = S.specular_reflected_direction(k, n, **CPU64)
    close(got_dir, want_dir)
    spec = S.fresnel_reflectance_specular(np.asarray(rv), np.asarray(rh), k, n, **CPU64)
    close(spec, np.stack([JS.fresnel_reflectance_specular(rv[i], rh[i], jk[i], jn[i])
                          for i in range(4)]))
    non = S.fresnel_reflectance_nonspecular(np.asarray(rv), np.asarray(rh), k, k_out, n,
                                            **CPU64)
    close(non, np.stack([JS.fresnel_reflectance_nonspecular(rv[i], rh[i], jk[i],
                                                            jnp.asarray(k_out), jn[i])
                         for i in range(4)]))
    same = S.fresnel_reflectance_nonspecular(np.asarray(rv), np.asarray(rh), k, got_dir, n,
                                             **CPU64)
    flat = [0, 1, 3]  # the frames are built about the local vertical
    np.testing.assert_allclose(same.numpy()[flat], spec.numpy()[flat], atol=1e-12)


def test_specular_and_nonspecular_radiance_match_jax():
    """specular_radiance at 1e-12 (batched), and the patch sum of
    nonspecular_radiance_from_patches over a 12 x 13 grid of patches north
    of a north-facing slope at 1e-12: the JAX package's patch test's
    geometry, with random Stokes sources."""
    k, n = _directions()
    rng = np.random.default_rng(5)
    I_in, J = rng.uniform(0.2, 1.0, (4, 4)), rng.uniform(0.2, 1.0, (4, 4))
    rv, rh = JS.fresnel(1.0, 3.2 + 0.5j, jnp.asarray([0.0, 40.0, 75.0, 20.0]))
    want = np.stack([JS.specular_radiance(jnp.asarray(I_in[i]), jnp.asarray(J[i]), rv[i], rh[i],
                                          jnp.asarray(k[i]), jnp.asarray(n[i]))
                     for i in range(4)])
    close(S.specular_radiance(I_in, J, np.asarray(rv), np.asarray(rh), k, n, **CPU64), want)

    lats, lons = np.linspace(0.05, 0.6, 12), np.linspace(-0.3, 0.3, 13)
    LA, LO = np.meshgrid(lats, lons, indexing="ij")
    coords = np.stack([LA.ravel(), LO.ravel()], -1)
    alts = rng.uniform(0.0, 300.0, coords.shape[0])
    sources = rng.uniform(0.1, 1.0, (coords.shape[0], 4))
    Jp = np.array([0.5, 0.01, -0.02, 0.0])
    k_out = np.array([0.3, 0.0, 0.95]) / np.hypot(0.3, 0.95)
    args = (np.array([0.0, 0.0]), 2000.0, np.array([0.0, 0.0, 1.0]), k_out, 6.371e6,
            float(lats[1] - lats[0]), float(lons[1] - lons[0]))
    outs = []
    for rv, rh in ((0.7 + 0.0j, 0.6 + 0.1j), (0.0j, 0.0j)):
        want = JS.nonspecular_radiance_from_patches(
            jnp.asarray(coords), jnp.asarray(alts), jnp.asarray(sources), jnp.asarray(Jp),
            jnp.asarray(rv), jnp.asarray(rh), *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                               else a for a in args))
        got = S.nonspecular_radiance_from_patches(coords, alts, sources, Jp, rv, rh, *args,
                                                  **CPU64)
        close(got, want)
        outs.append(float(got[0]))
    assert outs[0] > Jp[0] and outs[1] == Jp[0]  # reflected light; the emission alone


def test_surface_field_matches_jax():
    """SurfaceField.at at interior and clamped points of a 3 x 4 grid and on
    a constant (1 x 1) field at 1e-12, surface_field_from_numpy."""
    rng = np.random.default_rng(2)
    lat, lon = np.array([-10.0, 0.0, 25.0]), np.array([0.0, 20.0, 30.0, 90.0])
    props = {k: rng.uniform(0.5, 300.0, (3, 4)) for k in ("temperature", "elevation",
                                                         "emissivity")}
    jf = JSurfaceField(lat=jnp.asarray(lat), lon=jnp.asarray(lon),
                       **{k: jnp.asarray(v) for k, v in props.items()})
    pf = surface_field_from_numpy(dict(lat=lat, lon=lon, **props), **CPU64)
    qlat = np.array([-20.0, -10.0, 3.0, 24.9, 40.0, 0.0])
    qlon = np.array([45.0, -5.0, 25.0, 90.0, 100.0, 20.0])
    for fp, fj in ((pf, jf), (SurfaceField.constant(271.0, 12.0, 0.93, **CPU64),
                              JSurfaceField.constant(271.0, 12.0, 0.93))):
        got, want = fp.at(qlat, qlon), fj.at(jnp.asarray(qlat), jnp.asarray(qlon))
        for key in want:
            close(got[key], want[key])
        one = fp.at(3.0, 25.0)
        assert one["temperature"].shape == ()
    close(pf.at(-20.0, 100.0)["temperature"], props["temperature"][0, -1])


def test_refraction_matches_jax():
    """microwave_refractivity on arrays and tensors, refractivity_profile of
    the standard atmosphere with and without H2O, and refracted_path_1d
    (up, a limb path through a refracted tangent point, down to the
    surface, from inside and above the atmosphere) at 1e-12 of the JAX
    package's numpy; the same background."""
    p, t, h = np.array([101325.0, 5e4, 100.0]), np.array([288.0, 250.0, 220.0]), 0.01
    close(P.microwave_refractivity(p, t, h), JP.microwave_refractivity(p, t, h))
    close(P.microwave_refractivity(torch.tensor(p), torch.tensor(t), h),
          JP.microwave_refractivity(p, t, h))
    species = ("H2O", "N2", "O2")
    patm = standard_atmosphere(n_levels=41, z_top=80e3, species=species, **CPU64)
    jatm = j_standard_atmosphere(n_levels=41, z_top=80e3, species=species)
    for idx in (None, 0):
        for a, b in zip(P.refractivity_profile(patm, h2o_index=idx),
                        JP.refractivity_profile(jatm, h2o_index=idx)):
            close(a, b)
    z_n, n = JP.refractivity_profile(jatm, h2o_index=0)
    for args in ((0.0, 45.0), (100e3, 99.65), (100e3, 170.0), (20e3, 95.0), (5e3, 30.0)):
        got = P.refracted_path_1d(*args, 0.0, 80e3, torch.tensor(z_n), n, max_step=2000.0)
        want = JP.refracted_path_1d(*args, 0.0, 80e3, z_n, n, max_step=2000.0)
        assert got.background == want.background
        for key in ("alt", "s", "za"):
            close(getattr(got, key), getattr(want, key))
    assert dataclasses.is_dataclass(got)
