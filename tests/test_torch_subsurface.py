"""The port's subsurface emission (atm/subsurface.py) against arts_tpu on
the CPU at float64, on the same inputs: the layer recursion, and the
DISORT solve of all frequencies in one call (the fused route, whose
kernels run their plain versions on CPU tensors) at 8 and 16 streams
with volume scattering and downwelling illumination; DISORT against the
recursion at every upwelling angle; and scene.build_subsurface_case at a
small size.

The JAX references are compiled with `ref_jit`, each stream count's as
one function."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.atm.subsurface import SubsurfaceField as JSub
from arts_tpu_torch import fwd as F
from arts_tpu_torch.convert import subsurface_field_from_numpy
from arts_tpu_torch.ops.planck import planck
from arts_tpu_torch.path import geometric_path_1d
from arts_tpu_torch.scene import build_predef_scene, build_subsurface_case

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
FREQ = np.array([1.4e9, 18.7e9, 89e9])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small operations under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field(nd=21, seed=4):
    """A 2 m column warming with depth, absorption [ND, F] growing with
    frequency, and HG scattering that fades with depth."""
    rng = np.random.default_rng(seed)
    z = np.linspace(0.0, 2.0, nd)
    k = (0.5 + rng.uniform(0.0, 0.5, (nd, 1))) * (FREQ / 1e9) ** 0.8 * 0.3
    return dict(depth=z, t=250.0 + 6.0 * z + rng.uniform(-1.0, 1.0, nd), absorption=k,
                ssa=0.6 * np.exp(-z / 0.7), g=0.4 * np.exp(-z / 1.0))


@functools.partial(ref_jit, static_argnames="nquad")
def _disort_ref(sub, f, I_down, nquad):
    out = sub.emerging_radiance_disort(f, I_down=I_down, nquad=nquad)
    return out.u0, out.flux_up


def close(got, want, rtol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def test_emerging_radiance_matches_jax():
    """The recursion at 1e-12 along three directions, with absorption [ND]
    and [ND, F]; subsurface_field_from_numpy."""
    d = _field()
    for k in (d["absorption"], d["absorption"][:, 0]):
        dd = dict(d, absorption=k)
        sub = subsurface_field_from_numpy(dd, **CPU64)
        jsub = JSub(**{key: jnp.asarray(v) for key, v in dd.items()})
        for mu in (1.0, 0.6, 0.2):
            close(sub.emerging_radiance(FREQ, mu=mu, **CPU64),
                  jsub.emerging_radiance(jnp.asarray(FREQ), mu=mu))


@pytest.mark.parametrize("nquad", [8, 16])
def test_emerging_radiance_disort_matches_jax(nquad):
    """All frequencies in one disort() call on the fused route (its kernels'
    plain versions here) against the JAX package's vmapped solve, with
    volume scattering and a downwelling illumination, at
    tests/test_fused_disort.py's rtol 2e-5: the intensities at every level
    and angle, and the upward flux; DisortOutput.mu is [nquad]."""
    d = _field()
    sub = subsurface_field_from_numpy(d, **CPU64)
    jsub = JSub(**{key: jnp.asarray(v) for key, v in d.items()})
    I_down = planck(torch.tensor(FREQ), torch.tensor(120.0))
    out = sub.emerging_radiance_disort(FREQ, I_down=I_down, nquad=nquad, **CPU64)
    u0, flux_up = _disort_ref(jsub, jnp.asarray(FREQ), jnp.asarray(I_down.numpy()), nquad)
    assert out.mu.shape == (nquad,) and out.u0.shape == (FREQ.size, 21, nquad)
    close(out.u0, u0, rtol=2e-5)
    close(out.flux_up, flux_up, rtol=2e-5)
    plain = sub.emerging_radiance_disort(FREQ, I_down=I_down, nquad=nquad, fast_linalg=False,
                                         **CPU64)
    close(plain.u0, out.u0, rtol=2e-5)


def test_disort_matches_recursion_at_every_angle():
    """A purely absorbing column (5 m, 2 /m, warming 8 K/m with depth):
    DISORT's emerging radiance against the recursion along each upwelling
    quadrature direction, at 201 levels within 1e-4 (4.6e-5 measured).

    The gap is the recursion's discretization of the source (the layer
    mean of the Planck radiance), which shrinks about as dz^2: at 21
    levels it is 2.8e-3, and tests/test_geo_3d.py::
    test_subsurface_disort_matches_recursion_absorbing, which holds it at
    1e-6 there, compares nothing (its loop runs over the empty
    out.mu[4:] of a [2, 8] array).  Also the isothermal closure: with
    I_down = B(T) and no scattering the column emits B(T), held at 1e-6 as
    chip_smoke.py holds it (the solve's rounding over 200 thin layers reads
    ~7e-8 here)."""
    for nd, lim, what in ((201, 1e-4, "within"), (21, 1e-3, "beyond")):
        depth = np.linspace(0.0, 5.0, nd)
        sub = subsurface_field_from_numpy(dict(depth=depth, t=260.0 + 8.0 * depth,
                                               absorption=np.full(nd, 2.0)), **CPU64)
        f = np.array([10e9, 90e9])
        out = sub.emerging_radiance_disort(f, nquad=8, **CPU64)
        gaps = [float(((out.u0[:, 0, 4 + i] - rec) / rec).abs().max())
                for i, mu in enumerate(out.mu[4:])
                for rec in [sub.emerging_radiance(f, mu=float(mu), **CPU64)]]
        assert len(gaps) == 4
        assert (max(gaps) <= lim) == (what == "within"), (nd, gaps)
    iso = subsurface_field_from_numpy(dict(depth=depth, t=np.full(nd, 250.0),
                                           absorption=np.full(nd, 0.3)), **CPU64)
    B = planck(torch.tensor(f), torch.tensor(250.0))
    out = iso.emerging_radiance_disort(f, I_down=B, nquad=16, **CPU64)
    close(out.u0[:, 0, 8:], B[:, None].expand(-1, 8), rtol=1e-6)


def test_build_subsurface_case_small():
    """build_subsurface_case at 21 levels, 6 frequencies and a 12-level sky:
    218.5 K at depth, absorption rising with frequency at every depth,
    I_down the zenith sky's downwelling radiance (simulate_clearsky),
    below the sky's warmest Planck radiance; the emerging radiance in
    float32 within 5e-3 of float64 on the same inputs (chip_smoke.py's u0
    guard), and between the smaller and above the larger of the sky's
    radiance and the column's coldest and warmest Planck radiances."""
    c = build_subsurface_case(n_lev=21, n_freq=6, n_atm=12, device="cpu", dtype=torch.float32)
    fld = c.field
    assert c.nquad == 16 and fld.absorption.shape == (21, 6)
    assert abs(float(fld.t[-1]) - 218.5) < 1e-3
    assert bool((fld.absorption.diff(dim=1) > 0).all())
    allsky, _ = build_predef_scene(n_lev=12, n_freq=2, device="cpu", dtype=torch.float32)
    sky = F.ClearskyScene(atm=allsky.atm, cat=None, pf=None, predef=allsky.predef,
                          species_names=allsky.species_names)
    up = geometric_path_1d(0.0, 0.0, 0.0, float(sky.atm.z[-1]), 1000.0)
    want = F.simulate_clearsky(sky, c.f_grid, up.alt, up.dr, device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(c.I_down.numpy(), want.numpy())
    assert bool((c.I_down > 0).all() and (c.I_down < planck(c.f_grid, sky.atm.t.max())).all())
    u32 = fld.emerging_radiance_disort(c.f_grid, c.I_down, nquad=c.nquad, device="cpu",
                                       dtype=torch.float32).u0[:, 0, c.nquad // 2:]
    u64 = fld.emerging_radiance_disort(c.f_grid, c.I_down, nquad=c.nquad, **CPU64).u0[
        :, 0, c.nquad // 2:]
    assert float((u32.double() - u64).abs().max()) <= 5e-3 * float(u64.abs().max())
    f64, t64, sky64 = c.f_grid.double(), fld.t.double(), c.I_down.double()[:, None]
    lo = torch.minimum(planck(f64, t64.min())[:, None], sky64)
    hi = torch.maximum(planck(f64, t64.max())[:, None], sky64)
    assert bool(((u64 > lo) & (u64 < hi)).all())
