"""The port's clear-sky scalar path (arts_tpu_torch) against arts_tpu on the
CPU at float64, on identical inputs made with numpy: the scalar and
polarized emission recursions here, and the fixtures of the files that
hold the rest of the path, seven cases or fewer each:
test_torch_clearsky_paths.py (simulate_clearsky, constant and lintau over
three backgrounds, a wind case, simulate_clearsky_bt),
test_torch_clearsky_levels.py (linprop, the level cache on both routes,
the dense route's float32 line centres, Jacobians against jax.jacrev,
one Gauss-Newton step of the water-vapour retrieval) and
test_torch_clearsky_wofz.py (the batched recursion, wofz's derivative
rule).

The JAX references are compiled with `ref_jit`, each fixture's as one
function, so that each is traced and compiled once for all the cases
that read it."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import fwd as JF
from arts_tpu.path import geometric_path_1d
from arts_tpu.rtepack import emission as JE
from arts_tpu_torch import fwd as F
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.rtepack import emission as E
from test_clearsky import make_scene

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
N_LEV = 51
FREQ = np.linspace(170e9, 240e9, 101)
BACKGROUNDS = ("space", "surface", "surface_reflect")
# jax.jit with LLVM's optimizations off: each operation rounds as it does
# op by op, with no multiply and add contracted across operations.  With
# them on, a path point's interpolated temperature can land one ulp to the
# other side of a partition-function grid node (make_scene's temperatures
# are whole kelvins, on the nodes), where the temperature Jacobian has a
# kink, and JAX's own columns there move by 4e-5.
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
OPTIONS = ("constant", "lintau", "linprop")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the recursions' many small operations wait on
    the whole thread pool after each one when test workers share cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_numpy(js):
    """A JAX ClearskyScene's leaves as numpy (clearsky_scene_from_numpy's input)."""
    leaves = lambda o: {f.name: np.asarray(getattr(o, f.name))
                        for f in dataclasses.fields(o) if getattr(o, f.name) is not None}
    return {"atm": leaves(js.atm), "cat": leaves(js.cat), "pf": leaves(js.pf),
            "surface_temperature": np.asarray(js.surface_temperature),
            "surface_emissivity": np.asarray(js.surface_emissivity)}


def close(got, want, rtol=0.0, atol_scale=0.0):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


WIND = lambda z: np.stack([40.0 * np.sin(z / 2e4), 30.0 + 0 * z, 0.1 * np.cos(z / 1e4)])
WIND_PATH = geometric_path_1d(100e3, 130.0, 0.0, 80e3, 8000.0)
WIND_AA = 30.0


@ref_jit
def _clearsky_refs(js, jw, f, alt, dr, walt, wdr, wza, waa):
    """The JAX references of the case fixture, compiled as one function:
    every background x rte_option, the brightness temperatures and the
    level cache on the nadir path, and the wind case on its slant path."""
    out = {f"{bg}/{opt}": JF.simulate_clearsky(js, f, alt, dr, background=bg, rte_option=opt)
           for bg in BACKGROUNDS for opt in OPTIONS}
    out["bt"] = JF.simulate_clearsky_bt(js, f, alt, dr, background="surface")
    out["levels"] = JF.gas_absorption_levels(js, f)
    out["wind"] = JF.simulate_clearsky(jw, f, walt, wdr, background="surface", path_za=wza,
                                       path_aa=waa)
    return out


@pytest.fixture(scope="module")
def case():
    """make_scene with a reflecting surface (emissivity 0.8), a nadir path
    in 1 km steps and tests/test_clearsky.py's 101 frequencies; both
    packages' scenes, the same scene with a wind profile, and the JAX
    references of every case that uses them."""
    js = dataclasses.replace(make_scene(N_LEV), surface_emissivity=jnp.asarray(0.8))
    path = geometric_path_1d(100e3, 180.0, 0.0, 80e3, 1000.0)
    ps = clearsky_scene_from_numpy(scene_numpy(js), **CPU64)
    wind = WIND(np.asarray(js.atm.z))
    jw = dataclasses.replace(js, atm=dataclasses.replace(js.atm, wind=jnp.asarray(wind)))
    pw = dataclasses.replace(ps, atm=dataclasses.replace(ps.atm, wind=T(wind)))
    wp = WIND_PATH
    ref = _clearsky_refs(js, jw, *map(jnp.asarray, (FREQ, path.alt, path.dr, wp.alt, wp.dr,
                                                     wp.za, np.full(wp.za.shape, WIND_AA))))
    return ps, pw, path, {k: np.asarray(v) for k, v in ref.items()}


def _emission_inputs(seed, npts=81, nf=FREQ.size, pol=False):
    rng = np.random.default_rng(seed)
    r = rng.uniform(200.0, 3000.0, npts - 1)
    r[4] = 0.0  # a padded (zero-length) layer
    if pol:
        k = rng.normal(size=(npts, nf, 7)) * 1e-5
        k[..., 0] = rng.uniform(1e-5, 1e-3, (npts, nf))
        J = rng.uniform(0.5, 2.0, (npts, nf, 4)) * [1.0, 0.1, 0.1, 0.1]
        return k, J, r, rng.uniform(0.5, 2.0, (nf, 4))
    # absorption from 1e-7 to 1e-3 /m: thin and thick layers, both slope
    # signs, and slopes on both sides of linprop's 1e-6 gate
    k = 10.0 ** rng.uniform(-7.0, -3.0, (npts, nf))
    k[6:8] = k[5] * (1.0 + rng.uniform(-1e-7, 1e-7, (2, nf)))
    k[12:14] = k[11] * (1.0 + rng.uniform(-1e-3, 1e-3, (2, nf)))
    J = rng.uniform(0.5, 2.0, (npts, nf))
    return k, J, r, rng.uniform(0.5, 2.0, nf)


SCALAR_FORMS = [("emission_unpolarized", 1e-12), ("emission_unpolarized_pscan", 1e-12),
                ("emission_unpolarized_linsrc", 1e-12), ("emission_unpolarized_linprop", 1e-10)]
POLARIZED_FORMS = ["emission_polarized_linsrc", "emission_polarized_linprop",
                   "cumulative_transmittance"]


@ref_jit
def _emission_refs(scalar, polarized):
    """JAX's scalar forms of the scalar inputs, and its polarized lintau,
    linprop and cumulative transmittance of the polarized ones, compiled
    as one function."""
    out = {name: getattr(JE, name)(*scalar) for name, _ in SCALAR_FORMS}
    k, J, r, I0 = polarized
    out["emission_polarized_linsrc"] = JE.emission_polarized_linsrc(k, J, r, I0)
    out["emission_polarized_linprop"] = JE.emission_polarized_linprop(k, J, r, I0)
    out["cumulative_transmittance"] = JE.cumulative_transmittance(10.0 * k, r)
    return out


@pytest.fixture(scope="module")
def emission():
    """Random scalar layers (81 points) and polarized layers (21 points, 15
    frequencies), each with a zero-length layer, and JAX's forms of them."""
    scalar = _emission_inputs(3)
    polarized = _emission_inputs(4, npts=21, nf=15, pol=True)
    want = _emission_refs(*(tuple(map(jnp.asarray, a)) for a in (scalar, polarized)))
    return scalar, polarized, {n: np.asarray(v) for n, v in want.items()}


@pytest.mark.parametrize("name,tol", SCALAR_FORMS)
def test_scalar_emission_matches_jax(emission, name, tol):
    """Each scalar recursion on random absorption (zero-length layer
    included) against JAX's; linprop, through the erfcx / Dawson parts, at
    1e-10 of scale, the rest at rtol 1e-12."""
    (k, J, r, I0), _, want = emission
    if name.endswith("linprop"):
        d = np.abs(k[1:] - k[:-1]) * r[:, None] / 2
        assert ((d > 0) & (d < 1e-6)).any() and (d > 1e-6).any()
        assert (k[1:] > k[:-1]).any() and (k[1:] < k[:-1]).any()
    got = getattr(E, name)(T(k), T(J), T(r), T(I0)).numpy()
    if tol == 1e-12:
        close(got, want[name], rtol=tol)
    else:
        close(got, want[name], atol_scale=tol)


@pytest.mark.parametrize("name", POLARIZED_FORMS)
def test_polarized_emission_matches_jax(emission, name):
    _, (k, J, r, I0), want = emission
    args = (T(10.0 * k), T(r)) if name == "cumulative_transmittance" else map(T, (k, J, r, I0))
    got = getattr(E, name)(*args).numpy()
    close(got, want[name], rtol=1e-12, atol_scale=1e-14)


def check_simulate_clearsky(case, bg, opt):
    """simulate_clearsky for one background (emissivity 0.8) and
    rte_option at 1e-10 of scale (test_simulate_clearsky_matches_jax, its
    cases in test_torch_clearsky_paths.py and _levels.py)."""
    ps, _, path, ref = case
    got = F.simulate_clearsky(ps, FREQ, path.alt, path.dr, background=bg, rte_option=opt,
                              **CPU64)
    close(got.numpy(), ref[f"{bg}/{opt}"], atol_scale=1e-10)
