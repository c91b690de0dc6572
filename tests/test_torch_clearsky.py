"""The port's clear-sky scalar path (arts_tpu_torch) against arts_tpu on the
CPU at float64, on identical inputs made with numpy: the emission
recursions, wofz's derivative rule, simulate_clearsky (three backgrounds x
three rte_options, and a wind case), simulate_clearsky_bt, the level
cache on both routes, temperature and H2O-VMR Jacobians against
jax.jacrev, and one Gauss-Newton step of the water-vapour retrieval;
and the dense route's float32 line centres against its float64.

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
from arts_tpu.ops import wofz as JW
from arts_tpu.path import geometric_path_1d
from arts_tpu.retrieval import StateMapping as JStateMapping
from arts_tpu.retrieval import oem as j_oem
from arts_tpu.rtepack import emission as JE
from arts_tpu.sensor import gaussian_channels as j_gaussian_channels
from arts_tpu_torch import fwd as F
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.lbl.voigt import absorption
from arts_tpu_torch.ops.wofz import wofz
from arts_tpu_torch.retrieval import oem
from arts_tpu_torch.rtepack import emission as E
from arts_tpu_torch.scene import build_clearsky_retrieval, build_scene
from test_clearsky import make_scene
from test_oem import vmr_targets

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


def test_batched_recursion_is_per_path():
    """A [np, G, F] batch with per-path layer lengths gives each path's own
    radiance (the layout the observers use)."""
    k, J, r, I0 = _emission_inputs(6)
    k2, J2, r2, _ = _emission_inputs(7)
    for fn in (E.emission_unpolarized, E.emission_unpolarized_linprop):
        both = fn(T(np.stack([k, k2], 1)), T(np.stack([J, J2], 1)),
                  T(np.stack([r, r2], 1)), T(I0))
        for g, (kk, JJ, rr) in enumerate(((k, J, r), (k2, J2, r2))):
            np.testing.assert_array_equal(both[g].numpy(),
                                          fn(T(kk), T(JJ), T(rr), T(I0)).numpy())


def test_wofz_derivative_matches_jax_custom_jvp():
    """d Re w / d(x, y) and d Im w / d(x, y) by jacfwd (the jvp rule) and
    jacrev (the backward rule) against jax.jacfwd / jax.jacrev through the
    JAX package's custom_jvp, inside the far gate and beyond it, and under
    vmap."""
    x = np.array([0.0, 0.3, 2.5, 8.0, 15.0, 22.0, 40.0, 300.0])
    y = np.array([1e-3, 0.5, 1.0, 3.0, 0.2, 10.0, 25.0, 1e-2])

    def jf(v):
        w = JW.wofz(jax.lax.complex(v[0], v[1]))
        return jnp.stack([w.real, w.imag])

    def tf(v):
        w = wofz(torch.complex(v[0], v[1]))
        return torch.stack([w.real, w.imag])

    v = np.stack([x, y])
    wants = ref_jit(lambda v: [jax.vmap(jt(jf), 1)(v) for jt in (jax.jacfwd, jax.jacrev)])(
        jnp.asarray(v))
    for want, tt in zip(wants, (torch.func.jacfwd, torch.func.jacrev)):
        want = np.asarray(want)
        got = torch.func.vmap(tt(tf), 1)(T(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("bg", BACKGROUNDS)
@pytest.mark.parametrize("opt", OPTIONS)
def test_simulate_clearsky_matches_jax(case, bg, opt):
    """Every background (emissivity 0.8) x rte_option at 1e-10 of scale."""
    ps, _, path, ref = case
    got = F.simulate_clearsky(ps, FREQ, path.alt, path.dr, background=bg, rte_option=opt,
                              **CPU64)
    close(got.numpy(), ref[f"{bg}/{opt}"], atol_scale=1e-10)


def test_wind_and_bt_match_jax(case):
    """A wind profile shifts each point's grid by its line-of-sight speed
    (a slant path, azimuth 30 deg); and the brightness temperatures of
    simulate_clearsky_bt; both at 1e-10 of scale."""
    ps, pw, nadir, ref = case
    path = WIND_PATH
    kw = dict(background="surface", path_za=path.za, path_aa=np.full(path.za.shape, WIND_AA))
    got = F.simulate_clearsky(pw, FREQ, path.alt, path.dr, **kw, **CPU64).numpy()
    still = F.simulate_clearsky(ps, FREQ, path.alt, path.dr, **kw, **CPU64).numpy()
    want = ref["wind"]
    assert np.abs(got - still).max() > 1e-3 * np.abs(want - still).max() > 0
    close(got, want, atol_scale=1e-10)
    bt = F.simulate_clearsky_bt(ps, FREQ, nadir.alt, nadir.dr, background="surface", **CPU64)
    close(bt.numpy(), ref["bt"], atol_scale=1e-10)


def test_gas_absorption_levels_match_jax(case):
    """The level cache: "xla" against JAX's "xla" at 1e-10 of scale;
    "pallas" (the Voigt kernel's plain version on the CPU) against JAX's
    "xla" at the JAX package's Pallas-vs-XLA bound (atol 5e-7 * scale,
    rtol 2e-6, tests/test_tpu_kernels.py:22,59)."""
    ps, _, _, ref = case
    want = ref["levels"]
    assert want.shape == (N_LEV, FREQ.size)
    xla = F.gas_absorption_levels(ps, FREQ, **CPU64).numpy()
    close(xla, want, atol_scale=1e-10)
    pallas = F.gas_absorption_levels(ps, FREQ, backend="pallas", **CPU64).numpy()
    np.testing.assert_allclose(pallas, want, rtol=2e-6, atol=5e-7 * np.abs(want).max())


def test_dense_route_float32_keeps_shifted_centres():
    """The dense route in float32 against float64 on the same inputs
    within 2 MHz of four bench lines at 54-80 km, where Doppler widths
    are ~20 float32 spacings of f0: within 1e-5 of each level's largest
    value.  Forming the shifted centre f0 + shift in float32 before
    f - f0 moved it by 2 % of that."""
    scene, _ = build_scene(n_lev=60, n_freq=8, n_lines=16, device="cpu", dtype=torch.float32)
    cat, atm, top = scene.cat, scene.atm, slice(40, 60)
    for f0 in cat.f0[:4].tolist():
        f = torch.tensor(f0 + np.linspace(-2e6, 2e6, 101), dtype=torch.float32)
        k32, k64 = (absorption(f, cat, scene.pf, atm.t[top], atm.p[top], atm.vmr[:, top].T,
                               device="cpu", dtype=dt) for dt in (torch.float32, torch.float64))
        err = (k32.double() - k64).abs().amax(-1) / k64.abs().amax(-1)
        assert float(err.max()) < 1e-5, (f0, err.max())


def test_jacobians_match_jax_jacrev():
    """d I / d (T, VMR0) of simulate_clearsky over the surface by
    torch.func.jacfwd (through wofz's rule) against jax.jacrev: each column
    within 1e-8 of its largest entry plus 1e-14 of the largest entry of its
    field's block.  The second term is float64 roundoff: in the upper
    levels the temperature columns are 1e-16 of the block's scale, and
    JAX's own jacfwd and jacrev differ there by as much as the port does.
    linprop over the reflecting surface on the path padded with
    zero-length layers gives the unpadded path's finite Jacobian in both
    modes (JAX's reverse mode is NaN there, ROADMAP §C).  make_scene at 21
    levels, a nadir path in 4 km steps, 15 frequencies."""
    js = dataclasses.replace(make_scene(21), surface_emissivity=jnp.asarray(0.8))
    ps = clearsky_scene_from_numpy(scene_numpy(js), **CPU64)
    path = geometric_path_1d(100e3, 180.0, 0.0, 80e3, 4000.0)
    freq = FREQ[::7]
    n = 21

    def j_fn(x):
        atm = dataclasses.replace(js.atm, t=x[:n], vmr=js.atm.vmr.at[0].set(x[n:]))
        return JF.simulate_clearsky(dataclasses.replace(js, atm=atm), jnp.asarray(freq),
                                    jnp.asarray(path.alt), jnp.asarray(path.dr),
                                    background="surface")

    def t_fn(alt, dr, **kw):
        def fn(x):
            atm = dataclasses.replace(ps.atm, t=x[:n],
                                      vmr=torch.cat([x[None, n:], ps.atm.vmr[1:]]))
            return F.simulate_clearsky(dataclasses.replace(ps, atm=atm), freq, alt, dr,
                                       **kw, **CPU64)
        return fn

    x0 = np.concatenate([np.asarray(js.atm.t), np.asarray(js.atm.vmr[0])])
    want = np.asarray(ref_jit(jax.jacrev(j_fn))(jnp.asarray(x0)))
    got = torch.func.jacfwd(t_fn(path.alt, path.dr, background="surface"))(T(x0)).numpy()
    for blk in (slice(0, n), slice(n, 2 * n)):
        w, g = want[:, blk], got[:, blk]
        col = np.abs(w).max(0)
        assert (col > 0).all()
        np.testing.assert_array_less(np.abs(g - w).max(0), 1e-8 * col + 1e-14 * col.max())

    kw = dict(background="surface_reflect", rte_option="linprop")
    alt = np.concatenate([path.alt, [path.alt[-1]] * 3])
    dr = np.concatenate([path.dr, [0.0] * 3])
    for jac in (torch.func.jacfwd, torch.func.jacrev):
        base = jac(t_fn(path.alt, path.dr, **kw))(T(x0)).numpy()
        padded = jac(t_fn(alt, dr, **kw))(T(x0)).numpy()
        assert np.isfinite(padded).all()
        for blk in (slice(0, n), slice(n, 2 * n)):
            np.testing.assert_allclose(padded[:, blk], base[:, blk], rtol=1e-12,
                                       atol=1e-14 * np.abs(base[:, blk]).max())


def test_gauss_newton_step_matches_jax():
    """One GN step of build_clearsky_retrieval (float64) against the JAX
    package's oem on the same state and measurement: its scene is make_scene
    and its channels tests/test_oem.py's; the step within 1e-8."""
    case = build_clearsky_retrieval(**CPU64)
    js = make_scene()
    for a, b in ((case.scene.atm.t, js.atm.t), (case.scene.atm.p, js.atm.p),
                 (case.scene.atm.vmr, js.atm.vmr), (case.scene.cat.f0, js.cat.f0)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13)
    sensor = j_gaussian_channels(np.asarray(case.f_grid), np.linspace(175e9, 235e9, 25), 2e9)
    np.testing.assert_allclose(case.sensor.w.numpy(), np.asarray(sensor.w), rtol=1e-15)
    mapping = JStateMapping(targets=[vmr_targets()], ref_scene=js)
    f, alt, dr = (jnp.asarray(x.numpy()) for x in (case.f_grid, case.alt, case.dr))

    def j_forward(x):
        I = JF.simulate_clearsky(mapping.to_scene(x), f, alt, dr, background="surface")
        return sensor.apply(I[None, :])

    y_obs = jnp.asarray(case.y_obs.numpy())
    # oem jits j_forward again, which reuses this compile
    np.testing.assert_allclose(np.asarray(jax.jit(j_forward)(jnp.asarray(case.x_true.numpy()))),
                               case.y_obs.numpy(), rtol=1e-10)
    S_a, S_e = jnp.asarray(case.S_a.numpy()), jnp.diag(jnp.asarray(case.S_e.numpy()))
    want = j_oem(j_forward, jnp.ones(case.x_a.numel()), y_obs, S_a, S_e, method="gn",
                 max_iter=1)
    got = oem(case.forward, case.x_a, case.y_obs, case.S_a, case.S_e, method="gn",
              max_iter=1, device="cpu")
    assert got.n_iter == want.n_iter == 1
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0, atol=1e-8)
