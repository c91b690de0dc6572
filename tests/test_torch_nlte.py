"""The port's non-LTE band (arts_tpu_torch.lbl.nlte and simulate_clearsky
with scene.nlte) against arts_tpu on the CPU at float64, on identical
inputs made with numpy: the amplitudes and the absorption and source with
Boltzmann and with inverted populations, the statistical-equilibrium
helpers, the line profiles and the mean intensity, the population fit in
tests/test_nlte.py's two regimes, and the clear-sky radiance of its
two-level band.  Each within 1e-10 of the reference's largest value
unless stated.  The JAX references of each fixture are compiled as one
function with `ref_jit`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.constants as jconst
from arts_tpu import fwd as JF
from arts_tpu.lbl import nlte as JN
from arts_tpu_torch import fwd as F
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.lbl import nlte as N
from arts_tpu_torch.lbl.catalog import LineCatalog, catalog_from_arrays
from test_nlte import (
    VMR,
    _boltzmann,
    _nadir_scene_pair,
    _two_level_setup,
    lte_populations,
)
from test_nlte import F as F_LINE
from test_nlte import P as P_LINE
from test_nlte import T as T_LINE
from test_zeeman import CAT

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
# three atmospheric points for the batched forms
PTS_T, PTS_P = np.array([210.0, 250.0, 288.0]), np.array([2e2, 5e4, 1e5])


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under parallel test workers the thread pool's
    waits after each small operation cost more than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cat(jcat):
    return catalog_from_arrays({f.name: np.asarray(getattr(jcat, f.name))
                                for f in dataclasses.fields(LineCatalog)}, "cpu", torch.float64)


def close(got, want, atol_scale=1e-10, rtol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max())


POPULATIONS = {"lte": lte_populations(T_LINE), "inverted": (0.9, 0.1)}


@pytest.fixture(scope="module")
def line_refs():
    """JAX's amplitudes and absorption/source of tests/test_nlte.py's line
    for each population, at its point and batched over PTS (populations
    scaled per point), compiled as one function."""

    @ref_jit
    def refs(f, pts_t, pts_p, pops):
        out = {}
        for name, (ru, rl) in pops.items():
            ru, rl = jnp.asarray([ru]), jnp.asarray([rl])
            one = (T_LINE, P_LINE, VMR, ru, rl)
            scale = jnp.linspace(0.8, 1.2, 3)[:, None]
            many = (pts_t, pts_p, jnp.broadcast_to(VMR, (3, 1)), ru * scale, rl / scale)
            out[name] = dict(
                amp=JN.nlte_amplitudes(CAT, *one),
                abs_src=JN.nlte_absorption_source(f, CAT, *one),
                amp_b=jax.vmap(lambda *a: JN.nlte_amplitudes(CAT, *a))(*many),
                abs_src_b=jax.vmap(lambda *a: JN.nlte_absorption_source(f, CAT, *a))(*many))
        return out

    out = refs(F_LINE, jnp.asarray(PTS_T), jnp.asarray(PTS_P),
               {k: tuple(map(float, v)) for k, v in POPULATIONS.items()})
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.mark.parametrize("populations", sorted(POPULATIONS))
def test_amplitudes_absorption_and_source_match_jax(line_refs, populations):
    """Boltzmann populations (the source excess vanishes) and an inverted
    pair (negative absorption), at one point and batched over three."""
    ru, rl = POPULATIONS[populations]
    want = line_refs[populations]
    cat = port_cat(CAT)
    one = (T(T_LINE), T(P_LINE), T(np.asarray(VMR)), T([ru]), T([rl]))
    scale = T(np.linspace(0.8, 1.2, 3))[:, None]
    many = (T(PTS_T), T(PTS_P), T(np.broadcast_to(np.asarray(VMR), (3, 1))), ru * scale,
            rl / scale)
    amp = lambda *a: N.nlte_amplitudes(cat, *a)
    abs_src = lambda *a: N.nlte_absorption_source(T(F_LINE), cat, *a)
    for fn, args, w in ((amp, one, want["amp"]), (abs_src, one, want["abs_src"]),
                        (amp, many, want["amp_b"]), (abs_src, many, want["abs_src_b"])):
        got = fn(*args)
        # the source's spontaneous term alone (rl = 0): with Boltzmann
        # populations the source cancels to roundoff of that term
        term = fn(*args[:4], 0.0 * args[4])[1].abs().max()
        for i, (g, ww) in enumerate(zip(got, w)):
            if i == 1:
                np.testing.assert_allclose(g.numpy(), ww, rtol=1e-12, atol=1e-10 * float(term))
            else:
                close(g, ww, rtol=1e-12)
    alpha, src = N.nlte_absorption_source(T(F_LINE), cat, *one)
    if populations == "lte":
        assert float(src.abs().max()) < 1e-9 * float((alpha * T_LINE).abs().max())
    else:
        assert float(alpha.min()) < 0 < float(src.max())


def test_statistical_equilibrium_helpers_match_jax():
    """statistical_equilibrium on random batched 4-level rate matrices with
    a scalar and a per-batch total, two_level_rates and boltzmann_ratios,
    to 1e-12 relative."""
    rng = np.random.default_rng(7)
    W = rng.uniform(0.0, 2.0, (5, 4, 4))
    tot = rng.uniform(0.5, 1.5, 5)
    for norm in (1.0, tot):
        close(N.statistical_equilibrium(T(W), T(norm)),
              JN.statistical_equilibrium(jnp.asarray(W), jnp.asarray(norm)), 1e-12, 1e-12)
    J = rng.uniform(0.0, 1e3, 6)
    args = (1.0, 2.0, 3.0, 0.5, 0.25)
    close(N.two_level_rates(*args, T(J)), JN.two_level_rates(*args, jnp.asarray(J)), 0.0, 1e-15)
    t, g, E = rng.uniform(150, 300, 6), np.array([1.0, 3.0, 5.0]), np.array([0.0, 1e-22, 4e-22])
    Q = (g * np.exp(-E / (jconst.k * t[:, None]))).sum(-1)
    close(N.boltzmann_ratios(T(t), T(g), T(E), T(Q)),
          JN.boltzmann_ratios(jnp.asarray(t), jnp.asarray(g), jnp.asarray(E), jnp.asarray(Q)),
          0.0, 1e-13)


def test_line_profiles_and_mean_intensity_match_jax():
    """The line profiles of tests/test_nlte.py's CO-like line on its 16
    levels and 512 frequencies, and the mean intensity of random absorption
    and source on them (8 Gauss-Legendre directions, a grey surface)."""
    cat, z, t, p, vmr, f, _, _ = _two_level_setup()
    rng = np.random.default_rng(8)
    k = rng.uniform(1e-7, 1e-3, (z.shape[0], f.shape[0]))
    J = rng.uniform(0.5, 2.0, k.shape) * 1e-15
    x, w = np.polynomial.legendre.leggauss(8)
    mus, wmus = 0.5 * (x + 1.0), 0.5 * w
    want = ref_jit(lambda *a: (
        jax.vmap(lambda tt, pp, vv: JN.line_profiles(a[0], cat, tt, pp, vv))(*a[1:4]),
        JN.mean_intensity_profile(a[0], a[4], a[5], a[6], a[7], a[8], 2.735, 280.0, 0.7)))(
        *map(jnp.asarray, (f, t, p, vmr, z, k, J, mus, wmus)))
    pc = port_cat(cat)
    close(N.line_profiles(T(f), pc, T(t), T(p), T(vmr)), want[0])
    close(N.mean_intensity_profile(T(f), T(z), T(k), T(J), T(mus), T(wmus), 2.735, T(280.0),
                                   0.7), want[1])


def _fit_case(regime):
    """tests/test_nlte.py:105-150: strong collisions in detailed balance
    from a flat start, or none inside an isothermal cavity at 250 K."""
    f0 = 115.27e9 if regime == "collision" else 2.0e12
    cat, z, t, p, vmr, f, E, g = _two_level_setup(f0=f0)
    nz = z.shape[0]
    kw = dict(convergence_limit=1e-9)
    if regime == "collision":
        hf_kt = jconst.h * f0 / (jconst.k * t)
        Cul = jnp.full((nz, 1), 1.0e3)
        Clu = Cul * (g[1] / g[0]) * jnp.exp(-hf_kt)[:, None]
        r_sum, r_init = jnp.sum(_boltzmann(t, g, E), -1), jnp.full((nz, 2), 0.5)
        surf_t = jnp.asarray(280.0)
    else:
        vmr = jnp.full((nz, 1), 1e-12)
        Cul = Clu = jnp.zeros((nz, 1))
        r_init = _boltzmann(t, g, E)
        r_sum, surf_t = jnp.sum(r_init, -1), jnp.asarray(250.0)
        kw = dict(surf_eps=1.0, t_space=250.0, convergence_limit=1e-10)
    args = (f, z, t, p, vmr, cat, 2, jnp.asarray([1]), jnp.asarray([0]), Cul, Clu)
    return args, dict(r_sum=r_sum, r_init=r_init, surf_t=surf_t, **kw)


@pytest.mark.parametrize("regime", ["collision", "radiation"])
def test_nlte_fit_profile_matches_jax(regime):
    """The population fit in both regimes of tests/test_nlte.py: the same
    number of iterations, ratios within 1e-8, and the last largest change
    below the limit in both."""
    args, kw = _fit_case(regime)
    r_j, n_j, mc_j = JN.nlte_fit_profile(*args, **kw)
    conv = lambda a: a if isinstance(a, (int, float)) else np.asarray(a)
    pargs = [port_cat(a) if i == 5 else conv(a) for i, a in enumerate(args)]
    pkw = {k: conv(v) for k, v in kw.items()}
    r_t, n_t, mc_t = N.nlte_fit_profile(*pargs, **pkw, **CPU64)
    assert n_t == n_j < 100
    assert mc_t < kw["convergence_limit"] and mc_j < kw["convergence_limit"]
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-8)


def test_simulate_clearsky_nlte_matches_jax():
    """tests/test_nlte.py's nadir scene over its two-level band (no LTE
    lines), with Boltzmann populations and with the upper level depleted by
    2 % (the line's absorption grows severalfold): over the surface with
    constant layers and over the reflecting surface with linprop."""
    *_, t, _, _, _, E, g = _two_level_setup()
    r_lte = np.asarray(_boltzmann(t, g, E))
    fields = {"lte": r_lte, "pumped": r_lte * [1.0, 0.98]}
    cases = (("surface", "constant"), ("surface_reflect", "linprop"))

    @ref_jit
    def refs(scenes, f, alt, dr):
        return {(name, bg): JF.simulate_clearsky(s, f, alt, dr, background=bg, rte_option=opt)
                for name, s in scenes.items() for bg, opt in cases}

    scenes, ports = {}, {}
    for name, r in fields.items():
        js, _, f, alt, dr, *_ = _nadir_scene_pair(jnp.asarray(r))
        js = dataclasses.replace(js, surface_emissivity=jnp.asarray(0.8))
        scenes[name] = js
        nl = js.nlte
        ports[name] = clearsky_scene_from_numpy(dict(
            atm={k: np.asarray(getattr(js.atm, k)) for k in ("z", "t", "p", "vmr")},
            surface_temperature=np.asarray(js.surface_temperature),
            surface_emissivity=0.8,
            nlte=dict(z=np.asarray(nl.z), r=np.asarray(nl.r),
                      cat={fl.name: np.asarray(getattr(nl.cat, fl.name))
                           for fl in dataclasses.fields(LineCatalog)},
                      up_idx=np.asarray(nl.up_idx), lo_idx=np.asarray(nl.lo_idx))), **CPU64)
    want = refs(scenes, f, alt, dr)
    for (name, bg), w in want.items():
        opt = dict(cases)[bg]
        got = F.simulate_clearsky(ports[name], np.asarray(f), np.asarray(alt), np.asarray(dr),
                                  background=bg, rte_option=opt, **CPU64)
        close(got, w)
    base = np.asarray(want[("lte", "surface")])
    assert np.abs(np.asarray(want[("pumped", "surface")]) - base).max() > 1e-3 * base.max()
