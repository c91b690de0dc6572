"""The port's clear-sky scalar path against arts_tpu on the CPU at
float64 (test_torch_clearsky.py's fixtures): linprop over every
background, the level cache on both routes, the dense route's float32
line centres, temperature and H2O-VMR Jacobians against jax.jacrev, and
one Gauss-Newton step of the water-vapour retrieval."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import fwd as JF
from arts_tpu.path import geometric_path_1d
from arts_tpu.retrieval import StateMapping as JStateMapping
from arts_tpu.retrieval import oem as j_oem
from arts_tpu.sensor import gaussian_channels as j_gaussian_channels
from arts_tpu_torch import fwd as F
from arts_tpu_torch.convert import clearsky_scene_from_numpy
from arts_tpu_torch.lbl.voigt import absorption
from arts_tpu_torch.retrieval import oem
from arts_tpu_torch.scene import build_clearsky_retrieval, build_scene
from test_clearsky import make_scene
from test_oem import vmr_targets
from test_torch_clearsky import (  # noqa: F401 (fixtures)
    BACKGROUNDS,
    CPU64,
    FREQ,
    N_LEV,
    OPTIONS,
    T,
    case,
    check_simulate_clearsky,
    close,
    one_thread,
    ref_jit,
    scene_numpy,
)


@pytest.mark.parametrize("bg", BACKGROUNDS)
@pytest.mark.parametrize("opt", OPTIONS[2:])
def test_simulate_clearsky_matches_jax(case, bg, opt):
    """Every background x the linprop rte_option."""
    check_simulate_clearsky(case, bg, opt)


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
