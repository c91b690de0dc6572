"""The port's Zeeman kernels' plain versions against arts_tpu on the CPU:
the polarized Voigt contraction, the parent-pole moments and near
correction, the zeeman_mp kernel (each Pallas kernel once in interpret
mode on a one- or two-step grid), the pole records' padded width, the
kernel's random card case and the near correction's scatter, on
identical inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu.ops import zeeman_mp_kernel as JMP
from arts_tpu.ops.voigt_kernel import voigt_sum_pol as j_voigt_sum_pol
from arts_tpu_torch.ops import voigt_kernel as V
from arts_tpu_torch.ops import zeeman_mp_kernel as MP
from arts_tpu_torch.scene import build_zeeman_mp_case
from test_torch_zeeman import T, one_thread, ref_jit  # noqa: F401 (fixture)


def _pol_case():
    """Lines over two blocks of 128 and one 256-frequency tile, all three
    polarizations, a finite cutoff on half of them."""
    rng = np.random.default_rng(6)
    L, F = 200, 256
    f = np.linspace(-4e9, 4e9, F)
    f0 = np.sort(rng.uniform(-6e9, 6e9, L))
    inv_gd = rng.uniform(1e-7, 4e-6, L)
    z_imag = rng.uniform(0.05, 500.0, L)
    s_re, s_im = rng.normal(size=L), 0.1 * rng.normal(size=L)
    cutoff = np.where(rng.random(L) < 0.5, rng.uniform(2e9, 5e9, L), 1e30)
    polidx = rng.integers(0, 3, L)
    table = rng.normal(size=(3, 7))
    return (f, f0, inv_gd, z_imag, s_re, s_im, cutoff, np.zeros(L), np.zeros(L)), polidx, table


def test_voigt_sum_pol_plain_matches_jax_interpret():
    """The polarized kernel's plain version against the JAX Pallas kernel
    in interpret mode (one tile, two line blocks), the [3, 7] table against
    JAX's per-line rows.  The same tiers in float64, but JAX's kernel
    weights the components by a matrix product accumulated in float32
    (preferred_element_type), so the bound is float32's: 1e-6 of scale."""
    cols, polidx, table = _pol_case()
    got = V.voigt_sum_pol(*map(T, cols), torch.as_tensor(polidx), T(table))
    want = np.asarray(ref_jit(lambda *a: j_voigt_sum_pol(*a, tf=256, tl=128, interpret=True))(
        *map(jnp.asarray, cols), jnp.asarray(table[polidx])))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_voigt_sum_pol_with_one_row_is_voigt_sum():
    """With every table row (1, 0, ..., 0) the polarized contraction is the
    unpolarized one in component 0 and zero elsewhere."""
    cols, polidx, _ = _pol_case()
    table = np.zeros((3, 7))
    table[:, 0] = 1.0
    got = V.voigt_sum_pol(*map(T, cols), torch.as_tensor(polidx), T(table)).numpy()
    want = V.voigt_sum(*map(T, cols), plain=True).numpy()
    np.testing.assert_allclose(got[0], want, rtol=0, atol=1e-13 * np.abs(want).max())
    assert not got[1:].any()


def _pole_case():
    """Two levels of 12 poles with up to 4 components each (padded slots
    have strength 0) on a grid fine enough that poles have near points."""
    rng = np.random.default_rng(8)
    Zl, CM, NP = 2, 4, 12
    centres = np.sort(rng.uniform(-2e9, 2e9, NP))
    f0 = centres + rng.uniform(-1e6, 1e6, (Zl, CM, NP))
    igd = np.broadcast_to(rng.uniform(2e-6, 5e-6, NP), (Zl, CM, NP)).copy()
    zi = np.broadcast_to(rng.uniform(0.01, 1.0, (Zl, 1, NP)), (Zl, CM, NP)) * igd / igd[:, :1]
    sr, si = rng.normal(size=(Zl, CM, NP)), 0.1 * rng.normal(size=(Zl, CM, NP))
    pad = rng.random((Zl, CM, NP)) < 0.3
    pad[:, 0] = False
    sr[pad] = si[pad] = 0.0
    swc = 1e-3 * rng.normal(size=(Zl, CM, NP))
    pw = rng.normal(size=(3, 7))[rng.integers(0, 3, (CM, NP))]
    f = np.linspace(-2.5e9, 2.5e9, 2000)
    cut = rng.uniform(1e9, 4e9, NP)
    return f, (f0, igd, zi, sr, si, swc, pw), cut


def test_pole_moments_and_near_correction_match_jax():
    """zeeman_pole_moments per level, then near_correction on a zero field,
    against JAX at 1e-12 (float64)."""
    f, comps, cut = _pole_case()
    got = MP.zeeman_pole_moments(*map(T, comps), terms=MP.MP_TERMS, kappa=6.0)
    want = ref_jit(jax.vmap(lambda *c: JMP.zeeman_pole_moments(*c, jnp.asarray(comps[-1]), 5, 6.0)))(
        *map(jnp.asarray, comps[:-1]))
    for key in ("c_re", "g0", "R", "rnear", "rnear2", "M_re", "M_im", "swcsum", "count"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max(), err_msg=key)

    args = ([got[k] for k in ("c_re", "g0", "rnear")], [want[k] for k in ("c_re", "g0", "rnear")])
    out = MP.near_correction(T(f), torch.zeros(2, 7, f.size, dtype=torch.float64), *args[0],
                             T(cut), *map(T, comps[:-2]), T(comps[-1]), noff=8)
    near = ref_jit(JMP.near_correction, static_argnames=("noff", "wofz_n"))
    jout = np.asarray(near(
        jnp.asarray(f), jnp.zeros((2, 8, f.size)), *args[1], jnp.asarray(cut),
        *map(jnp.asarray, comps[:-2]), jnp.asarray(comps[-1]), noff=8, wofz_n=16))[:, :7]
    assert np.count_nonzero(jout) > 20  # near points exist
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-12 * np.abs(jout).max())


def test_zeeman_mp_plain_matches_jax_interpret():
    """The zeeman_mp kernel's plain version against the JAX Pallas kernel
    in interpret mode (two levels, one tile, one parent block).  JAX's
    kernel contracts the moments by matrix products accumulated in
    float32 (preferred_element_type), so the bound is float32's: 1e-5 of
    scale."""
    f, comps, cut = _pole_case()
    f = f[::40]  # 50 points
    m = MP.zeeman_pole_moments(*map(T, comps), terms=MP.MP_TERMS, kappa=6.0)
    keys = ("c_re", "g0", "R", "rnear2")
    got = MP.zeeman_mp_eval(T(f), *(m[k] for k in keys), T(cut), m["M_re"], m["M_im"],
                            m["swcsum"]).numpy()
    want = np.asarray(ref_jit(lambda *a: JMP.zeeman_mp_eval(
        *a, terms=5, tf=64, pb=16, interpret=True))(
        jnp.asarray(f), *(jnp.asarray(m[k].numpy()) for k in keys), jnp.asarray(cut),
        *(jnp.asarray(m[k].numpy()) for k in ("M_re", "M_im", "swcsum"))))[:, :7]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_pole_records_padded_width():
    """pole_records pads each record to record_width(P) (84 values at P = 5,
    whole 16-byte pieces) with zeros; _terms reads P back from the padded
    and the unpadded width and refuses others; zeeman_mp_plain gives the
    same field on both; the kernel wrapper on CPU tensors runs it."""
    rng = np.random.default_rng(2)
    Zl, NP, P = 2, 9, MP.MP_TERMS
    cols = [T(rng.uniform(-1e9, 1e9, (Zl, NP))), T(rng.uniform(1e6, 3e6, (Zl, NP))),
            T(rng.uniform(1e6, 5e6, (Zl, NP))), T(rng.uniform(1e13, 1e14, (Zl, NP))),
            T(rng.uniform(2e8, 1e9, NP)), T(rng.normal(size=(Zl, NP, P, 7))),
            T(rng.normal(size=(Zl, NP, P, 7))), T(rng.normal(size=(Zl, NP, 7)))]
    rec = MP.pole_records(*cols)
    assert rec.shape == (Zl, NP, MP.record_width(P)) == (Zl, NP, 84)
    assert not rec[..., 12 + 14 * P:].any()
    unpadded = rec[..., :12 + 14 * P].contiguous()
    assert MP._terms(rec) == MP._terms(unpadded) == P
    for w in (83, 85, 12):
        with pytest.raises(ValueError):
            MP._terms(rec.new_zeros(1, 1, w))
    f = T(np.linspace(-1.2e9, 1.2e9, 40))
    got = MP.zeeman_mp_plain(f, rec)
    assert torch.equal(got, MP.zeeman_mp_plain(f, unpadded))
    assert got.abs().max() > 0 and torch.equal(MP.zeeman_mp_kernel(f, rec), got)


def test_build_zeeman_mp_case_shows_every_part():
    """The random pole records of the kernel's card checks: parents in
    random order, M_re, M_im and swcsum nonzero on all 7 components, near
    pairs, parents whose window misses a whole 512-frequency tile, and the
    ragged sizes asked for."""
    f, rec = build_zeeman_mp_case(2, 45, 600, seed=3, device="cpu", dtype=torch.float64)
    assert rec.shape == (2, 45, 84) and f.shape == (600,)
    assert not bool((rec[:, 1:, 0] >= rec[:, :-1, 0]).all())
    for lo, hi in ((5, 12), (12, 47), (47, 82)):
        assert bool((rec[..., lo:hi].abs().amax((0, 1)) > 0).all())
    counts = MP.pair_counts(f, rec)
    assert counts["near"] > 0 and counts["far"] > 0
    inwin = (f[None, None, :512] - rec[..., 0, None]).abs() <= rec[..., 4, None]
    assert bool((~inwin.any(-1)).any())


def test_segment_sum_is_deterministic_index_add():
    """The near correction's scatter: equal to index_add_ with repeated
    keys, and bit-identical from run to run."""
    rng = np.random.default_rng(3)
    key = torch.as_tensor(rng.integers(0, 50, 400))
    vals = T(rng.normal(size=(400, 7)))
    want = torch.zeros(60, 7, dtype=torch.float64).index_add_(0, key, vals)
    got = MP._segment_sum(vals, key, 60)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-13)
    assert torch.equal(got, MP._segment_sum(vals, key, 60))
    assert not MP._segment_sum(vals[:0], key[:0], 60).any()
