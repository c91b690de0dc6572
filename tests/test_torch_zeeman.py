"""The port's Zeeman path (arts_tpu_torch) against arts_tpu on the CPU:
catalog ingestion with g factors from the quanta, the magnetic geometry,
the dense propagation matrix, the route through the polarized Voigt
kernel's plain version, the parent-pole pieces (moments, the zeeman_mp
kernel's plain version, the near correction) and the whole profile route,
on identical inputs made with numpy.  JAX runs its XLA routes, and each
of the two Pallas kernels once in interpret mode on a one- or two-step
grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from arts_tpu.io.hitran import parse_par_line as j_parse_par_line
from arts_tpu.io.hitran import record_state as j_record_state
from arts_tpu.io.hitran import zeeman_catalog_from_par as j_zeeman_catalog_from_par
from arts_tpu.io.quantum import zeeman_g as j_zeeman_g
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.lbl import zeeman as JZ
from arts_tpu.ops import zeeman_mp_kernel as JMP
from arts_tpu.ops.voigt_kernel import voigt_sum_pol as j_voigt_sum_pol
from arts_tpu_torch import _cuda
from arts_tpu_torch._cuda import move
from arts_tpu_torch.convert import padded_zeeman_catalog_from_numpy, zeeman_catalog_from_numpy
from arts_tpu_torch.io.hitran import parse_par_line, record_state, zeeman_catalog_from_par
from arts_tpu_torch.io.quantum import zeeman_g
from arts_tpu_torch.lbl import zeeman as Z
from arts_tpu_torch.lbl.catalog import LineCatalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.ops import voigt_kernel as V
from arts_tpu_torch.ops import zeeman_mp_kernel as MP
from arts_tpu_torch.scene import build_zeeman_inputs, build_zeeman_mp_case

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
SPECIES = ["H2O", "O2"]
# the oblique field of tests/test_zeeman.py:123: all 7 components nonzero
MAG, ZA, AA = [10e-6, -20e-6, 40e-6], 65.0, 30.0


def _f32(a):
    """float64 values that float32 represents exactly."""
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _par_row(mol, nu_cm, A, gu, gl, q_up="", q_lo="", q_loc_lo="", trailing=""):
    row = (f"{mol:2d}1" + f"{nu_cm:12.6f}" + f"{1.0e-30:10.3E}" + f"{A:10.3E}"
           + "0.0470.047" + f"{16.3876:10.4f}" + "0.74" + f"{0.0:8.6f}"
           + q_up.ljust(15) + q_lo.ljust(15) + " " * 15 + q_loc_lo.ljust(15)
           ).ljust(146) + f"{gu:7.1f}" + f"{gl:7.1f}"
    return row + trailing


# an O2 line with classic local quanta, an NO line with Omega in the
# global quanta, and an O2 line with extended-format trailing states
MIXED_ROWS = [
    _par_row(7, 3.961085, 6.9e-10, 19.0, 17.0, q_loc_lo="  Q  9  R  8   "),
    _par_row(8, 5.015520, 1.2e-8, 10.0, 8.0, q_up="       X3/2  0 ",
             q_lo="       X3/2  0 ", q_loc_lo="  R  3.5       "),
    _par_row(7, 4.012000, 3.0e-10, 5.0, 3.0,
             trailing=",ElecStateLabel=X;v=0;J=1;N=1,ElecStateLabel=X;v=0;J=0;N=1"),
]


@pytest.fixture(scope="module")
def cats():
    """The 96-line bench catalog from .par rows, both sides, float64, with
    every float rounded to float32 values (so that float32 runs see the
    same data), and the shared partition functions."""
    rows = bench.synth_par_rows(n_lines=96)
    jz = jax.tree_util.tree_map(
        lambda x: jnp.asarray(_f32(x)) if jnp.issubdtype(jnp.asarray(x).dtype, jnp.floating) else x,
        j_zeeman_catalog_from_par(rows, SPECIES, strength_option="A", cutoff=25e9))
    pz = move(move(zeeman_catalog_from_par(rows, SPECIES, cutoff=25e9, **CPU64),
                   "cpu", torch.float32), "cpu", torch.float64)
    jpf = j_rigid_rotor_table(2, [174.6, 215.7], 1.5)
    pf = rigid_rotor_table(2, [174.6, 215.7], 1.5, **CPU64)
    return rows, jz, pz, jpf, pf


@pytest.fixture(scope="module")
def profile():
    """Three levels (top, middle, bottom of the bench profile), a 256-point
    160-260 GHz grid and JAX's XLA propagation matrices [3, 256, 7]."""
    f = _f32(np.linspace(160e9, 260e9, 256))
    pts = dict(T=_f32([210.0, 250.0, 288.0]), P=_f32([2e2, 2e4, 1e5]),
               vmr=_f32([[4e-6, 0.21]] * 3), mag=_f32(MAG))
    return f, pts


@pytest.fixture(scope="module")
def reference(cats, profile):
    _, jz, _, jpf, _ = cats
    f, pts = profile
    fn = jax.jit(jax.vmap(lambda t, p, v: JZ.zeeman_propmat(
        jnp.asarray(f), jz, jpf, t, p, v, jnp.asarray(pts["mag"]), ZA, AA)))
    return np.asarray(fn(*(jnp.asarray(pts[k]) for k in ("T", "P", "vmr"))))


def test_zeeman_catalog_matches_jax(cats):
    """Same .par rows -> the same pseudo-line expansion (indices exactly,
    splits and strengths to 1e-14) and the same padded buckets."""
    rows = cats[0]
    for rr in (rows, MIXED_ROWS):
        species = SPECIES if rr is rows else ["O2", "NO"]
        jz = j_zeeman_catalog_from_par(rr, species, strength_option="A", cutoff=25e9)
        pz = zeeman_catalog_from_par(rr, species, cutoff=25e9, **CPU64)
        for f in dataclasses.fields(LineCatalog):
            np.testing.assert_array_equal(getattr(pz.cat, f.name).numpy(),
                                          np.asarray(getattr(jz.cat, f.name)), err_msg=f.name)
        for a, b in zip(jz.idx, pz.idx):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for name in ("split", "strength"):
            for a, b in zip(getattr(jz, name), getattr(pz, name)):
                a = np.asarray(a)
                np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-14 * np.abs(a).max())
        jp, pp = JZ.pad_zeeman_catalog(jz), Z.pad_zeeman_catalog(pz)
        for name in ("parent", "split", "strength", "polidx"):
            got, want = getattr(pp, name), getattr(jp, name)
            assert [tuple(g.shape) for g in got] == [w.shape for w in want], name
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_quantum_states_and_g_factors_match_jax():
    """Classic diatomic quanta and extended trailing states parse into
    the same states and Lande g factors."""
    for row in MIXED_ROWS:
        st, jst = record_state(parse_par_line(row)), j_record_state(j_parse_par_line(row))
        assert (st.upper, st.lower) == (jst.upper, jst.lower)
        iso = parse_par_line(row).isotopologue
        assert zeeman_g(iso, st) == j_zeeman_g(iso, jst)


def test_magnetic_angles_and_pol_matrices_match_jax():
    rng = np.random.default_rng(4)
    mag = rng.normal(size=(20, 3)) * 3e-5
    mag[0] = 0.0
    za, aa = rng.uniform(0, 180, 20), rng.uniform(-180, 180, 20)
    got = Z.magnetic_angles(T(mag), T(za), T(aa))
    want = JZ.magnetic_angles(jnp.asarray(mag), jnp.asarray(za), jnp.asarray(aa))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13, atol=1e-15)
    pm, jpm = Z.pol_matrices(*got[1:]), JZ.pol_matrices(*want[1:])
    for pol in Z.POLS:
        np.testing.assert_allclose(pm[pol].numpy(), np.asarray(jpm[pol]), rtol=1e-13, atol=1e-13)


def _propmat(cats, profile, **kw):
    _, _, pz, _, pf = cats
    f, pts = profile
    args = [T(pts[k]) for k in ("T", "P", "vmr", "mag")]
    return Z.zeeman_propmat(T(f), pz, pf, *args, ZA, AA, **kw, **CPU64).numpy()


def test_dense_propmat_matches_jax(cats, profile, reference):
    """The dense route for all three levels at once, and for one point,
    against JAX's XLA route at float64 roundoff (1e-10 of scale)."""
    got = _propmat(cats, profile)
    scale = np.abs(reference).max()
    assert (np.abs(reference[..., 1:]).max(axis=(0, 1)) > 1e-8 * scale).all()
    np.testing.assert_allclose(got, reference, rtol=0, atol=1e-10 * scale)
    _, _, pz, _, pf = cats
    f, pts = profile
    one = Z.zeeman_propmat(T(f), pz, pf, T(pts["T"][1]), T(pts["P"][1]), T(pts["vmr"][1]),
                           T(pts["mag"]), ZA, AA, **CPU64).numpy()
    np.testing.assert_allclose(one, reference[1], rtol=0, atol=1e-10 * scale)


def test_kernel_a_route_matches_jax(cats, profile, reference):
    """backend="pallas" through the polarized Voigt kernel's plain version
    (tiered w(z), multipole far field) against JAX's XLA route at the JAX
    package's Pallas-vs-XLA bound (atol 2e-6 * scale, rtol 2e-5,
    tests/test_zeeman.py:146), float64."""
    got = _propmat(cats, profile, backend="pallas")
    scale = np.abs(reference).max()
    np.testing.assert_allclose(got, reference, rtol=2e-5, atol=2e-6 * scale)


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
    want = np.asarray(j_voigt_sum_pol(*map(jnp.asarray, cols), jnp.asarray(table[polidx]),
                                      tf=256, tl=128, interpret=True))
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
    want = jax.jit(jax.vmap(lambda *c: JMP.zeeman_pole_moments(*c, jnp.asarray(comps[-1]), 5, 6.0)))(
        *map(jnp.asarray, comps[:-1]))
    for key in ("c_re", "g0", "R", "rnear", "rnear2", "M_re", "M_im", "swcsum", "count"):
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max(), err_msg=key)

    args = ([got[k] for k in ("c_re", "g0", "rnear")], [want[k] for k in ("c_re", "g0", "rnear")])
    out = MP.near_correction(T(f), torch.zeros(2, 7, f.size, dtype=torch.float64), *args[0],
                             T(cut), *map(T, comps[:-2]), T(comps[-1]), noff=8)
    near = jax.jit(JMP.near_correction, static_argnames=("noff", "wofz_n"))
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
    want = np.asarray(JMP.zeeman_mp_eval(
        jnp.asarray(f), *(jnp.asarray(m[k].numpy()) for k in keys), jnp.asarray(cut),
        *(jnp.asarray(m[k].numpy()) for k in ("M_re", "M_im", "swcsum")),
        terms=5, tf=64, pb=16, interpret=True))[:, :7]
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


def test_profile_route_matches_jax(cats, profile, reference):
    """zeeman_propmat_profile on float32 data through the zeeman_mp
    kernel's plain version, against JAX's XLA route at 1e-4 of scale
    (tests/test_zeeman.py:202); the knobs equal JAX's tuner's."""
    _, jz, pz, _, pf = cats
    f, pts = profile
    f32 = torch.tensor(f, dtype=torch.float32)
    pzcat = Z.pad_zeeman_catalog(move(pz, "cpu", torch.float32))
    tune = Z.tune_zeeman_profile(f32, pzcat)
    jf32 = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, jz)
    assert tune == JZ.tune_zeeman_profile(jnp.asarray(f, jnp.float32), JZ.pad_zeeman_catalog(jf32))
    got = Z.zeeman_propmat_profile(f32, pzcat, pf, *(T(pts[k]) for k in ("T", "P", "vmr", "mag")),
                                   ZA, AA, **tune, device="cpu", dtype=torch.float32)
    scale = np.abs(reference).max()
    assert np.abs(got.double().numpy() - reference).max() <= 1e-4 * scale


def test_catalogs_carry_across_from_numpy(cats):
    """A JAX ZeemanCatalog and its padded form, carried across as numpy
    arrays, equal the port's own."""
    _, jz, pz, _, _ = cats
    fields = [f.name for f in dataclasses.fields(LineCatalog)]
    npy = lambda t: [np.asarray(a) for a in t]
    jcat = {k: np.asarray(getattr(jz.cat, k)) for k in fields}
    got = zeeman_catalog_from_numpy(dict(cat=jcat, idx=npy(jz.idx), split=npy(jz.split),
                                         strength=npy(jz.strength)), **CPU64)
    jp, pp = JZ.pad_zeeman_catalog(jz), Z.pad_zeeman_catalog(pz)
    gotp = padded_zeeman_catalog_from_numpy(dict(
        cat=jcat, parent=npy(jp.parent), split=npy(jp.split), strength=npy(jp.strength),
        polidx=npy(jp.polidx)), **CPU64)
    for a, b in ((got, pz), (gotp, pp)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            pairs = ([(getattr(x, k), getattr(y, k)) for k in fields] if f.name == "cat"
                     else list(zip(x, y)))
            for u, v in pairs:
                assert u.dtype == v.dtype and torch.equal(u, v), f.name


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
