"""The port's Zeeman path (arts_tpu_torch) against arts_tpu on the CPU:
catalog ingestion with g factors from the quanta, the magnetic geometry,
the dense propagation matrix, the route through the polarized Voigt
kernel's plain version and the whole profile route, on identical inputs
made with numpy; JAX runs its XLA routes.  test_torch_zeeman_kernels.py
holds the kernels' plain versions and the parent-pole pieces."""

import dataclasses
import functools

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
from arts_tpu_torch._cuda import move
from arts_tpu_torch.convert import padded_zeeman_catalog_from_numpy, zeeman_catalog_from_numpy
from arts_tpu_torch.io.hitran import parse_par_line, record_state, zeeman_catalog_from_par
from arts_tpu_torch.io.quantum import zeeman_g
from arts_tpu_torch.lbl import zeeman as Z
from arts_tpu_torch.lbl.catalog import LineCatalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
SPECIES = ["H2O", "O2"]
# the oblique field of tests/test_zeeman.py:123: all 7 components nonzero
MAG, ZA, AA = [10e-6, -20e-6, 40e-6], 65.0, 30.0
# jax.jit with LLVM's optimizations off: the JAX references compile in a
# fraction of the time of their own jit
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: the dense route's
    many small operations wait on the whole thread pool after each one,
    which costs tens of seconds when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    fn = ref_jit(jax.vmap(lambda t, p, v: JZ.zeeman_propmat(
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
