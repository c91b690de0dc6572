"""The port's line-by-line path (arts_tpu_torch) against arts_tpu on the CPU
at float64: catalog ingestion, w(z), the Voigt kernel's plain version and
the absorption routes, on identical inputs made with numpy."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from arts_tpu.atm.standard import standard_atmosphere as j_standard_atmosphere
from arts_tpu.io.hitran import read_par as j_read_par
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.lbl.voigt import absorption as j_absorption
from arts_tpu.ops.voigt_kernel import voigt_sum as j_voigt_sum
from arts_tpu.ops.wofz import wofz as j_wofz
from arts_tpu_torch.atm.standard import standard_atmosphere
from arts_tpu_torch.io.hitran import read_par
from arts_tpu_torch.lbl.catalog import LineCatalog, build_catalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.lbl.voigt import absorption, absorption_kernel
from arts_tpu_torch.ops import voigt_kernel as V
from arts_tpu_torch.ops.wofz import wofz
from arts_tpu_torch.scene import synth_par_rows

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
# jax.jit with LLVM's optimizations off: compiles the interpret-mode
# kernel in about half the time of its own jit
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(reader, n_lines=64):
    rows = bench.synth_par_rows(n_lines=n_lines)
    if reader is j_read_par:
        lines = j_read_par(rows, ["H2O", "O2"], strength_option="A", cutoff=25e9)
    else:
        lines = reader(rows, ["H2O", "O2"], cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    return lines


def test_synth_par_rows_match_bench():
    assert synth_par_rows() == bench.synth_par_rows()


def test_catalog_matches_jax():
    """Same .par rows -> the same line dicts and catalog arrays, exactly
    (both sides parse the same text into float64)."""
    mine, ref = _lines(read_par), _lines(j_read_par)
    assert mine == ref
    cat = build_catalog(mine, **CPU64)
    jcat = j_build_catalog(ref)
    for f in dataclasses.fields(LineCatalog):
        np.testing.assert_array_equal(getattr(cat, f.name).numpy(),
                                      np.asarray(getattr(jcat, f.name)), err_msg=f.name)


@pytest.mark.parametrize("n", [16, 24, 64])
def test_wofz_matches_jax(n):
    """Both regions (Weideman and the Laurent series) at rtol 1e-12: the
    same float64 recurrences, differing only in complex-division roundoff."""
    rng = np.random.default_rng(5)
    z = rng.uniform(-60, 60, 4000) + 1j * np.abs(rng.uniform(0, 40, 4000)) ** 1.5
    got = wofz(torch.as_tensor(z), n).numpy()
    want = np.asarray(j_wofz(jnp.asarray(z), n))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _window_mix():
    """tests/test_tpu_kernels.py:22: finite and effectively infinite
    cutoffs, widths from Doppler to pressure broadened."""
    rng = np.random.default_rng(3)
    L, F = 300, 700
    f = np.linspace(-40e9, 40e9, F)
    f0 = np.sort(rng.uniform(-60e9, 60e9, L))
    inv_gd = rng.uniform(1e-6, 4e-6, L)
    z_imag = rng.uniform(0.5, 2000.0, L)
    s_re = rng.normal(size=L)
    s_im = 0.1 * rng.normal(size=L)
    cutoff = np.where(rng.random(L) < 0.5, rng.uniform(2e9, 10e9, L), 1e30)
    wcut = np.where(cutoff < 1e20,
                    np.asarray(j_wofz(jnp.asarray(inv_gd * cutoff + 1j * z_imag))), 0.0)
    return f, f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut.real, wcut.imag


def _mid_tier():
    """tests/test_tpu_kernels.py:59: Doppler-dominated lines one tile
    away, landing in the mid and Weideman tiers."""
    rng = np.random.default_rng(9)
    L, F = 256, 512
    f = np.linspace(-5e9, 5e9, F)
    f0 = np.sort(rng.uniform(6e9, 15e9, L))
    inv_gd = rng.uniform(1.0e-9, 1.4e-9, L)
    z_imag = rng.uniform(1e-3, 0.3, L)
    s_re = rng.normal(size=L)
    s_im = 0.1 * rng.normal(size=L)
    return f, f0, inv_gd, z_imag, s_re, s_im, np.full(L, 1e30), np.zeros(L), np.zeros(L)


@pytest.mark.parametrize("case", [_window_mix, _mid_tier])
def test_voigt_sum_plain_matches_jax_interpret(case):
    """The kernel's plain version (same visit lists and tier rule) against
    the JAX Pallas kernel in interpret mode at <= 1e-9 * scale: both run
    the same tiers in float64; only the summation order differs."""
    args = case()
    got = V.voigt_sum(*map(T, args), plain=True).numpy()
    want = np.asarray(ref_jit(lambda *a: j_voigt_sum(*a, tf=256, tl=128, interpret=True))(
        *map(jnp.asarray, args)))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale)


def test_voigt_kernel_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    from arts_tpu_torch import _cuda

    f, *cols = map(T, _mid_tier())
    args, _ = V.voigt_inputs(f, *(c[None] for c in cols))
    before = dict(_cuda.LAUNCHES)
    np.testing.assert_array_equal(V.voigt_kernel(*args).numpy(),
                                  V.voigt_kernel_plain(*args).numpy())
    assert _cuda.LAUNCHES == before


def test_pair_counts_cover_the_visited_blocks():
    """Every slot before nvisit contributes tl*tf visited pairs, split over
    the tiers; in-window pairs are a subset."""
    f, *cols = map(T, _window_mix())
    args, _ = V.voigt_inputs(f, *(c[None] for c in cols))
    f, lines, ext, blkidx, nvisit, _ = args
    counts = V.pair_counts(f, lines, ext, blkidx, nvisit)
    tl = lines.shape[1] // ext.shape[-1]  # lines are [Z, nl*tl, 8] records
    tf = f.shape[0] // nvisit.shape[-1]
    assert sum(counts["visited"].values()) == int(nvisit.sum()) * tl * tf
    for k, v in counts["in_window"].items():
        assert 0 <= v <= counts["visited"][k]
    assert sum(counts["in_window"].values()) > 0


@pytest.fixture(scope="module")
def point_inputs():
    """The bench catalog cut to 64 lines, a 256-point 160-260 GHz grid and
    the 10-level US-76 atmosphere, as numpy."""
    cat = j_build_catalog(_lines(j_read_par))
    pf = j_rigid_rotor_table(2, [174.6, 215.7], 1.5)
    atm = j_standard_atmosphere(n_levels=10, z_top=80e3, species=("H2O", "O2"))
    f = np.linspace(160e9, 260e9, 256)
    return cat, pf, atm, f


@pytest.mark.parametrize("level", [0, 4, 9])
@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_absorption_matches_jax(point_inputs, route, level):
    """One atmospheric point against JAX's dense `absorption`.  The dense
    route repeats its arithmetic (rtol 1e-10: float64 roundoff); the kernel
    route adds the multipole far field and the tiered w(z), held at the
    JAX package's own multipole-vs-direct bound (3e-6 * scale, rtol 1e-4,
    tests/test_tpu_kernels.py:131)."""
    jcat, jpf, jatm, f = point_inputs
    t, p, v = (np.asarray(a) for a in (jatm.t[level], jatm.p[level], jatm.vmr[:, level]))
    want = np.asarray(j_absorption(jnp.asarray(f), jcat, jpf, t, p, v))
    cat = build_catalog(_lines(read_par), **CPU64)
    pf = rigid_rotor_table(2, [174.6, 215.7], 1.5, **CPU64)
    atm = standard_atmosphere(n_levels=10, z_top=80e3, species=("H2O", "O2"), **CPU64)
    np.testing.assert_allclose(atm.p.numpy(), np.asarray(jatm.p), rtol=1e-14)
    tt, pp, vv = T(t), T(p), T(v)
    if route == "dense":
        got = absorption(T(f), cat, pf, tt, pp, vv, **CPU64).numpy()
        tol = dict(rtol=1e-10, atol=1e-10 * np.abs(want).max())
    else:
        got = absorption_kernel(T(f), cat, pf, tt[None], pp[None], vv[None],
                                **CPU64)[0].numpy()
        tol = dict(rtol=1e-4, atol=3e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)
