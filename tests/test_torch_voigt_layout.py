"""The Voigt kernel's input layout on the CPU: polarization-pure line
blocks from voigt_inputs, and the polarized plain version against a dense
numpy sum per polarization."""

import numpy as np
import pytest
import torch
from scipy.special import wofz as sp_wofz

from arts_tpu_torch.ops import voigt_kernel as V

T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pol_lines(counts, L_far=0, seed=4):
    """Lines of polarizations 0, 1, 2 in the given counts, shuffled, on a
    300-point grid (two tiles); unique f0; half of them with a finite
    cutoff, but the first L_far pi lines, which lie 26-28 GHz beyond the
    grid without cutoff, with MHz widths (a whole block of them is left to
    the multipole far field)."""
    rng = np.random.default_rng(seed)
    polidx = np.concatenate([np.full(n, p) for p, n in enumerate(counts)])
    rng.shuffle(polidx)
    L = polidx.size
    f = np.linspace(-4e9, 4e9, 300)
    f0 = rng.permutation(np.linspace(-5e9, 5e9, L))
    far = np.flatnonzero(polidx == 0)[:L_far]
    f0[far] = np.linspace(3e10, 3.2e10, L_far)
    inv_gd = rng.uniform(1e-8, 4e-6, L)
    z_imag = rng.uniform(0.05, 500.0, L)
    s_re, s_im = rng.uniform(0.1, 1.0, L), 0.1 * rng.normal(size=L)
    cutoff = np.where(rng.random(L) < 0.5, rng.uniform(1e9, 4e9, L), 1e30)
    cutoff[far] = 1e30
    inv_gd[far], z_imag[far] = 1e-6, rng.uniform(1.0, 3.0, far.size)
    wcut_re, wcut_im = 1e-3 * rng.normal(size=L), 1e-3 * rng.normal(size=L)
    return (f, f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re, wcut_im), polidx


def test_voigt_inputs_make_polarization_pure_blocks():
    """130 pi lines, no sigma-, 5 sigma+: blocks [pi, pi, sigma+]; every
    line sits once, in order, in a block of its polarization; padding
    lines have zero strength, z_imag 1 and cutoff -1."""
    cols, polidx = _pol_lines((130, 0, 5))
    table = np.random.default_rng(1).normal(size=(1, 3, 7))
    args, _ = V.voigt_inputs(T(cols[0]), *(T(c)[None] for c in cols[1:]),
                             polidx=torch.as_tensor(polidx), table=T(table))
    f, lines, ext, blkidx, nvisit, wcoef, blkpol, tab = args
    assert blkpol.dtype == torch.int32 and blkpol.tolist() == [0, 0, 2]
    assert tuple(lines.shape) == (1, 3 * V.TL, len(V.REC_COLS))
    rec = lines[0].view(3, V.TL, -1)
    col = dict(zip(V.REC_COLS, rec.unbind(-1)))
    pad = col["cutoff"] == -1.0
    assert int((~pad).sum()) == polidx.size
    for name in ("s_re", "s_im", "swc", "res"):
        assert not col[name][pad].any(), name
    assert bool((col["z_imag"][pad] == 1.0).all())
    assert not col["res"].any()  # no remainders given
    for p in (0, 2):
        blocks = (blkpol == p).nonzero()[:, 0]
        got = torch.cat([col["f0"][b][~pad[b]] for b in blocks])
        np.testing.assert_array_equal(got.numpy(), cols[1][polidx == p])
    with pytest.raises(ValueError, match="polarization indices"):
        V.voigt_inputs(T(cols[0]), *(T(c)[None] for c in cols[1:]),
                       polidx=torch.as_tensor(np.where(polidx == 2, 3, polidx)),
                       table=T(table))


def test_voigt_sum_pol_plain_matches_dense_per_polarization():
    """200 pi lines, a single sigma- line and no sigma+, at two levels
    with their own [3, 7] tables: the plain version (tiers and the
    multipole far field of a block of far lines) against the dense numpy sum
    with scipy's w(z), at the JAX package's multipole-vs-direct bound
    (3e-6 of scale, rtol 1e-4, tests/test_tpu_kernels.py:131)."""
    cols, polidx = _pol_lines((200, 1, 0), L_far=128)
    f, f0, igd, zi, sr, si, cut, wre, wim = cols
    Z = 2
    zi_z = zi[None] * np.array([[1.0], [0.7]])  # the second level: narrower lines
    table = np.random.default_rng(2).normal(size=(Z, 3, 7))
    lev = lambda c: T(np.broadcast_to(c, (Z, c.size)))
    got = V.voigt_sum_pol(T(f), lev(f0), lev(igd), T(zi_z), lev(sr), lev(si), lev(cut),
                          lev(wre), lev(wim), torch.as_tensor(polidx), T(table)).numpy()
    want = np.zeros((Z, 7, f.size))
    for z in range(Z):
        zz = igd[:, None] * (f[None] - f0[:, None]) + 1j * zi_z[z][:, None]
        term = ((sr + 1j * si)[:, None] * (sp_wofz(zz) - (wre + 1j * wim)[:, None])).real
        term = np.where(np.abs(f[None] - f0[:, None]) <= cut[:, None], term, 0.0)
        want[z] = table[z][polidx].T @ term
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-6 * np.abs(want).max())
