"""The port's ECS line mixing (arts_tpu_torch/lbl/ecs.py and
ops/eig_comp_sym.py) against arts_tpu on the CPU at float64, on the
inputs of tests/test_ecs.py: the Wigner symbols, rotational energies,
reduced dipoles and band geometry; the complex-symmetric Jacobi against
the JAX one, scipy.linalg.eig and torch.linalg.eig; ecs_absorption for
O2, linear (CO2 with the Tran and Rodrigues coefficients),
symmetric-top and spherical-top bands at batched points; and
d(absorption)/dT by autograd and forward mode against jax.jacfwd and
central differences.

The JAX references are built once, in module fixtures, each band's as
one jitted, vmapped function over the points."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

import arts_tpu.constants as const
import arts_tpu.lbl.ecs as J
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.ops.eig_comp_sym import eig_comp_sym as j_eig_comp_sym
from arts_tpu_torch.lbl import ecs as P
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.ops.eig_comp_sym import eig_comp_sym
from arts_tpu_torch.ops.eigh_jacobi import _tournament
from test_ecs import co2_like_lines, nh3_like_lines, o2_like_lines

CPU64 = dict(device="cpu", dtype=torch.float64)
T = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
# three points per band: (T [K], P [Pa]) as in tests/test_ecs.py, and two
# more, colder and thinner, and warmer and denser
POINTS = {"o2": ((250.0, 220.0, 290.0), (5e4, 1e4, 8e4), 0.21),
          "linear": ((250.0, 220.0, 290.0), (5e4, 3e4, 1.013e5), 4e-4),
          "stotop": ((260.0, 230.0, 290.0), (6e4, 2e4, 1.013e5), 1e-5),
          "sphtop": ((220.0, 200.0, 280.0), (5e4, 1e4, 1e5), 1.7e-6)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sphtop_lines():
    """tests/test_ecs.py's spherical-top (CH4-like) R branch."""
    erot = J._rigid_erot(J.TOP_B0_KAYCM["CH4-211"])
    return [dict(f0=(erot(j + 1.0) - erot(j)) / const.h, a=1e-8 / (j + 1),
                 e0=erot(float(j)), gu=2.0 * (j + 1) + 1.0, Ji=float(j + 1), Jf=float(j),
                 g0=(1.8e4, 0.7), t0=296.0) for j in range(0, 8)]


def _grid(lines, lo, hi, n):
    f0 = np.array([ln["f0"] for ln in lines])
    return np.linspace(f0.min() * lo, f0.max() * hi, n)


def band_cases():
    """(name, [(label, JAX band, port band)], f_grid) per band kind, on
    tests/test_ecs.py's lines and grids, with line mixing on."""
    co2 = co2_like_lines(6)
    nh3 = nh3_like_lines()
    ch4 = sphtop_lines()
    linear = [(f"co2/{name}", *(m.make_linear_band(co2, ecs=getattr(m, name), mass_other=mo,
                                                   **kw) for m, kw in ((J, {}), (P, dict(
                                                       device="cpu")))))
              for name, mo in (("TRAN2011_CO2", 43.98983), ("RODRIGUES1997_N2", 28.0),
                               ("RODRIGUES1997_O2", 28.0))]
    return {
        "o2": ([("o2", J.make_o2_band(o2_like_lines(3)),
                 P.make_o2_band(o2_like_lines(3), device="cpu"))],
               np.linspace(54e9, 67e9, 201)),
        "linear": (linear, np.linspace(70.0e12, 70.9e12, 1501)),
        "stotop": ([("nh3", J.make_stotop_band(nh3, ecs=J.TRAN2011_CO2),
                     P.make_stotop_band(nh3, ecs=P.TRAN2011_CO2, device="cpu"))],
                   _grid(nh3, 0.9, 1.1, 2001)),
        "sphtop": ([("ch4", J.make_sphtop_band(ch4, ecs=J.TRAN2011_CO2),
                     P.make_sphtop_band(ch4, ecs=P.TRAN2011_CO2, device="cpu"))],
                   _grid(ch4, 0.9, 1.1, 1501)),
    }


@pytest.fixture(scope="module")
def cases():
    """Each band kind's bands, grid, points and JAX spectra [3, F] (the
    partition function of tests/test_ecs.py)."""
    jpf = j_rigid_rotor_table(1, 150.0, 1.0)
    out = {}
    for kind, (bands, f) in band_cases().items():
        t, p, v = POINTS[kind]
        refs = []
        for label, jb, pb in bands:
            fn = ref_jit(jax.vmap(lambda T_, P_, jb=jb: J.ecs_absorption(
                jnp.asarray(f), jb, jpf, 0, T_, P_, v)))
            refs.append((label, jb, pb, np.asarray(fn(jnp.asarray(t), jnp.asarray(p)))))
        out[kind] = (refs, f, (t, p, v))
    return out


def test_wigner_energies_dipoles_and_band_geometry_match_jax():
    """The Wigner 3j and 6j symbols, O2 and CO2 rotational energies, the
    reduced dipoles and every field of the four band builders' bands
    equal the JAX package's to 1e-14 relative."""
    js = np.arange(0.0, 4.5, 0.5)
    for j1 in js:
        for j2 in js:
            for j3 in js:
                for m1 in np.arange(-j1, j1 + 0.5):
                    assert P.wigner3j(j1, j2, j3, m1, -m1, 0.0) == pytest.approx(
                        J.wigner3j(j1, j2, j3, m1, -m1, 0.0), rel=1e-14, abs=1e-15)
                assert P.wigner6j(j1, j2, j3, 1.0, j2, j1) == pytest.approx(
                    J.wigner6j(j1, j2, j3, 1.0, j2, j1), rel=1e-14, abs=1e-15)
    for N in range(1, 40, 2):
        for Jq in (N - 1, N, N + 1):
            assert P.o2_erot(N, Jq) == J.o2_erot(N, Jq)
            assert P.makarov_reduced_dipole(N, Jq, N) == pytest.approx(
                J.makarov_reduced_dipole(N, Jq, N), rel=1e-14, abs=1e-15)
    for Jq in range(0, 12):
        assert P.co2_erot(Jq) == J.co2_erot(Jq)
        assert P.linear_reduced_dipole(Jq + 1.0, Jq, 1.0, 0.0) == pytest.approx(
            J.linear_reduced_dipole(Jq + 1.0, Jq, 1.0, 0.0), rel=1e-14, abs=1e-15)
    assert P.TOP_B0_KAYCM == J.TOP_B0_KAYCM and P._rigid_erot(5.0)(3.0) == J._rigid_erot(5.0)(3.0)
    for bands, _ in band_cases().values():
        for label, jb, pb in bands:
            assert pb.direct_at_ji == jb.direct_at_ji
            for f in dataclasses.fields(pb):
                if f.name == "direct_at_ji":
                    continue
                got, want = getattr(pb, f.name), np.asarray(getattr(jb, f.name))
                assert got.dtype in (torch.float64, torch.int64, torch.bool), (label, f.name)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0,
                                           err_msg=f"{label}.{f.name}")


def _band_matrices():
    """The O2 band's symmetrized band matrices at three points, random
    complex symmetric matrices of odd and even size with line-mixing
    scales (diagonal ~ 6e10 Hz, couplings ~ 1e8 Hz), as numpy."""
    band = P.make_o2_band(o2_like_lines(3), device="cpu")
    M, _ = P.band_matrix(band, T([250.0, 220.0, 290.0]), T([5e4, 1e4, 8e4]))
    out = [M.numpy()]
    rng = np.random.default_rng(11)
    for n in (5, 8):
        d = np.sort(rng.uniform(5e10, 7e10, n))
        W = rng.normal(size=(3, n, n)) * 1e8
        out.append(np.diag(d)[None] + 1j * (W + W.transpose(0, 2, 1)))
    return out


def test_eig_comp_sym_matches_jax_scipy_and_torch():
    """Against the JAX package's Jacobi (eigenvalues within 1e-13 and
    eigenvectors within 1e-9 of scale, the same rounds and sort); the
    eigenvalues against scipy.linalg.eig and torch.linalg.eig within
    1e-13 of the largest; A = Q diag(w) Q^T and Q^T Q = I; each q_k q_k^T
    against torch.linalg.eig's v_k v_k^T / (v_k^T v_k) (its v_k have unit
    2-norm, not v^T v = 1) within 1e-8 of the largest.  Every round of the
    schedule holds the same number of pairs, so the JAX package's padding
    of uneven rounds never applies."""
    for n in range(2, 41):
        assert len({len(r) for r in _tournament(n)}) == 1
    for A in _band_matrices():
        w, Q = (t.numpy() for t in eig_comp_sym(torch.tensor(A)))
        wj, Qj = (np.asarray(x) for x in j_eig_comp_sym(jnp.asarray(A)))
        scale = np.abs(wj).max()
        np.testing.assert_allclose(w, wj, rtol=0, atol=1e-13 * scale)
        np.testing.assert_allclose(Q, Qj, rtol=0, atol=1e-9 * np.abs(Qj).max())
        n = A.shape[-1]
        np.testing.assert_allclose(Q @ (w[..., :, None] * np.swapaxes(Q, -1, -2)), A, rtol=0,
                                   atol=1e-13 * np.abs(A).max())
        np.testing.assert_allclose(np.swapaxes(Q, -1, -2) @ Q, np.broadcast_to(np.eye(n), A.shape),
                                   rtol=0, atol=1e-9)
        sort = lambda x: np.take_along_axis(x, np.argsort(x.real, -1), -1)
        w_sp = sort(np.stack([scipy.linalg.eig(a)[0] for a in A]))
        w_t, V_t = torch.linalg.eig(torch.tensor(A))
        order = torch.argsort(w_t.real, -1)
        w_t = torch.take_along_dim(w_t, order, -1).numpy()
        V_t = torch.take_along_dim(V_t, order[..., None, :], -1).numpy()
        for ref in (w_sp, w_t):
            np.testing.assert_allclose(w, ref, rtol=0, atol=1e-13 * scale)
        proj = Q[..., :, None, :] * Q[..., None, :, :]  # [..., i, j, k] = q_ik q_jk
        vtv = np.einsum("...ik,...ik->...k", V_t, V_t)
        proj_t = V_t[..., :, None, :] * V_t[..., None, :, :] / vtv[..., None, None, :]
        np.testing.assert_allclose(proj, proj_t, rtol=0, atol=1e-8 * np.abs(proj_t).max())


@pytest.mark.parametrize("kind", ["o2", "linear", "stotop", "sphtop"])
def test_ecs_absorption_matches_jax(cases, kind):
    """ecs_absorption at three batched points against the JAX function per
    point, each spectrum within 1e-9 of its largest value."""
    refs, f, (t, p, v) = cases[kind]
    pf = rigid_rotor_table(1, 150.0, 1.0, **CPU64)
    for label, _, pb, want in refs:
        got = P.ecs_absorption(T(f), pb, pf, 0, T(t), T(p), T(np.full(3, v))).numpy()
        assert got.shape == want.shape == (3, f.size)
        for i in range(3):
            np.testing.assert_allclose(got[i], want[i], rtol=0,
                                       atol=1e-9 * np.abs(want[i]).max(), err_msg=label)


def test_temperature_derivative_matches_jax_and_differences():
    """d(absorption)/dT of tests/test_ecs.py's case (two N+- pairs, 41
    frequencies over 55-65 GHz, 8e4 Pa, 250 K) through the whole eigen
    chain: by autograd (torch.func.jacrev) and forward mode
    (torch.func.jacfwd) against jax.jacfwd within 1e-8 of scale, and
    against central differences of the port (dT = 0.05 K) at the
    reference's own rtol 2e-4 and 1e-6 of scale."""
    lines = o2_like_lines(2)
    f = np.linspace(55e9, 65e9, 41)
    jb, pb = J.make_o2_band(lines), P.make_o2_band(lines, device="cpu")
    jpf, pf = j_rigid_rotor_table(1, 150.0, 1.0), rigid_rotor_table(1, 150.0, 1.0, **CPU64)
    want = np.asarray(ref_jit(jax.jacfwd(
        lambda t: J.ecs_absorption(jnp.asarray(f), jb, jpf, 0, t, 8e4, 0.21)))(250.0))
    fn = lambda t: P.ecs_absorption(T(f), pb, pf, 0, t, T(8e4), T(0.21))
    t0 = T(250.0)
    assert np.isfinite(want).all()
    for jac in (torch.func.jacrev, torch.func.jacfwd):
        got = jac(fn)(t0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-8 * np.abs(want).max())
    dT = 0.05
    fd = ((fn(t0 + dT) - fn(t0 - dT)) / (2 * dT)).numpy()
    got = torch.func.jacrev(fn)(t0).numpy()
    np.testing.assert_allclose(got, fd, rtol=2e-4, atol=np.abs(fd).max() * 1e-6)
