"""The port's CIA, cross-section fits, Lagrange interpolation, unclipped
line absorption and absorption lookup tables against arts_tpu on the CPU
at float64 (float32 CIA against float64 on the same inputs)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.constants as jconst
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.cia import CIADataset as JCIA
from arts_tpu.lbl.cia import cia_absorption as j_cia_absorption
from arts_tpu.lbl.lookup import train_lookup as j_train_lookup
from arts_tpu.lbl.voigt import absorption as j_absorption
from arts_tpu.lbl.xsec_fit import XsecFitDataset as JXsec
from arts_tpu.lbl.xsec_fit import xsec_fit_absorption as j_xsec_fit_absorption
from arts_tpu.ops import interp as JI
from arts_tpu.lbl.tmodel import Law
from arts_tpu_torch.convert import (
    cia_dataset_from_numpy,
    lookup_table_from_numpy,
    xsec_fit_dataset_from_numpy,
)
from arts_tpu_torch.lbl.catalog import catalog_from_arrays
from arts_tpu_torch.lbl.cia import cia_absorption
from arts_tpu_torch.lbl.lookup import train_lookup
from arts_tpu_torch.lbl.partfun import PartFunTable
from arts_tpu_torch.lbl.voigt import absorption, absorption_kernel
from arts_tpu_torch.lbl.xsec_fit import xsec_fit_absorption
from arts_tpu_torch.ops import interp as I
from test_voigt_lbl import CAT, LINES, PF, VMR

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
T64 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float64)
# the kernel route against the dense route: the JAX package's Pallas-vs-XLA
# bound (tests/test_tpu_kernels.py:22,59)
KERNEL_RTOL, KERNEL_ATOL = 2e-6, 5e-7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}


def port_catalog(jcat, jpf):
    return (catalog_from_arrays(_leaves(jcat), "cpu", torch.float64),
            PartFunTable(t_grid=T64(jpf.t_grid), q_grid=T64(jpf.q_grid)))


def close(got, want, rtol=0.0, atol_scale=0.0, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * np.abs(want).max(),
                               err_msg=what)


# CIA: tests/test_cia_lookup.py's exactly bilinear table and a random one
# of a second pair, at points inside, below and above the temperature
# grid, on table nodes, between them and outside the band
CIA_F = np.linspace(1e10, 1e12, 21)
CIA_T = np.array([200.0, 250.0, 300.0])
CIA_SETS = [dict(f_grid=CIA_F, t_grid=CIA_T, xsec=CIA_T[:, None] * CIA_F[None, :] * 1e-70,
                 spec1=0, spec2=1),
            dict(f_grid=CIA_F, t_grid=CIA_T,
                 xsec=np.random.default_rng(2).uniform(0.2, 3.0, (3, 21)) * 1e-71,
                 spec1=1, spec2=1)]
CIA_FQ = np.concatenate([CIA_F[::4], np.linspace(5e9, 1.2e12, 37)])
CIA_PTS = (np.array([225.0, 190.0, 310.0, 250.0]), np.array([1e5, 5e4, 8e4, 2e3]),
           np.array([[0.2, 0.8], [0.5, 0.5], [0.01, 0.99], [0.3, 0.7]]))


def test_cia_matches_jax():
    """Two datasets (the JAX test's and a random one) at four points:
    against the JAX package's (vmapped over the points) at 1e-12 of
    scale, and the JAX test's closed form at the first point."""
    jsets = [JCIA(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                     for k, v in d.items()}) for d in CIA_SETS]
    T, P, vmr = CIA_PTS
    want = jax.vmap(lambda t, p, v: j_cia_absorption(jsets, jnp.asarray(CIA_FQ), t, p, v))(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(vmr))
    got = cia_absorption([cia_dataset_from_numpy(d, **CPU64) for d in CIA_SETS], CIA_FQ,
                         T, P, vmr, **CPU64)
    close(got, want, atol_scale=1e-12)
    one = cia_absorption([cia_dataset_from_numpy(CIA_SETS[0], **CPU64)], [5e11, 2e12], 225.0,
                         1e5, [0.2, 0.8], **CPU64)
    n = 1e5 / (jconst.k * 225.0)
    np.testing.assert_allclose(float(one[0]), 225.0 * 5e11 * 1e-70 * (n * 0.2) * (n * 0.8),
                               rtol=1e-12)
    assert float(one[1]) == 0.0  # outside the table


def test_cia_float32_against_float64():
    """Float32 CIA in the scaled form (lbl/cia.py): finite and within 1e-6
    of scale of float64 on the same inputs (the float32 datasets and
    points, cast up), table nodes and the band's edge included (the
    unscaled product would read 0 * inf there)."""
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    T, P, vmr = (f32(a) for a in CIA_PTS)
    f = f32(CIA_FQ)
    sets = [cia_dataset_from_numpy(d, device="cpu", dtype=torch.float32) for d in CIA_SETS]
    lo = cia_absorption(sets, f, T, P, vmr, device="cpu", dtype=torch.float32)
    hi = cia_absorption(sets, f, T, P, vmr, **CPU64)
    assert bool(torch.isfinite(lo).all()) and float(hi.abs().max()) > 0.0
    close(lo.double(), hi, atol_scale=1e-6)


def test_xsec_fit_matches_jax():
    """tests/test_aux.py's band and a random one at four points, against the
    JAX package's at 1e-12 of scale; zero outside both bands."""
    rng = np.random.default_rng(5)
    g = np.linspace(1e13, 2e13, 11)
    c0 = np.zeros((11, 4))
    c0[:, 0], c0[:, 1] = 1e-24, 1e-27
    c1 = rng.normal(size=(17, 4)) * [1e-24, 1e-27, 1e-30, 1e-29]
    sets = [dict(f_grid=g, coeffs=c0, spec_idx=0),
            dict(f_grid=np.linspace(1.2e13, 1.8e13, 17), coeffs=c1, spec_idx=1)]
    f = np.concatenate([g, np.linspace(0.9e13, 2.1e13, 29), [5e13]])
    T, P = np.array([250.0, 210.0, 290.0, 230.0]), np.array([1e4, 3e4, 9e4, 5e2])
    vmr = np.array([[1e-6, 2e-6], [3e-6, 1e-7], [1e-5, 5e-6], [2e-7, 2e-7]])
    jsets = [JXsec(f_grid=jnp.asarray(d["f_grid"]), coeffs=jnp.asarray(d["coeffs"]),
                   spec_idx=d["spec_idx"]) for d in sets]
    want = jax.vmap(lambda t, p, v: j_xsec_fit_absorption(jsets, jnp.asarray(f), t, p, v))(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(vmr))
    got = xsec_fit_absorption([xsec_fit_dataset_from_numpy(d, **CPU64) for d in sets], f, T,
                              P, vmr, **CPU64)
    close(got, want, atol_scale=1e-12)
    assert float(got[:, -1].abs().max()) == 0.0


def test_interp_orders_match_jax():
    """lagrange_weights and interp at orders 1-3 on an uneven grid, at
    nodes, between them and outside (clamped), along a middle axis:
    against the JAX package's at 1e-13 of scale."""
    rng = np.random.default_rng(8)
    grid = np.sort(rng.uniform(0.0, 10.0, 9))
    values = rng.normal(size=(3, 9, 4))
    x = np.concatenate([grid[[0, 4, 8]], rng.uniform(-1.0, 11.0, 10)]).reshape(13, 1)
    for order in (1, 2, 3):
        i0, w = I.lagrange_weights(T64(grid), T64(x), order)
        j0, jw = JI.lagrange_weights(jnp.asarray(grid), jnp.asarray(x), order)
        np.testing.assert_array_equal(i0.numpy(), np.asarray(j0))
        close(w, jw, atol_scale=1e-13, what=f"weights, order {order}")
        got = I.interp(T64(grid), T64(values), T64(x), order=order, axis=1)
        want = JI.interp(jnp.asarray(grid), jnp.asarray(values), jnp.asarray(x), order=order,
                         axis=1)
        close(got, want, atol_scale=1e-13, what=f"interp, order {order}")


def _mixing_catalog():
    """tests/test_voigt_lbl.py's lines with a strong first-order mixing on
    the first, so that its wing absorbs negatively."""
    lines = copy.deepcopy(LINES)
    lines[0]["ls"]["bath"]["Y"] = (Law.T1, [2e-5, 0.8])
    return j_build_catalog(lines)


ABS_F = np.linspace(150e9, 400e9, 251)
ABS_PTS = (np.array([275.0, 240.0, 300.0]), np.array([8e4, 3e4, 1e5]),
           np.array([[0.01, 0.99], [0.002, 0.998], [0.02, 0.98]]))


def test_absorption_unclamped_matches_jax():
    """absorption(no_negative_absorption=False) against the JAX package's at
    1e-10 of scale, where the mixing makes it negative, and the clipped
    default at 0 there; absorption_kernel's plain version against it at
    the kernel bound."""
    jcat = _mixing_catalog()
    T, P, vmr = ABS_PTS
    want = np.asarray(jax.vmap(lambda t, p, v: j_absorption(
        jnp.asarray(ABS_F), jcat, PF, t, p, v, no_negative_absorption=False))(
        jnp.asarray(T), jnp.asarray(P), jnp.asarray(vmr)))
    assert want.min() < -1e-3 * np.abs(want).max()
    cat, pf = port_catalog(jcat, PF)
    got = absorption(T64(ABS_F), cat, pf, T64(T), T64(P), T64(vmr), no_negative_absorption=False,
                     **CPU64)
    close(got, want, atol_scale=1e-10)
    clipped = absorption(T64(ABS_F), cat, pf, T64(T), T64(P), T64(vmr), **CPU64)
    close(clipped, np.maximum(want, 0.0), atol_scale=1e-10)
    kern = absorption_kernel(T64(ABS_F), cat, pf, T64(T), T64(P), T64(vmr),
                             no_negative_absorption=False, **CPU64)
    close(kern, want, rtol=KERNEL_RTOL, atol_scale=KERNEL_ATOL)


# tests/test_cia_lookup.py's lookup case on 64 frequencies
LK_F = np.linspace(150e9, 400e9, 64)
LK_P = np.logspace(5, 3, 12)  # descending
LK_T = np.linspace(290.0, 220.0, 12)
LK_W = 0.01 * LK_P / 1e5
LK_TP = np.array([-20.0, -10.0, 0.0, 10.0, 20.0])
LK_WP = np.array([0.25, 0.5, 1.0, 2.0, 4.0])


@pytest.fixture(scope="module")
def jax_table():
    return j_train_lookup(jnp.asarray(LK_F), CAT, PF, jnp.asarray(LK_P), jnp.asarray(LK_T),
                          jnp.asarray(LK_W), jnp.asarray(VMR), 0, jnp.asarray(LK_TP),
                          jnp.asarray(LK_WP))


def test_train_lookup_matches_jax(jax_table):
    """train_lookup through the Voigt kernel's plain version (CPU tensors)
    against the JAX package's dense-route table, at the kernel bound of
    the whole table's scale; the grids stored ascending in pressure."""
    cat, pf = port_catalog(CAT, PF)
    tbl = train_lookup(LK_F, cat, pf, LK_P, LK_T, LK_W, VMR, 0, LK_TP, LK_WP, **CPU64)
    for name in ("log_p_grid", "t_ref", "w_ref", "t_pert", "w_pert", "f_grid"):
        close(getattr(tbl, name), getattr(jax_table, name), rtol=1e-14, what=name)
    assert tbl.xsec.shape == (5, 5, 12, 64)
    close(tbl.xsec, jax_table.xsec, rtol=KERNEL_RTOL, atol_scale=KERNEL_ATOL, what="xsec")


LK_PTS = (np.array([262.3, 241.0, 230.5]), np.array([3.1e4, 7.7e4, 2.2e3]),
          np.array([[0.0041, 0.99], [0.0081, 0.99], [1.7e-4, 0.99]]))


@ref_jit
def _lookup_refs(tbl, T, P, vmr):
    out = {}
    for orders in ((1, 1, 1), (3, 2, 3)):
        fn = lambda t, p, v: tbl.absorption(t, p, v, *orders)
        out[orders] = (jax.vmap(fn)(T, P, vmr),
                       jax.vmap(jax.grad(lambda t, p, v: fn(t, p, v).sum(), argnums=(0, 1, 2)))(
                           T, P, vmr))
    return out


def test_lookup_value_and_gradient_match_jax(jax_table):
    """The JAX package's table carried across (lookup_table_from_numpy),
    evaluated at three off-grid points, multilinear and at orders (3, 2,
    3), batched: values at 1e-12 of scale and d/dT, d/dP, d/dvmr against
    jax.grad at 1e-9 of each one's scale."""
    tbl = lookup_table_from_numpy({k: np.asarray(v) for k, v in _leaves(jax_table).items()},
                                  **CPU64)
    refs = _lookup_refs(jax_table, *map(jnp.asarray, LK_PTS))
    for orders, (want, grads) in refs.items():
        T, P, vmr = (T64(a).requires_grad_() for a in LK_PTS)
        got = tbl.absorption(T, P, vmr, *orders)
        close(got.detach(), want, atol_scale=1e-12, what=f"value {orders}")
        got.sum().backward()
        for g, jg, name in zip((T.grad, P.grad, vmr.grad), grads, ("T", "P", "vmr")):
            close(g, jg, atol_scale=1e-9, what=f"d/d{name} {orders}")
