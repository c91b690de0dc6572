"""The rest of the port's Zeeman path (arts_tpu_torch) on the CPU: float32
against float64 on identical inputs at the top levels for the three
propagation-matrix routes, the dense route batched over points against
per-point calls, and simulate_clearsky_polarized over a reflecting surface
with a non-LTE band (scene.build_zeeman_nlte_scene at a small size)
against arts_tpu at float64, its radiance and its Jacobian with respect to
the magnetic field.  The JAX references are compiled once, as one
function, with `ref_jit`."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# imported before any trace: simulate_clearsky_polarized imports it lazily,
# and a first import inside a trace makes its module constant _SIGN_V a
# tracer that the next trace then sees (ROADMAP §C)
import arts_tpu.rtepack.surface  # noqa: F401
from arts_tpu import fwd as JF
from arts_tpu.atm import Atmosphere1D as JAtmosphere1D
from arts_tpu.lbl import zeeman as JZ
from arts_tpu.lbl.catalog import LineCatalog as JLineCatalog
from arts_tpu.lbl.nlte import NlteField as JNlteField
from arts_tpu.lbl.partfun import PartFunTable as JPartFunTable
from arts_tpu_torch import simulate_clearsky_polarized
from arts_tpu_torch._cuda import move
from arts_tpu_torch.lbl import zeeman as Z
from arts_tpu_torch.scene import build_zeeman_inputs, build_zeeman_nlte_scene

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
JCLASSES = {"Atmosphere1D": JAtmosphere1D, "LineCatalog": JLineCatalog,
            "ZeemanCatalog": JZ.ZeemanCatalog, "PartFunTable": JPartFunTable,
            "NlteField": JNlteField, "ZeemanScene": JF.ZeemanScene}
OPTIONS = ("constant", "linprop")
TOP_LEVELS = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: under parallel test workers the thread pool's
    waits after each small operation cost more than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(x):
    """The JAX package's counterpart of a port object, leaf for leaf."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, tuple):
        return tuple(map(to_jax, x))
    if dataclasses.is_dataclass(x):
        return JCLASSES[type(x).__name__](**{f.name: to_jax(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
    return x


def _centre_case():
    """The bench Zeeman catalog cut to 32 lines, its top levels, and a grid
    of 64 points over +-2 MHz around each of four O2 lines across the band
    (the first, two in the middle and the last), where the top levels'
    Doppler widths (~0.2 MHz) are resolved: float32 values, in float32 and
    the same values in float64."""
    d = build_zeeman_inputs(n_lev=60, n_freq=8, n_lines=32, device="cpu", dtype=torch.float32)
    cat = d["zcat"].cat
    o2 = torch.nonzero(cat.spec_idx == 1).flatten()
    pick = o2[torch.tensor([0, len(o2) // 3, 2 * len(o2) // 3, len(o2) - 1])]
    f = np.sort(np.concatenate([float(cat.f0[i]) + np.linspace(-2e6, 2e6, 64) for i in pick]))
    d["f_grid"] = torch.tensor(f, dtype=torch.float32)
    d["tune"] = Z.tune_zeeman_profile(d["f_grid"], d["pzcat"])
    for k in ("T", "P", "vmr"):
        d[k] = d[k][:TOP_LEVELS]
    return {dt: {k: move(v, "cpu", dt) for k, v in d.items() if k != "tune"}
            for dt in (torch.float32, torch.float64)}, d["tune"]


@pytest.mark.parametrize("route, limit", [("dense", 1e-5), ("kernel", 1e-5), ("profile", 1e-4)])
def test_float32_line_centres_match_float64(route, limit):
    """Each route in float32 against itself in float64 on the same inputs,
    level by level at the top levels, within `limit` of the level's
    largest value (the kernels' plain versions on the CPU: kernel 5's for
    "kernel", the parent-pole expansion and near correction for
    "profile").  Forming the shifted centres f0 + shift + H split in
    float32 moved them by up to half a float32 spacing of f0 (8 kHz at
    200 GHz)."""
    ins, tune = _centre_case()

    def run(dt):
        x = ins[dt]
        args = (x["f_grid"], x["pzcat" if route == "profile" else "zcat"], x["pf"], x["T"],
                x["P"], x["vmr"], x["mag"], x["los_za_deg"])
        if route == "profile":
            return Z.zeeman_propmat_profile(*args, **tune, device="cpu", dtype=dt)
        return Z.zeeman_propmat(*args, backend="pallas" if route == "kernel" else "xla",
                                device="cpu", dtype=dt)

    want = run(torch.float64)
    gap = (run(torch.float32).double() - want).abs().amax((-2, -1)) / want.abs().amax((-2, -1))
    assert float(gap.max()) <= limit, gap.tolist()


def test_dense_route_batched_over_points_matches_per_point_calls():
    """zeeman_propmat's dense route over 12 points at once against each
    point's own call to float64 roundoff; zeeman_propmat_views' two
    directions equal the route's own calls for each."""
    b = build_zeeman_nlte_scene(n_lev=12, n_freq=64, n_lines=16, **CPU64)
    scene, f, path = b["scene"], b["f_grid"], b["path"]
    pts = scene.atm.at(torch.as_tensor(path.alt))
    za = torch.as_tensor(path.za)
    args = (f, scene.zcat, scene.pf)
    pm = Z.zeeman_propmat(*args, pts.t, pts.p, pts.vmr, pts.mag, za, **CPU64)
    for i in range(pts.t.shape[0]):
        one = Z.zeeman_propmat(*args, pts.t[i], pts.p[i], pts.vmr[i], pts.mag[i], za[i], **CPU64)
        np.testing.assert_allclose(pm[i].numpy(), one.numpy(), rtol=1e-13,
                                   atol=1e-13 * float(one.abs().max()))
    views = Z.zeeman_propmat_views(*args, pts.t, pts.p, pts.vmr, pts.mag, [za, 180.0 - za],
                                   **CPU64)
    for view, z in zip(views, (za, 180.0 - za)):
        assert torch.equal(view, Z.zeeman_propmat(*args, pts.t, pts.p, pts.vmr, pts.mag, z,
                                                  **CPU64))


@pytest.fixture(scope="module")
def nlte_case():
    """build_zeeman_nlte_scene at 12 levels, 64 frequencies and 16 bench
    lines (its 16-line non-LTE band, IGRF-13 field and reflecting surface
    as at full size), the JAX package's scene of the same leaves, and JAX's
    radiance over the reflecting surface for each rte_option with its
    Jacobian with respect to atm.mag (jax.jacrev, constant layers)."""
    b = build_zeeman_nlte_scene(n_lev=12, n_freq=64, n_lines=16, **CPU64)
    scene, f, path = b["scene"], b["f_grid"], b["path"]
    js = to_jax(scene)

    @ref_jit
    def refs(js, f, alt, za, dr):
        sim = lambda s, opt: JF.simulate_clearsky_polarized(
            s, f, alt, za, dr, background="surface_reflect", rte_option=opt)
        with_mag = lambda m: dataclasses.replace(js, atm=dataclasses.replace(js.atm, mag=m))
        out = {opt: sim(js, opt) for opt in OPTIONS}
        out["jac"] = jax.jacrev(lambda m: sim(with_mag(m), "constant"))(js.atm.mag)
        return out

    want = refs(js, *(jnp.asarray(np.asarray(a)) for a in (f, path.alt, path.za, path.dr)))
    return scene, f, path, jax.tree_util.tree_map(np.asarray, want)


@pytest.mark.parametrize("opt", OPTIONS)
def test_polarized_reflecting_surface_and_nlte_band_match_jax(nlte_case, opt):
    """simulate_clearsky_polarized over the reflecting surface (reflectance
    0.1) with the non-LTE band, down-looking from the top: all four Stokes
    components within 1e-10 of I's scale, V within 1e-10 of its own, and
    V nonzero; the non-LTE band and the reflection each change I."""
    scene, f, path, want = nlte_case
    run = lambda sc, bg="surface_reflect": simulate_clearsky_polarized(
        sc, f, path.alt, path.za, path.dr, background=bg, rte_option=opt, **CPU64).numpy()
    got = run(scene)
    w = want[opt]
    np.testing.assert_allclose(got, w, rtol=0, atol=1e-10 * np.abs(w[:, 0]).max())
    vmax = np.abs(w[:, 3]).max()
    assert vmax > 0
    np.testing.assert_allclose(got[:, 3], w[:, 3], rtol=0, atol=1e-10 * vmax)
    for other in (run(dataclasses.replace(scene, nlte=None)), run(scene, "surface")):
        assert np.abs(other[:, 0] - got[:, 0]).max() > 1e-6 * np.abs(got[:, 0]).max()


def test_magnetic_field_jacobian_matches_jax_jacrev(nlte_case):
    """d I / d atm.mag (east, north, up at each of the 12 levels) of the
    radiance over the reflecting surface with the non-LTE band, by
    torch.func.jacfwd against jax.jacrev: each column within 1e-8 of its
    largest entry plus 1e-10 of the largest entry of its component's
    block.  The second term is float64 roundoff: near the surface the
    Zeeman splitting (~1 MHz) is a small perturbation of GHz-wide lines,
    so the field's derivative there is a difference of nearly equal
    sigma+- terms: these columns follow the last bits of the line
    centres' arithmetic, and JAX's own jacfwd and jacrev differ there by
    far more than 1e-14 of the block."""
    scene, f, path, want = nlte_case

    def fn(mag):
        sc = dataclasses.replace(scene, atm=dataclasses.replace(scene.atm, mag=mag))
        return simulate_clearsky_polarized(sc, f, path.alt, path.za, path.dr,
                                           background="surface_reflect", **CPU64)

    got = torch.func.jacfwd(fn)(scene.atm.mag).numpy()
    w = want["jac"]
    assert got.shape == w.shape == (f.numel(), 4) + tuple(scene.atm.mag.shape)
    for c in range(3):
        g, ww = got[..., c, :].reshape(-1, got.shape[-1]), w[..., c, :].reshape(-1, w.shape[-1])
        col = np.abs(ww).max(0)
        assert (col > 0).all()
        np.testing.assert_array_less(np.abs(g - ww).max(0), 1e-8 * col + 1e-10 * col.max())
