"""The port's solar DISORT (arts_tpu_torch.disort with mu0 > 0, BRDF
surfaces and the TMS/IMS corrections) against the cdisort goldens and
arts_tpu on the CPU at float64.  On CPU tensors the fused solve runs the
kernels' plain versions, stage 1's beam branch among them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.disort.solver as j_solver
from arts_tpu.disort import DisortInput as JInput
from arts_tpu.disort import brdf as j_brdf
from arts_tpu_torch.disort import DisortInput, disort
from arts_tpu_torch.disort import brdf as p_brdf
from test_disort import band_planck, golden_case

CPU64 = dict(device="cpu", dtype=torch.float64)
# jax.jit with LLVM's optimizations off, as in tests/test_torch_clearsky.py
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


def _golden_input(c):
    """A cdisort golden configuration as the port's one-frequency input."""
    L, nstr = c["nlyr"], c["nstr"]
    g = np.asarray(c["g"], np.float64)
    if c["planck"]:
        b_levels = [band_planck(c["wvnmlo"], c["wvnmhi"], t) for t in c["temper"][: L + 1]]
        b_surf = band_planck(c["wvnmlo"], c["wvnmhi"], c["btemp"])
        b_top = band_planck(c["wvnmlo"], c["wvnmhi"], c["ttemp"]) * c["temis"]
    else:
        b_levels, b_surf, b_top = np.zeros(L + 1), 0.0, 0.0
    one = lambda x: torch.tensor(np.asarray([x], np.float64))
    return DisortInput(
        tau=one(c["dtauc"]), omega=one(c["ssalb"]),
        leg=one(g[:, None] ** np.arange(c["nmom"] + 1)), f=one(g**nstr),
        b_levels=one(b_levels), fisot=one(c["fisot"]), albedo=one(c["albedo"]),
        b_surf=one(b_surf), b_top=one(b_top), fbeam=one(c["fbeam"]))


GROUPS = {
    "isotropic and HG beams": ("iso_thin_beam", "iso_thick_beam", "hg_beam", "hg_beam_albedo",
                               "hg_32str", "grazing_beam_thick", "near_conservative",
                               "iso_isotropic_top"),
    "beams with thermal emission": ("thermal_beam_mix", "thermal_beam_albedo",
                                    "eight_stream_mix"),
    "Hapke surfaces": ("hapke_beam", "hapke_thermal_beam"),
}


@pytest.mark.parametrize("group", list(GROUPS))
def test_cdisort_goldens_with_a_beam(group):
    """13 of the 15 cdisort goldens (12 with a beam, 2 of them over a Hapke
    BRDF, and the isotropic-top case) at tests/test_disort.py's
    tolerances: fluxes 2e-5, intensities 5e-4, the direct flux 1e-8; on
    the fused route (its plain versions here) and, for the thermal and
    Hapke groups, the differentiable route."""
    routes = (None,) if group == "isotropic and HG beams" else (None, False)
    for name in GROUPS[group]:
        c = golden_case(name)
        nstr, mu0 = c["nstr"], c["umu0"]
        brdf = None
        if c.get("brdf") == 4:
            brdf = p_brdf.surface_brdf_modes(p_brdf.hapke_brdf, nstr, nstr if mu0 > 0 else 1,
                                             mu0=mu0 if mu0 > 0 else None, **CPU64)
        for route in routes:
            out = disort(_golden_input(c), nquad=nstr, nleg=c["nmom"] + 1, mu0=mu0,
                         phi0=c["phi0"], phis=(0.0,), brdf=brdf, fast_linalg=route, **CPU64)
            what = f"{name} fast_linalg={route}"
            np.testing.assert_allclose(out.mu.numpy(), c["umu"], rtol=1e-10)
            scale = max(np.abs(c["flup"]).max(), np.abs(c["rfldn"]).max(),
                        np.abs(c["rfldir"]).max())
            np.testing.assert_allclose(out.flux_direct[0].numpy(), c["rfldir"], rtol=1e-8,
                                       atol=1e-12 * scale, err_msg=what)
            for key, ref in (("flux_up", c["flup"]), ("flux_down_diffuse", c["rfldn"])):
                np.testing.assert_allclose(getattr(out, key)[0].numpy(), ref, rtol=2e-5,
                                           atol=2e-5 * scale, err_msg=f"{what} {key}")
            u0_ref = np.asarray(c["u0u"]).T
            uscale = np.abs(u0_ref).max()
            np.testing.assert_allclose(out.u0[0].numpy(), u0_ref, rtol=5e-4, atol=5e-4 * uscale,
                                       err_msg=what)
            np.testing.assert_allclose(out.u[0, ..., 0].numpy(), np.asarray(c["uu"]).T,
                                       rtol=5e-4, atol=5e-4 * uscale, err_msg=what)


def _inputs(F=3, L=5, nleg=16, seed=0):
    """F problems as numpy: scattering layers with delta-M, one optically
    thin layer, one at omega = 1, thermal sources, isotropic illumination
    at the top, and a beam."""
    rng = np.random.default_rng(seed)
    tau = rng.uniform(0.05, 1.5, (F, L))
    tau[:, 1] = 3e-6
    omega = rng.uniform(0.1, 0.9, (F, L))
    omega[:, 2] = 1.0
    g = rng.uniform(0.0, 0.8, (F, L))
    return dict(
        tau=tau, omega=omega, leg=g[..., None] ** np.arange(nleg), f=0.5 * g**8,
        b_levels=np.linspace(1.0, 2.0, L + 1) * rng.uniform(0.5, 1.5, (F, 1)),
        fisot=rng.uniform(0.0, 0.2, F), albedo=rng.uniform(0.0, 0.4, F),
        b_surf=rng.uniform(2.0, 3.0, F), b_top=rng.uniform(0.0, 0.05, F),
        fbeam=rng.uniform(1.0, 3.0, F))


KW = dict(nquad=8, nleg=16, nfourier=4, mu0=0.6, phi0=30.0, phis=(0.0, 45.0, 180.0),
          intensity_correction=True)
RPV = dict(rho0=0.05, k=0.7, theta=-0.2)


def test_beam_brdf_and_corrections_match_jax():
    """A beam over an RPV surface, 4 Fourier modes, u at three azimuths
    with the TMS/IMS corrections (16 phase moments, the solve keeping 8):
    the fused route (its plain versions) and the differentiable route
    against arts_tpu's XLA route (LAPACK) at its fused-vs-XLA tolerance,
    rtol 2e-5 (tests/test_fused_disort.py:54).  The corrections move u
    by more than that."""
    d = _inputs()
    rpv = lambda lib: functools.partial(lib.rpv_brdf, **RPV)
    jb = j_brdf.surface_brdf_modes(rpv(j_brdf), 8, 4, mu0=KW["mu0"])
    jinp = JInput(**{k: jnp.asarray(v) for k, v in d.items()})

    @ref_jit
    def ref(jinp, jb):
        run = lambda ic: jax.vmap(lambda i: j_solver.disort(
            i, brdf=jb, fast_linalg=False, **dict(KW, intensity_correction=ic)))(jinp)
        return run(True), run(False).u

    want, u_plain = ref(jinp, jb)
    pb = p_brdf.surface_brdf_modes(rpv(p_brdf), 8, 4, mu0=KW["mu0"], **CPU64)
    inp = DisortInput(**{k: torch.tensor(v) for k, v in d.items()})
    for route in (None, False):
        out = disort(inp, brdf=pb, fast_linalg=route, **KW, **CPU64)
        for key in ("flux_up", "flux_down_diffuse", "flux_direct", "u0", "u"):
            w = np.asarray(getattr(want, key))
            np.testing.assert_allclose(getattr(out, key).numpy(), w, rtol=2e-5,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=f"fast_linalg={route} {key}")
    w = np.asarray(want.u)
    assert np.abs(w - np.asarray(u_plain)).max() > 100 * 2e-5 * np.abs(w).max()


def test_surface_brdf_modes_match_jax():
    """SurfaceBrdf modes of the Hapke and RPV BRDFs, with and without the
    beam column, against arts_tpu's at 1e-13 of scale."""
    for fn, kw in (("hapke_brdf", {}), ("rpv_brdf", RPV)):
        for mu0 in (None, 0.45):
            a = j_brdf.surface_brdf_modes(functools.partial(getattr(j_brdf, fn), **kw), 16, 5,
                                          mu0=mu0)
            b = p_brdf.surface_brdf_modes(functools.partial(getattr(p_brdf, fn), **kw), 16, 5,
                                          mu0=mu0, **CPU64)
            for key in ("bdr", "bdr_beam", "bem"):
                w = np.asarray(getattr(a, key))
                np.testing.assert_allclose(getattr(b, key).numpy(), w, rtol=0,
                                           atol=1e-13 * max(np.abs(w).max(), 1.0),
                                           err_msg=f"{fn} mu0={mu0} {key}")


def test_brdf_parameter_gradient_matches_jax():
    """d(TOA upwelling flux)/d(Hapke single scattering albedo) on the
    hapke_beam golden through the Fourier modes and the differentiable
    route (autograd) against jax.grad of arts_tpu's solve
    (tests/test_disort.py:261), at rtol 2e-5, and positive."""
    c = golden_case("hapke_beam")
    L, nstr = c["nlyr"], c["nstr"]
    leg = np.asarray(c["g"])[:, None] ** np.arange(c["nmom"] + 1)[None, :]
    fcol = np.asarray(c["g"]) ** nstr
    kw = dict(nquad=nstr, nleg=c["nmom"] + 1, mu0=c["umu0"], phis=(0.0,))

    def j_toa_up(wh):
        brdf = j_brdf.surface_brdf_modes(lambda mo, mi, dp: j_brdf.hapke_brdf(mo, mi, dp, w=wh),
                                         nstr, nstr, mu0=c["umu0"])
        inp = JInput(tau=jnp.asarray(c["dtauc"]), omega=jnp.asarray(c["ssalb"]),
                     leg=jnp.asarray(leg), f=jnp.asarray(fcol), b_levels=jnp.zeros(L + 1),
                     fbeam=jnp.asarray(c["fbeam"]), fisot=jnp.asarray(0.0),
                     albedo=jnp.asarray(0.0), b_surf=jnp.asarray(0.0), b_top=jnp.asarray(0.0))
        return j_solver.disort(inp, brdf=brdf, **kw).flux_up[0]

    want = float(ref_jit(jax.grad(j_toa_up))(0.6))
    wh = torch.tensor(0.6, dtype=torch.float64, requires_grad=True)
    brdf = p_brdf.surface_brdf_modes(lambda mo, mi, dp: p_brdf.hapke_brdf(mo, mi, dp, w=wh),
                                     nstr, nstr, mu0=c["umu0"], **CPU64)
    one = lambda x: torch.tensor(np.asarray([x], np.float64))
    inp = DisortInput(tau=one(c["dtauc"]), omega=one(c["ssalb"]), leg=one(leg), f=one(fcol),
                      b_levels=torch.zeros(1, L + 1, dtype=torch.float64),
                      fisot=one(0.0), albedo=one(0.0), b_surf=one(0.0), b_top=one(0.0),
                      fbeam=one(c["fbeam"]))
    out = disort(inp, brdf=brdf, fast_linalg=False, **kw, **CPU64)
    (got,) = torch.autograd.grad(out.flux_up[0, 0], wh)
    assert want > 0
    np.testing.assert_allclose(float(got), want, rtol=2e-5)
