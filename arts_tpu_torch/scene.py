"""The benchmark scenes and the cloud-retrieval case, built without JAX.

synth_par_rows and build_scene are copies of bench.py's (without its
real-catalog branch): 2048 HITRAN-shaped H2O + O2 lines read through the
.par reader, 4096 frequencies from 160 to 260 GHz, a 60-level US-76
atmosphere, one Henyey-Greenstein cloud between 4 and 9 km, and a 288 K
surface.  build_zeeman_inputs is bench.py's Zeeman stage on that scene, and
build_zeeman_nlte_scene the polarized radiance scene around it (IGRF-13
field, reflecting surface, a non-LTE band).
build_solar_scene is that scene lit by the sun (the solar DISORT path),
build_sun_camera the JAX package's sun-camera example.
build_cloud_retrieval is an OEM retrieval of cloud extinction, single
scattering albedo and surface temperature in a cloudy microwave window.
build_stage23_case gives the DISORT stage 2+3 kernel random problems on
which its elimination shows, build_stage1_case the stage 1 kernel random
scattering problems on which its Jacobi sweeps show (build_beam_case with
random beam sources for its beam instance), build_zeeman_mp_case
the zeeman_mp kernel random pole records on which every part of its sum
shows.  build_clearsky_measurement is an ATMS 183 GHz scan line over the
benchmark scene, build_clearsky_retrieval a water-vapour retrieval from
25 Gaussian channels on the window scene without its cloud.
build_continuum_scene is the benchmark scene with its continua added to
the lines, build_predef_scene an all-sky scene of the JAX package's
example gas models without a catalog, and build_lookup_case a lookup
table's training inputs on the benchmark and its check points.
build_ecs_scene is a clear-sky 50-70 GHz scene whose O2 band is one ECS
line-mixing band (o2_ecs_par_rows: the 38 lines of O2-MPM2020 as .par
rows), build_ecs_measurement an ATMS temperature-sounding scan line over
it.  build_occultation_scan is a limb scan through the 183 GHz water line
with the sun on every beam's axis, build_sky_almucantar a sky
radiometer's almucantar in the visible (the sun in the beam and the
Rayleigh-scattered sun), and build_subsurface_case a firn column's
microwave emission through DISORT under the clear-sky downwelling
radiance.
"""

import dataclasses

import numpy as np
import torch

from . import constants as const
from ._cuda import move, resolve
from .atm import Atmosphere1D
from .atm.field import hydrostatic_pressure
from .atm.subsurface import SubsurfaceField
from .atm.igrf import magnetic_profile
from .atm.standard import standard_atmosphere
from .disort import DisortInput
from .disort import fused_kernel as FK
from .disort.quadrature import double_gauss, lambda_tables
from .disort.solver import solve_terms
from .fwd import ClearskyScene, ZeemanScene, simulate_clearsky
from .fwd_allsky import AllskyScene, gas_absorption_profile, simulate_allsky
from .io.hitran import (
    einstein_a_from_s,
    o2_lines_from_par,
    read_par,
    read_par_records,
    zeeman_catalog_from_par,
)
from .io.species import ISOTOPOLOGUES
from .lbl.catalog import build_catalog, hitran_s
from .lbl.ecs import make_o2_band, o2_erot
from .lbl.nlte import NlteField, boltzmann_ratios, nlte_fit_profile
from .lbl.partfun import rigid_rotor_table
from .lbl.tmodel import Law
from .lbl.zeeman import pad_zeeman_catalog, tune_zeeman_profile
from .path import PathGeometry, geometric_path_1d
from .path.geometry import EARTH_RADIUS
from .ops.zeeman_mp_kernel import MP_TERMS, NCOMP, pole_records
from .predefined.models import _M20_C, _M20_F0, _M20_GA
from .retrieval import covariance
from .retrieval.targets import RetrievalTarget, StateMapping
from .scattering import HenyeyGreenstein
from .sensor import SensorArray, gaussian_channels
from .sensor.measurement import stack_paths
from .sun import Sun, sun_blackbody


def synth_par_rows(n_lines=2048, fmin=160e9, fmax=260e9, seed=7):
    """Synthetic but HITRAN-shaped .par rows for H2O + O2: per-line
    self + air broadening, spread temperature exponents, pressure shifts,
    O2 local quanta."""
    rng = np.random.default_rng(seed)
    rows = []
    f0s = np.sort(rng.uniform(fmin, fmax, n_lines))
    for i, f0 in enumerate(f0s):
        is_h2o = i % 2 == 0
        mol = 1 if is_h2o else 7
        nu = f0 / (100.0 * 299792458.0)
        A = rng.uniform(1e-8, 1e-6)
        gair = rng.uniform(0.02, 0.10)  # cm-1/atm
        gself = gair * rng.uniform(1.1, 5.0)
        e0 = rng.uniform(0.0, 1500.0)  # cm-1
        n_air = rng.uniform(0.4, 0.9)
        dair = rng.uniform(-0.01, 0.01)
        gu = 2.0 * rng.integers(1, 20) + 1.0
        N = int(rng.integers(1, 20))
        loc = f"  Q {N:2d}  R {max(N - 1, 0):2d}   " if not is_h2o else ""
        row = (
            f"{mol:2d}" + "1"
            + f"{nu:12.6f}" + f"{1e-30:10.3E}" + f"{A:10.3E}"
            + f"{gair:5.4f}"[:5] + f"{gself:5.4f}"[:5]
            + f"{e0:10.4f}" + f"{n_air:4.2f}" + f"{dair:8.6f}"
            + " " * 30 + " " * 15 + loc.ljust(15)
        ).ljust(146) + f"{gu:7.1f}" + f"{max(gu - 2, 1):7.1f}"
        rows.append(row)
    return rows


def build_scene(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """(AllskyScene, f_grid [n_freq]) of the benchmark; lines carry a
    25 GHz cutoff."""
    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=("H2O", "O2"),
                              device=dev, dtype=dt)
    scene = AllskyScene(
        atm=atm, cat=build_catalog(_bench_lines(n_lines), device=dev, dtype=dt),
        pf=_bench_partfun(dev, dt), scatterers=(_bench_cloud(atm),),
        surface_temperature=torch.tensor(288.0, dtype=dt, device=dev),
        surface_albedo=torch.tensor(0.0, dtype=dt, device=dev),
    )
    f_grid = torch.as_tensor(np.linspace(160e9, 260e9, n_freq), dtype=dt, device=dev)
    return scene, f_grid


def _bench_lines(n_lines):
    lines = read_par(synth_par_rows(n_lines), ["H2O", "O2"], cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    return lines


def _bench_partfun(dev, dt):
    return rigid_rotor_table(2, [174.6, 215.7], 1.5, device=dev, dtype=dt)


def _bench_cloud(atm):
    """The benchmark's Henyey-Greenstein cloud between 4 and 9 km."""
    in_cloud = (atm.z > 4e3) & (atm.z < 9e3)
    return HenyeyGreenstein(
        ext=torch.where(in_cloud, torch.full_like(atm.z, 3e-4), torch.zeros_like(atm.z)),
        ssa=torch.full_like(atm.z, 0.85),
        g=torch.full_like(atm.z, 0.7),
    )


# the continuum-only models of build_continuum_scene: no line of the
# benchmark catalog is counted twice
CONTINUA = ("H2O-SelfContCKDMT350", "H2O-ForeignContCKDMT350", "N2-SelfContStandardType")
# the gas models of the JAX package's examples 1 and 3
EXAMPLE_GAS_MODELS = ("N2-SelfContStandardType", "O2-PWR98", "H2O-PWR98")


def build_continuum_scene(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """(AllskyScene, f_grid) of the benchmark scene with its continua: an
    N2 row added to the atmosphere (rows H2O, O2, N2; the H2O and O2 rows
    and the catalog's species indices unchanged) and the MT_CKD 3.50 H2O
    self and foreign continua and the standard N2 continuum (CONTINUA)
    added to the 2048 lines."""
    dev, dt = resolve(device, dtype)
    scene, f = build_scene(n_lev, n_freq, n_lines, device=dev, dtype=dt)
    species = ("H2O", "O2", "N2")
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=species, device=dev,
                              dtype=dt)
    return dataclasses.replace(scene, atm=atm, predef=CONTINUA, species_names=species), f


def build_predef_scene(n_lev=60, n_freq=4096, device=None, dtype=None):
    """(AllskyScene, f_grid) of predefined models alone: the gas models of
    the JAX package's example 3 (EXAMPLE_GAS_MODELS), no line catalog, the
    benchmark's atmosphere (rows N2, O2, H2O), cloud and surface, and
    n_freq frequencies over example 1's 10-200 GHz."""
    dev, dt = resolve(device, dtype)
    species = ("N2", "O2", "H2O")
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=species, device=dev,
                              dtype=dt)
    scene = AllskyScene(
        atm=atm, cat=None, pf=None, scatterers=(_bench_cloud(atm),),
        surface_temperature=torch.tensor(288.0, dtype=dt, device=dev),
        surface_albedo=torch.tensor(0.0, dtype=dt, device=dev),
        predef=EXAMPLE_GAS_MODELS, species_names=species,
    )
    return scene, torch.as_tensor(np.linspace(10e9, 200e9, n_freq), dtype=dt, device=dev)


@dataclasses.dataclass(frozen=True)
class LookupCase:
    """A lookup table's training inputs (train_lookup's arguments) and the
    off-grid points at which to hold the table against direct absorption:
    T, P [M], vmr [M, S]."""

    f_grid: torch.Tensor
    cat: object
    pf: object
    p_grid: torch.Tensor
    t_ref: torch.Tensor
    w_ref: torch.Tensor
    vmr_ref: torch.Tensor
    spec_idx: int
    t_pert: torch.Tensor
    w_pert: torch.Tensor
    T: torch.Tensor
    P: torch.Tensor
    vmr: torch.Tensor

    def train_args(self):
        return (self.f_grid, self.cat, self.pf, self.p_grid, self.t_ref, self.w_ref,
                self.vmr_ref, self.spec_idx, self.t_pert, self.w_pert)


def build_lookup_case(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """A lookup table for H2O on the benchmark: the H2O lines of the
    benchmark catalog (a table holds one species, whose absorption its
    water axis scales; the O2 lines would need a table of their own), its
    n_freq frequencies, its n_lev levels as the reference profile (t, p,
    H2O VMR; the other species at their surface VMRs), temperature
    offsets -20..20 K and water factors 0.25..4 in 5 values each: 1,500
    training points at 60 levels.  The check points lie between adjacent
    levels (0.37 of the way in log p), 4.7 K warmer than the reference
    there and with 1.3 times its water."""
    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=("H2O", "O2"),
                              device=dev, dtype=dt)
    f = torch.as_tensor(np.linspace(160e9, 260e9, n_freq), dtype=dt, device=dev)
    lines = [l for l in _bench_lines(n_lines) if l["spec_idx"] == 0]
    lp = torch.log(atm.p)
    lp_mid = 0.63 * lp[:-1] + 0.37 * lp[1:]
    mix = lambda a: 0.63 * a[:-1] + 0.37 * a[1:]  # linear in log p
    vmr_ref = atm.vmr[:, 0]
    w_mid = 1.3 * mix(atm.vmr[0])
    vmr = torch.cat([w_mid[:, None], vmr_ref[1:].expand(w_mid.shape[0], -1)], 1)
    return LookupCase(
        f_grid=f, cat=build_catalog(lines, device=dev, dtype=dt), pf=_bench_partfun(dev, dt),
        p_grid=atm.p, t_ref=atm.t, w_ref=atm.vmr[0], vmr_ref=vmr_ref, spec_idx=0,
        t_pert=torch.linspace(-20.0, 20.0, 5, dtype=dt, device=dev),
        w_pert=torch.tensor([0.25, 0.5, 1.0, 2.0, 4.0], dtype=dt, device=dev),
        T=mix(atm.t) + 4.7, P=torch.exp(lp_mid), vmr=vmr)


def build_zeeman_inputs(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """The Zeeman stage's inputs on the benchmark scene (bench.py's Zeeman
    stage): the Zeeman catalog of synth_par_rows with g factors from the
    quanta and a 25 GHz cutoff, its padded form and the profile knobs, the
    atmosphere at its levels top first, a [0, 3e-5, 3e-5] T field and a
    nadir line of sight.  Returns a dict: f_grid, zcat (ZeemanCatalog),
    pzcat (its PaddedZeemanCatalog), pf, T, P, vmr, mag, los_za_deg and
    tune (tune_zeeman_profile's knobs)."""
    dev, dt = resolve(device, dtype)
    scene, f_grid = build_scene(n_lev, n_freq, n_lines, device=dev, dtype=dt)
    zcat = zeeman_catalog_from_par(synth_par_rows(n_lines), ["H2O", "O2"],
                                   cutoff=25e9, device=dev, dtype=dt)
    pzcat = pad_zeeman_catalog(zcat)
    pts = scene.atm.at(scene.atm.z.flip(0))
    return dict(
        f_grid=f_grid, zcat=zcat, pzcat=pzcat, pf=scene.pf, T=pts.t, P=pts.p,
        vmr=pts.vmr, mag=torch.tensor([0.0, 3e-5, 3e-5], dtype=dt, device=dev),
        los_za_deg=180.0, tune=tune_zeeman_profile(f_grid, pzcat),
    )


# the non-LTE band of build_zeeman_nlte_scene: the CO-like line of
# examples/8_nlte_radiance.py (J = 1 - 0: its A, g, mass and broadening) at
# NLTE_LINES centres spread over the grid, all between one pair of levels,
# in a species of its own at NLTE_VMR
NLTE_LINES = 16
NLTE_VMR = 1e-6
NLTE_G = (1.0, 3.0)
SURFACE_REFLECTANCE = 0.1


def build_zeeman_nlte_scene(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """The polarized scene with a reflecting surface and a non-LTE band:
    the catalog, grid and levels of build_zeeman_inputs (2048 .par lines,
    4096 frequencies from 160 to 260 GHz, 60 levels to 80 km), the IGRF-13
    field of 2020 at 60 N, 0 E (examples/2_zeeman.py's latitude), a 288 K
    surface of reflectance 0.1, and a 16-line CO-like two-level band whose
    population ratios come from nlte_fit_profile against the band's own
    radiation field with examples/8_nlte_radiance.py's collision rates
    (3e-7 /s scaled with pressure, the upward rate in detailed balance),
    starting from the Boltzmann ratios.  Everything is computed in
    float64 on `device` and cast to `dtype` at the end, so that every
    precision gets the same scene.

    Returns a dict: scene (ZeemanScene), f_grid, path (a down-looking
    path.PathGeometry from the top of the scene, one point per level),
    fit (nlte_fit_profile's keyword arguments, float64) and fit_iterations."""
    dev, dt = resolve(device, dtype)
    f64 = dict(device=dev, dtype=torch.float64)
    base, f_grid = build_scene(n_lev, n_freq, n_lines, **f64)
    zcat = zeeman_catalog_from_par(synth_par_rows(n_lines), ["H2O", "O2"], cutoff=25e9, **f64)
    z, t, p = base.atm.z, base.atm.t, base.atm.p
    vmr = torch.cat([base.atm.vmr, torch.full_like(base.atm.vmr[:1], NLTE_VMR)])
    atm = Atmosphere1D(z=z, t=t, p=p, vmr=vmr,
                       mag=magnetic_profile(z, lat_deg=60.0, lon_deg=0.0, year=2020.0, **f64))
    fmin, fmax = float(f_grid[0]), float(f_grid[-1])
    f0 = fmin + (np.arange(NLTE_LINES) + 0.5) * (fmax - fmin) / NLTE_LINES
    cat = build_catalog([dict(f0=f, a=7.2e-8, e0=0.0, gu=NLTE_G[1], gl=NLTE_G[0],
                              iso_mass=28.0, iso_ratio=1.0, spec_idx=vmr.shape[0] - 1,
                              iso_idx=0, band_idx=0, t0=296.0, cutoff=np.inf,
                              ls={"bath": {"G0": (Law.T1, [2.4e4, 0.75])}}) for f in f0],
                        **f64)
    g = torch.tensor(NLTE_G, **f64)
    E = torch.tensor([0.0, const.h * float(f0.mean())], **f64)
    Q = (g * torch.exp(-E / (const.k * t[:, None]))).sum(-1)
    r_lte = boltzmann_ratios(t, g, E, Q)
    Cul = 3e-7 * (p / p[0])[:, None].expand(-1, NLTE_LINES)
    Clu = Cul * (g[1] / g[0]) * torch.exp(-const.h * cat.f0 / (const.k * t[:, None]))
    up = torch.ones(NLTE_LINES, dtype=torch.int64, device=dev)
    fit = dict(f_grid=f_grid, z_levels=z, t_prof=t, p_prof=p, vmr_prof=vmr.T, cat=cat,
               n_levels=2, up_idx=up, lo_idx=up - 1, Cul=Cul, Clu=Clu, r_sum=r_lte.sum(-1),
               r_init=r_lte, surf_t=torch.tensor(288.0, **f64),
               surf_eps=1.0 - SURFACE_REFLECTANCE, convergence_limit=1e-8)
    r, n_iter, _ = nlte_fit_profile(**fit, **f64)
    scene = ZeemanScene(atm=atm, zcat=zcat, pf=base.pf,
                        surface_temperature=torch.tensor(288.0, **f64),
                        surface_reflectance=torch.tensor(SURFACE_REFLECTANCE, **f64),
                        nlte=NlteField(z=z, r=r, cat=cat, up_idx=up, lo_idx=up - 1))
    top = float(z[-1])
    path = geometric_path_1d(top, 180.0, 0.0, top, top / (n_lev - 1))
    return dict(scene=move(scene, dev, dt), f_grid=f_grid.to(dt), path=path, fit=fit,
                fit_iterations=n_iter)


def build_stage23_case(nquad, B, L, seed, device=None, dtype=None):
    """The stage 2+3 inputs (gp, gm, ek, rhs, rsurf, ut, vt, ub, vb) of B
    random thermal problems of L layers, nquad streams, one Fourier mode:
    optical depth 0.05-2 and single scattering albedo 0-0.9 per layer,
    Legendre moments g^k with g in 0.3-0.8, a Planck profile rising from
    top to bottom, a cold top (b 0.01) and a Lambertian surface of albedo
    0.3 (a non-zero Rsurf) at b 2.5.  So the homogeneous solution, which
    the block-tridiagonal elimination computes, carries a large part of
    the level radiances at the boundaries; on build_scene's black surface
    they are the particular solution to within its rounding.  Stage 1 runs
    its plain version in float64; the inputs are then cast to dtype."""
    dev, dt = resolve(device, dtype)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    inp = DisortInput(
        tau=t(rng.uniform(0.05, 2.0, (B, L))), omega=t(rng.uniform(0.0, 0.9, (B, L))),
        leg=t(rng.uniform(0.3, 0.8, (B, L, 1)) ** np.arange(nquad)), f=t(np.zeros((B, L))),
        b_levels=t(np.linspace(1.0, 2.0, L + 1) * rng.uniform(0.5, 1.5, (B, 1))),
        fisot=t(np.zeros(B)), albedo=t(np.full(B, 0.3)), b_surf=t(np.full(B, 2.5)),
        b_top=t(np.full(B, 0.01)))
    tm = solve_terms(inp, nquad, 1)
    s1 = FK.stage1_inputs(tm["leg_scaled"], tm["omega_p"], tm["dtau_p"], tm["tb0"], tm["tb1"],
                          lam=tm["lam"], sign=tm["sign"], mu=tm["mu"], w=tm["w"])
    ek, gp, gm, ut, vt, ub, vb = FK.stage1_plain(*s1, 8)
    rhs, rsurf = FK.stage23_inputs(ut, vt, ub, vb, tm["rsurf"], tm["b_neg"], tm["rhs_surf"])
    return tuple(x.to(dt).contiguous() for x in (gp, gm, ek, rhs, rsurf, ut, vt, ub, vb))


def build_stage1_case(nquad, B, L, seed, device=None, dtype=None):
    """The stage 1 inputs (pp, pm, om, dtau, tb0, tb1, qtab; see
    fused_kernel.stage1_inputs) of B random scattering problems of L
    layers, nquad streams, one Fourier mode: single scattering albedo
    0.05-0.95, Henyey-Greenstein moments with g 0-0.85, optical depth
    1e-3-1.5 and the thermal terms (1 - omega)(b0, b1) with b0 0.5-2 and
    b1 -1-1.  So H1 and H2 are far from diagonal and the Jacobi sweeps
    turn the eigenvectors away from the coordinate axes (the sine of the
    angle to the nearest axis has a median of ~0.2); in build_scene's
    layers the cloud is nearly black against the gas and they are
    diagonal to ~1e-3.  Built in float64, then cast to dtype."""
    dev, dt = resolve(device, dtype)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    n = nquad // 2
    mu, w = double_gauss(n)
    lam, sign = lambda_tables(1, nquad, n)
    omega = rng.uniform(0.05, 0.95, (B, L))
    g = rng.uniform(0.0, 0.85, (B, L))
    legs = (2 * np.arange(nquad) + 1) * g[..., None] ** np.arange(nquad)
    src = (1.0 - omega)[:, None, :]
    s1 = FK.stage1_inputs(t(legs), t(omega), t(rng.uniform(1e-3, 1.5, (B, L))),
                          t(src * rng.uniform(0.5, 2.0, (B, 1, L))),
                          t(src * rng.uniform(-1.0, 1.0, (B, 1, L))),
                          lam=lam, sign=sign, mu=mu, w=w)
    return tuple(x.to(dt).contiguous() for x in s1)


def build_beam_case(nquad, B, L, seed, mu0, device=None, dtype=None):
    """(stage 1 inputs, beam): build_stage1_case's B random scattering
    problems of L layers and stage 1's beam argument for them
    (fused_kernel.beam_inputs' layout): sources q+/q- uniform in -1..1
    and 0..2, the attenuation at the layer top uniform in 0.05..1 and at
    its bottom 0.2..1 of that, from zenith cosine mu0.  Built in float64,
    then cast to dtype."""
    dev, dt = resolve(device, dtype)
    ins = build_stage1_case(nquad, B, L, seed, device=dev, dtype=dt)
    rng = np.random.default_rng(seed + 1000)
    n = nquad // 2
    ebt = rng.uniform(0.05, 1.0, (L, B))
    beam = (rng.uniform(-1.0, 1.0, (L, n, B)), rng.uniform(0.0, 2.0, (L, n, B)), ebt,
            ebt * rng.uniform(0.2, 1.0, (L, B)))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev).to(dt).contiguous()
    return ins, tuple(map(t, beam)) + (float(mu0),)


def build_solar_scene(n_lev=60, n_freq=4096, n_lines=2048, device=None, dtype=None):
    """(AllskyScene, f_grid, simulate_allsky keywords) of the sun-lit
    benchmark scene: build_scene's atmosphere, catalog and cloud, the sun
    at 60 degrees zenith (mu0 = 0.5, azimuth 0) with fbeam = pi (as in the
    JAX package's examples/12_sun_camera_allsky.py), thermal emission on
    (both sources), 16 streams and 16 Fourier modes, the cloud's phase
    function to 32 moments (so that the TMS correction, the single
    scattering of the moments past the solve's 16, is not zero), and the
    field u at azimuths 0, 90 and 180 degrees with the TMS/IMS
    corrections."""
    scene, f = build_scene(n_lev=n_lev, n_freq=n_freq, n_lines=n_lines, device=device,
                           dtype=dtype)
    kw = dict(nquad=16, nleg=32, nfourier=16, mu0=0.5, fbeam=float(np.pi), phi0=0.0,
              phis=(0.0, 90.0, 180.0), thermal=True, intensity_correction=True)
    return scene, f, kw


def build_sun_camera(device=None, dtype=None):
    """(AllskyScene, f_grid, paths, observer) of the JAX package's
    examples/12_sun_camera_allsky.py: a 40-level N2 atmosphere to 60 km
    with a forward-scattering haze below 3 km (HG, ext 2e-5 / m, ssa 0.85,
    g 0.7), a 290 K black surface, one frequency (230 GHz), the sun at 60
    degrees zenith (fbeam = pi, azimuth 0, no thermal emission), and a
    ring of 7 camera pixels at 150 degrees zenith, azimuths 0-180 degrees,
    read by the azimuth-resolved allsky_observer (16 streams, 16 Fourier
    modes, 32 phase moments)."""
    from .sensor.observers import allsky_observer

    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=40, z_top=60e3, species=("N2",), device=dev, dtype=dt)
    haze = HenyeyGreenstein(
        ext=torch.where(atm.z < 3e3, torch.full_like(atm.z, 2e-5), torch.zeros_like(atm.z)),
        ssa=torch.full_like(atm.z, 0.85), g=torch.full_like(atm.z, 0.7))
    scene = AllskyScene(atm=atm, cat=None, pf=None, scatterers=(haze,),
                        surface_temperature=torch.tensor(290.0, dtype=dt, device=dev),
                        surface_albedo=torch.tensor(0.0, dtype=dt, device=dev))
    paths = [PathGeometry(alt=np.asarray([60e3, 0.0]), s=np.asarray([0.0, 60e3]),
                          za=np.asarray([150.0, 150.0]), background="surface", aa=a)
             for a in np.linspace(0.0, 180.0, 7)]
    obs = allsky_observer(nquad=16, nfourier=16, nleg=32, mu0=0.5, fbeam=float(np.pi),
                          phi0=0.0, thermal=False)
    return scene, torch.tensor([230e9], dtype=dt, device=dev), paths, obs


def build_zeeman_mp_case(Z, NP, F, seed, device=None, dtype=None):
    """(f [F], rec [Z, NP, record_width(MP_TERMS)]): random pole records for
    the zeeman_mp kernel on F frequencies from -50 to 50 GHz.  Centres
    uniform in -60..60 GHz in random order (some beyond the grid), cutoffs
    2-25 GHz (windows that miss whole tiles of 512 frequencies), near radii
    6 R with R 2-8 MHz (one or two grid points inside for the poles with
    g0 below it), g0 0.05-1.5 near radii (so both halves of u weigh), and
    moments M_re, M_im and swcsum random on all 7 components at scales
    1 to 1e-3.  On the bench's pole records M_re = 0 and 3 components are
    0 or small; here every part of the sum shows.  NP and F are the
    caller's: a multiple of neither 32 parents nor 512 frequencies tests the
    ragged edges.  Built in float64, then cast to dtype."""
    dev, dt = resolve(device, dtype)
    rng = np.random.default_rng(seed)
    P = MP_TERMS
    R = rng.uniform(2e6, 8e6, (Z, NP))
    rnear = 6.0 * R
    comp = 10.0 ** -np.linspace(0.0, 3.0, NCOMP)
    moment = lambda: rng.normal(size=(Z, NP, P, NCOMP)) * comp
    cols = (rng.uniform(-60e9, 60e9, (Z, NP)), rng.uniform(0.05, 1.5, (Z, NP)) * rnear, R,
            rnear * rnear, rng.uniform(2e9, 25e9, NP), moment(), moment(),
            1e-2 * rng.normal(size=(Z, NP, NCOMP)) * comp)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    f = t(np.linspace(-50e9, 50e9, F)).to(dt)
    return f, pole_records(*map(t, cols)).to(dt)


def window_scene(n_lev=51, device=None, dtype=None):
    """The cloudy microwave-window scene: a 51-level atmosphere to 80 km
    (lapse rate 6.5 K/km to 12 km, warming by 1 K/km above 20 km, a 1 %
    absorber decaying with a 2 km scale height, hydrostatic pressure), two
    H2O-like lines at 183.31 and 230 GHz, a Henyey-Greenstein cloud between
    4 and 8 km (ext 5e-4 1/m, ssa 0.9, g 0.7) and a 288 K black surface.
    Built in float64, then cast to `dtype`."""
    dev, dt = resolve(device, dtype)
    f64 = dict(dtype=torch.float64, device=dev)
    z = torch.linspace(0.0, 80e3, n_lev, **f64)
    t = 288.0 - 6.5e-3 * torch.clamp(z, max=12e3) + 1e-3 * torch.clamp(z - 20e3, min=0.0)
    vmr0 = 0.01 * torch.exp(-z / 2e3)
    atm = Atmosphere1D(z=z, t=t, p=hydrostatic_pressure(z, t, 101325.0),
                       vmr=torch.stack([vmr0, 1.0 - vmr0]))
    common = dict(iso_mass=18.0, iso_ratio=1.0, spec_idx=0, iso_idx=0, t0=296.0,
                  cutoff=np.inf)
    lines = [
        dict(f0=183.31e9, a=1e-5, e0=2.2e-21, gu=9.0, gl=7.0, band_idx=0,
             ls={"bath": {"G0": (Law.T1, [2.5e4, 0.7]), "D0": (Law.T0, [10.0])}},
             **common),
        dict(f0=230.0e9, a=3e-6, e0=1.0e-21, gu=5.0, gl=3.0, band_idx=1,
             ls={"bath": {"G0": (Law.T1, [2.0e4, 0.75])}}, **common),
    ]
    in_cloud = (z > 4e3) & (z < 8e3)
    cloud = HenyeyGreenstein(ext=torch.where(in_cloud, torch.full_like(z, 5e-4), 0.0),
                             ssa=torch.full_like(z, 0.9), g=torch.full_like(z, 0.7))
    scene = AllskyScene(
        atm=atm, cat=build_catalog(lines, device=dev, dtype=torch.float64),
        pf=rigid_rotor_table(1, 180.0, 1.5, device=dev, dtype=torch.float64),
        scatterers=(cloud,), surface_temperature=torch.tensor(288.0, **f64),
        surface_albedo=torch.tensor(0.0, **f64))
    return move(scene, dev, dt)


def _cloud_targets(idx):
    """log extinction and single scattering albedo of the cloud at the
    levels idx, and the surface temperature."""
    def leaf(name):
        return lambda s: getattr(s.scatterers[0], name)[idx]

    def put(name):
        def set_(s, v):
            hg = s.scatterers[0]
            new = dataclasses.replace(hg, **{name: getattr(hg, name).index_put((idx,), v)})
            return dataclasses.replace(s, scatterers=(new,) + s.scatterers[1:])
        return set_

    return [
        RetrievalTarget("cloud_ext", leaf("ext"), put("ext"), transform="log"),
        RetrievalTarget("cloud_ssa", leaf("ssa"), put("ssa"), transform="id"),
        RetrievalTarget("t_surface", lambda s: s.surface_temperature[None],
                        lambda s, v: dataclasses.replace(s, surface_temperature=v[0])),
    ]


@dataclasses.dataclass(frozen=True)
class CloudRetrieval:
    """An OEM cloud retrieval through the differentiable all-sky route.

    The state is log cloud extinction and single scattering albedo at the
    in-cloud levels, then the surface temperature; the measurement is the
    TOA upwelling flux and the most-nadir TOA radiance at every frequency
    (m = 2F).  The state and the covariances are float64; the forward
    model runs in the mapping's dtype on its device."""

    f_grid: torch.Tensor  # [F]
    k_gas: torch.Tensor  # [F, Z] gas absorption, TOA first (fixed: the state moves no gas)
    mapping: StateMapping
    nquad: int
    cloud_z: torch.Tensor  # [nc] altitudes of the in-cloud levels [m]
    x_a: torch.Tensor  # [n] prior state (float64)
    S_a: torch.Tensor  # [n, n]
    S_e: torch.Tensor  # [m] noise variances
    x_true: torch.Tensor  # [n]
    y_obs: torch.Tensor  # [m] forward(x_true)

    @property
    def scene(self):
        return self.mapping.ref_scene

    def forward(self, x, plain=False):
        """The measurement at state x through simulate_allsky's
        differentiable route (fast_linalg=False); plain=True runs the
        kernels' plain versions."""
        m = self.mapping
        out = simulate_allsky(m.to_scene(x.to(m.dtype)), self.f_grid, nquad=self.nquad,
                              k_gas=self.k_gas, fast_linalg=False, plain=plain,
                              device=m.device, dtype=m.dtype)
        return torch.cat([out.flux_up[:, 0], out.u0[:, 0, -1]])

    def astype(self, dtype):
        """The same retrieval with the forward model in `dtype`, on the same
        inputs (the scene, grid and gas absorption cast)."""
        m = self.mapping
        f, k = move((self.f_grid, self.k_gas), m.device, dtype)
        mapping = StateMapping(m.targets, m.ref_scene, device=m.device, dtype=dtype)
        return dataclasses.replace(self, f_grid=f, k_gas=k, mapping=mapping)


def build_cloud_retrieval(n_lev=51, n_freq=4096, nquad=16, device=None, dtype=None):
    """The cloud-retrieval case on window_scene(n_lev): frequencies 170-240
    GHz, the gas absorption computed once by gas_absorption_profile (the
    Voigt kernel), the prior (log extinction sd 0.5 with an exponential
    correlation over 3 km, ssa sd 0.1, surface sd 5 K), the truth (an
    extinction bump x(1 + 0.6 exp(-((z - 6 km)/1.5 km)^2 / 2)), ssa - 0.05,
    surface + 2 K), y_obs = forward(x_true) and noise sd 1e-4 of mean
    |y_obs|."""
    dev, dt = resolve(device, dtype)
    scene = window_scene(n_lev, device=dev, dtype=dt)
    f = torch.as_tensor(np.linspace(170e9, 240e9, n_freq), dtype=dt, device=dev)
    z = scene.atm.z
    idx = torch.nonzero((z > 4e3) & (z < 8e3))[:, 0]
    mapping = StateMapping(_cloud_targets(idx), scene, device=dev, dtype=dt)
    zc = z[idx].double().cpu().numpy()
    nc = len(zc)
    x_a = mapping.to_vector(scene).double()
    bump = 1.0 + 0.6 * np.exp(-0.5 * ((zc - 6e3) / 1.5e3) ** 2)
    dx = np.concatenate([np.log(bump), np.full(nc, -0.05), [2.0]])
    x_true = x_a + torch.as_tensor(dx, device=dev)
    S_a = covariance.block_diag(covariance.exponential(zc, 0.5, 3e3),
                                covariance.diagonal(np.full(nc, 0.1)),
                                covariance.diagonal([5.0])).to(dev)
    case = CloudRetrieval(
        f_grid=f, k_gas=gas_absorption_profile(scene, f, device=dev, dtype=dt),
        mapping=mapping, nquad=nquad, cloud_z=z[idx], x_a=x_a, S_a=S_a,
        S_e=x_a.new_zeros(0), x_true=x_true, y_obs=x_a.new_zeros(0))
    y = case.forward(x_true).double()
    noise = 1e-4 * float(y.abs().mean())
    return dataclasses.replace(case, y_obs=y, S_e=torch.full_like(y, noise**2))


# ATMS (Suomi NPP / NOAA-20): 96 beam positions of 1.11 deg from -52.725
# to 52.725 deg from an 824 km orbit; the five 183.31 GHz channels 18-22,
# offsets and bandwidths (GHz), each sideband its own Gaussian element
ATMS_ORBIT = 824e3
ATMS_SCAN_DEG = 52.725
ATMS_183_OFFSETS = (7.0, 4.5, 3.0, 1.8, 1.0)
ATMS_183_FWHM = (2.0, 2.0, 1.0, 1.0, 0.5)


@dataclasses.dataclass(frozen=True)
class ClearskyMeasurement:
    """A scan line of clear-sky measurements: scene, frequency grid, one
    path per beam position (PathGeometry) and the sensor weights."""

    scene: ClearskyScene
    f_grid: torch.Tensor
    paths: tuple
    sensor: SensorArray
    scan_deg: np.ndarray  # [G] scan angle per beam position


def build_clearsky_measurement(n_lev=60, n_freq=4096, n_lines=2048, n_scan=96,
                               max_step=1000.0, device=None, dtype=None):
    """One ATMS scan line over the benchmark scene (build_scene without its
    cloud: 2048 lines with a 25 GHz cutoff, 4096 frequencies 160-260 GHz,
    60 levels to 80 km, a 288 K surface of emissivity 0.9): n_scan beam
    positions evenly spaced over +-52.725 deg from 824 km (96: ATMS's
    1.11 deg steps), each a geometric_path_1d to the surface in steps of
    at most max_step, and ATMS's five 183.31 GHz channels (+-7.0, 4.5,
    3.0, 1.8, 1.0 GHz; fwhm 2.0, 2.0, 1.0, 1.0, 0.5 GHz), each sideband
    its own Gaussian element: 10 elements per position, in position
    order."""
    dev, dt = resolve(device, dtype)
    allsky, f = build_scene(n_lev, n_freq, n_lines, device=dev, dtype=dt)
    scene = ClearskyScene(atm=allsky.atm, cat=allsky.cat, pf=allsky.pf,
                          surface_temperature=allsky.surface_temperature,
                          surface_emissivity=torch.tensor(0.9, dtype=dt, device=dev))
    scan = np.linspace(-ATMS_SCAN_DEG, ATMS_SCAN_DEG, n_scan)
    z_top = float(allsky.atm.z[-1])
    paths = tuple(geometric_path_1d(ATMS_ORBIT, 180.0 - abs(a), 0.0, z_top, max_step)
                  for a in scan)
    return ClearskyMeasurement(scene=scene, f_grid=f, paths=paths,
                               sensor=atms_183_channels(f, n_scan, device=dev, dtype=dt),
                               scan_deg=scan)


def atms_183_channels(f_grid, n_geo, device=None, dtype=None):
    """ATMS's five 183.31 GHz channels on f_grid for each of n_geo
    geometries: 10 Gaussian elements per geometry (lower, then upper
    sideband of each channel), in geometry order."""
    off = np.asarray(ATMS_183_OFFSETS) * 1e9
    centers = 183.31e9 + np.stack([-off, off], -1).ravel()
    fwhm = np.repeat(np.asarray(ATMS_183_FWHM) * 1e9, 2)
    return gaussian_channels(torch.as_tensor(f_grid).double().cpu().numpy(),
                             np.tile(centers, n_geo), np.tile(fwhm, n_geo),
                             geo_idx=np.repeat(np.arange(n_geo), centers.size),
                             device=device, dtype=dtype)


def _vmr0_target():
    """The first species' VMR profile relative to the reference scene's."""
    def set_(s, v):
        vmr = torch.cat([v[None], s.atm.vmr[1:]], 0)
        return dataclasses.replace(s, atm=dataclasses.replace(s.atm, vmr=vmr))

    return RetrievalTarget("vmr0", lambda s: s.atm.vmr[0], set_, transform="rel")


@dataclasses.dataclass(frozen=True)
class ClearskyRetrieval:
    """A Gauss-Newton water-vapour retrieval from clear-sky nadir
    radiances: the state is the first species' VMR relative to the
    reference profile at every level; the measurement 25 Gaussian channels
    of the TOA nadir radiance over a surface.  The state and the
    covariances are float64; the forward model runs in the mapping's
    dtype on its device."""

    f_grid: torch.Tensor  # [F]
    alt: torch.Tensor  # [np] nadir path from 100 km, observer first
    dr: torch.Tensor  # [np-1]
    sensor: SensorArray
    mapping: StateMapping
    x_a: torch.Tensor  # [n] prior (ones)
    S_a: torch.Tensor  # [n, n]
    S_e: torch.Tensor  # [m] noise variances
    x_true: torch.Tensor  # [n]
    y_obs: torch.Tensor  # [m] forward(x_true)

    @property
    def scene(self):
        return self.mapping.ref_scene

    def forward(self, x):
        m = self.mapping
        I = simulate_clearsky(m.to_scene(x.to(m.dtype)), self.f_grid, self.alt, self.dr,
                              background="surface", device=m.device, dtype=m.dtype)
        return self.sensor.apply(I[None])


def build_clearsky_retrieval(n_lev=51, device=None, dtype=None):
    """The water-vapour retrieval of the JAX package's examples/5_oem_retrieval.py:
    window_scene(n_lev) without its cloud (two H2O-like lines, a 1 %
    absorber decaying with a 2 km scale height, a 288 K black surface),
    101 frequencies 170-240 GHz, a nadir path from 100 km in steps of at
    most 1 km, 25 Gaussian channels 175-235 GHz of fwhm 2 GHz; truth
    1 + 0.2 exp(-((z - 3 km)/2.5 km)^2 / 2) times the reference profile,
    prior ones with sd 0.3 and an exponential correlation over 10 km,
    y_obs = forward(truth), noise sd 1e-4 of mean |y_obs|."""
    dev, dt = resolve(device, dtype)
    ws = window_scene(n_lev, device=dev, dtype=dt)
    scene = ClearskyScene(atm=ws.atm, cat=ws.cat, pf=ws.pf,
                          surface_temperature=ws.surface_temperature)
    f = np.linspace(170e9, 240e9, 101)
    path = geometric_path_1d(100e3, 180.0, 0.0, 80e3, 1000.0)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
    sensor = gaussian_channels(f, np.linspace(175e9, 235e9, 25), 2e9, device=dev, dtype=dt)
    mapping = StateMapping([_vmr0_target()], scene, device=dev, dtype=dt)
    z = scene.atm.z.double().cpu().numpy()
    truth = 1.0 + 0.2 * np.exp(-0.5 * ((z - 3e3) / 2.5e3) ** 2)
    d = np.abs(z[:, None] - z[None, :])
    f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
    case = ClearskyRetrieval(
        f_grid=t(f), alt=t(path.alt), dr=t(path.dr), sensor=sensor, mapping=mapping,
        x_a=f64(np.ones(z.size)), S_a=f64(0.3**2 * np.exp(-d / 10e3)), S_e=f64(np.zeros(0)),
        x_true=f64(truth), y_obs=f64(np.zeros(0)))
    y = case.forward(case.x_true).double()
    noise = 1e-4 * float(y.abs().mean())
    return dataclasses.replace(case, y_obs=y, S_e=torch.full_like(y, noise**2))


# ---------------------------------------------------------------------------
# The 60 GHz O2 band by ECS line mixing, and an ATMS scan line over it
# ---------------------------------------------------------------------------
# O2-66: Q(296 K) of the scene's rigid-rotor table, abundance, mass
O2_Q296 = 215.7
O2_66 = ISOTOPOLOGUES["O2-66"]
# the gas models beside the band: examples 1 and 3 without O2-PWR98
ECS_PREDEF = ("H2O-PWR98", "N2-SelfContStandardType")
ECS_SPECIES = ("H2O", "O2", "N2")
# ATMS temperature channels 3-9: centre, fwhm (GHz); channel 7's two
# passbands at 53.596 -+ 0.115 GHz each its own element
ATMS_TEMP_CHANNELS = ((50.3, 0.18), (51.76, 0.4), (52.8, 0.4), (53.481, 0.17),
                      (53.711, 0.17), (54.4, 0.4), (54.94, 0.4), (55.5, 0.33))


def o2_ecs_par_rows():
    """The 38 lines of O2-MPM2020 (predefined/models.py, Makarov et al.
    2020) as HITRAN .par rows of O2-66 with O2 local quanta.

    Line j of the table (118.75 GHz first, then 56.26 GHz, ...) is N-
    for even j and N+ for odd j, N = 2 (j // 2) + 1: upper state (N, J =
    N), lower state (N, J = N - 1) for N- and (N, J = N + 1) for N+,
    lower energy o2_erot(N, J''), g = 2 J + 1.  Centres from _M20_F0, air
    widths from _M20_GA [GHz/bar at 300 K] as gamma_air(296 K) = GA (300 /
    296)^0.754 with n_air = 0.754, MPM2020's own temperature exponent, and
    no shift (MPM2020's shift is second order in pressure).

    Strengths: without mixing, MPM2020's line j integrates over frequency
    to conv C_j F0_j[GHz] p[bar] pi 1e9 [Hz/m] per unit O2 VMR at 300 K,
    conv = 0.1820e-7 / (2.0946 log10(e)) (models.o2_mpm2020), so its
    abundance-weighted intensity is S_j(300 K) = conv C_j F0_j pi 1e9
    k 300 / 1e5 [Hz m^2].  A follows from S(300 K) with Q(300 K)
    (io.hitran.einstein_a_from_s at T0 = 300 K); the rows carry that A and
    S(296 K) from it (lbl.catalog.hitran_s)."""
    conv = 0.1820e-7 / (2.0946 * np.log10(np.e))
    kayser = 100.0 * const.c  # cm^-1 -> Hz
    gamma = _M20_GA * 1e4 * (300.0 / 296.0) ** 0.754 * 101325.0 / kayser  # cm^-1/atm
    N = 2 * (np.arange(_M20_F0.size) // 2) + 1
    Jl = np.where(np.arange(_M20_F0.size) % 2 == 0, N - 1, N + 1)
    f0, gu, gl = _M20_F0 * 1e9, 2.0 * N + 1.0, 2.0 * Jl + 1.0
    e0 = np.array([o2_erot(float(n), float(j)) for n, j in zip(N, Jl)])
    s300 = conv * _M20_C * _M20_F0 * np.pi * 1e9 * const.k * 300.0 / 1e5
    a = np.array([einstein_a_from_s(*args, O2_Q296 * 300.0 / 296.0, O2_66.abundance, T0=300.0)
                  for args in zip(s300, gu, e0, f0)])
    cat = build_catalog([dict(f0=x, a=y, gu=g, e0=e, iso_ratio=O2_66.abundance)
                         for x, y, g, e in zip(f0, a, gu, e0)], device="cpu", dtype=torch.float64)
    s296 = hitran_s(cat, O2_Q296)
    rows = []
    for j in range(f0.size):
        loc = f"  Q {N[j]:2d}  {'R' if Jl[j] < N[j] else 'P'} {Jl[j]:2d}   "
        row = (
            " 71" + f"{f0[j] / kayser:12.6f}" + f"{s296[j] / (kayser * 1e-4):10.3E}"
            + f"{a[j]:10.3E}" + f"{gamma[j]:.4f}"[1:] * 2 + f"{e0[j] / (const.h * kayser):10.4f}"
            + ".754" + f"{0.0:8.6f}" + " " * 45 + loc.ljust(15)
        ).ljust(146) + f"{gu[j]:7.1f}" + f"{gl[j]:7.1f}"
        rows.append(row)
    return rows


def build_ecs_scene(n_lev=60, n_freq=4096, device=None, dtype=None):
    """(ClearskyScene, f_grid) of the 60 GHz O2 band by ECS line mixing:
    the benchmark's atmosphere (n_lev levels to 80 km) with rows H2O, O2
    and N2, n_freq frequencies over 50-70 GHz, a 288 K black surface, the
    gas models of the JAX package's examples 1 and 3 with O2 taken by one
    ECS band in place of O2-PWR98: H2O-PWR98 and the N2 continuum
    (ECS_PREDEF) beside the band of o2_ecs_par_rows' 38 lines, read back
    through read_par_records and o2_lines_from_par into make_o2_band
    (Makarov 2020 air coefficients), O2-66 at its abundance."""
    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=ECS_SPECIES, device=dev,
                              dtype=dt)
    lines, _, _ = o2_lines_from_par(read_par_records(o2_ecs_par_rows()), O2_Q296,
                                    zeeman=False)
    band = make_o2_band(lines, mass=O2_66.mass, device=dev)
    scene = ClearskyScene(
        atm=atm, cat=None, pf=rigid_rotor_table(1, O2_Q296, 1.0, device=dev, dtype=dt),
        surface_temperature=torch.tensor(288.0, dtype=dt, device=dev),
        surface_emissivity=torch.tensor(1.0, dtype=dt, device=dev),
        predef=ECS_PREDEF, species_names=ECS_SPECIES,
        ecs_bands=((band, ECS_SPECIES.index("O2"), 0, O2_66.abundance),),
    )
    return scene, torch.as_tensor(np.linspace(50e9, 70e9, n_freq), dtype=dt, device=dev)


def build_ecs_measurement(n_lev=60, n_freq=4096, n_scan=96, max_step=1000.0, device=None,
                          dtype=None):
    """One ATMS scan line over build_ecs_scene (surface emissivity 0.9), as
    build_clearsky_measurement builds its own: n_scan beam positions over
    +-52.725 deg from 824 km, each a path to the surface in steps of at
    most max_step, and ATMS's temperature channels 3-9 (50.3, 51.76, 52.8,
    53.596 -+ 0.115, 54.4, 54.94, 55.5 GHz; fwhm 180, 400, 400, 170, 400,
    400, 330 MHz) as Gaussian elements, channel 7's passbands each its
    own: 8 elements per position, in position order.  Channels 10-15 need
    a finer grid near 57.29 GHz."""
    dev, dt = resolve(device, dtype)
    scene, f = build_ecs_scene(n_lev, n_freq, device=dev, dtype=dt)
    scene = dataclasses.replace(scene, surface_emissivity=torch.tensor(0.9, dtype=dt,
                                                                       device=dev))
    scan = np.linspace(-ATMS_SCAN_DEG, ATMS_SCAN_DEG, n_scan)
    z_top = float(scene.atm.z[-1])
    paths = tuple(geometric_path_1d(ATMS_ORBIT, 180.0 - abs(a), 0.0, z_top, max_step)
                  for a in scan)
    centers, fwhm = (np.asarray(c) * 1e9 for c in zip(*ATMS_TEMP_CHANNELS))
    sensor = gaussian_channels(f.double().cpu().numpy(), np.tile(centers, n_scan),
                               np.tile(fwhm, n_scan),
                               geo_idx=np.repeat(np.arange(n_scan), centers.size),
                               device=dev, dtype=dt)
    return ClearskyMeasurement(scene=scene, f_grid=f, paths=paths, sensor=sensor,
                               scan_deg=scan)


@dataclasses.dataclass(frozen=True)
class SunPaths:
    """A batch of G pencil beams with the sun in the scene:
    simulate_clearsky's arguments (kwargs()).  path_alt [G, NP] and
    path_dr [G, NP-1] in the scene's dtype, padded as sensor.stack_paths
    pads; the angles in float64: path_za, path_aa [G, NP], sun_za [G]
    [deg].  labels [G]: tangent altitudes [m] or azimuths [deg]."""

    scene: ClearskyScene
    f_grid: torch.Tensor
    sun: Sun
    path_alt: torch.Tensor
    path_dr: torch.Tensor
    path_za: torch.Tensor
    path_aa: torch.Tensor
    sun_za: torch.Tensor
    sun_aa: float
    scattered_sun: bool
    labels: np.ndarray

    def kwargs(self):
        return dict(path_za=self.path_za, path_aa=self.path_aa, sun=self.sun,
                    sun_za=self.sun_za, sun_aa=self.sun_aa, scattered_sun=self.scattered_sun)


def _sun_paths(scene, f, paths, aa, sun_aa, scattered, labels, dev, dt):
    alt, dr, za, _ = stack_paths(paths, device=dev, dtype=torch.float64)
    aa = torch.as_tensor(np.asarray(aa, np.float64), device=dev)[:, None].expand_as(za)
    return SunPaths(scene=scene, f_grid=f, sun=sun_blackbody(f, device=dev, dtype=dt),
                    path_alt=alt.to(dt), path_dr=dr.to(dt), path_za=za,
                    path_aa=aa.contiguous(), sun_za=za[:, -1].clone(), sun_aa=sun_aa,
                    scattered_sun=scattered, labels=np.asarray(labels))


OCCULTATION_OBS = 600e3
SUN_SCENE_SPECIES = ("N2", "O2", "H2O")


def build_occultation_scan(n_lev=60, n_freq=4096, n_tan=21, max_step=2e3, device=None,
                           dtype=None):
    """A solar-occultation limb scan at full width (the first half of the
    JAX package's example 11): 60 US-76 levels to 80 km (rows N2, O2, H2O)
    absorbing by H2O-PWR98, n_freq frequencies over 175-191 GHz, a
    blackbody sun, and n_tan limb paths from 600 km with tangent altitudes
    evenly over 10-60 km (21: every 2.5 km) in steps of at most max_step,
    each with the sun on its axis (its sun_za is the path's zenith angle
    at its far end).  Limb sounders scanning through sunset or sunrise
    model or flag the sun in their beam this way."""
    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=SUN_SCENE_SPECIES,
                              device=dev, dtype=dt)
    scene = ClearskyScene(atm=atm, cat=None, pf=None, predef=("H2O-PWR98",),
                          species_names=SUN_SCENE_SPECIES)
    f = torch.as_tensor(np.linspace(175e9, 191e9, n_freq), dtype=dt, device=dev)
    z_top = float(atm.z[-1])
    tangents = np.linspace(10e3, 60e3, n_tan)
    r_obs = EARTH_RADIUS + OCCULTATION_OBS
    paths = [geometric_path_1d(OCCULTATION_OBS,
                               180.0 - np.degrees(np.arcsin((EARTH_RADIUS + h) / r_obs)),
                               0.0, z_top, max_step) for h in tangents]
    return _sun_paths(scene, f, paths, np.zeros(n_tan), 0.0, False, tangents, dev, dt)


ALMUCANTAR_SZA = 55.0


def build_sky_almucantar(n_lev=60, n_freq=4096, n_az=36, max_step=2e3, device=None,
                         dtype=None):
    """A sky radiometer's almucantar at full width (the second half of the
    JAX package's example 11): 60 US-76 levels to 80 km with no gas (the
    sky is Rayleigh air alone), n_freq frequencies over 4.3e14-7.5e14 Hz
    (400-700 nm), a blackbody sun at azimuth 0 and zenith angle 55 deg,
    and a ground observer looking at 55 deg zenith at n_az azimuths
    evenly over 0-360 deg (36: every 10 deg), up through the atmosphere in
    steps of at most max_step, with the Rayleigh-scattered sun
    (scattered_sun=True).  The 1-D scene holds the sun's local zenith
    angle fixed along a path: sun_za is its value where the beams leave
    the atmosphere (the paths' zenith angle there, ~54.0 deg: the beam at
    azimuth 0 looks at the sun), so one call runs both sun branches.  Sky
    radiometers that scan the almucantar, in the manner of AERONET, see
    such skies."""
    dev, dt = resolve(device, dtype)
    atm = standard_atmosphere(n_levels=n_lev, z_top=80e3, species=SUN_SCENE_SPECIES,
                              device=dev, dtype=dt)
    scene = ClearskyScene(atm=atm, cat=None, pf=None)
    f = torch.as_tensor(np.linspace(4.3e14, 7.5e14, n_freq), dtype=dt, device=dev)
    path = geometric_path_1d(0.0, ALMUCANTAR_SZA, 0.0, float(atm.z[-1]), max_step)
    azimuths = np.arange(n_az) * (360.0 / n_az)
    return _sun_paths(scene, f, [path] * n_az, azimuths, 0.0, True, azimuths, dev, dt)


@dataclasses.dataclass(frozen=True)
class SubsurfaceCase:
    """A subsurface emission case: the field, the frequency grid, the
    downwelling radiance at the surface [F] and the number of streams."""

    field: SubsurfaceField
    f_grid: torch.Tensor
    I_down: torch.Tensor
    nquad: int


ICE_DENSITY = 917.0  # [kg/m^3]


def _firn_density(depth, rho_surface=350.0, scale=30.0):
    """Firn density [kg/m^3] at depth [m]: ice density approached
    exponentially from the surface's, the e-folding depth `scale` (the
    shape of the Herron-Langway densification profile, Herron and Langway
    1980, J. Glaciol. 25(93))."""
    return ICE_DENSITY - (ICE_DENSITY - rho_surface) * np.exp(-np.asarray(depth) / scale)


def _ice_permittivity(f, t):
    """(eps', eps'') of pure ice at f [Hz] and t [K]: eps' = 3.1884 + 9.1e-4
    (t - 273.16) and eps'' = alpha / f + beta f (f in GHz) after Hufford
    (1991) with Mishima et al.'s (1983) beta term, as collected by Maetzler
    (2006, Thermal Microwave Radiation, IET, section 5.3)."""
    fg = np.asarray(f) * 1e-9
    t = np.asarray(t)
    theta = 300.0 / t - 1.0
    alpha = (0.00504 + 0.0062 * theta) * np.exp(-22.1 * theta)
    x = np.exp(335.0 / t)
    beta = (0.0207 / t * x / (x - 1.0) ** 2 + 1.16e-11 * fg**2
            + np.exp(-9.963 + 0.0372 * (t - 273.16)))
    return 3.1884 + 9.1e-4 * (t - 273.16), alpha / fg + beta * fg


def _firn_absorption(f, t, rho):
    """Absorption coefficient [1/m] of dry firn of density rho [kg/m^3]:
    the dry-snow mixing of Tiuri et al. (1984, IEEE J. Oceanic Eng. 9(5)),
    eps' = 1 + 1.7 r + 0.7 r^2 and eps'' = eps''_ice (0.52 r + 0.62 r^2) with
    r in g/cm^3, and the low-loss kappa = (2 pi f / c) eps'' / sqrt(eps')."""
    r = np.asarray(rho) * 1e-3
    _, e2_ice = _ice_permittivity(f, t)
    e1 = 1.0 + 1.7 * r + 0.7 * r * r
    e2 = e2_ice * (0.52 * r + 0.62 * r * r)
    return 2.0 * np.pi * np.asarray(f) / const.c * e2 / np.sqrt(e1)


def build_subsurface_case(n_lev=201, n_freq=4096, nquad=16, n_atm=60, device=None,
                          dtype=None):
    """A firn column's emission from L band to 89 GHz at full width: n_lev
    depths evenly over 0-100 m; temperature 218.5 K at depth with a surface
    wave of 20 K damped over 2 m (T = 218.5 + 20 exp(-z/2) cos(z/2), a
    summer snapshot of a cold, dry ice-sheet interior); absorption [ND, F]
    from _firn_density and _firn_absorption (pure ice after Maetzler 2006,
    dry-snow mixing after Tiuri et al. 1984): e-folding depths ~1 km at
    1.4 GHz and ~0.3 m at 89 GHz in the deep firn; Henyey-Greenstein
    volume scattering near the surface, ssa = 0.5 exp(-z/3) and g = 0.3
    exp(-z/3); n_freq frequencies over 1.4-89 GHz; nquad streams; and
    I_down, the clear-sky downwelling radiance at the surface from
    simulate_clearsky on a zenith path (background "space") through
    build_predef_scene's gas models and atmosphere (n_atm levels).
    SMOS/SMAP and AMSR-class retrievals over the ice sheets and sounders'
    surface models for snow run such columns."""
    dev, dt = resolve(device, dtype)
    z = np.linspace(0.0, 100.0, n_lev)
    f64 = np.linspace(1.4e9, 89e9, n_freq)
    t = 218.5 + 20.0 * np.exp(-z / 2.0) * np.cos(z / 2.0)
    k = _firn_absorption(f64[None, :], t[:, None], _firn_density(z)[:, None])
    tt = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    field = SubsurfaceField(depth=tt(z), t=tt(t), absorption=tt(k),
                            ssa=tt(0.5 * np.exp(-z / 3.0)), g=tt(0.3 * np.exp(-z / 3.0)))
    allsky, _ = build_predef_scene(n_lev=n_atm, n_freq=2, device=dev, dtype=dt)
    sky = ClearskyScene(atm=allsky.atm, cat=None, pf=None, predef=allsky.predef,
                        species_names=allsky.species_names)
    up = geometric_path_1d(0.0, 0.0, 0.0, float(allsky.atm.z[-1]), 1000.0)
    f = tt(f64)
    I_down = simulate_clearsky(sky, f, up.alt, up.dr, device=dev, dtype=dt)
    return SubsurfaceCase(field=field, f_grid=f, I_down=I_down, nquad=nquad)
