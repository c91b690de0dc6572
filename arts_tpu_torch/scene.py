"""The benchmark scenes and the cloud-retrieval case, built without JAX.

synth_par_rows and build_scene are copies of bench.py's (without its
real-catalog branch): 2048 HITRAN-shaped H2O + O2 lines read through the
.par reader, 4096 frequencies from 160 to 260 GHz, a 60-level US-76
atmosphere, one Henyey-Greenstein cloud between 4 and 9 km, and a 288 K
surface.  build_zeeman_inputs is bench.py's Zeeman stage on that scene.
build_cloud_retrieval is an OEM retrieval of cloud extinction, single
scattering albedo and surface temperature in a cloudy microwave window.
build_stage23_case gives the DISORT stage 2+3 kernel random problems on
which its elimination shows, build_stage1_case the stage 1 kernel random
scattering problems on which its Jacobi sweeps show, build_zeeman_mp_case
the zeeman_mp kernel random pole records on which every part of its sum
shows.
"""

import dataclasses

import numpy as np
import torch

from ._cuda import move, resolve
from .atm import Atmosphere1D
from .atm.field import hydrostatic_pressure
from .atm.standard import standard_atmosphere
from .disort import DisortInput
from .disort import fused_kernel as FK
from .disort.quadrature import double_gauss, lambda_tables
from .disort.solver import solve_terms
from .fwd_allsky import AllskyScene, gas_absorption_profile, simulate_allsky
from .io.hitran import read_par, zeeman_catalog_from_par
from .lbl.catalog import build_catalog
from .lbl.partfun import rigid_rotor_table
from .lbl.tmodel import Law
from .lbl.zeeman import pad_zeeman_catalog, tune_zeeman_profile
from .ops.zeeman_mp_kernel import MP_TERMS, NCOMP, pole_records
from .retrieval import covariance
from .retrieval.targets import RetrievalTarget, StateMapping
from .scattering import HenyeyGreenstein


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
    lines = read_par(synth_par_rows(n_lines), ["H2O", "O2"], cutoff=25e9)
    lines.sort(key=lambda l: l["f0"])
    cat = build_catalog(lines, device=dev, dtype=dt)
    pf = rigid_rotor_table(2, [174.6, 215.7], 1.5, device=dev, dtype=dt)
    in_cloud = (atm.z > 4e3) & (atm.z < 9e3)
    cloud = HenyeyGreenstein(
        ext=torch.where(in_cloud, torch.full_like(atm.z, 3e-4), torch.zeros_like(atm.z)),
        ssa=torch.full_like(atm.z, 0.85),
        g=torch.full_like(atm.z, 0.7),
    )
    scene = AllskyScene(
        atm=atm, cat=cat, pf=pf, scatterers=(cloud,),
        surface_temperature=torch.tensor(288.0, dtype=dt, device=dev),
        surface_albedo=torch.tensor(0.0, dtype=dt, device=dev),
    )
    f_grid = torch.as_tensor(np.linspace(160e9, 260e9, n_freq), dtype=dt, device=dev)
    return scene, f_grid


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
