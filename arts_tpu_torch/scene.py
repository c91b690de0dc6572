"""The benchmark scenes, built without JAX.

synth_par_rows and build_scene are copies of bench.py's (without its
real-catalog branch): 2048 HITRAN-shaped H2O + O2 lines read through the
.par reader, 4096 frequencies from 160 to 260 GHz, a 60-level US-76
atmosphere, one Henyey-Greenstein cloud between 4 and 9 km, and a 288 K
surface.  build_zeeman_inputs is bench.py's Zeeman stage on that scene.
"""

import numpy as np
import torch

from ._cuda import resolve
from .atm.standard import standard_atmosphere
from .fwd_allsky import AllskyScene
from .io.hitran import read_par, zeeman_catalog_from_par
from .lbl.catalog import build_catalog
from .lbl.partfun import rigid_rotor_table
from .lbl.zeeman import pad_zeeman_catalog, tune_zeeman_profile
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
