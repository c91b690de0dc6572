"""All-sky (scattering) forward operator: gas LBL + Henyey-Greenstein
particles -> DISORT (port of arts_tpu/fwd_allsky.py).

Per frequency: the vertical profile's gas absorption (the Voigt kernel
over all levels at once, and the predefined models), particle extinction
and phase moments, layer optical depths, Planck sources and the solar
beam, and one batched DISORT solve over all frequencies.
"""

import dataclasses

import torch

from . import constants as const
from ._cuda import move, resolve
from .atm import Atmosphere1D
from .disort import DisortInput, disort
from .fwd import species_absorption
from .lbl.catalog import LineCatalog
from .lbl.partfun import PartFunTable
from .ops.planck import planck
from .scattering import HenyeyGreenstein


@dataclasses.dataclass(frozen=True)
class AllskyScene:
    """Scene state of an all-sky simulation: the gas is the line catalog
    (cat, pf; None for none) and the predefined models named in predef,
    with species_names naming the rows of atm.vmr; scatterers are
    HenyeyGreenstein entries."""

    atm: Atmosphere1D
    cat: LineCatalog | None
    pf: PartFunTable | None
    scatterers: tuple
    surface_temperature: torch.Tensor
    surface_albedo: torch.Tensor
    predef: tuple = ()
    species_names: tuple = ()


def _scatterer_profiles(sc, F, Z, nleg):
    """(k_ext [F, Z], k_sca [F, Z], leg [F, Z, nleg]) for one scatterer,
    flipped to the TOA-first level order."""
    if not isinstance(sc, HenyeyGreenstein):
        raise TypeError(f"unsupported scatterer {type(sc).__name__} "
                        "(only HenyeyGreenstein is ported)")
    k_ext, k_sca, leg = sc.bulk_properties(nleg)
    return (k_ext.flip(-1).expand(F, Z), k_sca.flip(-1).expand(F, Z),
            leg.flip(-2).expand(F, Z, nleg))


def gas_absorption_profile(scene: AllskyScene, f_grid, plain: bool = False,
                           device=None, dtype=None):
    """Gas absorption on the scene's levels, TOA-first: [F, Z]: the lines
    through the Voigt kernel, all levels in one launch (its plain version
    for CPU tensors, or anywhere with plain=True), plus the predefined
    models."""
    dev, dt = resolve(device, dtype)
    scene, f_grid = move((scene, f_grid), dev, dt)
    pts = scene.atm.at(scene.atm.z.flip(0))
    k = species_absorption(scene, f_grid, pts.t, pts.p, pts.vmr, backend="pallas",
                           plain=plain)
    return k.t().contiguous()


def simulate_allsky(scene: AllskyScene, f_grid, nquad: int = 16, nleg: int | None = None,
                    nfourier: int | None = None, mu0: float = 0.0, fbeam=0.0,
                    phi0: float = 0.0, phis: tuple = (), k_gas=None,
                    fast_linalg: bool | None = None, thermal: bool = True,
                    intensity_correction: bool = False, plain: bool = False,
                    device=None, dtype=None):
    """DISORT radiance and flux field for the vertical profile of scene.atm
    with nleg (default nquad) phase moments.

    Returns a DisortOutput with a leading frequency axis; levels run from
    the TOA to the surface.  mu0 > 0 adds a solar beam of flux fbeam
    (scalar or [F]) from zenith cosine mu0 and azimuth phi0 (degrees);
    phis are the azimuths of the field u; intensity_correction adds the
    TMS/IMS corrections to u.  thermal=False leaves out the thermal
    emission (a solar-band run).  k_gas: optional precomputed [F, Z] gas
    absorption (TOA-first, from gas_absorption_profile).  fast_linalg:
    None or True solves by the fused DISORT kernels, False by the
    differentiable route (disort/solver.py), through which autograd and
    torch.func Jacobians run.  plain=True runs the kernels' plain versions
    on any device."""
    dev, dt = resolve(device, dtype)
    scene, f_grid, k_gas = move((scene, f_grid, k_gas), dev, dt)
    if k_gas is None:
        k_gas = gas_absorption_profile(scene, f_grid, plain=plain, device=dev, dtype=dt)
    nleg = nleg or nquad
    inp = allsky_input(scene, f_grid, k_gas, nleg=nleg, fbeam=fbeam, thermal=thermal)
    return disort(inp, nquad=nquad, nleg=nleg, nfourier=nfourier, mu0=mu0, phi0=phi0,
                  phis=phis, intensity_correction=intensity_correction,
                  fast_linalg=fast_linalg, plain=plain, device=dev, dtype=dt)


def allsky_input(scene: AllskyScene, f_grid, k_gas, nleg: int, fbeam=0.0,
                 thermal: bool = True) -> DisortInput:
    """The DISORT problem of every frequency: layer optical depths, single
    scattering albedos and phase moments from gas and particles, the beam
    flux fbeam (scalar or [F]), and the Planck sources at the levels, the
    surface and the top (the cosmic background), zero when not thermal."""
    dt, dev = f_grid.dtype, f_grid.device
    z = scene.atm.z.flip(0)  # TOA..surface
    pts = scene.atm.at(z)
    F, Z = f_grid.shape[0], z.shape[0]
    k_ext = k_gas
    k_sca = torch.zeros_like(k_gas)
    leg_w = torch.zeros(k_gas.shape + (nleg,), dtype=dt, device=dev)
    for sc in scene.scatterers:
        e, s, lg = _scatterer_profiles(sc, F, Z, nleg)
        k_ext = k_ext + e
        k_sca = k_sca + s
        leg_w = leg_w + lg

    dz = -torch.diff(z)  # [Z-1] positive layer thickness
    lay = lambda a: 0.5 * (a[..., 1:] + a[..., :-1])
    tau = lay(k_ext) * dz  # [F, L]
    ksca_l = lay(k_sca) * dz
    omega = torch.where(tau > 0, ksca_l / torch.clamp(tau, min=1e-300), 0.0)
    legl = lay(torch.movedim(leg_w, -1, 0)) * dz  # [NLeg, F, L]
    leg = torch.movedim(torch.where(ksca_l > 0, legl / torch.clamp(ksca_l, min=1e-300),
                                    0.0), 0, -1)  # [F, L, NLeg]
    # g_0 = 1, out of place so that torch.func transforms pass
    leg = torch.cat([torch.ones_like(leg[..., :1]), leg[..., 1:]], -1)
    if thermal:
        b_levels = planck(f_grid[:, None], pts.t[None, :])
        b_surf = planck(f_grid, scene.surface_temperature)
        b_top = planck(f_grid, torch.tensor(
            const.cosmic_microwave_background_temperature, dtype=dt, device=dev))
    else:
        # a solar-band run: the thermal emission is another call's
        b_levels = torch.zeros((F, Z), dtype=dt, device=dev)
        b_surf = b_top = torch.zeros(F, dtype=dt, device=dev)
    return DisortInput(
        tau=tau,
        omega=omega,
        leg=leg,
        f=torch.zeros_like(tau),  # no fractional scattering
        b_levels=b_levels,
        fisot=torch.zeros(F, dtype=dt, device=dev),
        albedo=scene.surface_albedo.expand(F),
        b_surf=b_surf,
        b_top=b_top,
        fbeam=torch.as_tensor(fbeam, dtype=dt, device=dev).expand(F),
    )
