"""Forward operators shared by the port's paths (port of parts of
arts_tpu/fwd.py): gas absorption assembly (line-catalog branch only) and
the polarized clear-sky radiance through Zeeman-split lines."""

import dataclasses

import torch

from . import constants as const
from ._cuda import move, resolve
from .atm import Atmosphere1D
from .lbl.partfun import PartFunTable
from .lbl.voigt import absorption_kernel
from .lbl.zeeman import ZeemanCatalog, zeeman_propmat
from .ops.planck import planck
from .rtepack.emission import emission_polarized


def species_absorption(scene, fg, t, p, v, plain=False):
    """Absorption [Z, F] at the points t, p [Z], v [Z, S] through the
    Voigt kernel (its plain version on CPU tensors, or anywhere with
    plain=True)."""
    return absorption_kernel(fg, scene.cat, scene.pf, t, p, v, plain=plain,
                             device=fg.device, dtype=fg.dtype)


@dataclasses.dataclass(frozen=True)
class ZeemanScene:
    """Clear-sky scene with Zeeman-split polarized absorption (after
    ARTS's 2-zeeman example): the atmosphere carries the magnetic field
    (Atmosphere1D.mag)."""

    atm: Atmosphere1D
    zcat: ZeemanCatalog
    pf: PartFunTable
    surface_temperature: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(288.0))


def simulate_clearsky_polarized(scene: ZeemanScene, f_grid, path_alt, path_za,
                                path_dr, background="space", device=None,
                                dtype=None):
    """Full-Stokes clear-sky radiance [F, 4] at the observer.

    path_alt, path_za (line-of-sight zenith angle per point, degrees, for
    the magnetic geometry) [np], path_dr [np-1] (path.geometric_path_1d);
    background "space" (the cosmic background) or "surface" (a blackbody
    at scene.surface_temperature).  The propagation matrices come from
    zeeman_propmat's dense route for every path point at once, as the
    JAX function takes the XLA route; the emission is the "constant"
    layer recursion.  Not ported yet: "surface_reflect", the non-LTE
    band, and the lintau and linprop recursions.
    """
    if background not in ("space", "surface"):
        raise ValueError(f"simulate_clearsky_polarized: background {background!r} "
                         "is not supported (space, surface)")
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
    scene = move(scene, dev, dt)
    f_grid, path_alt, path_za, r = (as_t(x) for x in (f_grid, path_alt, path_za, path_dr))
    pts = scene.atm.at(path_alt)
    k = zeeman_propmat(f_grid, scene.zcat, scene.pf, pts.t, pts.p, pts.vmr, pts.mag,
                       path_za, device=dev, dtype=dt)  # [np, F, 7]
    J = torch.zeros(k.shape[:-1] + (4,), dtype=dt, device=dev)
    J[..., 0] = planck(f_grid[None, :], pts.t[:, None])
    t_bg = (scene.surface_temperature if background == "surface"
            else as_t(const.cosmic_microwave_background_temperature))
    I0 = torch.zeros(f_grid.shape + (4,), dtype=dt, device=dev)
    I0[:, 0] = planck(f_grid, t_bg)
    return emission_polarized(k, J, r, I0)
