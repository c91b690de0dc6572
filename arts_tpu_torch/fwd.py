"""Clear-sky forward operators (port of arts_tpu/fwd.py): gas absorption
assembly, the scalar clear-sky radiance along a path, the level-cached
absorption and the radiance interpolated from it, and the polarized
clear-sky radiance through Zeeman-split lines.

    path -> atmosphere at the path points -> LBL absorption -> Planck source
         -> layer transmittances -> emission recursion (+ background)

Every path argument may carry leading batch axes (one path per row,
padded with zero-length segments, which are exact no-ops); the result
keeps them.  Everything is differentiable by autograd and torch.func.

A non-LTE band (scene.nlte, lbl.nlte.NlteField) adds its absorption to
K and its emission excess S to the source, J = B + K^-1 S, in the scalar
and the polarized radiance.  Not ported yet (each raises
NotImplementedError): the predefined continua and ECS line-mixing bands
(ROADMAP §A 5) and the sun in the pencil beam (§A 7).
"""

import dataclasses

import torch

from . import constants as const
from ._cuda import move, resolve
from .atm import Atmosphere1D
from .lbl.catalog import LineCatalog
from .lbl.partfun import PartFunTable
from .lbl.nlte import nlte_absorption_source
from .lbl.voigt import absorption, absorption_kernel
from .lbl.zeeman import ZeemanCatalog, zeeman_propmat_views
from .ops.planck import inv_planck, planck
from .options import PathBackground, RteOption, check_option
from .rtepack import emission as E
from .rtepack.propmat import inv as pm_inv
from .rtepack.propmat import matvec
from .rtepack.surface import flat_scalar_reflection


def _emission_fn(rte_option: str):
    """Scalar emission recursion for an rte_option."""
    return {
        "constant": E.emission_unpolarized,
        "lintau": E.emission_unpolarized_linsrc,
        "linprop": E.emission_unpolarized_linprop,
    }[check_option(RteOption, rte_option)]


def _emission_fn_polarized(rte_option: str):
    """Polarized emission recursion for an rte_option."""
    return {
        "constant": E.emission_polarized,
        "lintau": E.emission_polarized_linsrc,
        "linprop": E.emission_polarized_linprop,
    }[check_option(RteOption, rte_option)]


def _refuse_unported(scene):
    if getattr(scene, "predef", ()):
        raise NotImplementedError("predefined absorption models are not ported yet "
                                  "(ROADMAP §A 5)")
    if getattr(scene, "ecs_bands", ()):
        raise NotImplementedError("ECS line-mixing bands are not ported yet (ROADMAP §A 5)")


def species_absorption(scene, fg, t, p, v, block: int = 256, backend: str = "xla",
                       plain: bool = False):
    """Gas absorption [..., F] at the points t, p [...], v [..., S]: the
    line catalog by the dense route (backend "xla", differentiable, lines
    in blocks of `block`; fg [F] or one grid per point [..., F]) or through
    the Voigt kernel (backend "pallas": its plain version on CPU tensors,
    or anywhere with plain=True; fg [F])."""
    _refuse_unported(scene)
    if scene.cat is None or scene.cat.n_lines == 0:
        return torch.zeros(t.shape + fg.shape[-1:], dtype=fg.dtype, device=fg.device)
    if backend == "pallas":
        shape = t.shape
        a = absorption_kernel(fg, scene.cat, scene.pf, t.reshape(-1), p.reshape(-1),
                              v.reshape(-1, v.shape[-1]), plain=plain,
                              device=fg.device, dtype=fg.dtype)
        return a.reshape(shape + fg.shape)
    if backend != "xla":
        raise ValueError(f"species_absorption: backend {backend!r} (xla, pallas)")
    return absorption(fg, scene.cat, scene.pf, t, p, v, block=block,
                      device=fg.device, dtype=fg.dtype)


@dataclasses.dataclass(frozen=True)
class ClearskyScene:
    """Scene state of a clear-sky emission simulation.  nlte is an optional
    non-LTE band (lbl.nlte.NlteField).  predef and ecs_bands are the JAX
    package's fields for absorption the port cannot evaluate yet: a scene
    that sets one raises NotImplementedError.  species_names names the
    rows of atm.vmr."""

    atm: Atmosphere1D
    cat: LineCatalog | None
    pf: PartFunTable | None
    surface_temperature: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(288.0))
    surface_emissivity: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(1.0))
    predef: tuple = ()
    species_names: tuple = ()
    ecs_bands: tuple = ()
    nlte: object | None = None


def _background(scene, f_grid, k, J, r, background, emission):
    """The radiance entering the far end of the path [F]: the cosmic
    background ("space"), an emitting surface ("surface") or an emitting
    surface that reflects the downwelling radiance of the same layers
    ("surface_reflect", the recursion over the reversed path)."""
    cmb = planck(f_grid, torch.tensor(const.cosmic_microwave_background_temperature,
                                      dtype=f_grid.dtype, device=f_grid.device))
    cmb = cmb * torch.ones_like(f_grid)
    bg = check_option(PathBackground, background)
    eps = scene.surface_emissivity
    if bg == "surface":
        return eps * planck(f_grid, scene.surface_temperature) + (1.0 - eps) * cmb
    if bg == "surface_reflect":
        I_down = emission(k.flip(0), J.flip(0), r.flip(0), cmb)
        return (1.0 - eps) * I_down + eps * planck(f_grid, scene.surface_temperature)
    return cmb


def _radiance(scene, f_grid, k, pts, r, background, rte_option, dJ=None):
    """Emission along the paths from point quantities [..., NP, F]; dJ adds
    to the Planck source (a non-LTE band's K^-1 S)."""
    emission = _emission_fn(rte_option)
    J = planck(f_grid, pts.t[..., None])
    if dJ is not None:
        J = J + dJ
    k, J, r = torch.movedim(k, -2, 0), torch.movedim(J, -2, 0), torch.movedim(r, -1, 0)
    I0 = _background(scene, f_grid, k, J, r, background, emission)
    return emission(k, J, r, I0.expand(k.shape[1:]))


def simulate_clearsky(scene: ClearskyScene, f_grid, path_alt, path_dr,
                      background: str = "space", block: int = 256, path_za=None,
                      path_aa=None, rte_option: str = "constant", sun=None, sun_za=None,
                      sun_aa=0.0, scattered_sun: bool = False, depolarization: float = 0.0,
                      sun_refraction: bool = False, device=None, dtype=None):
    """Clear-sky spectral radiance [..., F] (W / (m^2 Hz sr)) at the observer.

    path_alt [..., NP] altitudes from the observer to the far end, path_dr
    [..., NP-1] layer lengths (path.geometric_path_1d); background
    "space", "surface" or "surface_reflect"; rte_option "constant",
    "lintau" or "linprop".  Absorption takes the dense route at every path
    point (lines in blocks of `block`).  With scene.atm.wind set and
    path_za (and optionally path_aa) given in degrees, each point's
    absorption is evaluated on its Doppler-shifted grid
    f (1 - v_los / c).  A non-LTE band (scene.nlte) adds its absorption at
    each point (on the same grid) to K and its source S as K^-1 S to the
    Planck source, with K the full absorption.  The sun arguments raise
    NotImplementedError (not ported yet, ROADMAP §A 7).
    """
    if sun is not None or scattered_sun:
        raise NotImplementedError("the sun in the pencil beam is not ported yet "
                                  "(ROADMAP §A 7)")
    _emission_fn(rte_option)
    check_option(PathBackground, background)
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
    scene = move(scene, dev, dt)
    f_grid, path_alt, r = as_t(f_grid), as_t(path_alt), as_t(path_dr)
    pts = scene.atm.at(path_alt)
    fg = f_grid
    if scene.atm.wind is not None and path_za is not None:
        za = torch.deg2rad(as_t(path_za))
        aa = torch.zeros_like(za) if path_aa is None else torch.deg2rad(as_t(path_aa))
        aa = aa.expand_as(za)
        khat = torch.stack([torch.sin(za) * torch.sin(aa), torch.sin(za) * torch.cos(aa),
                            torch.cos(za)], -1)
        v_los = (pts.wind * khat).sum(-1)
        fg = f_grid * (1.0 - v_los / const.c)[..., None]
    k = species_absorption(scene, fg, pts.t, pts.p, pts.vmr, block=block)
    dJ = None
    if scene.nlte is not None:
        ru, rl = scene.nlte.at(path_alt)
        a_n, s_n = nlte_absorption_source(fg, scene.nlte.cat, pts.t, pts.p, pts.vmr, ru, rl,
                                          block=block)
        k = k + a_n
        dJ = s_n / torch.where(k.abs() > 1e-30, k, torch.ones_like(k))
    return _radiance(scene, f_grid, k, pts, r, background, rte_option, dJ)


def gas_absorption_levels(scene: ClearskyScene, f_grid, block: int = 256,
                          backend: str = "xla", plain: bool = False, device=None,
                          dtype=None):
    """Gas absorption on the scene's own levels, ascending: [Z, F].

    The level cache of many-geometry batches: in a 1D atmosphere every
    path samples the same vertical state, so the absorption is computed
    once here and each path interpolates it
    (simulate_clearsky_from_levels).  backend "pallas" takes the Voigt
    kernel, one launch for all levels; "xla" the dense route.  A non-LTE
    or a windy scene raises ValueError, as in the JAX package: the one
    needs its per-point source term, the other per-point Doppler grids."""
    if scene.nlte is not None:
        raise ValueError("gas_absorption_levels has no NLTE source term: NLTE scenes "
                         "must use simulate_clearsky (per-point evaluation)")
    if scene.atm.wind is not None:
        raise ValueError("gas_absorption_levels cannot cache a wind (Doppler) scene: the "
                         "per-point frequency shift breaks the shared level grid")
    dev, dt = resolve(device, dtype)
    scene, f_grid = move((scene, torch.as_tensor(f_grid)), dev, dt)
    pts = scene.atm.at(scene.atm.z)
    return species_absorption(scene, f_grid, pts.t, pts.p, pts.vmr, block=block,
                              backend=backend, plain=plain)


def simulate_clearsky_from_levels(k_levels, scene: ClearskyScene, f_grid, path_alt,
                                  path_dr, background: str = "space",
                                  rte_option: str = "constant", device=None, dtype=None):
    """Clear-sky radiance [..., F] with the absorption interpolated from the
    level cache k_levels [Z, F] (gas_absorption_levels): linear in
    altitude, exact at the levels, O(dz^2) between them.  Paths as in
    simulate_clearsky; no wind."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
    scene = move(scene, dev, dt)
    k_levels, f_grid, alt, r = (as_t(x) for x in (k_levels, f_grid, path_alt, path_dr))
    z = scene.atm.z
    i1 = torch.clamp(torch.searchsorted(z, alt), 1, z.shape[0] - 1)
    i0 = i1 - 1
    w = torch.clamp((alt - z[i0]) / (z[i1] - z[i0]), 0.0, 1.0)[..., None]
    k = k_levels[i0] * (1.0 - w) + k_levels[i1] * w
    return _radiance(scene, f_grid, k, scene.atm.at(alt), r, background, rte_option)


def simulate_clearsky_bt(scene, f_grid, path_alt, path_dr, background="space",
                         device=None, dtype=None):
    """simulate_clearsky as Planck brightness temperature [..., F] (K)."""
    dev, dt = resolve(device, dtype)
    f_grid = torch.as_tensor(f_grid).to(device=dev, dtype=dt)
    I = simulate_clearsky(scene, f_grid, path_alt, path_dr, background=background,
                          device=dev, dtype=dt)
    return inv_planck(I, f_grid)


@dataclasses.dataclass(frozen=True)
class ZeemanScene:
    """Clear-sky scene with Zeeman-split polarized absorption (after
    ARTS's 2-zeeman example): the atmosphere carries the magnetic field
    (Atmosphere1D.mag).  surface_reflectance is the scalar power
    reflectance of background="surface_reflect"; nlte an optional
    non-LTE band (lbl.nlte.NlteField) of unpolarized lines."""

    atm: Atmosphere1D
    zcat: ZeemanCatalog
    pf: PartFunTable
    surface_temperature: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(288.0))
    surface_reflectance: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.tensor(0.0))
    nlte: object | None = None


def simulate_clearsky_polarized(scene: ZeemanScene, f_grid, path_alt, path_za,
                                path_dr, background="space", rte_option="constant",
                                device=None, dtype=None):
    """Full-Stokes clear-sky radiance [F, 4] at the observer.

    path_alt, path_za (line-of-sight zenith angle per point, degrees, for
    the magnetic geometry) [np], path_dr [np-1] (path.geometric_path_1d);
    rte_option "constant", "lintau" or "linprop" (the polarized
    recursions of rtepack.emission).  background "space" (the cosmic
    background), "surface" (a blackbody at scene.surface_temperature) or
    "surface_reflect": the downwelling Stokes vector is integrated along
    the mirrored path (zenith angle 180 - za, which flips the magnetic
    geometry, so its propagation matrices are formed anew for that
    direction) from the cosmic background, then reflected with
    flat_scalar_reflection (scene.surface_reflectance, V mirrored, the
    rest emitted at scene.surface_temperature).  As in the JAX package,
    the mirrored leg's K holds the Zeeman lines only, and its source the
    full J.  A non-LTE band (scene.nlte) adds its absorption to component
    0 of K and its source as J = B e1 + K^-1 S, with component 0 of K
    floored at 1e-30 for the inversion only.  The propagation matrices
    come from zeeman_propmat's dense route for every path point at once
    (both directions from one set of shape sums), as the JAX function
    takes the XLA route.
    """
    bg = check_option(PathBackground, background)
    emission = _emission_fn_polarized(rte_option)
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x).to(device=dev, dtype=dt)
    scene = move(scene, dev, dt)
    f_grid, path_alt, path_za, r = (as_t(x) for x in (f_grid, path_alt, path_za, path_dr))
    pts = scene.atm.at(path_alt)
    views = [path_za] + ([180.0 - path_za] if bg == "surface_reflect" else [])
    k, *k_mirror = zeeman_propmat_views(f_grid, scene.zcat, scene.pf, pts.t, pts.p, pts.vmr,
                                        pts.mag, views, device=dev, dtype=dt)  # [np, F, 7]
    stokes = lambda x: torch.nn.functional.pad(x[..., None], (0, 3))  # x e1
    J = stokes(planck(f_grid[None, :], pts.t[:, None]))
    if scene.nlte is not None:
        ru, rl = scene.nlte.at(path_alt)
        a_n, s_n = nlte_absorption_source(f_grid, scene.nlte.cat, pts.t, pts.p, pts.vmr, ru,
                                          rl)
        k = torch.cat([k[..., :1] + a_n[..., None], k[..., 1:]], -1)
        k_inv = torch.cat([torch.clamp(k[..., :1], min=1e-30), k[..., 1:]], -1)
        J = J + matvec(pm_inv(k_inv), stokes(s_n))
    cmb = stokes(planck(f_grid, as_t(const.cosmic_microwave_background_temperature))
                 * torch.ones_like(f_grid))
    if bg == "surface":
        I0 = stokes(planck(f_grid, scene.surface_temperature) * torch.ones_like(f_grid))
    elif bg == "surface_reflect":
        # the mirrored leg runs from the far end of the path to the surface:
        # its points in reverse order
        I_down = emission(k_mirror[0].flip(0), J.flip(0), r.flip(0), cmb)
        B = stokes(planck(f_grid, scene.surface_temperature) * torch.ones_like(f_grid))
        I0 = flat_scalar_reflection(I_down, scene.surface_reflectance, B)
    else:
        I0 = cmb
    return emission(k, J, r, I0)
