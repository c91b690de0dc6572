"""Clear-sky forward operators (port of arts_tpu/fwd.py): gas absorption
assembly, the scalar clear-sky radiance along a path, the level-cached
absorption and the radiance interpolated from it, and the polarized
clear-sky radiance through Zeeman-split lines.

    path -> atmosphere at the path points -> LBL absorption -> Planck source
         -> layer transmittances -> emission recursion (+ background)

Every path argument may carry leading batch axes (one path per row,
padded with zero-length segments, which are exact no-ops); the result
keeps them.  Everything is differentiable by autograd and torch.func.

The gas absorption of a scene is its line catalog plus its predefined
models (scene.predef, the continua and full models of
predefined/models.py, with scene.species_names naming the rows of the
VMRs) plus its ECS line-mixing bands (scene.ecs_bands, lbl.ecs),
assembled in species_absorption for every caller.  A non-LTE band
(scene.nlte, lbl.nlte.NlteField) adds its absorption to K and its
emission excess S to the source, J = B + K^-1 S, in the scalar and the
polarized radiance.

The sun enters the scalar radiance in two ways (simulate_clearsky's sun
arguments): as the path's background where the line of sight at the far
end hits the solar disk (sun.hit_sun_los), and as first-order Rayleigh
scattered sunlight along the path, attenuated along each scatter point's
spherical-shell sun leg (sun_leg_tau, geometric or refracted).  Not
ported yet: the 3-D clear-sky operator, simulate_clearsky_3d (ROADMAP
§A 7).
"""

import dataclasses
import math

import torch

from . import _cuda
from . import constants as const
from ._cuda import move, resolve
from .atm import Atmosphere1D
from .lbl.catalog import LineCatalog
from .lbl.ecs import ecs_absorption
from .lbl.partfun import PartFunTable
from .lbl.nlte import nlte_absorption_source
from .lbl.voigt import absorption, absorption_kernel
from .lbl.zeeman import ZeemanCatalog, zeeman_propmat_views
from .ops.planck import inv_planck, planck
from .options import PathBackground, RteOption, check_option
from .path.geometry import EARTH_RADIUS
from .path.refraction import microwave_refractivity
from .predefined import predefined_absorption
from .rtepack import emission as E
from .rtepack.propmat import inv as pm_inv
from .rtepack.propmat import matvec
from .rtepack.scattering import rayleigh_scat_airsimple, rayleigh_scattering
from .rtepack.surface import flat_scalar_reflection
from .sun import hit_sun_los, sun_background_radiance


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


def species_absorption(scene, fg, t, p, v, block: int = 256, backend: str = "xla",
                       plain: bool = False):
    """Gas absorption [..., F] at the points t, p [...], v [..., S]: the
    line catalog by the dense route (backend "xla", differentiable, lines
    in blocks of `block`; fg [F] or one grid per point [..., F]) or through
    the Voigt kernel (backend "pallas": its plain version on CPU tensors,
    or anywhere with plain=True; fg [F]), plus the scene's predefined
    models (scene.predef, VMRs by scene.species_names) and its ECS bands
    (scene.ecs_bands, each (band, spec_idx, iso_idx, iso_ratio), the band
    matrix in float64 whatever the dtype) on either."""
    if backend not in ("xla", "pallas"):
        raise ValueError(f"species_absorption: backend {backend!r} (xla, pallas)")
    a = torch.zeros(torch.broadcast_shapes(t.shape + (1,), fg.shape), dtype=fg.dtype,
                    device=fg.device)
    if scene.cat is not None and scene.cat.n_lines > 0:
        if backend == "pallas":
            shape = t.shape
            a = a + absorption_kernel(fg, scene.cat, scene.pf, t.reshape(-1), p.reshape(-1),
                                      v.reshape(-1, v.shape[-1]), plain=plain,
                                      device=fg.device, dtype=fg.dtype).reshape(shape + fg.shape)
        else:
            a = a + absorption(fg, scene.cat, scene.pf, t, p, v, block=block,
                               device=fg.device, dtype=fg.dtype)
    if getattr(scene, "predef", ()):
        vmrs = {tag: v[..., i] for i, tag in enumerate(scene.species_names)}
        a = a + predefined_absorption(scene.predef, fg, t, p, vmrs, device=fg.device,
                                      dtype=fg.dtype)
    for band, sidx, iidx, irat in getattr(scene, "ecs_bands", ()):
        a = a + ecs_absorption(fg, band, scene.pf, iidx, t, p, v[..., sidx], irat)
    return a


@dataclasses.dataclass(frozen=True)
class ClearskyScene:
    """Scene state of a clear-sky emission simulation.  predef names the
    predefined absorption models (predefined.PREDEF_MODELS) added to the
    catalog's lines; species_names names the rows of atm.vmr; cat and pf
    may be None (predefined models only).  nlte is an optional non-LTE
    band (lbl.nlte.NlteField).  ecs_bands holds ECS line-mixing bands,
    ((lbl.ecs.EcsBand, spec_idx, iso_idx, iso_ratio), ...), evaluated at
    every point like the catalog; pf must then hold their
    isotopologues."""

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


def _background(scene, f_grid, k, J, r, background, emission, space=None):
    """The radiance entering the far end of the path [F] (or [..., F]): the
    cosmic background, or `space` in its place ("space"), an emitting
    surface ("surface") or an emitting surface that reflects the
    downwelling radiance of the same layers ("surface_reflect", the
    recursion over the reversed path)."""
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
    return cmb if space is None else space


def _radiance(scene, f_grid, k, pts, r, background, rte_option, dJ=None, space=None):
    """Emission along the paths from point quantities [..., NP, F]; dJ adds
    to the Planck source (a non-LTE band's K^-1 S, the scattered sun's);
    space replaces the cosmic background of background "space"."""
    emission = _emission_fn(rte_option)
    J = planck(f_grid, pts.t[..., None])
    if dJ is not None:
        J = J + dJ
    k, J, r = torch.movedim(k, -2, 0), torch.movedim(J, -2, 0), torch.movedim(r, -1, 0)
    I0 = _background(scene, f_grid, k, J, r, background, emission, space)
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
    Planck source, with K the full absorption.

    The sun (sun.Sun, e.g. sun.sun_blackbody) with its local direction
    (sun_za, sun_aa) [deg, toward the sun], each a scalar or one value per
    path (the leading axes of path_alt):
      * background "space" with path_za given: the background becomes the
        photosphere radiance where the line of sight at the path's last
        point (path_za and path_aa, each [..., NP] or a scalar) hits the disk
        (sun.hit_sun_los, in float64; padded paths repeat their last
        point, as sensor.stack_paths pads them);
      * scattered_sun=True (path_za needed): first-order Rayleigh scattered
        sunlight at every point, J += K^-1 scat, with scat = k_ray
        P11 / (4 pi) pi sin^2(alpha) S exp(-tau_sun) (the phase matrix's
        first element at depolarization `depolarization`, air by
        rayleigh_scat_airsimple) and tau_sun along each point's
        spherical-shell sun leg through the levels' absorption plus
        Rayleigh air (sun_leg_tau; refracted by the levels' Smith-Weintraub
        index with sun_refraction=True, H2O from the scene's "H2O" row);
        the Rayleigh air extinction joins K on the path.
    The sun's geometry (hit test, sun legs, phase) is computed in float64
    whatever the dtype.
    """
    _emission_fn(rte_option)
    check_option(PathBackground, background)
    dev, dt = resolve(device, dtype)
    as_t = lambda x: _cuda.tensor(x, dev, dt)
    as_64 = lambda x: _cuda.tensor(x, dev, torch.float64)
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
    space = None
    if sun is not None and (scattered_sun or (background == "space" and path_za is not None)):
        if path_za is None:
            raise ValueError("simulate_clearsky: scattered_sun needs path_za")
        sun_in, sun = sun, move(sun, dev, dt)
        per_path = lambda x: torch.broadcast_to(as_64(x), path_alt.shape[:-1])
        sza, saa = per_path(sun_za), per_path(sun_aa)
        za64 = torch.broadcast_to(as_64(path_za), path_alt.shape)
        aa64 = torch.broadcast_to(as_64(0.0 if path_aa is None else path_aa), path_alt.shape)
        if scattered_sun:
            k_ray = rayleigh_scat_airsimple(f_grid, pts.p[..., None], pts.t[..., None],
                                            device=dev, dtype=dt)
            t_sun = _sun_transmittance(scene, f_grid, path_alt, sza, block, sun_refraction)
            los_in = torch.stack([sza[..., None].expand(za64.shape),
                                  saa[..., None].expand(za64.shape)], -1)
            phase = rayleigh_scattering(los_in, torch.stack([za64, aa64], -1), depolarization,
                                        device=dev, dtype=torch.float64)[..., 0, 0]
            scat = (k_ray * (phase / (4.0 * math.pi)).to(dt)[..., None]
                    * (math.pi * sun.sin_alpha_squared()) * sun.spectrum * t_sun)
            k = k + k_ray  # the scattering extinction on the main path too
            dJ_sun = scat / torch.where(k.abs() > 1e-30, k, torch.ones_like(k))
            dJ = dJ_sun if dJ is None else dJ + dJ_sun
        if background == "space" and path_za is not None:
            _, hit = hit_sun_los(sun_in, za64[..., -1], aa64[..., -1], sza, saa, device=dev)
            space = sun_background_radiance(sun, f_grid, hit)
    return _radiance(scene, f_grid, k, pts, r, background, rte_option, dJ, space)


def _sun_transmittance(scene, f_grid, path_alt, sun_za, block, refraction):
    """exp(-tau) [..., NP, F] of the sun legs of the path points (0 where the
    planet blocks the leg): the levels' gas absorption plus Rayleigh air,
    averaged over each layer, through sun_leg_tau; sun_za [...] per path."""
    zg = scene.atm.z
    lv = scene.atm.at(zg)
    kx = species_absorption(scene, f_grid, lv.t, lv.p, lv.vmr, block=block) + (
        rayleigh_scat_airsimple(f_grid, lv.p[:, None], lv.t[:, None], device=f_grid.device,
                                dtype=f_grid.dtype))
    k_mid = 0.5 * (kx[1:] + kx[:-1])  # [Z-1, F]
    n_lvl = None
    if refraction:
        names = scene.species_names
        h2o = lv.vmr[:, names.index("H2O")] if "H2O" in names else torch.zeros_like(lv.p)
        n_lvl = 1.0 + microwave_refractivity(lv.p, lv.t, h2o)
    tau, visible = sun_leg_tau(zg, k_mid, path_alt, sun_za[..., None], n_levels=n_lvl)
    return torch.where(visible[..., None], torch.exp(-tau), torch.zeros_like(tau))


def sun_leg_tau(z_levels, k_mid, alt, sun_za_deg, radius=EARTH_RADIUS, n_levels=None):
    """Optical depth [..., F] along the sun legs of the points at `alt`
    [...], and whether the planet leaves each leg open [...] (bool).

    The spherical-shell form of ARTS's find_sun_path: from a point at alt
    with local sun zenith angle sun_za_deg (broadcast to alt), the ray's
    Bouguer invariant is p = n(alt) (R + alt) sin(za); within shell j (its
    refractive index n_j the mean of its levels') the slant coordinate is
    S_j(r) = sqrt((n_j r)^2 - p^2) / n_j, so the slant lengths per shell
    are differences of S and tau is one contraction with k_mid [Z-1, F],
    the layers' extinction.  Rays above the horizon (za > 90) descend to
    the tangent radius (n r = p) first: where that clears the surface the
    sun is still seen (twilight) and tau = 2 tau_full - tau_up; where it
    does not, the planet blocks the leg.  n_levels [Z] (optional): the
    refractive index at the levels z_levels [Z] (ascending); None = 1.
    Assumes n r increases outward (no ducting).

    The geometry is float64 whatever the dtype: sqrt((n r)^2 - p^2) at r ~
    6.4e6 m cancels ~1e-4 of tau in float32.  The slant lengths are then
    cast to k_mid's dtype and contracted in full float32 (no TF32), the
    descending legs' 2 S_full - S_up formed before the contraction."""
    dev = k_mid.device
    d = lambda x: _cuda.tensor(x, dev, torch.float64)
    alt = d(alt)
    za = torch.deg2rad(torch.broadcast_to(d(sun_za_deg), alt.shape))
    r_a = radius + alt
    z = d(z_levels)
    r_l = radius + z
    if n_levels is None:
        n_mid = torch.ones_like(z[1:])
        n_at = torch.ones_like(alt)
        n_bot = 1.0
    else:
        n = d(n_levels)
        n_mid = 0.5 * (n[1:] + n[:-1])
        i1 = torch.clamp(torch.searchsorted(z, alt), 1, z.shape[0] - 1)
        w = torch.clamp((alt - z[i1 - 1]) / (z[i1] - z[i1 - 1]), 0.0, 1.0)
        n_at = n[i1 - 1] * (1.0 - w) + n[i1] * w
        n_bot = n[0]
    p_inv = n_at * r_a * torch.sin(za)

    def S_of(r, nj):
        x = (nj * r) ** 2 - p_inv[..., None] ** 2
        pos = x > 0
        return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                           torch.zeros_like(x)) / nj

    S_lo, S_hi = S_of(r_l[:-1], n_mid), S_of(r_l[1:], n_mid)  # [..., Z-1]
    Sa = S_of(r_a[..., None], n_mid)  # the start, clamped per shell
    seg_up = torch.clamp(S_hi - torch.maximum(S_lo, Sa), min=0.0)
    seg_full = torch.clamp(S_hi - S_lo, min=0.0)
    desc = za > math.pi / 2
    # tau = 2 tau_full - tau_up on descending legs, as one contraction of
    # the combined slant lengths (float32 would round the two sums apart)
    seg = torch.where(desc[..., None], 2.0 * seg_full - seg_up, seg_up).to(k_mid.dtype)
    with _cuda.full_f32_matmul():
        tau = seg @ k_mid
    return tau, (~desc) | (p_inv > n_bot * radius)


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
