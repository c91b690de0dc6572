"""Non-LTE line absorption and source, and statistical equilibrium (port of
arts_tpu/lbl/nlte.py).

After ARTS's lbl_lineshape_voigt_nlte.cpp: per line, with the upper and
lower level population ratios ru, rl,
    k_amp = inv_sqrt_pi inv_gd r x (rl gu/gl - ru) a / f0^3,
    e_amp = 2 h inv_sqrt_pi inv_gd r x (e - k B_part) / c^2,
    B_part = f0^3 / expm1(h f0 / k T),  e = ru a,
with the frequency prefactor N f c^2 / (8 pi).  The absorption goes into
the propagation matrix and the emission excess into the source vector S
(J = B + K^-1 S).  The level populations come from the balanced rate
equations (ARTS's m_nlte.cc), iterated against the radiation field by
nlte_fit_profile.

Point arguments T, P [...], vmr [..., S], ru, rl [..., L] may carry
leading batch axes (levels or path points).
"""

import dataclasses

import numpy as np
import torch

from .. import constants as const
from .._cuda import move, resolve
from ..ops.planck import planck
from ..ops.zeeman_mp_kernel import wofz_parts
from .catalog import LineCatalog
from .tmodel import ID0, IDV, IG0
from .voigt import _shape_sum, lineshape_params


@dataclasses.dataclass(frozen=True)
class NlteField:
    """A non-LTE band carried in a scene: level-population-ratio profiles
    r [NZ, NL] on the ascending altitude grid z [NZ], the band's own line
    catalog (not also in the LTE catalog) and each line's upper and lower
    level indices up_idx, lo_idx [L]."""

    z: torch.Tensor
    r: torch.Tensor
    cat: LineCatalog
    up_idx: torch.Tensor
    lo_idx: torch.Tensor

    def at(self, alt):
        """(ru, rl) [..., L]: each line's upper and lower ratios at the
        altitudes alt [...], linear in altitude, held at the ends."""
        alt = torch.as_tensor(alt, dtype=self.z.dtype, device=self.z.device)
        i1 = torch.clamp(torch.searchsorted(self.z, alt), 1, self.z.shape[0] - 1)
        i0 = i1 - 1
        w = torch.clamp((alt - self.z[i0]) / (self.z[i1] - self.z[i0]), 0.0, 1.0)
        r = self.r[i0] * (1.0 - w[..., None]) + self.r[i1] * w[..., None]
        return r[..., self.up_idx], r[..., self.lo_idx]


def _amplitudes(cat: LineCatalog, T, P, vmr, ru, rl):
    """(k_amp, e_amp, shift, inv_gd, z_imag) [..., L]: the amplitudes with
    the 1/f0^3, N and c^2/8pi factors folded in (grouped so that every
    intermediate stays in float32 range), the pressure shift of the
    centres, 1/Doppler width and Im z."""
    ls = lineshape_params(cat, T, P, vmr)
    T1 = T[..., None]
    shift = ls[..., ID0] + ls[..., IDV]
    gd_part = torch.sqrt(const.doppler_broadening_const_squared * T1 / cat.iso_mass)
    inv_gd = 1.0 / (gd_part * (cat.f0 + shift))
    z_imag = ls[..., IG0] * inv_gd

    inv_f0 = 1.0 / cat.f0
    N = P[..., None] / (const.k * T1)
    x = vmr[..., cat.spec_idx]
    common = const.inv_sqrt_pi * inv_gd * cat.iso_ratio * x

    # absorption: N f (c^2/8pi) (rl gu/gl - ru) a / f0^3
    k_red = (rl * cat.gu / cat.gl - ru) * cat.a
    pref = (N * inv_f0) * ((const.c**2 / (8.0 * const.pi)) * inv_f0) * inv_f0
    k_amp = common * k_red * pref

    # source: f N (2h/8pi) common a [ru - (rl gu/gl - ru) / expm1(h f0/kT)]
    # (the c^2 cancels)
    b_red = 1.0 / torch.expm1(const.h * cat.f0 / (const.k * T1))
    e_term = cat.a * (ru - (rl * cat.gu / cat.gl - ru) * b_red)
    e_amp = common * (2.0 * const.h / (8.0 * const.pi) * N) * e_term
    return k_amp, e_amp, shift, inv_gd, z_imag


def nlte_amplitudes(cat: LineCatalog, T, P, vmr, ru, rl):
    """(k_amp, e_amp, f0s, inv_gd, z_imag) [..., L]: the per-line non-LTE
    amplitudes, the pressure-shifted centres, 1/Doppler width and Im z."""
    k_amp, e_amp, shift, inv_gd, z_imag = _amplitudes(cat, T, P, vmr, ru, rl)
    return k_amp, e_amp, cat.f0 + shift, inv_gd, z_imag


def nlte_absorption_source(f_grid, cat: LineCatalog, T, P, vmr, ru, rl, block: int = 256):
    """(alpha, src) [..., F]: the band's absorption [1/m], which adds to the
    propagation matrix, and its source term [W/(m^2 Hz sr)/m], the
    source-vector entry S of J = B + K^-1 S.  The dense shape sums of
    lbl.voigt (lines in blocks of `block`), the pressure shift applied
    after f - f0; both amplitudes on one leading axis, so that w(z) is
    evaluated once for the two."""
    k_amp, e_amp, shift, inv_gd, z_imag = _amplitudes(cat, T, P, vmr, ru, rl)
    shape = _shape_sum(f_grid, torch.stack([k_amp, e_amp]), cat.f0, inv_gd, z_imag,
                       cat.cutoff, block, shift=shift).real
    return f_grid * shape[0], f_grid * shape[1]


def statistical_equilibrium(W, normalize_to=1.0):
    """Steady-state level populations [..., nl] of the rate matrix W
    [..., nl, nl] (W[i, j] the rate j -> i; the diagonal ignored): dn/dt
    = 0 with sum(n) = normalize_to (a scalar or [...])."""
    out_rates = W.sum(-2) - torch.diagonal(W, dim1=-2, dim2=-1)
    M = W - torch.diag_embed(out_rates)
    M[..., -1, :] = 1.0  # the closure row
    b = torch.zeros(W.shape[:-1], dtype=W.dtype, device=W.device)
    b[..., -1] = torch.as_tensor(normalize_to, dtype=W.dtype, device=W.device)
    return torch.linalg.solve(M, b[..., None])[..., 0]


def two_level_rates(A, Bul, Blu, Cul, Clu, Jbar):
    """The two-level rate matrix [..., 2, 2] of the mean intensity Jbar
    [...]: W[0, 1] = A + Bul Jbar + Cul (into the lower level), W[1, 0] =
    Blu Jbar + Clu (into the upper)."""
    Jbar = torch.as_tensor(Jbar)
    W = torch.zeros(Jbar.shape + (2, 2), dtype=Jbar.dtype, device=Jbar.device)
    W[..., 0, 1] = A + Bul * Jbar + Cul
    W[..., 1, 0] = Blu * Jbar + Clu
    return W


def boltzmann_ratios(T, g, E, Q):
    """LTE level population ratios n_level / n_species = g exp(-E/kT) / Q(T):
    T, Q [...], g, E [nl] -> [..., nl]."""
    return g * torch.exp(-E / (const.k * T[..., None])) / Q[..., None]


def line_profiles(f_grid, cat: LineCatalog, T, P, vmr):
    """Normalized Voigt profiles phi_l(f) [..., L, F] at the points T, P [...]
    (integral over f of 1): the line-flux integration weights of ARTS's
    nlte_line_flux_profileIntegrate."""
    ls = lineshape_params(cat, T, P, vmr)
    f0s = cat.f0 + ls[..., ID0] + ls[..., IDV]
    gd_part = torch.sqrt(const.doppler_broadening_const_squared * T[..., None] / cat.iso_mass)
    inv_gd = 1.0 / (gd_part * f0s)
    z_imag = ls[..., IG0] * inv_gd
    zr = inv_gd[..., None] * (f_grid - f0s[..., None])
    zi = z_imag[..., None].expand_as(zr)
    wr, _ = wofz_parts(zr, zi, 24 if zr.dtype == torch.float32 else 64)
    return const.inv_sqrt_pi * inv_gd[..., None] * wr


def mean_intensity_profile(f_grid, z_levels, k, J, mus, wmus, t_space, surf_t, surf_eps):
    """Mean intensity Jbar(z, f) [nz, F] = (1/4pi) of the radiance over all
    directions in a plane-parallel atmosphere, by Gauss-Legendre zenith
    quadrature (ARTS's spectral_flux_profilePseudo2D).

    k, J [nz, F] on the ascending levels z_levels [nz]; mus, wmus the
    nodes on (0, 1] and their weights (sum 1).  Each direction's down- and
    upwelling radiances at all levels come from one recursion each over
    the layers, for all directions at once.  Space is a blackbody at
    t_space; the surface emits at surf_t with emissivity surf_eps and
    reflects the rest of the downwelling radiance specularly."""
    dz = torch.diff(z_levels)  # [nz-1]
    k_lay = 0.5 * (k[:-1] + k[1:])
    j_lay = 0.5 * (J[:-1] + J[1:])
    I_space = planck(f_grid, torch.as_tensor(t_space, dtype=f_grid.dtype,
                                             device=f_grid.device)) * torch.ones_like(f_grid)
    b_surf = planck(f_grid, surf_t) * torch.ones_like(f_grid)
    t = torch.exp(-k_lay * (dz / mus[:, None])[..., None])  # [nmu, nz-1, F]
    nl = dz.shape[0]
    I = I_space.expand(mus.shape + f_grid.shape)
    dn = [None] * nl
    for i in reversed(range(nl)):  # from space down to level 0
        I = t[:, i] * (I - j_lay[i]) + j_lay[i]
        dn[i] = I
    I_dn = torch.stack(dn + [I_space.expand_as(I)], 1)  # [nmu, nz, F]
    I = surf_eps * b_surf + (1.0 - surf_eps) * I_dn[:, 0]
    up = [I]
    for i in range(nl):  # from the surface up to the top level
        I = t[:, i] * (I - j_lay[i]) + j_lay[i]
        up.append(I)
    I_up = torch.stack(up, 1)
    return 0.5 * torch.einsum("m,mzf->zf", wmus, I_up + I_dn)


def nlte_fit_profile(f_grid, z_levels, t_prof, p_prof, vmr_prof, cat: LineCatalog,
                     n_levels: int, up_idx, lo_idx, Cul, Clu, r_sum, r_init, surf_t,
                     surf_eps=1.0, t_space=const.cosmic_microwave_background_temperature,
                     k_bg=None, n_mu: int = 8, convergence_limit: float = 1e-6,
                     iteration_limit: int = 100, device=None, dtype=None):
    """Fixed-point fit of the non-LTE level populations to the radiation
    field (ARTS's atm_profileFitNonLTE): iterate radiation field -> each
    line's profile-weighted mean intensity -> statistical equilibrium
    until the largest relative change of a population falls below
    convergence_limit, or iteration_limit iterations.

    z/t/p [nz]; vmr_prof [nz, S]; up_idx/lo_idx [L] each line's level
    indices; Cul/Clu [nz, L] collision rates; r_sum [nz] the total of the
    ratios; r_init [nz, nl].  Einstein coefficients from the catalog:
    Bul = A c^2 / (2 h f0^3), Blu = Bul gu / gl.  Returns (r [nz, nl],
    iterations, the last largest relative change)."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: None if x is None else torch.as_tensor(x)
    cat = move(cat, dev, dt)
    f_grid, z_levels, t_prof, p_prof, vmr_prof, up_idx, lo_idx, Cul, Clu, r_sum, r, surf_t, \
        k_bg = move(tuple(map(as_t, (f_grid, z_levels, t_prof, p_prof, vmr_prof, up_idx,
                                     lo_idx, Cul, Clu, r_sum, r_init, surf_t, k_bg))), dev, dt)
    x_np, w_np = np.polynomial.legendre.leggauss(n_mu)
    mus = torch.as_tensor(0.5 * (x_np + 1.0), dtype=dt, device=dev)  # on (0, 1)
    wmus = torch.as_tensor(0.5 * w_np, dtype=dt, device=dev)  # sum 1

    Aul = cat.a
    Bul = cat.a / (2.0 * const.h / const.c**2 * cat.f0**3)
    Blu = Bul * cat.gu / cat.gl
    Bplanck = planck(f_grid[None, :], t_prof[:, None])  # [nz, F]
    if k_bg is None:
        k_bg = torch.zeros_like(Bplanck)
    # the profiles and their quadrature over the grid do not change from one
    # iteration to the next; normalizing by the latter (analytically 1)
    # cancels the profile mass outside f_grid
    phi = line_profiles(f_grid, cat, t_prof, p_prof, vmr_prof)  # [nz, L, F]
    phi_mass = torch.clamp(torch.trapezoid(phi, f_grid, dim=-1), min=1e-30)  # [nz, L]
    # rate of each line into its lower (down) and upper (up) level as
    # entries of the flattened [nl, nl] rate matrix, summed by a product
    # (no scatter: deterministic on the card)
    onehot = lambda i: torch.nn.functional.one_hot(i, n_levels * n_levels).to(dt)
    down, up = onehot(lo_idx * n_levels + up_idx), onehot(up_idx * n_levels + lo_idx)
    nz = r.shape[0]

    def body(r):
        alpha, src = nlte_absorption_source(f_grid, cat, t_prof, p_prof, vmr_prof,
                                            r[:, up_idx], r[:, lo_idx])
        k_tot = alpha + k_bg
        safe = torch.where(k_tot.abs() > 1e-30, k_tot, torch.ones_like(k_tot))
        J = Bplanck + src / safe
        Jmean = mean_intensity_profile(f_grid, z_levels, k_tot, J, mus, wmus, t_space,
                                       surf_t, surf_eps)
        Jbar = torch.trapezoid(phi * Jmean[:, None, :], f_grid, dim=-1) / phi_mass
        W = ((Aul + Bul * Jbar + Cul) @ down + (Blu * Jbar + Clu) @ up).reshape(
            nz, n_levels, n_levels)
        r_new = statistical_equilibrium(W, r_sum)
        change = ((r_new - r).abs() / torch.clamp(r.abs(), min=1e-30)).max()
        return r_new, change

    max_change = float("inf")
    n_iter = 0
    for n_iter in range(1, iteration_limit + 1):
        r, change = body(r)
        max_change = float(change)
        if max_change < convergence_limit:
            break
    return r, n_iter, max_change
