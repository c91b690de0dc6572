"""Voigt LTE line-by-line absorption (port of arts_tpu/lbl/voigt.py).

Two routes to the same absorption coefficient:
  * `absorption`: the plain dense path, complex w(z) over blocks of lines
    (the JAX package's XLA path), differentiable;
  * `absorption_kernel`: the lines x frequencies contraction through the
    Voigt kernel (ops/voigt_kernel.py; the counterpart of JAX's
    absorption_pallas), for every level at once.

Atmospheric-point arguments T, P [...] and vmr [..., S] may carry a
leading batch of points (levels); line arrays come out as [..., L].
"""

import torch

from .. import constants as const
from .._cuda import move, resolve
from ..ops.voigt_kernel import voigt_sum
from ..ops.wofz import wofz
from .catalog import BATH, PAD, LineCatalog
from .partfun import PartFunTable
from .tmodel import IDV, IG, IG0, ID0, IY, P_POW, eval_law


def lineshape_params(cat: LineCatalog, T, P, vmr):
    """The 9 line-shape variables per line at (T, P, vmr): [..., L, NV].

    VMR-weighted sum over perturbers; a Bath entry takes the remainder
    weight (1 - sum of listed VMRs); without Bath the weighted mean."""
    sval = eval_law(cat.ls_law, cat.ls_x, cat.t0[:, None, None],
                    T[..., None, None, None])  # [..., L, P, NV]
    ppow = torch.tensor(P_POW, dtype=sval.dtype, device=sval.device)
    sval = sval * P[..., None, None, None] ** ppow
    is_pad = cat.ls_spec == PAD
    is_bath = cat.ls_spec == BATH
    w_spec = torch.where(is_pad | is_bath, 0.0, vmr[..., cat.ls_spec.clamp(min=0)])
    vmr_sum = w_spec.sum(-1)  # [..., L]
    has_bath = is_bath.any(-1)
    w = w_spec + torch.where(is_bath, (1.0 - vmr_sum)[..., None], 0.0)
    num = (w[..., None] * sval).sum(-2)
    one = torch.ones_like(vmr_sum)
    denom = torch.where(has_bath, one, torch.where(vmr_sum > 0, vmr_sum, one))
    return num / denom[..., None]


def line_strengths_parts(cat: LineCatalog, pf: PartFunTable, T, P, vmr, ls):
    """(sr, si, f0s, inv_gd, z_imag), each [..., L]: the complex line
    strength as real parts with the number-density and c^2/8pi/f0^3
    prefactors folded in (grouped so every intermediate stays in float32
    range), the pressure-shifted centre, 1/Doppler width and Im z."""
    T1 = T[..., None]
    Q = pf.Q(T, cat.iso_idx)
    inv_f0 = 1.0 / cat.f0
    g_line = cat.a * cat.gu * torch.exp(-cat.e0 / (const.k * T1)) / Q
    f0s = cat.f0 + ls[..., ID0] + ls[..., IDV]
    gd_part = torch.sqrt(const.doppler_broadening_const_squared * T1 / cat.iso_mass)
    inv_gd = 1.0 / (gd_part * f0s)
    z_imag = ls[..., IG0] * inv_gd
    N = P[..., None] / (const.k * T1)
    pref = (N * inv_f0) * ((const.c**2 / (8.0 * const.pi)) * inv_f0) * inv_f0
    x = vmr[..., cat.spec_idx]
    pre = (const.inv_sqrt_pi * inv_gd * cat.iso_ratio * x) * (g_line * pref)
    return pre * (1.0 + ls[..., IG]), pre * (-ls[..., IY]), f0s, inv_gd, z_imag


def line_strengths(cat, pf, T, P, vmr, ls):
    """(complex strength, f0s, inv_gd, z_imag)."""
    sr, si, f0s, inv_gd, z_imag = line_strengths_parts(cat, pf, T, P, vmr, ls)
    return torch.complex(sr, si), f0s, inv_gd, z_imag


def _shape_sum(f_grid, s, f0s, inv_gd, z_imag, cutoff, block=256, shift=None):
    """sum_l s_l [w(z_l(f)) - w(z_cut,l)] masked to |f - f0| <= cut:
    [..., F] complex, for line columns [..., L] (cutoff [L]) and f_grid
    [F] or [..., F], over blocks of `block` lines (bounding the
    [..., block, F] work).  With `shift` [..., L] the centres are f0s +
    shift, and the shift is subtracted after f - f0s: that difference is
    exact in float32 (Sterbenz), while f0s + shift would first round the
    shifted centre to the float32 spacing of f0s, ~16 kHz at 200 GHz, a
    few percent of a Doppler width in the upper levels."""
    wofz_n = 24 if f_grid.dtype == torch.float32 else 64
    fg = f_grid[..., None, :]
    total = None
    for b in range(0, s.shape[-1], block):
        s_b, f0_b, ig_b, zi_b = (a[..., b : b + block] for a in (s, f0s, inv_gd, z_imag))
        cut_b = cutoff[b : b + block]
        df = fg - f0_b[..., None]
        if shift is not None:
            df = df - shift[..., b : b + block, None]
        zr = ig_b[..., None] * df
        w = wofz(torch.complex(zr, zi_b[..., None].expand_as(zr)), wofz_n)
        has_cut = torch.isfinite(cut_b)
        # inf cutoffs made finite before the product: 0 * inf inside an
        # untaken branch would still make its derivative NaN
        cut_safe = torch.where(has_cut, cut_b, 0.0)
        wc = wofz(torch.complex(ig_b * cut_safe, zi_b), wofz_n)
        wcut = torch.where(has_cut, wc, torch.zeros_like(wc))
        inside = df.abs() <= cut_b[:, None]
        contrib = s_b[..., None] * (w - wcut[..., None])
        part = torch.where(inside, contrib, torch.zeros_like(contrib)).sum(-2)
        total = part if total is None else total + part
    return total


def _stimulated(f_grid, T):
    """-f expm1(-h f / k T): the stimulated-emission frequency factor."""
    return -f_grid * torch.expm1(-(const.h * f_grid) / (const.k * T[..., None]))


def absorption(f_grid, cat: LineCatalog, pf: PartFunTable, T, P, vmr, block=256,
               device=None, dtype=None):
    """LBL absorption coefficient [1/m] by the plain dense route (the JAX
    package's XLA route), clipped at 0: [..., F] at the points T, P [...],
    vmr [..., S]; f_grid [F], or [..., F] with one grid per point (the
    Doppler-shifted grids of a windy path).  The lines are summed in
    blocks of `block`, so that a call's intermediates hold
    [..., block, F] complex values.  Differentiable (autograd and
    torch.func) with the derivative of the JAX package's wofz rule."""
    dev, dt = resolve(device, dtype)
    f_grid, cat, pf, T, P, vmr = move((f_grid, cat, pf, T, P, vmr), dev, dt)
    ls = lineshape_params(cat, T, P, vmr)
    s, _, inv_gd, z_imag = line_strengths(cat, pf, T, P, vmr, ls)
    alpha = _stimulated(f_grid, T) * _shape_sum(
        f_grid, s, cat.f0, inv_gd, z_imag, cat.cutoff, block,
        shift=ls[..., ID0] + ls[..., IDV]).real
    return torch.clamp(alpha, min=0.0)


def voigt_sum_args(f_grid, cat: LineCatalog, pf: PartFunTable, T, P, vmr):
    """Positional voigt_sum arguments for the points T [Z]: the grid and
    line columns shifted by a common anchor (float32 keeps sub-kHz
    resolution of f - f0 only so)."""
    ls = lineshape_params(cat, T, P, vmr)
    sr, si, _, inv_gd, z_imag = line_strengths_parts(cat, pf, T, P, vmr, ls)
    has_cut = torch.isfinite(cat.cutoff)
    cut_safe = torch.where(has_cut, cat.cutoff, 0.0)
    wc = wofz(torch.complex(inv_gd * cut_safe, z_imag))
    wcut = torch.where(has_cut, wc, torch.zeros_like(wc))
    cut_k = torch.where(has_cut, cat.cutoff, 1e30).expand_as(sr)
    # f0 - anchor is exact (Sterbenz: both within a factor 2 of each other
    # in a band), so the pressure shift is added after it; f0s - anchor
    # would first round the shifted centre to the float32 spacing of f0,
    # ~16 kHz at 200 GHz, a few percent of a Doppler width
    anchor = f_grid.mean()
    f0_rel = (cat.f0 - anchor) + (ls[..., ID0] + ls[..., IDV])
    return (f_grid - anchor, f0_rel, inv_gd, z_imag, sr, si, cut_k,
            wcut.real, wcut.imag)


def absorption_kernel(f_grid, cat: LineCatalog, pf: PartFunTable, T, P, vmr,
                      plain=False, device=None, dtype=None):
    """absorption() for the points T, P [Z] and vmr [Z, S] through the
    Voigt kernel: [Z, F].  plain=True runs the kernel's plain version."""
    dev, dt = resolve(device, dtype)
    f_grid, cat, pf, T, P, vmr = move((f_grid, cat, pf, T, P, vmr), dev, dt)
    shape_re = voigt_sum(*voigt_sum_args(f_grid, cat, pf, T, P, vmr), plain=plain)
    return torch.clamp(_stimulated(f_grid, T) * shape_re, min=0.0)
