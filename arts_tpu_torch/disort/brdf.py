"""Non-Lambertian surfaces for DISORT: the BRDF's Fourier modes (port of
arts_tpu/disort/brdf.py).

cdisort's c_surface_bidir derives a surface's Fourier modes from its
bidirectional reflectivity by an azimuth quadrature,

    BDR_m(mu_i, mu_j) = (2 - delta_m0)/2 * sum_k gwt_k
                        * brdf(mu_i, mu_j, pi * gmu_k) * cos(m pi gmu_k)

with (gmu, gwt) a Gauss-Legendre rule on (0, 1) mirrored to (-1, 0), the
beam column at mu_j = mu0, and the directional emissivity 1 - the
hemispheric reflectance.  The solver applies (1 + delta_m0) sum_j w_j mu_j
BDR_m(i, j) to the downward field and BDR_m(i, beam) mu0 fbeam / pi to the
attenuated beam.

The modes are dense [nfourier, N, N] tensors from one evaluation of the
BRDF function over an (out, in, azimuth) grid, differentiable in any
parameter the function closes over.
"""

import dataclasses

import numpy as np
import torch

from .._cuda import resolve
from .quadrature import double_gauss


@dataclasses.dataclass(frozen=True)
class SurfaceBrdf:
    """Fourier-mode surface reflection operators at the quadrature angles."""

    bdr: torch.Tensor  # [nfourier, N, N] mode m, outgoing i, incoming j
    bdr_beam: torch.Tensor  # [nfourier, N] incoming = mu0
    bem: torch.Tensor  # [N] directional emissivity 1 - hemispheric reflectance


def _sqrt_pos(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def hapke_brdf(mu_out, mu_in, dphi, b0=1.0, hh=0.06, w=0.6):
    """The Hapke (1993) BRDF of cdisort's c_bidir_reflectivity_hapke (the
    defaults are its fixed values)."""
    ctheta = mu_out * mu_in + _sqrt_pos((1.0 - mu_out**2) * (1.0 - mu_in**2)) * torch.cos(dphi)
    ctheta = torch.clamp(ctheta, -1.0, 1.0)
    thetah = torch.arccos(ctheta)
    p = 1.0 + 0.5 * ctheta
    b = b0 * hh / (hh + torch.tan(0.5 * thetah))
    gam = _sqrt_pos(1.0 - torch.as_tensor(w, dtype=ctheta.dtype, device=ctheta.device))
    h0 = (1.0 + 2.0 * mu_in) / (1.0 + 2.0 * gam * mu_in)
    h = (1.0 + 2.0 * mu_out) / (1.0 + 2.0 * gam * mu_out)
    return 0.25 * w * ((1.0 + b) * p + h0 * h - 1.0) / (mu_out + mu_in)


def rpv_brdf(mu_out, mu_in, dphi, rho0=0.027, k=0.647, theta=-0.169, scale=1.0):
    """The Rahman-Pinty-Verstraete BRDF (cdisort's c_bidir_reflectivity_rpv
    core form, without the hotspot's sigma/t1/t2 extensions)."""
    ci, co = mu_in, mu_out
    si = _sqrt_pos(1.0 - ci**2)
    so = _sqrt_pos(1.0 - co**2)
    cphi = torch.cos(dphi)
    cosg = torch.clamp(ci * co + si * so * cphi, -1.0, 1.0)
    ti, to = si / ci, so / co
    G = torch.sqrt(torch.clamp(ti**2 + to**2 - 2.0 * ti * to * cphi, min=1e-12))
    F = (1.0 - theta**2) / (1.0 + 2.0 * theta * cosg + theta**2) ** 1.5
    hot = 1.0 + (1.0 - rho0) / (1.0 + G)
    return scale * rho0 * (ci * co * (ci + co)) ** (k - 1.0) * F * hot


def surface_brdf_modes(brdf_fn, nquad: int, nfourier: int, mu0=None, nmug: int = 50,
                       device=None, dtype=None):
    """SurfaceBrdf Fourier modes of a bidirectional reflectivity, on
    `device` (None: the card) in `dtype` (None: float32).

    brdf_fn(mu_out, mu_in, dphi) must broadcast over tensors; nquad is the
    solver's 2N streams.  The azimuth rule and normalization are cdisort's
    c_surface_bidir's (an nmug-point mirrored Gauss rule).  The modes are
    differentiable in the parameters brdf_fn closes over."""
    device, dtype = resolve(device, dtype)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    n = nquad // 2
    mu, _ = double_gauss(n)
    gmu_h, gwt_h = double_gauss(nmug // 2)  # the (0, 1) half rule
    # the mirrored azimuth rule on (-1, 1): dphi = pi u
    u = t(np.concatenate([gmu_h, -gmu_h]))
    wu = t(np.concatenate([gwt_h, gwt_h]))
    mu_j = t(mu)
    m_arr = t(np.arange(nfourier))

    # bdr[m, i, j]: outgoing mu_i, incoming mu_j, azimuth-projected
    vals = brdf_fn(mu_j[:, None, None], mu_j[None, :, None], np.pi * u[None, None, :])  # [N, N, K]
    cosm = torch.cos(m_arr[:, None] * np.pi * u[None, :])  # [M, K]
    pref = 0.5 * (2.0 - (m_arr == 0).to(dtype))
    bdr = pref[:, None, None] * torch.einsum("ijk,k,mk->mij", vals, wu, cosm)
    if mu0 is not None:
        vb = brdf_fn(mu_j[:, None], t(mu0), np.pi * u[None, :])  # [N, K]
        bdr_beam = pref[:, None] * torch.einsum("ik,k,mk->mi", vb, wu, cosm)
    else:
        bdr_beam = torch.zeros((nfourier, n), dtype=bdr.dtype, device=bdr.device)
    # directional emissivity: 1 - the integral of brdf mu' dmu' dphi
    ve = brdf_fn(mu_j[:, None, None], t(gmu_h)[None, :, None], np.pi * u[None, None, :])
    dref = torch.einsum("ijk,j,j,k->i", ve, t(gwt_h), t(gmu_h), wu)
    return SurfaceBrdf(bdr=bdr, bdr_beam=bdr_beam, bem=1.0 - dref)
