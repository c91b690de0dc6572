"""Plane-parallel discrete-ordinates solver (port of arts_tpu/disort/solver.py,
the fused path for thermal emission: mu0 == 0, Lambertian surface).

The frequency axis is an explicit leading batch axis of every input.  The
solve itself runs in disort/fused_kernel.py; this module does the
pre-processing (delta-M scaling, the thin-layer thermal switch, boundary
terms) and the post-processing (fluxes, azimuthally averaged intensity,
Fourier synthesis at the requested azimuths).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._cuda import move, resolve
from .fused_kernel import fused_u_lvl
from .quadrature import double_gauss, lambda_tables


@dataclasses.dataclass(frozen=True)
class DisortInput:
    """Inputs for F frequencies and L layers, level 0 = TOA."""

    tau: torch.Tensor  # [F, L] layer optical thickness (unscaled)
    omega: torch.Tensor  # [F, L] single scattering albedo
    leg: torch.Tensor  # [F, L, NLeg] phase moments g_l, g_0 = 1
    f: torch.Tensor  # [F, L] delta-M fractional scattering (0 = off)
    b_levels: torch.Tensor  # [F, L+1] thermal source (Planck) at levels
    fisot: torch.Tensor  # [F] isotropic illumination at TOA
    albedo: torch.Tensor  # [F] Lambertian surface albedo
    b_surf: torch.Tensor  # [F] surface emission Planck radiance
    b_top: torch.Tensor  # [F] top-boundary emission radiance


@dataclasses.dataclass(frozen=True)
class DisortOutput:
    """Per-level outputs; mu ascending (negative = downwelling)."""

    mu: torch.Tensor  # [NQuad]
    flux_up: torch.Tensor  # [F, L+1]
    flux_down_diffuse: torch.Tensor  # [F, L+1]
    flux_direct: torch.Tensor  # [F, L+1]
    u0: torch.Tensor  # [F, L+1, NQuad] azimuthally averaged intensity
    u: Optional[torch.Tensor] = None  # [F, L+1, NQuad, nphi]


def disort(inp: DisortInput, nquad: int = 16, nfourier: int | None = None,
           mu0: float = 0.0, phi0: float = 0.0, phis: tuple = (), brdf=None,
           plain: bool = False, device=None, dtype=None) -> DisortOutput:
    """Solve F plane-parallel thermal-emission problems at once.

    The solve keeps min(NLeg, nquad) phase moments of inp.leg.  Only
    mu0 == 0 (no beam) and a Lambertian surface (brdf None) are ported;
    anything else raises NotImplementedError.  plain=True runs the
    kernels' plain versions on any device."""
    if mu0 != 0.0:
        raise NotImplementedError("beam sources (mu0 > 0) are not ported")
    if brdf is not None:
        raise NotImplementedError("BRDF surfaces are not ported")
    dev, dt = resolve(device, dtype)
    inp = move(inp, dev, dt)
    M = int(nfourier if nfourier is not None else 1)
    terms = solve_terms(inp, nquad, M)
    u_lvl, v_lvl = fused_u_lvl(**terms, plain=plain)
    mu = torch.as_tensor(terms["mu"], dtype=dt, device=dev)
    w = torch.as_tensor(terms["w"], dtype=dt, device=dev)
    return _disort_post(u_lvl, v_lvl, terms["mu"], mu, w, M, phi0, phis)


def solve_terms(inp: DisortInput, nquad: int, M: int):
    """fused_u_lvl's keyword arguments for M Fourier modes: delta-M
    scaling, the thermal source coefficients and the boundary terms."""
    dt, dev = inp.tau.dtype, inp.tau.device
    N = nquad // 2
    nlegc = min(inp.leg.shape[-1], nquad)
    mu_np, w_np = double_gauss(N)
    lam_np, sign_np = lambda_tables(M, nlegc, N)
    mu = torch.as_tensor(mu_np, dtype=dt, device=dev)
    w = torch.as_tensor(w_np, dtype=dt, device=dev)

    # delta-M scaling; omega' clipped below 1 keeps -H1 positive definite
    f = inp.f
    omega = torch.clamp(inp.omega, 0.0, 1.0 - 1e-9)
    wf = omega * f
    omega_p = omega * (1.0 - f) / (1.0 - wf)
    dtau_p = (1.0 - wf) * inp.tau
    ls = torch.arange(nlegc, dtype=dt, device=dev)
    leg_scaled = (2.0 * ls + 1.0) * (inp.leg[..., :nlegc] - f[..., None]) / (
        1.0 - f[..., None])

    # thermal source (1 - w')(b0 + b1 t): optically thin layers switch to
    # a constant source, since the slope form cancels catastrophically
    # there (emission ~ tau B, error O(dtau^2 dB))
    b = inp.b_levels
    thin = dtau_p < 1e-5
    safe_dtau = torch.where(dtau_p > 1e-30, dtau_p, torch.ones_like(dtau_p))
    b0 = torch.where(thin, 0.5 * (b[:, 1:] + b[:, :-1]), b[:, :-1])
    b1 = torch.where(thin, torch.zeros_like(dtau_p), (b[:, 1:] - b[:, :-1]) / safe_dtau)
    srcf = 1.0 - omega_p
    m0 = torch.as_tensor(np.arange(M) == 0, dtype=dt, device=dev)  # [M]

    # boundary conditions: isotropic + emitted radiance at the top, a
    # Lambertian surface at the bottom; modes m > 0 have no sources
    F = inp.tau.shape[0]
    ones_n = torch.ones(N, dtype=dt, device=dev)
    Rsurf = (2.0 * inp.albedo)[:, None, None] * ones_n[:, None] * (w * mu)[None, :]
    return dict(
        leg_scaled=leg_scaled, omega_p=omega_p, dtau_p=dtau_p,
        tb0=m0[None, :, None] * (srcf * b0)[:, None, :],
        tb1=m0[None, :, None] * (srcf * b1)[:, None, :],
        rsurf=(m0[None, :, None, None] * Rsurf[:, None]).expand(F, M, N, N),
        b_neg=m0[None, :, None] * (inp.fisot + inp.b_top)[:, None, None] * ones_n,
        rhs_surf=m0[None, :, None] * ((1.0 - inp.albedo) * inp.b_surf)[:, None, None] * ones_n,
        lam=lam_np, sign=sign_np, mu=mu_np, w=w_np,
    )


def _disort_post(u_lvl, v_lvl, mu_np, mu, w, M, phi0, phis):
    """Fluxes, the azimuthally averaged u0 and the Fourier synthesis at
    phis from the per-mode level radiances [F, M, L+1, N]."""
    u0 = torch.cat([v_lvl[:, 0].flip(-1), u_lvl[:, 0]], -1)
    wmu = 2.0 * np.pi * (w * mu)
    fup = (u_lvl[:, 0] * wmu).sum(-1)
    fdn = (v_lvl[:, 0] * wmu).sum(-1)
    u_out = None
    if phis:
        dt = u_lvl.dtype
        phis_r = torch.as_tensor(np.asarray(phis, np.float64) * np.pi / 180.0,
                                 dtype=dt, device=u_lvl.device)
        ms = torch.arange(M, dtype=dt, device=u_lvl.device)
        cosm = torch.cos(ms[:, None] * (np.pi / 180.0 * phi0 - phis_r[None, :]))
        synth = lambda x: (x[..., None] * cosm[:, None, None, :]).sum(1)
        u_out = torch.cat([synth(v_lvl).flip(-2), synth(u_lvl)], -2)
    return DisortOutput(
        mu=torch.as_tensor(np.concatenate([-mu_np[::-1], mu_np]), dtype=u_lvl.dtype,
                           device=u_lvl.device),
        flux_up=fup,
        flux_down_diffuse=fdn,
        flux_direct=torch.zeros_like(fup),
        u0=u0,
        u=u_out,
    )
