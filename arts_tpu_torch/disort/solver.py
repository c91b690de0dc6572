"""Plane-parallel discrete-ordinates solver (port of arts_tpu/disort/solver.py,
thermal emission: mu0 == 0, Lambertian surface).

The frequency axis is an explicit leading batch axis of every input.  Two
routes solve the same problem, as in the JAX package:

  * fused (fast_linalg None or True, the default): disort/fused_kernel.py,
    two CUDA kernels with no derivative rule;
  * differentiable (fast_linalg=False, the JAX package's XLA route): the
    eigen stage `_eigen` with torch.linalg.cholesky and the Jacobi eigh
    kernel (ops/eigh_jacobi.py, which carries jvp, backward and vmap
    rules), the thermal particular solution by torch.linalg.solve, the
    structured block-tridiagonal Thomas elimination as a loop over layers
    and the level radiances.  Every step is a PyTorch operation or the
    eigh Function, so autograd and torch.func (jacfwd, jacrev) run
    through it; Jacobians of the all-sky radiance take this route.

This module also does the pre-processing (delta-M scaling, the thin-layer
thermal switch, boundary terms) and the post-processing (fluxes,
azimuthally averaged intensity, Fourier synthesis at the requested
azimuths) of both routes.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _cuda
from .._cuda import move, resolve
from ..ops.eigh_jacobi import eigh_jacobi
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
           fast_linalg: bool | None = None, plain: bool = False, device=None,
           dtype=None) -> DisortOutput:
    """Solve F plane-parallel thermal-emission problems at once.

    The solve keeps min(NLeg, nquad) phase moments of inp.leg.  Only
    mu0 == 0 (no beam) and a Lambertian surface (brdf None) are ported;
    anything else raises NotImplementedError on both routes.
    fast_linalg None or True takes the fused route, False the
    differentiable route (module docstring).  plain=True runs the
    kernels' plain versions on any device."""
    if mu0 != 0.0:
        raise NotImplementedError("beam sources (mu0 > 0) are not ported")
    if brdf is not None:
        raise NotImplementedError("BRDF surfaces are not ported")
    dev, dt = resolve(device, dtype)
    inp = move(inp, dev, dt)
    M = int(nfourier if nfourier is not None else 1)
    terms = solve_terms(inp, nquad, M)
    if fast_linalg is False:
        u_lvl, v_lvl = _solve_differentiable(**terms, plain=plain)
    else:
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


def phase_matrices(leg_scaled, lam, sign):
    """(Pp, Pm) [F, M, L, N, N]: the phase matrices p(+-mu_i, mu_j) per
    frequency, Fourier mode and layer from the scaled moments
    [F, L, nlegc] and the numpy quadrature tables lam, sign."""
    t = lambda a: torch.as_tensor(a, dtype=leg_scaled.dtype, device=leg_scaled.device)
    lam, sign = t(lam), t(sign)
    with _cuda.full_f32_matmul():
        Pp = torch.einsum("flk,mki,mkj->fmlij", leg_scaled, lam, lam)
        Pm = torch.einsum("flk,mk,mki,mkj->fmlij", leg_scaled, sign, lam, lam)
    return Pp, Pm


def hsym(Pp, Pm, omega_p, mu, w):
    """(Hsym, Lc, S2): the symmetric eigenproblem of the differentiable
    route.  The asymmetric (alpha - beta)(alpha + beta) system is similar
    to H1 H2 with H1, H2 symmetric (F = diag(sqrt(w/mu))); the Cholesky
    factor Lc of -H1 turns it into Hsym = -Lc^T H2 Lc.  S2 = c(Pp + Pm) -
    diag(1/w).  mu, w are tensors."""
    c = (0.5 * omega_p)[:, None, :, None, None]
    inv_w = 1.0 / w
    Fq = torch.sqrt(w / mu)
    S1 = c * Pp - c * Pm - torch.diag(inv_w)
    S2 = c * Pp + c * Pm - torch.diag(inv_w)
    H1 = Fq[:, None] * S1 * Fq[None, :]
    H2 = Fq[:, None] * S2 * Fq[None, :]
    with _cuda.full_f32_matmul():
        Lc = torch.linalg.cholesky(-H1)  # -H1 is positive definite for omega < 1
        return -(Lc.mT @ H2 @ Lc), Lc, S2


def _eigen(Pp, Pm, omega_p, mu, w, plain=False):
    """Homogeneous solutions per (frequency, mode, layer): k [F, M, L, N],
    G+/G- [F, M, L, N, N] (eigenvalues ascending), through the Jacobi
    eigh of Hsym (ops/eigh_jacobi.py)."""
    H, Lc, S2 = hsym(Pp, Pm, omega_p, mu, w)
    k2, V = eigh_jacobi(H, plain=plain, device=H.device)
    k = torch.sqrt(torch.clamp(k2, min=1e-24))
    E = torch.sqrt(w * mu)
    Y = (1.0 / E)[:, None] * (Lc @ V)
    # F2 = M^-1 S2 W; G+ - G- = (F2 Y) / k
    F2Y = (1.0 / mu)[:, None] * ((S2 * w[None, :]) @ Y)
    D = F2Y / k[..., None, :]
    return k, 0.5 * (Y + D), 0.5 * (Y - D)


def _solve_block_tridiag(Gp, Gm, Ek, rhs, Rsurf):
    """DISORT's block-tridiagonal Thomas elimination in the unknowns
    X_l = [C+_l; C-_l], structured as the JAX package's
    _solve_block_tridiag_structured: the forward sweep carries only the
    rank-N terms W = U P and uy = U y of the layer above.

    Gp, Gm [L, ..., N, N]; Ek [L, ..., N]; rhs [L, ..., 2N]; Rsurf
    [..., N, N] the surface reflection operator.  Returns X [L, ..., 2N]."""
    Lr, N = Gp.shape[0], Gp.shape[-1]
    batch = Gp.shape[1:-2]
    dt, dev = Gp.dtype, Gp.device
    S_mat = torch.cat([torch.zeros(N, N, dtype=dt, device=dev),
                       torch.eye(N, dtype=dt, device=dev)], 0).expand(batch + (2 * N, N))
    W = torch.zeros(batch + (N, N), dtype=dt, device=dev)
    uy = torch.zeros(batch + (N,), dtype=dt, device=dev)
    Ps, ys = [], []
    for l in range(Lr):
        e = Ek[l][..., None, :]
        GpE, GmE = Gp[l] * e, Gm[l] * e
        U = torch.cat([GmE, Gp[l]], -1)  # [..., N, 2N]
        T = -torch.cat([Gp[l], GmE], -1)
        sgn = 1.0 if l == 0 else -1.0
        Arows = sgn * torch.cat([Gm[l], GpE], -1) - W @ T
        Brows = torch.cat([GpE, Gm[l]], -1)
        if l == Lr - 1:  # surface reflection
            Brows = Brows - Rsurf @ U
        rmod = torch.cat([rhs[l][..., :N] - uy, rhs[l][..., N:]], -1)
        sol = torch.linalg.solve(torch.cat([Arows, Brows], -2),
                                 torch.cat([S_mat, rmod[..., None]], -1))
        P, y = sol[..., :N], sol[..., N]
        W = U @ P
        uy = (U @ y[..., None])[..., 0]
        Ps.append(P)
        ys.append(y)
    t = torch.zeros(batch + (N,), dtype=dt, device=dev)
    Xs = [None] * Lr
    for l in range(Lr - 1, -1, -1):
        X = ys[l] - (Ps[l] @ t[..., None])[..., 0]
        GmE = Gm[l] * Ek[l][..., None, :]
        t = -(torch.cat([Gp[l], GmE], -1) @ X[..., None])[..., 0]
        Xs[l] = X
    return torch.stack(Xs)


def _solve_differentiable(leg_scaled, omega_p, dtau_p, tb0, tb1, rsurf, b_neg,
                          rhs_surf, *, lam, sign, mu, w, plain=False):
    """(u_lvl, v_lvl) [F, M, L+1, N] by the differentiable route, from
    fused_u_lvl's arguments (solve_terms): the eigen stage, the thermal
    particular solution, the boundary-value problem and the radiances at
    every level."""
    dt, dev = leg_scaled.dtype, leg_scaled.device
    mu_t = torch.as_tensor(mu, dtype=dt, device=dev)
    w_t = torch.as_tensor(w, dtype=dt, device=dev)
    N = mu_t.shape[0]
    I_N = torch.eye(N, dtype=dt, device=dev)
    m0 = (torch.arange(tb0.shape[1], device=dev) == 0).to(dt)[None, :, None, None]
    Pp, Pm = phase_matrices(leg_scaled, lam, sign)
    with _cuda.full_f32_matmul():
        k, Gp, Gm = _eigen(Pp, Pm, omega_p, mu_t, w_t, plain=plain)
        Ek = torch.exp(-k * dtau_p[:, None, :, None])  # [F, M, L, N]

        # thermal particular solution (mode 0): q1 = AmB^-1 g1,
        # p + r = 2 AmB^-1 g0, p - r = 2 ApB^-1 q1, with g = (1 - w') b / mu
        c = (0.5 * omega_p)[:, :, None, None]
        ApB = (1.0 / mu_t)[:, None] * (I_N - c * (Pp[:, 0] - Pm[:, 0]) * w_t)
        AmB = (1.0 / mu_t)[:, None] * (I_N - c * (Pp[:, 0] + Pm[:, 0]) * w_t)
        slv = lambda A, b: torch.linalg.solve(A, b[..., None])[..., 0]
        e_over_mu = 1.0 / mu_t
        q1 = slv(AmB, tb1[:, 0, :, None] * e_over_mu)
        p_minus_r = 2.0 * slv(ApB, q1)
        p_plus_r = 2.0 * slv(AmB, tb0[:, 0, :, None] * e_over_mu)
        p0 = 0.5 * (p_plus_r + p_minus_r)
        r0 = 0.5 * (p_plus_r - p_minus_r)
        q1d = q1 * dtau_p[..., None]
        up_top, vp_top = m0 * p0[:, None], m0 * r0[:, None]  # [F, M, L, N]
        up_bot, vp_bot = m0 * (p0 + q1d)[:, None], m0 * (r0 + q1d)[:, None]

        # rows A: the top boundary (l = 0), then v-continuity at interface l;
        # rows B: u-continuity at interface l + 1, then the surface
        A_rhs = torch.cat([(b_neg - vp_top[:, :, 0])[:, :, None],
                           vp_top[:, :, 1:] - vp_bot[:, :, :-1]], 2)
        surf = rhs_surf - up_bot[:, :, -1] + (rsurf @ vp_bot[:, :, -1, :, None])[..., 0]
        B_rhs = torch.cat([up_top[:, :, 1:] - up_bot[:, :, :-1], surf[:, :, None]], 2)
        lay = lambda x: x.movedim(2, 0)  # layer axis first
        X = _solve_block_tridiag(lay(Gp), lay(Gm), lay(Ek),
                                 lay(torch.cat([A_rhs, B_rhs], -1)), rsurf)
        Cp, Cm = X[..., :N].movedim(0, 2), X[..., N:].movedim(0, 2)  # [F, M, L, N]

        GpE, GmE = Gp * Ek[..., None, :], Gm * Ek[..., None, :]
        ev = lambda Ga, Gb, part: (Ga @ Cp[..., None] + Gb @ Cm[..., None])[..., 0] + part
        u_top = ev(Gp, GmE, up_top)
        v_top = ev(Gm, GpE, vp_top)
        u_bot = ev(GpE, Gm, up_bot)
        v_bot = ev(GmE, Gp, vp_bot)
    return (torch.cat([u_top, u_bot[:, :, -1:]], 2),
            torch.cat([v_top, v_bot[:, :, -1:]], 2))


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
