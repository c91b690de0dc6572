"""Plane-parallel discrete-ordinates solver (port of arts_tpu/disort/solver.py:
thermal emission, the solar beam with its azimuthal Fourier modes, a
Lambertian or bidirectional (disort/brdf.py) surface, and the TMS/IMS
intensity corrections).

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
thermal switch, the beam sources, boundary terms) and the post-processing
(fluxes with the direct beam, azimuthally averaged intensity, Fourier
synthesis at the requested azimuths, the TMS/IMS corrections) of both
routes.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _cuda
from .._cuda import move, resolve
from ..ops.eigh_jacobi import eigh_jacobi
from .fused_kernel import fused_u_lvl
from .quadrature import double_gauss, lambda_at, lambda_tables


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
    fbeam: Optional[torch.Tensor] = None  # [F] beam flux at TOA (None: 0)


@dataclasses.dataclass(frozen=True)
class DisortOutput:
    """Per-level outputs; mu ascending (negative = downwelling)."""

    mu: torch.Tensor  # [NQuad]
    flux_up: torch.Tensor  # [F, L+1]
    flux_down_diffuse: torch.Tensor  # [F, L+1]
    flux_direct: torch.Tensor  # [F, L+1] (unscaled beam)
    u0: torch.Tensor  # [F, L+1, NQuad] azimuthally averaged intensity
    u: Optional[torch.Tensor] = None  # [F, L+1, NQuad, nphi]


def disort(inp: DisortInput, nquad: int = 16, nleg: int | None = None,
           nfourier: int | None = None, mu0: float = 0.0, phi0: float = 0.0,
           phis: tuple = (), brdf=None, intensity_correction: bool = False,
           fast_linalg: bool | None = None, plain: bool = False, device=None,
           dtype=None) -> DisortOutput:
    """Solve F plane-parallel problems at once.

    The solve keeps min(nleg or nquad, nquad) phase moments of inp.leg.
    mu0 > 0 adds the solar beam inp.fbeam from direction mu0 (azimuth phi0
    in degrees); nfourier defaults to nquad modes under a beam, 1 without.
    brdf: a SurfaceBrdf (disort/brdf.py) in place of the Lambertian
    inp.albedo, its emissivity bem scaling inp.b_surf.  phis: azimuths
    (degrees) of the Fourier synthesis u; intensity_correction adds the
    TMS/IMS corrections to u under a beam.  fast_linalg None or True
    takes the fused route, False the differentiable route (module
    docstring).  plain=True runs the kernels' plain versions on any
    device."""
    dev, dt = resolve(device, dtype)
    inp = move(inp, dev, dt)
    if inp.fbeam is None:
        inp = dataclasses.replace(inp, fbeam=torch.zeros_like(inp.fisot))
    brdf = move(brdf, dev, dt)
    M = int(nfourier if nfourier is not None else (nquad if mu0 > 0 else 1))
    terms = solve_terms(inp, nquad, M, mu0=mu0, brdf=brdf, nleg=nleg)
    if fast_linalg is False:
        u_lvl, v_lvl = _solve_differentiable(**terms, plain=plain)
    else:
        u_lvl, v_lvl = fused_u_lvl(**terms, plain=plain)
    return _disort_post(inp, u_lvl, v_lvl, terms, nquad, mu0, phi0, phis,
                        intensity_correction)


def solve_terms(inp: DisortInput, nquad: int, M: int, mu0: float = 0.0, brdf=None,
                nleg: int | None = None):
    """fused_u_lvl's keyword arguments for M Fourier modes: delta-M
    scaling, the thermal and beam source coefficients and the boundary
    terms (a Lambertian surface, or the Fourier modes of brdf)."""
    dt, dev = inp.tau.dtype, inp.tau.device
    N = nquad // 2
    nlegc = min(inp.leg.shape[-1], nquad if nleg is None else min(nleg, nquad))
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
    F = inp.tau.shape[0]

    # beam sources: q+ ~ p^m(mu_i, -mu0), q- ~ p^m(-mu_i, -mu0) with the
    # (2 - delta_m0) fbeam omega' / 4 pi prefactor, and the scaled
    # attenuation exp(-tau' / mu0) at the levels
    has_beam = mu0 > 0.0
    if has_beam:
        lam0 = torch.as_tensor(lambda_at(M, nlegc, mu0), dtype=dt, device=dev)
        lam_t = torch.as_tensor(lam_np, dtype=dt, device=dev)
        sign_t = torch.as_tensor(sign_np, dtype=dt, device=dev)
        pref = (2.0 - m0)[None, :, None] * (inp.fbeam[:, None] * omega_p / (4.0 * np.pi))[:, None]
        with _cuda.full_f32_matmul():
            qp = pref[..., None] * torch.einsum("flk,mk,mki->fmli", leg_scaled, sign_t * lam0, lam_t)
            qm = pref[..., None] * torch.einsum("flk,mk,mki->fmli", leg_scaled, lam0, lam_t)
        tau_p = torch.cat([torch.zeros_like(dtau_p[:, :1]), torch.cumsum(dtau_p, -1)], -1)
        ebea = torch.exp(-tau_p / mu0)  # [F, L+1]
        beam_surf = mu0 * inp.fbeam * ebea[:, -1] / np.pi  # [F]
    else:
        qp = qm = ebea = None

    # boundary conditions: isotropic + emitted radiance at the top; at the
    # bottom a Lambertian surface (mode 0 only) or the BRDF's modes
    # (cdisort c_setmtx: (1 + delta_m0) sum_j w_j mu_j BDR_m(i, j) on the
    # downward field, BDR_m(i, beam) mu0 fbeam / pi on the attenuated
    # beam, the emissivity bem on b_surf in mode 0)
    ones_n = torch.ones(N, dtype=dt, device=dev)
    if brdf is None:
        Rsurf = (2.0 * inp.albedo)[:, None, None] * ones_n[:, None] * (w * mu)[None, :]
        rsurf = (m0[None, :, None, None] * Rsurf[:, None]).expand(F, M, N, N)
        surf0 = (1.0 - inp.albedo) * inp.b_surf
        if has_beam:
            surf0 = surf0 + inp.albedo * beam_surf
        rhs_surf = m0[None, :, None] * surf0[:, None, None] * ones_n
    else:
        # modes past the BRDF's own are zero; bdr [(F,) nb, N, N],
        # bdr_beam [(F,) nb, N], bem [(F,) N]
        nb = min(brdf.bdr.shape[-3], M)
        bdr = torch.nn.functional.pad(brdf.bdr[..., :nb, :, :], (0, 0, 0, 0, 0, M - nb))
        rsurf = ((1.0 + m0)[:, None, None] * bdr * (w * mu)).expand(F, M, N, N)
        rhs_surf = m0[None, :, None] * (brdf.bem * inp.b_surf[:, None])[:, None, :]
        if has_beam:
            bdr_beam = torch.nn.functional.pad(brdf.bdr_beam[..., :nb, :], (0, 0, 0, M - nb))
            rhs_surf = rhs_surf + bdr_beam * beam_surf[:, None, None]
        rhs_surf = rhs_surf.expand(F, M, N)
    return dict(
        leg_scaled=leg_scaled, omega_p=omega_p, dtau_p=dtau_p,
        tb0=m0[None, :, None] * (srcf * b0)[:, None, :],
        tb1=m0[None, :, None] * (srcf * b1)[:, None, :],
        rsurf=rsurf,
        b_neg=m0[None, :, None] * (inp.fisot + inp.b_top)[:, None, None] * ones_n,
        rhs_surf=rhs_surf,
        qp=qp, qm=qm, ebea=ebea, mu0=float(mu0),
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
                          rhs_surf, *, lam, sign, mu, w, qp=None, qm=None, ebea=None,
                          mu0=0.0, plain=False):
    """(u_lvl, v_lvl) [F, M, L+1, N] by the differentiable route, from
    fused_u_lvl's arguments (solve_terms): the eigen stage, the thermal
    and beam particular solutions, the boundary-value problem and the
    radiances at every level."""
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
        c = (0.5 * omega_p)[:, None, :, None, None]
        ApB_m = (1.0 / mu_t)[:, None] * (I_N - c * (Pp - Pm) * w_t)  # [F, M, L, N, N]
        AmB_m = (1.0 / mu_t)[:, None] * (I_N - c * (Pp + Pm) * w_t)
        ApB, AmB = ApB_m[:, 0], AmB_m[:, 0]
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

        if qp is not None:
            # beam particular solution, every mode: (ApB AmB - I/mu0^2) s =
            # ApB (q+ + q-)/mu - (q+ - q-)/(mu mu0), d = -mu0 (AmB s -
            # (q+ + q-)/mu), z+- = (s +- d)/2 times the beam's attenuation
            mv = lambda A, x: (A @ x[..., None])[..., 0]
            spm = (qp + qm) / mu_t
            rhs_s = mv(ApB_m, spm) - ((qp - qm) / mu_t) / mu0
            s = slv(ApB_m @ AmB_m - I_N / (mu0 * mu0), rhs_s)
            d = -mu0 * (mv(AmB_m, s) - spm)
            zp, zm = 0.5 * (s + d), 0.5 * (s - d)
            ebt, ebb = ebea[:, None, :-1, None], ebea[:, None, 1:, None]
            up_top, vp_top = up_top + zp * ebt, vp_top + zm * ebt
            up_bot, vp_bot = up_bot + zp * ebb, vp_bot + zm * ebb

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


def _disort_post(inp, u_lvl, v_lvl, terms, nquad, mu0, phi0, phis, intensity_correction):
    """Fluxes, the azimuthally averaged u0 and the Fourier synthesis at
    phis (plus the TMS/IMS corrections when asked for under a beam) from
    the per-mode level radiances [F, M, L+1, N]."""
    dt, dev = u_lvl.dtype, u_lvl.device
    mu_np, M = terms["mu"], u_lvl.shape[1]
    mu = torch.as_tensor(mu_np, dtype=dt, device=dev)
    w = torch.as_tensor(terms["w"], dtype=dt, device=dev)
    u0 = torch.cat([v_lvl[:, 0].flip(-1), u_lvl[:, 0]], -1)
    wmu = 2.0 * np.pi * (w * mu)
    fup = (u_lvl[:, 0] * wmu).sum(-1)
    fdn = (v_lvl[:, 0] * wmu).sum(-1)
    if mu0 > 0.0:
        # the solve carries the delta-M scaled beam; the direct flux is the
        # unscaled one, and the diffuse flux takes their difference
        tau_u = torch.cat([torch.zeros_like(inp.tau[:, :1]), torch.cumsum(inp.tau, -1)], -1)
        fdir_scaled = mu0 * inp.fbeam[:, None] * terms["ebea"]
        fdir = mu0 * inp.fbeam[:, None] * torch.exp(-tau_u / mu0)
        fdn = fdn + fdir_scaled - fdir
    else:
        fdir = torch.zeros_like(fup)
    u_out = None
    if phis:
        phis_r = torch.as_tensor(np.asarray(phis, np.float64) * np.pi / 180.0,
                                 dtype=dt, device=dev)
        ms = torch.arange(M, dtype=dt, device=dev)
        cosm = torch.cos(ms[:, None] * (np.pi / 180.0 * phi0 - phis_r[None, :]))
        synth = lambda x: (x[..., None] * cosm[:, None, None, :]).sum(1)
        u_out = torch.cat([synth(v_lvl).flip(-2), synth(u_lvl)], -2)
        if intensity_correction and mu0 > 0.0:
            u_out = u_out + tms_ims_correction(inp, nquad, mu0, phi0, phis)
    return DisortOutput(
        mu=torch.as_tensor(np.concatenate([-mu_np[::-1], mu_np]), dtype=dt, device=dev),
        flux_up=fup,
        flux_down_diffuse=fdn,
        flux_direct=fdir,
        u0=u0,
        u=u_out,
    )


def _legendre_all(ctheta, kmax):
    """P_k(ctheta) for k = 0..kmax, stacked on axis 0."""
    pls = [torch.ones_like(ctheta), ctheta]
    for k in range(2, kmax + 1):
        pls.append(((2 * k - 1) * ctheta * pls[-1] - (k - 1) * pls[-2]) / k)
    return torch.stack(pls[: kmax + 1], 0)


def _single_scat(phase, omega, tau_lvl, mu, mu0, fbeam):
    """cdisort's c_single_scat at every layer boundary: phase [F, NQ,
    nphi, L] the phase function at each output direction's scattering
    angle, omega [F, L], tau_lvl [F, L+1] cumulative optical depth, mu [NQ]
    the output cosines (+-), fbeam [F].  Returns [F, NQ, nphi, L+1]."""
    u = tau_lvl[:, None, :, None]  # [F, 1, L+1, 1] boundary depths
    t0 = tau_lvl[:, None, None, :-1]  # [F, 1, 1, L] layer tops
    t1 = tau_lvl[:, None, None, 1:]  # layer bottoms
    mu_b = mu[None, :, None, None]  # [1, NQ, 1, 1]

    def E(t):
        # the exponent is <= 0 in every taken branch; the clamp keeps the
        # untaken branch finite
        return torch.exp(torch.clamp(-((t - u) / mu_b + t / mu0), max=0.0))

    zero = torch.zeros((), dtype=phase.dtype, device=phase.device)
    # upward: the layers below the boundary, their top clamped to it;
    # downward: the layers above it, their bottom clamped to it
    term_up = torch.where(t1 > u + 1e-30, E(torch.maximum(t0, u)) - E(t1), zero)
    term_dn = torch.where(t0 < u - 1e-30, E(torch.minimum(t1, u)) - E(t0), zero)
    term = torch.where(mu_b > 0, term_up, term_dn)  # [F, NQ, L+1, L]
    ans = torch.einsum("fqxl,fqpl->fqpx", term, omega[:, None, None, :] * phase)
    denom = 1.0 + mu / mu0
    return ans * fbeam[:, None, None, None] / (4.0 * np.pi * denom[None, :, None, None])


def tms_ims_correction(inp: DisortInput, nquad: int, mu0: float, phi0: float, phis: tuple,
                       ims: bool = True):
    """The TMS/IMS intensity corrections (Nakajima-Tanaka), cdisort's
    c_new_intensity_correction: the delta-M truncated single scattering
    replaced by the exact phase function's (TMS), less the secondary
    scattering's delta-M overshoot near the solar aureole (IMS).  Returns
    du [F, L+1, NQuad, nphi] to add to the intensity field."""
    dt, dev = inp.tau.dtype, inp.tau.device
    N = nquad // 2
    mu_np, _ = double_gauss(N)
    mu_all = np.concatenate([-mu_np[::-1], mu_np])  # ascending

    omega = torch.clamp(inp.omega, 0.0, 1.0 - 1e-9)
    f = inp.f
    wf = omega * f
    omega_p = omega * (1.0 - f) / (1.0 - wf)
    dtau_p = (1.0 - wf) * inp.tau
    zero = torch.zeros_like(inp.tau[:, :1])
    tau_p = torch.cat([zero, torch.cumsum(dtau_p, -1)], -1)
    tau_u = torch.cat([zero, torch.cumsum(inp.tau, -1)], -1)

    kfull = inp.leg.shape[-1] - 1
    phis_r = np.deg2rad(np.asarray(phis, dtype=np.float64))
    # the scattering angles' cosines for every (mu, phi), computed on the
    # host in float64 as the JAX package does
    ct_np = -mu0 * mu_all[:, None] + np.sqrt(
        np.maximum((1.0 - mu0**2) * (1.0 - mu_all**2), 0.0))[:, None] * np.cos(
        phis_r - np.deg2rad(phi0))[None, :]
    ct = torch.as_tensor(ct_np, dtype=dt, device=dev)  # [NQ, nphi]
    P = _legendre_all(ct, kfull)  # [K+1, NQ, nphi]
    w2k1 = 2.0 * torch.arange(kfull + 1, dtype=dt, device=dev) + 1.0
    phasa = torch.einsum("k,kqp,flk->fqpl", w2k1, P, inp.leg)  # [F, NQ, nphi, L]
    ktrunc = min(nquad - 1, kfull)
    legm = (inp.leg[..., : ktrunc + 1] - f[..., None]) / (1.0 - f[..., None])
    legm = torch.cat([torch.ones_like(legm[..., :1]), legm[..., 1:]], -1)
    phasm = torch.einsum("k,kqp,flk->fqpl", w2k1[: ktrunc + 1], P[: ktrunc + 1], legm)
    phast = phasa / (1.0 - f * omega)[:, None, None, :]
    mu_j = torch.as_tensor(mu_all, dtype=dt, device=dev)
    du = (_single_scat(phast, omega, tau_p, mu_j, mu0, inp.fbeam)
          - _single_scat(phasm, omega_p, tau_p, mu_j, mu0, inp.fbeam))  # [F, NQ, nphi, L+1]

    if ims:
        # the aureole window is fixed by the quadrature and the sun
        theta0 = np.degrees(np.arccos(-mu0))
        thetap = np.degrees(np.arccos(mu_all))
        ims_mask = (mu_all < 0.0) & (np.abs(theta0 - thetap) <= 10.0)
        if ims_mask.any():
            mu_ims = np.where(ims_mask, mu_all, -0.5)  # keeps the exponentials bounded
            ims_val = _ims_term(inp, ct, tau_u, nquad, kfull,
                                torch.as_tensor(mu_ims, dtype=dt, device=dev), mu0)
            du = du - torch.as_tensor(ims_mask, dtype=dt, device=dev)[:, None, None] * ims_val
    return du.permute(0, 3, 1, 2)


def _ims_term(inp: DisortInput, ct, tau_u, nstr, kfull, mu, mu0):
    """cdisort's c_secondary_scat: the delta-M spike's double-scattering
    term for the scattering cosines ct [NQ, nphi] and output cosines mu
    [NQ] (negative = downward, where it applies); [F, NQ, nphi, L+1]."""
    dt, dev = inp.tau.dtype, inp.tau.device
    omega = torch.clamp(inp.omega, 0.0, 1.0 - 1e-9)
    f = inp.f
    # the cumulative (unscaled) means down to each boundary
    w_dt = omega * inp.tau
    f_dt = f * w_dt
    stau = tau_u[:, 1:]  # [F, L] boundary depths (the term is 0 at the top)
    wbar = torch.cumsum(w_dt, -1)
    fbar = torch.cumsum(f_dt, -1)
    tiny = 1e-4
    ok = (wbar > tiny) & (fbar > tiny) & (stau > tiny)
    fbar_n = fbar / torch.where(wbar > 0, wbar, torch.ones_like(wbar))
    wbar_n = wbar / torch.where(stau > 0, stau, torch.ones_like(stau))

    P = _legendre_all(ct, kfull)  # [K+1, NQ, nphi]
    # the spike's phase function: moments k < nstr with gbar = 1, k >= nstr
    # with gbar from the moments
    ktop = min(nstr, kfull + 1)
    base = torch.einsum("k,kqp->qp", 2.0 * torch.arange(1, ktop, dtype=dt, device=dev) + 1.0,
                        P[1:ktop])  # [NQ, nphi]
    pspike = 1.0 + base[None, :, :, None] * torch.ones_like(stau)[:, None, None, :]
    if kfull >= nstr:
        gmom = torch.cumsum(inp.leg[..., nstr:] * w_dt[..., None], -2)  # [F, L, K-]
        denom = fbar_n * wbar_n * stau
        gbar = torch.where((denom > tiny)[..., None],
                           gmom / torch.where(denom > 0, denom, torch.ones_like(denom))[..., None],
                           torch.zeros_like(gmom))
        kk = torch.arange(nstr, kfull + 1, dtype=dt, device=dev)
        pspike = pspike + torch.einsum("flk,kqp->fqpl", gbar * (2.0 - gbar) * (2.0 * kk + 1.0),
                                       P[nstr:])
    fw = fbar_n * wbar_n
    umu0p = mu0 / (1.0 - fw)

    def xi(umu1, umu2, tau):
        x1 = (umu2 - umu1) / (umu2 * umu1)
        e1 = torch.exp(-tau / umu1)
        x1s = torch.where(x1 == 0, torch.ones_like(x1), x1)
        main = ((tau * x1 - 1.0) * torch.exp(-tau / umu2) + e1) / (x1s**2 * umu1 * umu2)
        limit = tau * tau * e1 / (2.0 * umu1 * umu2)
        return torch.where(x1 == 0, limit, main)

    xiv = xi((-mu)[None, :, None, None], umu0p[:, None, None, :],
             stau[:, None, None, :])  # [F, NQ, 1, L]
    val = (inp.fbeam[:, None, None, None] / (4.0 * np.pi)
           * (fw**2 / (1.0 - fw))[:, None, None, :] * pspike * xiv)
    val = torch.where(ok[:, None, None, :], val, torch.zeros_like(val))
    return torch.cat([torch.zeros_like(val[..., :1]), val], -1)
