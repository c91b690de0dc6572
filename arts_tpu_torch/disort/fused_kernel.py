"""The fused DISORT solve: two CUDA kernels, their plain PyTorch versions,
and the lane-layout and right-hand-side assembly around them (port of
arts_tpu/disort/fused_kernel.py).

Every (frequency x Fourier mode) problem is a lane, lane = m * F + f;
tensors are laid out [layer, entry, lane] so that neighbouring threads
read neighbouring lanes.

  stage 1  (kernel `disort_stage1`, a team of n/2 threads per (lane,
           layer) problem, sharing one eigen core with fused_eigen):
           phase matrices -> H1/H2 -> Cholesky(-H1) -> Hsym = -Lc^T H2 Lc
           -> tournament cyclic Jacobi -> k, Ek = exp(-k dtau), G+/G- and
           the thermal particular solution at the layer top and bottom;
           under a solar beam (the kernel's beam instance) also the
           beam's, a third solve with the same ApB/AmB.
  stages 2+3 (kernel `disort_stage23`, 8 threads per lane, each
           owning columns of the layer's system): the structured
           block-tridiagonal Thomas elimination forward over the layers,
           carrying W [n x n] and uy [n], each layer's block solved by
           Gauss-Jordan elimination, then the back-substitution in reverse
           layer order with the level radiances u/v at every layer top
           and bottom.

Eigenmode order is whatever the Jacobi sweep leaves (no sort): the
boundary-value problem treats modes symmetrically, and the plain versions
run the same schedule, so kernel and plain version agree mode for mode.
"""

import ctypes
import math

import torch

from .. import _cuda
from ..ops.eigh_jacobi import _default_sweeps
from .eigen_kernel import eigen_plain, h12_plain, quad_table, split_qtab


def _ge_solve(A, B):
    """Gaussian elimination without pivoting, A X = B, batched:
    A [..., n, n], B [..., n, k].  DISORT's systems are diagonally
    dominant by construction, as for the unrolled TPU solve."""
    A = A.clone()
    B = B.clone()
    n = A.shape[-1]
    for i in range(n):
        inv = 1.0 / A[..., i, i]
        A[..., i, i + 1 :] = A[..., i, i + 1 :] * inv[..., None]
        B[..., i, :] = B[..., i, :] * inv[..., None]
        f = A[..., i + 1 :, i, None]
        A[..., i + 1 :, i + 1 :] = A[..., i + 1 :, i + 1 :] - f * A[..., i, None, i + 1 :]
        B[..., i + 1 :, :] = B[..., i + 1 :, :] - f * B[..., i, None, :]
    X = torch.empty_like(B)
    for i in range(n - 1, -1, -1):
        acc = B[..., i, :]
        for r in range(i + 1, n):
            acc = acc - A[..., i, r, None] * X[..., r, :]
        X[..., i, :] = acc
    return X


# ---------------------------------------------------------------------------
# stage 1: eigen + thermal particular solution
# ---------------------------------------------------------------------------


def stage1(pp, pm, om, dtau, tb0, tb1, qtab, sweeps, beam=None):
    """(ek [L, n, B], gp, gm [L, n*n, B], ut, vt, ub, vb [L, n, B]).

    pp/pm [L, n*n, B] phase matrices; om, dtau [L, B] scaled single
    scattering albedo and optical depth; tb0/tb1 [L, B] the pre-masked
    (1 - omega') thermal source coefficients; qtab from quad_table; beam
    None or beam_inputs' (qp, qm [L, n, B], ebt, ebb [L, B], mu0), whose
    particular solution is added to the radiances.  On a CUDA tensor this
    launches csrc/disort_fused.cu:disort_stage1 (its beam instance under a
    beam); on a CPU tensor it runs the plain version."""
    if pp.device.type == "cpu":
        return stage1_plain(pp, pm, om, dtau, tb0, tb1, qtab, sweeps, beam)
    dev, dt = pp.device, pp.dtype
    L, nn, B = pp.shape
    n = math.isqrt(nn)
    _check_lanes("disort_stage1", dev, dt, n)
    ins = [("pp", pp, (L, nn, B)), ("pm", pm, (L, nn, B)), ("om", om, (L, B)),
           ("dtau", dtau, (L, B)), ("tb0", tb0, (L, B)), ("tb1", tb1, (L, B)),
           ("qtab", qtab, (5 * n + 2 * nn,))]
    if beam is not None:
        qp, qm, ebt, ebb, mu0 = beam
        if not mu0 > 0.0:
            raise ValueError(f"disort_stage1: the beam needs mu0 > 0, got {mu0}")
        ins += [("qp", qp, (L, n, B)), ("qm", qm, (L, n, B)), ("ebt", ebt, (L, B)),
                ("ebb", ebb, (L, B))]
    for name, t, shape in ins:
        _cuda.check(name, t, dev, dt, shape)
    ek = torch.empty((L, n, B), dtype=dt, device=dev)
    gp = torch.empty((L, nn, B), dtype=dt, device=dev)
    gm = torch.empty_like(gp)
    ut, vt, ub, vb = (torch.empty_like(ek) for _ in range(4))
    if L and B:
        none = ctypes.c_void_p()
        extra = ((none,) * 4 + (0.0,) if beam is None else
                 tuple(map(_cuda.ptr, (qp, qm, ebt, ebb))) + (float(mu0),))
        _cuda.launch("disort_stage1", dt, *map(_cuda.ptr, (
            pp, pm, om, dtau, tb0, tb1, qtab, ek, gp, gm, ut, vt, ub, vb)),
            n, L, B, sweeps, *extra, counter=None if beam is None else "disort_stage1_beam")
    return ek, gp, gm, ut, vt, ub, vb


def stage1_occupancy(n, dtype, beam, lib=None):
    """(blocks resident at once on one SM, dynamic shared memory in bytes
    per block) of csrc/disort_fused.cu's stage 1 kernel at n streams per
    hemisphere in dtype (its beam instance under beam), as the CUDA runtime
    gives them for the current card; lib, a loaded build of that source
    (default the package's)."""
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    fn = getattr(lib or _cuda.library(), f"disort_stage1_occupancy_{suffix}")
    fn.argtypes = _cuda._SIGNATURES["disort_stage1_occupancy"]
    fn.restype = ctypes.c_int
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    rc = fn(n, int(beam), ctypes.byref(blocks), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"disort_stage1_occupancy_{suffix}: CUDA error {rc}")
    return blocks.value, smem.value


def stage1_plain(pp, pm, om, dtau, tb0, tb1, qtab, sweeps, beam=None):
    """The plain PyTorch version of stage1: the same arithmetic, batched
    over all (layer, lane) problems as matrices [L, B, n, n]; the eigen
    part is disort/eigen_kernel.py's, shared with fused_eigen."""
    L, nn, B = pp.shape
    n = math.isqrt(nn)
    imu, _, _, _, _, _, sc = split_qtab(qtab, n)
    H1, H2 = h12_plain(pp, pm, om, qtab)
    _, ek, Gp, Gm = eigen_plain(H1, H2, dtau, qtab, sweeps)

    # thermal particular solution: q1 = AmB^-1 tb1/mu, p+r = 2 AmB^-1 tb0/mu,
    # p-r = 2 ApB^-1 q1, with ApB/AmB = sc * H1/H2
    G = torch.stack([tb1[..., None] * imu, tb0[..., None] * imu], -1)
    sol = _ge_solve(sc * H2, G)
    q1 = sol[..., 0]
    p_plus_r = 2.0 * sol[..., 1]
    p_minus_r = 2.0 * _ge_solve(sc * H1, q1[..., None])[..., 0]
    p0 = 0.5 * (p_plus_r + p_minus_r)
    r0 = 0.5 * (p_plus_r - p_minus_r)
    q1d = q1 * dtau[..., None]
    lane = lambda x: x.permute(0, 2, 1).contiguous()  # [L, B, n] -> [L, n, B]
    flat = lambda x: x.permute(0, 2, 3, 1).reshape(L, nn, B).contiguous()
    ut, vt, ub, vb = p0, r0, p0 + q1d, r0 + q1d
    if beam is not None:
        zp, zm, ebt, ebb = _beam_plain(sc * H1, sc * H2, imu, *beam)
        ut, vt = ut + zp * ebt, vt + zm * ebt
        ub, vb = ub + zp * ebb, vb + zm * ebb
    return (lane(ek), flat(Gp), flat(Gm), lane(ut), lane(vt), lane(ub), lane(vb))


def _beam_plain(ApB, AmB, imu, qp, qm, ebt, ebb, mu0):
    """The beam's particular solution of every (layer, lane) problem:
    (z+, z- [L, B, n], ebt, ebb [L, B, 1]) from ApB/AmB [L, B, n, n] and
    beam_inputs' lane-layout sources: (ApB AmB - I/mu0^2) s = ApB (q+ +
    q-)/mu - (q+ - q-)/(mu mu0), d = -mu0 (AmB s - (q+ + q-)/mu), z+- = (s
    +- d)/2, each product and sum in the beam kernel's order.  The system
    squares the conditioning of ApB and AmB, so the kernel keeps this
    rounding (no FMA) rather than amplify a difference from it."""
    n = ApB.shape[-1]
    qp, qm = qp.permute(0, 2, 1), qm.permute(0, 2, 1)  # [L, B, n]
    one = torch.ones((), dtype=ApB.dtype, device=ApB.device)
    m0 = one * mu0  # mu0 in the working dtype, as the kernel takes it
    imu0, imu02 = one / m0, one / (m0 * m0)

    def mv(A, x):  # sum_t A[..., :, t] x[..., t], t in order
        a = A[..., 0] * x[..., :1]
        for t in range(1, n):
            a = a + A[..., t] * x[..., t : t + 1]
        return a

    spm = (qp + qm) * imu
    rhs = mv(ApB, spm) - (qp - qm) * imu * imu0
    Asys = ApB[..., :, :1] * AmB[..., :1, :]
    for t in range(1, n):
        Asys = Asys + ApB[..., :, t : t + 1] * AmB[..., t : t + 1, :]
    Asys = Asys - torch.eye(n, dtype=ApB.dtype, device=ApB.device) * imu02
    s = _ge_solve(Asys, rhs[..., None])[..., 0]
    d = -m0 * (mv(AmB, s) - spm)
    return 0.5 * (s + d), 0.5 * (s - d), ebt[..., None], ebb[..., None]


# ---------------------------------------------------------------------------
# stages 2+3: block-tridiagonal elimination, back-substitution, radiances
# ---------------------------------------------------------------------------


def stage23(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb):
    """(utop, vtop, ubot, vbot) [L, n, B]: the level radiances at every
    layer top and bottom.

    gp/gm [L, n*n, B], ek [L, n, B] from stage 1; rhs [L, 2n, B] the
    boundary-value right-hand sides; rsurf [n*n, B] the surface reflection
    operator; ut/vt/ub/vb [L, n, B] the particular radiances.  On a CUDA
    tensor this launches csrc/disort_fused.cu:disort_stage23; on a CPU
    tensor it runs the plain version."""
    if gp.device.type == "cpu":
        return stage23_plain(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb)
    dev, dt = gp.device, gp.dtype
    L, nn, B = gp.shape
    n = math.isqrt(nn)
    _check_lanes("disort_stage23", dev, dt, n)
    for name, t, shape in (("gp", gp, (L, nn, B)), ("gm", gm, (L, nn, B)),
                           ("ek", ek, (L, n, B)), ("rhs", rhs, (L, 2 * n, B)),
                           ("rsurf", rsurf, (nn, B)), ("ut", ut, (L, n, B)),
                           ("vt", vt, (L, n, B)), ("ub", ub, (L, n, B)),
                           ("vb", vb, (L, n, B))):
        _cuda.check(name, t, dev, dt, shape)
    # the kernel's scratch S [L, B, n + 1, 2n]: per (layer, lane) the n
    # columns of the forward factor P, then y, written by the forward and
    # read back by the backward pass of the same kernel
    S = torch.empty((L, B, n + 1, 2 * n), dtype=dt, device=dev)
    outs = tuple(torch.empty((L, n, B), dtype=dt, device=dev) for _ in range(4))
    if L and B:
        _cuda.launch("disort_stage23", dt, *map(_cuda.ptr, (
            gp, gm, ek, rhs, rsurf, ut, vt, ub, vb, S) + outs), n, L, B)
    return outs


def stage23_plain(gp, gm, ek, rhs, rsurf, ut, vt, ub, vb):
    """The plain PyTorch version of stage23: Python loops over the layers,
    batched over lanes."""
    L, nn, B = gp.shape
    n = math.isqrt(nn)
    mat = lambda x: x.view(n, n, B).permute(2, 0, 1)  # [B, n, n]
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    Rs = mat(rsurf)
    W = torch.zeros((B, n, n), dtype=gp.dtype, device=gp.device)
    uy = torch.zeros((B, n), dtype=gp.dtype, device=gp.device)
    rhs_base = torch.zeros((B, 2 * n, n + 1), dtype=gp.dtype, device=gp.device)
    rhs_base[:, n:, :n] = torch.eye(n, dtype=gp.dtype, device=gp.device)
    Ps, ys = [], []
    with _cuda.full_f32_matmul():
        for l in range(L):
            Gp, Gm, e = mat(gp[l]), mat(gm[l]), ek[l].t()[:, None, :]
            GpE, GmE = Gp * e, Gm * e
            U = torch.cat([GmE, Gp], -1)  # [B, n, 2n]
            T = -torch.cat([Gp, GmE], -1)
            # A rows: -[Gm | GpE] for every layer (the l = 0 sign flip is
            # folded into the right-hand side), minus W T of the layer above
            Arows = -torch.cat([Gm, GpE], -1) - W @ T
            Brows = torch.cat([GpE, Gm], -1)
            if l == L - 1:  # surface reflection
                Brows = Brows - Rs @ U
            r = rhs[l].t()
            Bm = rhs_base.clone()
            Bm[:, :n, n] = r[:, :n] - uy
            Bm[:, n:, n] = r[:, n:]
            sol = _ge_solve(torch.cat([Arows, Brows], -2), Bm)
            P, yv = sol[..., :n], sol[..., n]
            W = U @ P
            uy = mv(U, yv)
            Ps.append(P)
            ys.append(yv)

        t = torch.zeros((B, n), dtype=gp.dtype, device=gp.device)
        outs = [[None] * L for _ in range(4)]
        for l in range(L - 1, -1, -1):
            X = ys[l] - mv(Ps[l], t)
            Cp, Cm = X[:, :n], X[:, n:]
            Gp, Gm, e = mat(gp[l]), mat(gm[l]), ek[l].t()[:, None, :]
            GpE, GmE = Gp * e, Gm * e
            GpX, GmEX = mv(Gp, Cp), mv(GmE, Cm)
            t = -(GpX + GmEX)
            outs[0][l] = GpX + GmEX + ut[l].t()
            outs[1][l] = mv(Gm, Cp) + mv(GpE, Cm) + vt[l].t()
            outs[2][l] = mv(GpE, Cp) + mv(Gm, Cm) + ub[l].t()
            outs[3][l] = mv(GmE, Cp) + mv(Gp, Cm) + vb[l].t()
    return tuple(torch.stack(o).permute(0, 2, 1).contiguous() for o in outs)


def _check_lanes(name, dev, dt, n):
    if dev.type != "cuda" or dt not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported {dt} on {dev}")
    if n not in (4, 8):
        raise ValueError(f"{name}: the kernel is built for n = 4 or 8 streams "
                         f"per hemisphere (nquad 8 or 16), got n = {n}")


# ---------------------------------------------------------------------------
# the solve in lane layout
# ---------------------------------------------------------------------------


def stage1_inputs(leg_scaled, omega_p, dtau_p, tb0, tb1, *, lam, sign, mu, w):
    """(pp, pm, om, dtau, tb0, tb1, qtab): stage 1's inputs in lane layout
    from the per-frequency terms (see fused_u_lvl)."""
    F, L = omega_p.shape
    M = tb0.shape[1]
    MF = M * F
    dt, dev = leg_scaled.dtype, leg_scaled.device
    lam_t = torch.as_tensor(lam, dtype=dt, device=dev)
    sign_t = torch.as_tensor(sign, dtype=dt, device=dev)
    with _cuda.full_f32_matmul():
        Pp = torch.einsum("flk,mki,mkj->lijmf", leg_scaled, lam_t, lam_t)
        Pm = torch.einsum("flk,mk,mki,mkj->lijmf", leg_scaled, sign_t, lam_t, lam_t)
    lanes = lambda x: x.reshape(L, -1, MF).contiguous()
    vecMF = lambda x: x.permute(2, 1, 0).reshape(L, MF).contiguous()
    vecF = lambda x: vecMF(x[:, None, :].expand(F, M, L))
    return (lanes(Pp), lanes(Pm), vecF(omega_p), vecF(dtau_p), vecMF(tb0),
            vecMF(tb1), quad_table(mu, w, dt, dev))


def beam_inputs(qp, qm, ebea, mu0):
    """stage1's beam argument (qp, qm [L, n, B], ebt, ebb [L, B], mu0) in
    lane layout from the per-frequency beam sources qp/qm [F, M, L, n]
    and the scaled attenuation ebea [F, L+1] at the levels."""
    F, M, L, n = qp.shape
    MF = M * F
    lanes = lambda x: x.permute(2, 3, 1, 0).reshape(L, n, MF).contiguous()
    vecF = lambda x: x[:, None, :].expand(F, M, L).permute(2, 1, 0).reshape(L, MF).contiguous()
    return lanes(qp), lanes(qm), vecF(ebea[:, :-1]), vecF(ebea[:, 1:]), float(mu0)


def stage23_inputs(ut, vt, ub, vb, rsurf, b_neg, rhs_surf):
    """(rhs [L, 2n, B], rsurf [n*n, B]): the boundary-value right-hand
    sides from stage 1's particular radiances and the boundary terms.

    A rows, l = 0: -(b_neg - v_top[0]) (stage 2 uses -[Gm | GpE] for every
    layer); l >= 1: v_top[l] - v_bot[l-1].  B rows, l <= L-2:
    u_top[l+1] - u_bot[l]; l = L-1, the surface: rhs_surf - u_bot +
    Rsurf v_bot."""
    F, M, n = b_neg.shape
    MF = M * F
    bneg = b_neg.permute(2, 1, 0).reshape(n, MF)
    rsv = rhs_surf.permute(2, 1, 0).reshape(n, MF)
    rsurf_f = rsurf.permute(2, 3, 1, 0).reshape(n * n, MF).contiguous()
    Rvb = (rsurf_f.view(n, n, MF) * vb[-1][None]).sum(1)
    rhs = torch.cat([
        torch.cat([-(bneg - vt[0])[None], vt[1:] - vb[:-1]], 0),
        torch.cat([ut[1:] - ub[:-1], (rsv - ub[-1] + Rvb)[None]], 0),
    ], 1).contiguous()
    return rhs, rsurf_f


def fused_u_lvl(leg_scaled, omega_p, dtau_p, tb0, tb1, rsurf, b_neg, rhs_surf,
                *, lam, sign, mu, w, qp=None, qm=None, ebea=None, mu0=0.0, sweeps=None,
                plain=False):
    """(u_lvl, v_lvl) [F, M, L+1, N]: up- and downwelling radiances at the
    quadrature nodes, per frequency, Fourier mode and level.

    leg_scaled [F, L, nlegc]; omega_p, dtau_p [F, L]; tb0/tb1 [F, M, L]
    pre-masked mode-0 (1 - omega') thermal coefficients; rsurf [F, M, N, N];
    b_neg, rhs_surf [F, M, N]; lam/sign numpy quadrature tables; mu, w the
    quadrature nodes and weights (numpy); under a beam from mu0 > 0 the
    prefactored sources qp/qm [F, M, L, N] and the scaled attenuation ebea
    [F, L+1] (None without).  plain=True runs the kernels' plain versions
    on any device."""
    F, L = omega_p.shape
    M = tb0.shape[1]
    n = len(mu)
    if sweeps is None:
        sweeps = _default_sweeps(leg_scaled.dtype)
    s1, s23 = (stage1_plain, stage23_plain) if plain else (stage1, stage23)
    beam = None if qp is None else beam_inputs(qp, qm, ebea, mu0)
    ek, gp, gm, ut, vt, ub, vb = s1(*stage1_inputs(
        leg_scaled, omega_p, dtau_p, tb0, tb1, lam=lam, sign=sign, mu=mu, w=w,
    ), sweeps, beam)
    rhs, rsurf_f = stage23_inputs(ut, vt, ub, vb, rsurf, b_neg, rhs_surf)
    utop, vtop, ubot, vbot = s23(gp, gm, ek, rhs, rsurf_f, ut, vt, ub, vb)
    unpack = lambda x: x.view(L, n, M, F).permute(3, 2, 0, 1)  # [F, M, L, n]
    u_lvl = torch.cat([unpack(utop), unpack(ubot)[:, :, -1:]], 2)
    v_lvl = torch.cat([unpack(vtop), unpack(vbot)[:, :, -1:]], 2)
    return u_lvl, v_lvl
