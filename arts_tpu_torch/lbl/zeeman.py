"""Zeeman-split polarized absorption (port of arts_tpu/lbl/zeeman.py).

Zeeman components become pseudo-lines: a host-side expansion (parent
line, polarization pi/sigma-/sigma+, splitting coefficient, relative
strength), after ARTS's lbl_zeeman.{h,cpp}.  Each pseudo-line is the
parent shifted by H * split; the per-polarization Voigt sums are
weighted by the geometric polarization matrices into the 7-component
propagation matrix.  Three routes to the same matrices:

  * `zeeman_propmat(backend="xla")`: the dense per-polarization shape
    sums (lbl.voigt._shape_sum), the JAX package's XLA route;
  * `zeeman_propmat(backend="pallas")`: all pseudo-lines through the
    polarized Voigt kernel (ops.voigt_kernel.voigt_sum_pol);
  * `zeeman_propmat_profile`: the parent-pole expansion over a whole
    profile (ops.zeeman_mp_kernel), from the bucketed catalog of
    `pad_zeeman_catalog`.

Atmospheric-point arguments T, P [...], vmr [..., S], mag [..., 3] and
los_za may carry a leading axis of levels; propagation matrices come
out as [..., F, 7].  Not ported: tune_zeeman_kernel (it only sized the
TPU grid's static visit axis; a CUDA block reads its own visit count).
"""

import dataclasses
import math

import numpy as np
import torch
from scipy.special import gammaln

from .. import constants as const
from .._cuda import move, resolve
from ..ops.voigt_kernel import voigt_sum_pol, weideman_order
from ..ops.wofz import wofz
from ..ops.zeeman_mp_kernel import (
    MP_TERMS,
    near_correction,
    wofz_parts,
    zeeman_mp_eval,
    zeeman_pole_moments,
)
from .catalog import LineCatalog
from .partfun import PartFunTable
from .tmodel import ID0, IDV, IG0
from .voigt import _shape_sum, _stimulated, line_strengths, lineshape_params

POLS = ("pi", "sm", "sp")
BUCKETS = (4, 16, 64, 128)  # component slots per pole, pad_zeeman_catalog
DM = {"pi": 0, "sm": -1, "sp": 1}
POL_FACTOR = {"pi": 1.5, "sm": 0.75, "sp": 0.75}


def wigner3j_dipole(jl, ml, dm, ju):
    """wigner3j(Jl, 1, Ju; Ml, dM, -Mu) with Mu = Ml + dM (Racah formula,
    host side; integers or half-integers)."""
    mu = ml + dm
    if abs(ml) > jl or abs(mu) > ju or abs(ju - jl) > 1 or ju + jl < 1:
        return 0.0

    def lf(x):
        return gammaln(x + 1.0)

    j1, j2, j3 = jl, 1.0, ju
    m1, m2, m3 = ml, dm, -mu
    pref = 0.5 * (
        lf(j1 + j2 - j3) + lf(j1 - j2 + j3) + lf(-j1 + j2 + j3)
        - lf(j1 + j2 + j3 + 1)
        + lf(j1 + m1) + lf(j1 - m1) + lf(j2 + m2) + lf(j2 - m2)
        + lf(j3 + m3) + lf(j3 - m3)
    )
    tmin = int(max(0.0, max(j2 - j3 - m1, j1 - j3 + m2)))
    tmax = int(min(j1 + j2 - j3, min(j1 - m1, j2 + m2)))
    s = 0.0
    for t in range(tmin, tmax + 1):
        denom = (
            lf(t) + lf(j3 - j2 + m1 + t) + lf(j3 - j1 - m2 + t)
            + lf(j1 + j2 - j3 - t) + lf(j1 - m1 - t) + lf(j2 + m2 - t)
        )
        s += (-1.0) ** t * math.exp(pref - denom)
    return (-1.0) ** int(round(j1 - j2 - m3)) * s


def zeeman_components(ju, jl, pol):
    """(ml array, mu array, strengths) for one line and polarization."""
    dm = DM[pol]
    C = POL_FACTOR[pol]
    mls, strengths = [], []
    m = -jl
    while m <= jl + 1e-9:
        w = wigner3j_dipole(jl, m, dm, ju)
        if w != 0.0:
            mls.append(m)
            strengths.append(C * w * w)
        m += 1.0
    mls = np.asarray(mls)
    return mls, mls + dm, np.asarray(strengths)


@dataclasses.dataclass(frozen=True)
class ZeemanCatalog:
    """Base catalog + per-polarization pseudo-line expansions."""

    cat: LineCatalog
    idx: tuple  # 3 x [K] int64 indices into the catalog's lines (pi, sm, sp)
    split: tuple  # 3 x [K] splitting coefficients [Hz/T]
    strength: tuple  # 3 x [K] relative strengths


def expand_zeeman(cat: LineCatalog, ju, jl, gu_z, gl_z) -> ZeemanCatalog:
    """Host-side component expansion.  ju, jl: [L] J quantum numbers;
    gu_z, gl_z: [L] Lande g factors (both 0 leaves a line unsplit: one
    component per polarization at zero shift, with the closure weights
    1/2, 1/4, 1/4 so that the summed matrix is the isotropic line)."""
    C = const.bohr_magneton / const.h
    dev, dt = cat.f0.device, cat.f0.dtype
    idx_t, split_t, strength_t = [], [], []
    for pol in POLS:
        ii, ss, st = [], [], []
        for l in range(cat.n_lines):
            if gu_z[l] == 0.0 and gl_z[l] == 0.0:
                ii.append(l)
                ss.append(0.0)
                st.append({"pi": 0.5, "sm": 0.25, "sp": 0.25}[pol])
                continue
            mls, mus, w = zeeman_components(float(ju[l]), float(jl[l]), pol)
            for k in range(len(w)):
                ii.append(l)
                ss.append(C * (mus[k] * gu_z[l] - mls[k] * gl_z[l]))
                st.append(w[k])
        idx_t.append(torch.tensor(np.asarray(ii, dtype=np.int64), device=dev))
        split_t.append(torch.tensor(np.asarray(ss, dtype=np.float64), dtype=dt, device=dev))
        strength_t.append(torch.tensor(np.asarray(st, dtype=np.float64), dtype=dt, device=dev))
    return ZeemanCatalog(cat=cat, idx=tuple(idx_t), split=tuple(split_t),
                         strength=tuple(strength_t))


def magnetic_angles(mag, los_za_deg, los_aa_deg):
    """(H, theta, eta) from the magnetic field [..., 3] [T] (u=E, v=N,
    w=Up) and line-of-sight angles in degrees (ARTS lbl_zeeman.cpp)."""
    u, v, w = mag[..., 0], mag[..., 1], mag[..., 2]
    za = torch.deg2rad(torch.as_tensor(los_za_deg, dtype=mag.dtype, device=mag.device))
    aa = torch.deg2rad(torch.as_tensor(los_aa_deg, dtype=mag.dtype, device=mag.device))
    sa, ca, sz, cz = torch.sin(aa), torch.cos(aa), torch.sin(za), torch.cos(za)
    H = torch.sqrt(u * u + v * v + w * w)
    uct = sz * sa * u + sz * ca * v + cz * w
    duct = u * sa * cz + v * ca * cz - w * sz
    safeH = torch.where(H > 0, H, torch.ones_like(H))
    theta = torch.where(H > 0, torch.arccos(torch.clamp(uct / safeH, -1.0, 1.0)),
                        torch.zeros_like(H))
    eta = -torch.atan2(ca * u - sa * v, -duct)
    return H, theta, eta


def pol_matrices(theta, eta):
    """The 7-component polarization weights per type, {pol: [..., 7]}
    (ARTS lbl_zeeman.cpp)."""
    CT = torch.cos(theta)
    ST2 = torch.sin(theta) ** 2
    Q = ST2 * torch.cos(2 * eta)
    U = ST2 * torch.sin(2 * eta)
    z = torch.zeros_like(ST2)
    stack = lambda *c: torch.stack(torch.broadcast_tensors(*c), -1)
    return {
        "pi": stack(ST2, -Q, U, z, z, U, Q),
        "sm": stack(2 - ST2, Q, -U, 2 * CT, -2 * CT, -U, -Q),
        "sp": stack(2 - ST2, Q, -U, -2 * CT, 2 * CT, -U, -Q),
    }


def _pseudo_lines(zcat, p_i, T, s, f0s, inv_gd, ls, H):
    """(f0 [K], offset, inv_gd, z_imag, s [..., K]) of polarization p_i's
    components: the parent's unshifted centre and, apart from it, the
    pressure shift plus H split, with the Doppler width updated for the
    shifted centre (as ARTS does) and the strength rescaled to it.  The
    dense route subtracts the offset after f - f0, which is exact near
    the line in float32, and kernel 5's route carries what rounding
    (f0 - anchor) + offset leaves out (_pol_args): f0 + offset would
    round the centre to the float32 spacing of f0, ~16 kHz at 200 GHz,
    several percent of an upper level's Doppler width."""
    cat = zcat.cat
    idx = zcat.idx[p_i]
    off_k = (ls[..., idx, ID0] + ls[..., idx, IDV]) + H[..., None] * zcat.split[p_i]
    gd_part = torch.sqrt(const.doppler_broadening_const_squared * T[..., None]
                         / cat.iso_mass[idx])
    inv_gd_k = 1.0 / (gd_part * (f0s[..., idx] + H[..., None] * zcat.split[p_i]))
    z_imag_k = ls[..., idx, IG0] * inv_gd_k
    s_k = zcat.strength[p_i] * s[..., idx] * (inv_gd_k / inv_gd[..., idx])
    return cat.f0[idx], off_k, inv_gd_k, z_imag_k, s_k


def _point_terms(f_grid, zcat, pf, T, P, vmr, mag, los_za_deg, los_aa_deg):
    """(polarization weights {pol: [..., 7]}, stimulated-emission factor
    [..., F], each polarization's pseudo-lines) at the points T [...]."""
    cat = zcat.cat
    ls = lineshape_params(cat, T, P, vmr)
    s, f0s, inv_gd, _ = line_strengths(cat, pf, T, P, vmr, ls)
    H, theta, eta = magnetic_angles(mag, los_za_deg, los_aa_deg)
    parts = [_pseudo_lines(zcat, p_i, T, s, f0s, inv_gd, ls, H) for p_i in range(3)]
    return pol_matrices(theta, eta), _stimulated(f_grid, T), parts


def _pol_args(f_grid, zcat, npm, parts, Z):
    """voigt_sum_pol's positional arguments for [Z, L] pseudo-lines, in
    pi/sm/sp order, shifted by a common anchor as JAX's route does, and
    the centres' rounding remainders: f0 - anchor is exact, and the
    offset is added to it with the sum's rounding error carried apart
    (TwoSum), for the kernel to subtract after f - f0."""
    anchor = f_grid.mean()
    base = torch.cat([(f0 - anchor).expand_as(off) for f0, off, *_ in parts], -1).reshape(Z, -1)
    off = torch.cat([off for _, off, *_ in parts], -1).reshape(Z, -1)
    f0_a = base + off
    b_v = f0_a - base
    res = (base - (f0_a - b_v)) + (off - b_v)
    igd_a, zi_a, s_a = (
        torch.cat([p[i] for p in parts], -1).reshape(Z, -1) for i in range(2, 5))
    polidx = torch.cat([torch.full_like(i, p_i) for p_i, i in enumerate(zcat.idx)])
    table = torch.stack([npm[pol] for pol in POLS], -2).reshape(-1, 3, 7).expand(Z, 3, 7)
    cut = zcat.cat.cutoff[torch.cat(zcat.idx)]
    has_cut = torch.isfinite(cut)
    cut_safe = torch.where(has_cut, cut, 0.0)
    wc = wofz(torch.complex(igd_a * cut_safe, zi_a))
    wcut = torch.where(has_cut, wc, torch.zeros_like(wc))
    cut_k = torch.where(has_cut, cut, 1e30).expand_as(f0_a)
    return (f_grid - anchor, f0_a, igd_a, zi_a, s_a.real, s_a.imag, cut_k,
            wcut.real, wcut.imag, polidx, table, res)


def voigt_sum_pol_args(f_grid, zcat: ZeemanCatalog, pf: PartFunTable, T, P, vmr, mag,
                       los_za_deg, los_aa_deg=0.0):
    """(voigt_sum_pol's positional arguments, stimulated-emission factor
    [Z, F]) for the points T, P [Z], vmr [Z, S]: the inputs of
    zeeman_propmat's backend="pallas" route, on the tensors' device."""
    npm, scl, parts = _point_terms(f_grid, zcat, pf, T, P, vmr, mag, los_za_deg, los_aa_deg)
    return _pol_args(f_grid, zcat, npm, parts, T.shape[0]), scl


def zeeman_propmat(f_grid, zcat: ZeemanCatalog, pf: PartFunTable, T, P, vmr,
                   mag, los_za_deg, los_aa_deg=0.0, backend="xla", device=None,
                   dtype=None):
    """Polarized propagation matrix [..., F, 7] at the points T, P [...],
    vmr [..., S], mag [..., 3] [T], seen along los_za_deg / los_aa_deg.

    backend="xla": the per-polarization dense shape sums, for all points
    at once (lines in blocks of 256).
    backend="pallas": all three polarizations' pseudo-lines, concatenated
    in pi/sm/sp order, through the polarized Voigt kernel (one launch for
    all points)."""
    dev, dt = resolve(device, dtype)
    f_grid, zcat, pf, T, P, vmr, mag = move((f_grid, zcat, pf, T, P, vmr, mag), dev, dt)
    los_za = torch.as_tensor(los_za_deg, dtype=dt, device=dev)
    npm, scl, parts = _point_terms(f_grid, zcat, pf, T, P, vmr, mag, los_za, los_aa_deg)

    if backend == "pallas":
        one = T.dim() == 0
        out7 = voigt_sum_pol(*_pol_args(f_grid, zcat, npm, parts,
                                        1 if one else T.shape[0]))  # [Z, 7, F]
        pm = scl.reshape(-1, f_grid.shape[0])[..., None] * out7.transpose(1, 2)
        return pm[0] if one else pm
    if backend != "xla":
        raise ValueError(f"zeeman_propmat: unknown backend {backend!r}")
    return _polarize(npm, _dense_shapes(f_grid, zcat, parts, scl))


def _dense_shapes(f_grid, zcat, parts, scl):
    """Each polarization's stimulated-emission-weighted shape sum [..., F]
    by the dense route, for all points at once."""
    shapes = []
    for p_i in range(len(POLS)):
        f0_k, off_k, inv_gd_k, z_imag_k, s_k = parts[p_i]
        cut = zcat.cat.cutoff[zcat.idx[p_i]]
        shapes.append(scl * _shape_sum(f_grid, s_k, f0_k, inv_gd_k, z_imag_k, cut,
                                       shift=off_k).real)
    return shapes


def _polarize(npm, shapes):
    """The propagation matrix [..., F, 7] of the polarization weights
    {pol: [..., 7]} and the shape sums [..., F]."""
    pm = torch.zeros(shapes[0].shape + (7,), dtype=shapes[0].dtype, device=shapes[0].device)
    for pol, shape in zip(POLS, shapes):
        pm = pm + npm[pol][..., None, :] * shape[..., None]
    return pm


def zeeman_propmat_views(f_grid, zcat: ZeemanCatalog, pf: PartFunTable, T, P, vmr, mag,
                         los_za_degs, los_aa_deg=0.0, device=None, dtype=None):
    """zeeman_propmat(backend="xla") at the same points seen along each of
    the lines of sight los_za_degs: a list of [..., F, 7].  The shape sums
    do not depend on the direction (only the polarization weights do), so
    they are computed once for all views; each matrix equals that of its
    own zeeman_propmat call."""
    dev, dt = resolve(device, dtype)
    f_grid, zcat, pf, T, P, vmr, mag = move((f_grid, zcat, pf, T, P, vmr, mag), dev, dt)
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    _, scl, parts = _point_terms(f_grid, zcat, pf, T, P, vmr, mag, as_t(los_za_degs[0]),
                                 los_aa_deg)
    shapes = _dense_shapes(f_grid, zcat, parts, scl)
    return [_polarize(pol_matrices(*magnetic_angles(mag, as_t(za), los_aa_deg)[1:]), shapes)
            for za in los_za_degs]


@dataclasses.dataclass(frozen=True)
class PaddedZeemanCatalog:
    """Bucketed component-major Zeeman layout for the parent-pole path.

    Each pole is one parent line (or a co-located chunk of a parent with
    more components than the largest bucket); its components live in a
    [CM, NP] slot grid (strength 0 padding), CM the smallest bucket size
    covering the parent's component count."""

    cat: LineCatalog
    parent: tuple  # per bucket: [NP_b] int64 line index of each pole
    split: tuple  # per bucket: [CM_b, NP_b] splitting coefficients [Hz/T]
    strength: tuple  # per bucket: [CM_b, NP_b] relative strengths (0 = pad)
    polidx: tuple  # per bucket: [CM_b, NP_b] int64 polarization 0/1/2


def pad_zeeman_catalog(zcat: ZeemanCatalog):
    """Host-side ZeemanCatalog -> PaddedZeemanCatalog.  Each parent goes
    to the smallest of BUCKETS holding its component count; parents
    beyond the largest bucket split into bucket-sized co-located poles,
    and each chunk (a short remainder too) buckets by its own length."""
    buckets = BUCKETS
    bmax = buckets[-1]
    n = int(zcat.cat.f0.shape[0])
    per_parent = [[] for _ in range(n)]
    for p_i in range(len(POLS)):
        idx = zcat.idx[p_i].cpu().numpy()
        spl = zcat.split[p_i].cpu().numpy()
        st = zcat.strength[p_i].cpu().numpy()
        for k in range(idx.shape[0]):
            per_parent[int(idx[k])].append((spl[k], st[k], p_i))
    groups = {b: [] for b in buckets}
    for p in range(n):
        comps = per_parent[p]
        for o in range(0, max(len(comps), 1), bmax):
            chunk = comps[o:o + bmax]
            if not chunk:
                continue
            b = next(bb for bb in buckets if len(chunk) <= bb)
            groups[b].append((p, chunk))
    dev, dt = zcat.cat.f0.device, zcat.cat.f0.dtype
    ten = lambda a, d=dt: torch.tensor(a, dtype=d, device=dev)
    parent_t, split_t, strength_t, polidx_t = [], [], [], []
    for b in buckets:
        rows = groups[b]
        if not rows:
            continue
        NP = len(rows)
        split = np.zeros((b, NP))
        strength = np.zeros((b, NP))
        polidx = np.zeros((b, NP), np.int64)
        for r, (p, comps) in enumerate(rows):
            for c, (sp, st, p_i) in enumerate(comps):
                split[c, r] = sp
                strength[c, r] = st
                polidx[c, r] = p_i
        parent_t.append(ten(np.asarray([p for p, _ in rows], np.int64), torch.int64))
        split_t.append(ten(split))
        strength_t.append(ten(strength))
        polidx_t.append(ten(polidx, torch.int64))
    return PaddedZeemanCatalog(cat=zcat.cat, parent=tuple(parent_t), split=tuple(split_t),
                               strength=tuple(strength_t), polidx=tuple(polidx_t))


def zeeman_mp_args(f_grid, zcat: PaddedZeemanCatalog, pf: PartFunTable, T, P, vmr, mag,
                   los_za_deg, los_aa_deg=0.0, mp_kappa=6.0):
    """The parent-pole route's inputs for the levels T, P [Z], vmr [Z, S]
    and one field mag [3], on the tensors' device: (zeeman_mp_eval's
    positional arguments, near_correction's per-bucket arguments after
    `out`, the stimulated-emission factor [Z, F])."""
    if not isinstance(zcat, PaddedZeemanCatalog):
        raise TypeError("zeeman_propmat_profile needs a PaddedZeemanCatalog: "
                        "convert once with pad_zeeman_catalog(zcat)")
    if not zcat.parent:
        raise ValueError("empty PaddedZeemanCatalog (no Zeeman components); "
                         "nothing to evaluate")
    cat = zcat.cat
    H, theta, eta = magnetic_angles(mag, los_za_deg, los_aa_deg)
    npm = pol_matrices(theta, eta)
    pw_tab = torch.stack([npm[pol] for pol in POLS])  # [3, 7]
    cut_parent = torch.where(torch.isfinite(cat.cutoff), cat.cutoff, 1e30)
    wn = weideman_order(f_grid.dtype)

    ls = lineshape_params(cat, T, P, vmr)
    s_l, f0_l, igd_l, _ = line_strengths(cat, pf, T, P, vmr, ls)  # [Z, L]
    g0_l = ls[..., IG0]
    shift_l = ls[..., ID0] + ls[..., IDV]
    gd_c = torch.sqrt(const.doppler_broadening_const_squared * T[:, None]
                      / cat.iso_mass[None, :])
    anchor = f_grid.mean()
    fa = f_grid - anchor

    # per bucket: the component grids [Z, CM_b, NP_b] and the pole moments
    moms, near = [], []
    for parent_b, split_b, strength_b, polidx_b in zip(
            zcat.parent, zcat.split, zcat.strength, zcat.polidx):
        pw_k = pw_tab[polidx_b]  # [CM_b, NP_b, 7]
        cut_b = cut_parent[parent_b]
        at = lambda x: x[:, parent_b][:, None, :]
        # centres relative to the anchor: f0 - anchor is exact, and the
        # offset (pressure shift + H split) is added to it for the pole
        # moments and subtracted after f - (f0 - anchor) by the near
        # correction (see _pseudo_lines); the Doppler width from the
        # shifted centre
        base_k = (cat.f0[parent_b] - anchor).expand_as(split_b[None])
        off_k = at(shift_l) + H * split_b[None]
        f0_k = base_k + off_k
        igd_k = 1.0 / (at(gd_c) * (at(f0_l) + H * split_b[None]))
        zi_k = at(g0_l) * igd_k
        s_k = strength_b[None] * at(s_l) * (igd_k / at(igd_l))
        sr_k, si_k = s_k.real, s_k.imag
        wcr, wci = wofz_parts(igd_k * cut_b, zi_k, wn)
        swc_k = sr_k * wcr - si_k * wci
        m = zeeman_pole_moments(f0_k, igd_k, zi_k, sr_k, si_k, swc_k, pw_k, MP_TERMS,
                                mp_kappa)
        moms.append(m)
        near.append((m["c_re"], m["g0"], m["rnear"], cut_b, base_k.expand_as(igd_k), igd_k,
                     zi_k, sr_k, si_k, pw_k, off_k))
    catp = lambda key: torch.cat([m[key] for m in moms], 1)
    poles = (fa, catp("c_re"), catp("g0"), catp("R"), catp("rnear2"),
             cut_parent[torch.cat(zcat.parent)], catp("M_re"), catp("M_im"), catp("swcsum"))
    return poles, near, _stimulated(f_grid, T)


def zeeman_propmat_profile(f_grid, zcat: PaddedZeemanCatalog, pf: PartFunTable, T, P,
                           vmr, mag, los_za_deg, los_aa_deg=0.0, mp_kappa=6.0, noff=6,
                           device=None, dtype=None):
    """Polarized propagation matrices for a whole profile: [Z, F, 7].

    T, P [Z]; vmr [Z, S]; mag [3] (u, v, w in T).  Beyond a small
    per-parent near radius the Zeeman components of a parent collapse
    into a MP_TERMS-term parent-pole expansion, evaluated for all levels
    by one launch of the zeeman_mp kernel; the few grid points inside each
    near radius are corrected exactly.  mp_kappa and noff come from
    tune_zeeman_profile: noff must cover ceil(2 max r_near / grid
    spacing) + 2.
    """
    dev, dt = resolve(device, dtype)
    f_grid, zcat, pf, T, P, vmr, mag = move((f_grid, zcat, pf, T, P, vmr, mag), dev, dt)
    poles, near, scl = zeeman_mp_args(f_grid, zcat, pf, T, P, vmr, mag, los_za_deg,
                                      los_aa_deg, mp_kappa)
    out = zeeman_mp_eval(*poles)
    for args in near:
        out = near_correction(poles[0], out, *args, noff=noff, wofz_n=weideman_order(dt))
    return scl[..., None] * out.transpose(1, 2)


def tune_zeeman_profile(f_grid, pzcat: PaddedZeemanCatalog) -> dict:
    """Knobs for zeeman_propmat_profile on a concrete grid: mp_kappa, and
    noff large enough that the near-correction candidates cover the
    worst-case near radius, max(kappa R, R + 32 Doppler widths), from the
    catalog's component spreads (under fields up to 1e-4 T) and Doppler
    widths (up to 320 K) at this grid's spacing."""
    t_max, mp_kappa, H_ref = 320.0, 6.0, 1e-4
    fg = f_grid.detach().cpu().numpy()
    df = np.diff(fg).min() if fg.size > 1 else 1.0
    spread = max((float(s.abs().max()) for s in pzcat.split), default=0.0) * H_ref
    m_min = float(pzcat.cat.iso_mass.min())
    gd_max = float(fg.max()) * float(
        np.sqrt(const.doppler_broadening_const_squared * t_max / m_min))
    R_max = max(spread, gd_max)
    r_max = max(mp_kappa * R_max, R_max + 32.0 * gd_max)
    return dict(noff=int(np.ceil(2 * r_max / df)) + 2, mp_kappa=mp_kappa)
