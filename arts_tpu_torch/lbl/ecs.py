"""ECS (Energy-Corrected Sudden) full-band line mixing (port of
arts_tpu/lbl/ecs.py).

A band's relaxation matrix W comes from the ECS basis rates Q(L, T) and
Omega(L, T) contracted with a static Wigner geometry geo[i, j, L], built
on the host at band construction (make_o2_band for O2-66 after Makarov
et al. 2020, make_linear_band for CO2-like bands, make_stotop_band and
make_sphtop_band for symmetric and spherical tops).  At each point the
off-diagonal rates are completed by detailed balance, renormalized by the
sum rule, and the band matrix diag(f0 + D0) + i W, symmetrized by the
detailed-balance scaling, is diagonalized by the complex-orthogonal
Jacobi of ops.eig_comp_sym.  Its eigenvalues are the equivalent lines'
complex centres and its eigenvectors give their complex strengths; the
shape is the sum of their Voigt profiles.  The whole chain is
differentiable by autograd and torch.func.

Precision: the band matrix, its eigen solve and the equivalent strengths
are float64 / complex128 on every device, whatever the scene's dtype,
and the EcsBand keeps its tensors in float64 when a scene is moved
(fixed_dtype).  The eigenvalues are line centres near 6e10 Hz, where the
float32 spacing (~4 kHz) is a tenth of the Doppler half-width at the top
levels (~50 kHz); the detuning vals - f is formed in float64 and only the
Faddeeva argument is cast to the scene's dtype.
"""

import dataclasses
import math
from typing import ClassVar

import numpy as np
import torch
from scipy.special import gammaln

from .. import constants as const
from .._cuda import resolve
from ..ops.eig_comp_sym import eig_comp_sym
from ..ops.wofz import wofz

# ---------------------------------------------------------------------------
# Wigner symbols (host side, Racah formulas)
# ---------------------------------------------------------------------------


def _lf(x):
    return gammaln(x + 1.0)


def _triangle(a, b, c):
    if a + b < c or abs(a - b) > c:
        return None
    return 0.5 * (_lf(a + b - c) + _lf(a - b + c) + _lf(-a + b + c) - _lf(a + b + c + 1))


def wigner3j(j1, j2, j3, m1, m2, m3):
    """General Wigner 3j (floats; integer or half-integer arguments)."""
    if abs(m1) > j1 or abs(m2) > j2 or abs(m3) > j3 or m1 + m2 + m3 != 0:
        return 0.0
    tri = _triangle(j1, j2, j3)
    if tri is None:
        return 0.0
    pref = tri + 0.5 * (
        _lf(j1 + m1) + _lf(j1 - m1) + _lf(j2 + m2) + _lf(j2 - m2)
        + _lf(j3 + m3) + _lf(j3 - m3)
    )
    tmin = int(max(0.0, max(j2 - j3 - m1, j1 - j3 + m2)))
    tmax = int(min(j1 + j2 - j3, min(j1 - m1, j2 + m2)))
    s = 0.0
    for t in range(tmin, tmax + 1):
        denom = (
            _lf(t) + _lf(j3 - j2 + m1 + t) + _lf(j3 - j1 - m2 + t)
            + _lf(j1 + j2 - j3 - t) + _lf(j1 - m1 - t) + _lf(j2 + m2 - t)
        )
        s += (-1.0) ** t * math.exp(pref - denom)
    return (-1.0) ** int(round(j1 - j2 - m3)) * s


def wigner6j(j1, j2, j3, j4, j5, j6):
    """General Wigner 6j {j1 j2 j3; j4 j5 j6} (Racah sum)."""
    tris = [
        _triangle(j1, j2, j3),
        _triangle(j1, j5, j6),
        _triangle(j4, j2, j6),
        _triangle(j4, j5, j3),
    ]
    if any(t is None for t in tris):
        return 0.0
    pref = sum(tris)
    a1 = j1 + j2 + j3
    a2 = j1 + j5 + j6
    a3 = j4 + j2 + j6
    a4 = j4 + j5 + j3
    b1 = j1 + j2 + j4 + j5
    b2 = j2 + j3 + j5 + j6
    b3 = j3 + j1 + j6 + j4
    tmin = int(round(max(a1, a2, a3, a4)))
    tmax = int(round(min(b1, b2, b3)))
    s = 0.0
    for t in range(tmin, tmax + 1):
        num = _lf(t + 1)
        den = (
            _lf(t - a1) + _lf(t - a2) + _lf(t - a3) + _lf(t - a4)
            + _lf(b1 - t) + _lf(b2 - t) + _lf(b3 - t)
        )
        s += (-1.0) ** t * math.exp(pref + num - den)
    return s


# ---------------------------------------------------------------------------
# O2-66 rotational energies (Makarov constants, MHz -> J)
# ---------------------------------------------------------------------------
_B0, _D0, _H0 = 43100.4425, 0.145123, 3.8e-8
_XL0, _XG0 = 59501.3435, -252.58633
_XL1, _XL2 = 0.058369, 2.899e-7
_XG1, _XG2 = -2.4344e-4, -1.45e-9


def _o2_erot_raw(N, J):
    XX = N * (N + 1.0)
    xl = _XL0 + _XL1 * XX + _XL2 * XX**2
    xg = _XG0 + _XG1 * XX + _XG2 * XX**2
    C1 = _B0 * XX - _D0 * XX**2 + _H0 * XX**3
    if J < N:
        if N == 1:
            v = C1 - (xl + _B0 * (2 * N - 1) + xg * N)
        else:
            v = C1 - (xl + _B0 * (2 * N - 1) + xg * N) + math.sqrt(
                (_B0 * (2 * N - 1)) ** 2 + xl**2 - 2 * _B0 * xl
            )
    elif J > N:
        v = C1 - (xl - _B0 * (2 * N + 3) - xg * (N + 1)) - math.sqrt(
            (_B0 * (2 * N + 3)) ** 2 + xl**2 - 2 * _B0 * xl
        )
    else:
        v = C1
    return v * 1e6 * const.h  # MHz -> J


def o2_erot(N, J=None):
    """Rotational energy [J] of ground-state O2 at (N, J), rescaled so that
    erot(1, 0) = 0."""
    J = N if J is None else J
    return _o2_erot_raw(N, J) - _o2_erot_raw(1, 0)


def makarov_reduced_dipole(Ju, Jl, N):
    """(-1)^(Jl+N) sqrt(6 (2Jl+1)(2Ju+1)) {1 1 1; Jl Ju N}."""
    sign = 1.0 if (Jl + N) % 2 == 0 else -1.0
    return sign * math.sqrt(6.0 * (2 * Jl + 1) * (2 * Ju + 1)) * wigner6j(
        1.0, 1.0, 1.0, Jl, Ju, N
    )


# ---------------------------------------------------------------------------
# ECS datasets: each coefficient a T1 law (x0, n) evaluated as
# x0 (T0/T)^n; a constant has n = 0
# ---------------------------------------------------------------------------
_KAYCM_ATM = 2.99792458e10 / 101325.0  # kaycm_per_atm -> Hz/Pa

MAKAROV2020_AIR = dict(
    scaling=(1.0, 0.0), beta=(0.567, 0.0), lam=(0.39, 0.0),
    collisional_distance=0.61e-10,
)
RODRIGUES1997_N2 = dict(
    scaling=(0.0180 * _KAYCM_ATM, 0.85), beta=(0.008, 0.0),
    lam=(0.81, 0.0152), collisional_distance=2.2e-10,
)
RODRIGUES1997_O2 = dict(
    scaling=(0.0168 * _KAYCM_ATM, 0.5), beta=(0.007, 0.0),
    lam=(0.82, -0.091), collisional_distance=2.4e-10,
)
TRAN2011_CO2 = dict(
    scaling=(0.019 * _KAYCM_ATM, 0.0), beta=(0.052, 0.0),
    lam=(0.61, 0.0), collisional_distance=5.5e-10,
)


def co2_erot(J):
    """CO2-626 rotational energy B J (J + 1) [J]."""
    return 0.39021 * 2.99792458e10 * const.h * J * (J + 1.0)


def linear_reduced_dipole(Jf, Ji, lf=0.0, li=0.0, k=1.0):
    """Signed reduced dipole of a linear-molecule line."""
    sign = 1.0 if (Jf + lf + 1) % 2 == 0 else -1.0
    return sign * math.sqrt(2.0 * Jf + 1.0) * wigner3j(Jf, k, Ji, li, lf - li, -lf)


@dataclasses.dataclass(frozen=True)
class EcsBand:
    """One ECS band (single broadener), its lines sorted by importance.
    Float tensors stay float64 on any device (fixed_dtype)."""

    fixed_dtype: ClassVar[torch.dtype] = torch.float64

    f0: torch.Tensor  # [n]
    e0: torch.Tensor  # [n]
    gu: torch.Tensor  # [n]
    dip: torch.Tensor  # [n] signed transition dipole (T-independent)
    dipr: torch.Tensor  # [n] reduced dipole
    g0_x0: torch.Tensor  # [n] G0 T1 coefficients [Hz/Pa]
    g0_n: torch.Tensor  # [n]
    d0_x0: torch.Tensor  # [n] D0 T1 coefficients
    d0_n: torch.Tensor  # [n]
    t0: torch.Tensor  # reference temperature
    geo: torch.Tensor  # [n, n, NL] static Wigner geometry (direct triangle)
    mask_direct: torch.Tensor  # [n, n] bool: entry computed directly
    ni: torch.Tensor  # [n] int upper N per line (Omega factor index)
    erot_L: torch.Tensor  # [NL] rotational energies of the ECS basis
    erot_Lm2: torch.Tensor  # [NL]
    Lvals: torch.Tensor  # [NL] basis L values
    mass: torch.Tensor  # molecular mass [g/mol]
    mass_other: torch.Tensor  # perturber mass [g/mol]
    scaling: torch.Tensor  # [2] T1 law (x0, n)
    beta: torch.Tensor  # [2]
    lam: torch.Tensor  # [2]
    dc: torch.Tensor  # collisional distance [m]
    # Hartmann-type bands place the directly computed element at W[j, i],
    # Makarov's at W[i, j]
    direct_at_ji: bool = False


def ecs_band_from_numpy(d, device=None) -> EcsBand:
    """EcsBand on `device` (None: the card) from numpy arrays keyed by its
    field names (direct_at_ji a bool): floats as float64, ni as int64,
    mask_direct as bool."""
    dev, dt = resolve(device, torch.float64)
    out = {}
    for f in dataclasses.fields(EcsBand):
        a = d[f.name]
        if f.name == "direct_at_ji":
            out[f.name] = bool(a)
        elif f.name == "mask_direct":
            out[f.name] = torch.as_tensor(np.asarray(a, dtype=bool), device=dev)
        elif f.name == "ni":
            out[f.name] = torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)
        else:
            out[f.name] = torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    return EcsBand(**out)


def _law2(v):
    """(x0, n) array from a scalar (a constant) or a pair (a T1 law)."""
    a = np.asarray(v, dtype=float)
    return a if a.ndim else np.array([float(a), 0.0])


def _dipoles(lines, dipr):
    f0 = np.array([l["f0"] for l in lines])
    a = np.array([l["a"] for l in lines])
    dip = 0.5 * const.c * np.sqrt(a / (f0**3 * 2.0 * np.pi))
    return dip * np.where(dipr < 0, -1.0, 1.0)


def _importance_order(lines, dip):
    """Lines by f0 pop(T0) dip^2, descending."""
    T0 = lines[0].get("t0", 296.0)
    f0 = np.array([l["f0"] for l in lines])
    e0 = np.array([l["e0"] for l in lines])
    gu = np.array([l["gu"] for l in lines])
    pop0 = gu * np.exp(-e0 / (const.k * T0))
    return np.argsort(-(f0 * pop0 * dip**2))


def _common(lines, order, dip, dipr, ecs, mass, mass_other, erot_L, erot_Lm2, Lall):
    """The fields every band builder fills the same way, in line order."""
    pick = lambda key: np.array([lines[i][key] for i in order])
    return dict(
        f0=pick("f0"), e0=pick("e0"), gu=pick("gu"), dip=dip[order], dipr=dipr[order],
        g0_x0=np.array([lines[i]["g0"][0] for i in order]),
        g0_n=np.array([lines[i]["g0"][1] for i in order]),
        d0_x0=np.array([lines[i].get("d0", (0.0, 0.0))[0] for i in order]),
        d0_n=np.array([lines[i].get("d0", (0.0, 0.0))[1] for i in order]),
        t0=np.asarray(lines[0].get("t0", 296.0)), erot_L=erot_L, erot_Lm2=erot_Lm2,
        Lvals=Lall.astype(np.float64), mass=np.asarray(mass), mass_other=np.asarray(mass_other),
        scaling=_law2(ecs["scaling"]), beta=_law2(ecs["beta"]), lam=_law2(ecs["lam"]),
        dc=np.asarray(ecs["collisional_distance"]),
    )


def make_o2_band(lines, ecs=MAKAROV2020_AIR, mass=31.98983, mass_other=28.96, device=None):
    """EcsBand of O2-66-like lines on `device` (None: the card).

    lines: dicts with f0 [Hz], a, e0 [J], gu, Ju, Jl, Nu, Nl,
    g0=(x0, n) and optionally d0=(x0, n) T1-law broadening [Hz/Pa], t0."""
    n = len(lines)
    col = lambda key: np.array([l[key] for l in lines], dtype=float)
    Ju, Jl, Nu, Nl = col("Ju"), col("Jl"), col("Nu"), col("Nl")
    dipr = np.array([makarov_reduced_dipole(Ju[i], Jl[i], Nu[i]) for i in range(n)])
    dip = _dipoles(lines, dipr)
    order = _importance_order(lines, dip)
    Ju, Jl, Nu, Nl = (arr[order] for arr in (Ju, Jl, Nu, Nl))

    # ECS basis: L = 0 .. maxL-1 (only even L >= 2 enter the sums)
    maxL = int(2 * max(Ju.max(), Jl.max(), Nu.max(), Nl.max()) + 4)
    Lall = np.arange(maxL)
    erot_L = np.array([o2_erot(float(L)) for L in Lall])
    erot_Lm2 = np.array([o2_erot(float(L - 2)) for L in Lall])

    Si = Sf = 1.0  # O2 ground-state spin
    bk = lambda r: math.sqrt(2.0 * r + 1.0)
    geo = np.zeros((n, n, maxL))
    mask = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            # direct-computation triangle: Jl_j < Jl_i, ties to the larger
            # first index
            if not (Jl[j] < Jl[i] or (Jl[j] == Jl[i] and i > j)):
                continue
            mask[i, j] = True
            scl = ((-1.0) ** int(round(Ju[j] + Ju[i] + 1))) * bk(Nu[i]) * bk(Nl[i]) * bk(
                Nl[j]) * bk(Nu[j]) * bk(Jl[i]) * bk(Jl[j]) * bk(Ju[i]) * bk(Ju[j])
            for L in range(2, maxL, 2):
                aa = wigner3j(Nu[j], Nu[i], L, 0, 0, 0)
                if aa == 0.0:
                    continue
                bb = wigner3j(Nl[j], Nl[i], L, 0, 0, 0)
                cc = wigner6j(L, Ju[i], Ju[j], Si, Nu[j], Nu[i])
                dd = wigner6j(L, Jl[i], Jl[j], Sf, Nl[j], Nl[i])
                ee = wigner6j(L, Ju[i], Ju[j], 1.0, Jl[j], Jl[i])
                geo[i, j, L] = scl * aa * bb * cc * dd * ee * (2 * L + 1)

    return ecs_band_from_numpy(dict(
        _common(lines, order, dip, dipr, ecs, mass, mass_other, erot_L, erot_Lm2, Lall),
        geo=geo, mask_direct=mask, ni=Nu, direct_at_ji=False), device)


def make_linear_band(lines, ecs=TRAN2011_CO2, li=0.0, lf=0.0, erot_fn=co2_erot,
                     mass=43.98983, mass_other=43.98983, per_line_K=False, device=None):
    """EcsBand of a linear-molecule (CO2-like) band on `device`.

    lines: dicts with f0 [Hz], a, e0 [J], gu, Ji (upper J), Jf (lower J),
    g0=(x0, n), optionally d0, t0; li, lf the vibrational angular momenta
    of the upper and lower states.  The directly computed elements sit at
    W[j, i] (the Jf_p <= Jf triangle, ties to the larger outer index).

    per_line_K: symmetric-top mode; each line carries "K", which replaces
    l in the 3j symbols and the reduced dipole, and only lines of one K
    sub-band couple (delta K = 0), so the sum rule renormalizes within
    each sub-band."""
    n = len(lines)
    col = lambda key: np.array([l[key] for l in lines], dtype=float)
    Ji, Jf = col("Ji"), col("Jf")
    Kv = col("K") if per_line_K else None
    if per_line_K:
        dipr = np.array([linear_reduced_dipole(Jf[i], Ji[i], Kv[i], Kv[i]) for i in range(n)])
    else:
        dipr = np.array([linear_reduced_dipole(Jf[i], Ji[i], lf, li) for i in range(n)])
    dip = _dipoles(lines, dipr)
    order = _importance_order(lines, dip)
    Ji, Jf = Ji[order], Jf[order]
    if per_line_K:
        Kv = Kv[order]

    maxL = int(2 * max(Ji.max(), Jf.max()) + 4)
    Lall = np.arange(maxL)
    erot_L = np.array([erot_fn(float(L)) for L in Lall])
    erot_Lm2 = np.array([erot_fn(float(max(L - 2, 0))) if L >= 2 else erot_fn(0.0)
                         for L in Lall])

    geo = np.zeros((n, n, maxL))
    mask = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            if not (Jf[j] < Jf[i] or (Jf[j] == Jf[i] and j < i)):
                continue
            if per_line_K and Kv[j] != Kv[i]:
                continue  # delta K = 0: no coupling across sub-bands
            li_ij = Kv[i] if per_line_K else li
            lf_ij = Kv[i] if per_line_K else lf
            mask[i, j] = True
            scl = (2.0 * Ji[j] + 1.0) * math.sqrt((2.0 * Jf[i] + 1.0) * (2.0 * Jf[j] + 1.0))
            L0 = int(max(abs(Ji[i] - Ji[j]), abs(Jf[i] - Jf[j])))
            L0 += L0 % 2
            L0 = max(L0, 2)
            Lend = int(min(Ji[i] + Ji[j], Jf[i] + Jf[j]))
            for L in range(L0, min(Lend, maxL - 1) + 1, 2):
                aa = wigner3j(Ji[i], Ji[j], L, li_ij, -li_ij, 0.0)
                if aa == 0.0:
                    continue
                bb = wigner3j(Jf[i], Jf[j], L, lf_ij, -lf_ij, 0.0)
                cc = wigner6j(Ji[i], Jf[i], 1.0, Jf[j], Ji[j], L)
                geo[i, j, L] = scl * aa * bb * cc * (2 * L + 1)

    return ecs_band_from_numpy(dict(
        _common(lines, order, dip, dipr, ecs, mass, mass_other, erot_L, erot_Lm2, Lall),
        geo=geo, mask_direct=mask, ni=Ji, direct_at_ji=True), device)


# rigid-rotor B0 constants [cm^-1] of the symmetric- and spherical-top ECS
# basis energies (the IOS-limit basis rates carry no K dependence)
TOP_B0_KAYCM = {
    "NH3-4111": 9.9402,
    "PH3-1111": 4.4522,
    "CH4-211": 5.2410,
}


def _rigid_erot(B0_kaycm):
    B = B0_kaycm * 1e2 * const.c * const.h  # kayser -> J
    return lambda J: B * J * (J + 1.0)


def make_stotop_band(lines, ecs, isotope="NH3-4111", mass=17.027, mass_other=28.96,
                     device=None):
    """Symmetric-top (NH3, PH3) ECS band: per-line K sub-bands with delta K
    = 0 coupling; lines carry "K", the lower state's projection."""
    return make_linear_band(lines, ecs, erot_fn=_rigid_erot(TOP_B0_KAYCM[isotope]),
                            mass=mass, mass_other=mass_other, per_line_K=True, device=device)


def make_sphtop_band(lines, ecs, isotope="CH4-211", mass=16.031, mass_other=28.96,
                     device=None):
    """Spherical-top (CH4) ECS band: the linear-molecule geometry with
    l_i = l_f = 0."""
    return make_linear_band(lines, ecs, li=0.0, lf=0.0,
                            erot_fn=_rigid_erot(TOP_B0_KAYCM[isotope]), mass=mass,
                            mass_other=mass_other, device=device)


def _basis_QOm(band: EcsBand, T):
    """ECS basis Q(L, T) and Omega(L, T) [..., NL] at temperatures T [...];
    scaling, beta and lambda are T1 laws x0 (T0/T)^n."""
    tr = (band.t0 / T)[..., None]
    scaling = band.scaling[0] * tr ** band.scaling[1]
    beta = band.beta[0] * tr ** band.beta[1]
    lam = band.lam[0] * tr ** band.lam[1]
    L = band.Lvals
    Q = (torch.exp(-beta * band.erot_L / (const.k * T[..., None])) * scaling
         / torch.clamp(L * (L + 1.0), min=1.0) ** lam)
    wnnm2 = (band.erot_L - band.erot_Lm2) / const.h_bar
    inv_eff_mass = 1.0 / band.mass + 1.0 / band.mass_other
    vbar2 = (8.0 * const.k / (const.m_u * math.pi)) * T[..., None] * inv_eff_mass
    tauc2 = band.dc**2 / vbar2
    Om = 1.0 / (1.0 + wnnm2**2 * tauc2 / 24.0) ** 2
    return Q, Om


def _sum_rule(W, dipr, bal):
    """The sum-rule renormalization of the reference's sequential loop, out
    of place.  Step i of that loop scales column i below the diagonal by
    ratio_i = -sumup_i / sumlw_i (0 where sumlw_i = 0) and writes row i
    right of the diagonal from it by detailed balance.  Below the diagonal
    W is then its input scaled per column, so only the ratios are
    sequential: sumlw_i = sum_{k>i} dipr_k W[k, i] of the input, and
    sumup_i = dipr_i W[i, i] + sum_{k<i} dipr_k W[i, k] ratio_k
    bal[k, i], with bal[i, j] = exp((e0_i - e0_j) / kT)."""
    n = W.shape[-1]
    lower = torch.tril(W, -1)
    sumlw = (dipr[:, None] * lower).sum(-2)
    diag = torch.diagonal(W, dim1=-2, dim2=-1)
    coef = torch.tril(W * bal.mT, -1) * dipr
    ratios = []
    for i in range(n):
        up = dipr[i] * diag[..., i]
        if i:
            up = up + (coef[..., i, :i] * torch.stack(ratios, -1)).sum(-1)
        lw = sumlw[..., i]
        nz = lw != 0.0
        ratios.append(torch.where(nz, -up / torch.where(nz, lw, torch.ones_like(lw)),
                                  torch.zeros_like(lw)))
    low = lower * torch.stack(ratios, -1)[..., None, :]
    return low + low.mT * bal + torch.diag_embed(diag)


def band_matrix(band: EcsBand, T, P):
    """The band matrix at the points T, P [...] (float64 or cast to it):
    (Msym [..., n, n] complex128, d [..., n]), Msym = D (diag(f0 + D0) +
    i W) D^-1 symmetrized, D = diag(d), d = exp(-e0 / 2kT), W the
    relaxation matrix after the sum rule."""
    T = T.to(torch.float64)
    P = P.to(torch.float64)
    kT = const.k * T
    # diagonal line-shape parameters (T1 laws, pressure-scaled)
    tr = (band.t0 / T)[..., None]
    G0 = P[..., None] * band.g0_x0 * tr**band.g0_n
    D0 = P[..., None] * band.d0_x0 * tr**band.d0_n

    # off-diagonal relaxation rates; the G0 diagonal enters the sum rule,
    # which sets the pressure scale of the off-diagonals
    Qb, Om = _basis_QOm(band, T)
    contr = torch.einsum("ijl,...l->...ij", band.geo, Qb / torch.clamp(Om, min=1e-300))
    W0 = Om[..., band.ni][..., :, None] * contr * band.mask_direct
    bal = torch.exp((band.e0[:, None] - band.e0[None, :]) / kT[..., None, None])
    if band.direct_at_ji:
        # Hartmann: direct element at W[j, i], its detailed-balance partner at W[i, j]
        W = W0.mT + W0 * bal.mT + torch.diag_embed(G0)
    else:
        # Makarov: direct at W[i, j], partner W[j, i] = W[i, j] e^{(e0_j - e0_i)/kT}
        W = W0 + (W0 * bal.mT).mT + torch.diag_embed(G0)
    W = _sum_rule(W, band.dipr, bal)

    # band matrix (f0 + D0 real diagonal, i W) symmetrized by detailed balance
    M = torch.complex(torch.diag_embed(band.f0 + D0), W)
    d = torch.exp(-band.e0 / (2.0 * kT[..., None]))
    Msym = d[..., :, None] * M / d[..., None, :]
    return 0.5 * (Msym + Msym.mT), d


def ecs_absorption(f_grid, band: EcsBand, pf, iso_idx, T, P, vmr_self, iso_ratio=1.0):
    """ECS full-band absorption [..., F] [1/m] at the points T, P, vmr_self
    [...] (single broadener), on f_grid [F] or one grid per point
    [..., F], in f_grid's dtype.  pf and iso_idx give the partition
    function of the band's isotopologue."""
    dt = f_grid.dtype
    T64 = T.to(torch.float64)
    f64 = f_grid.to(torch.float64)
    kT = const.k * T64
    pop = (band.gu * torch.exp(-band.e0 / kT[..., None])
           / pf.Q(T, iso_idx).to(torch.float64)[..., None])
    Msym, d = band_matrix(band, T, P)
    vals, Qc = eig_comp_sym(Msym)

    # equivalent strengths (dip d) Q * (pop dip / d) Q, with the number
    # density folded in before any cast (raw strength / Doppler width
    # products of ~1e-36 would flush to zero in float32 far wings)
    s1 = torch.einsum("...i,...ik->...k", (band.dip * d).to(Qc.dtype), Qc)
    s2 = torch.einsum("...i,...ik->...k", (pop * band.dip / d).to(Qc.dtype), Qc)
    eqv_str = s1 * s2 * (P.to(torch.float64) / kT)[..., None]
    # equivalent Voigt lines; gamd is the Doppler HWHM
    gd_fac = torch.sqrt(const.doppler_broadening_const_squared * T64 / band.mass)
    gamd = const.sqrt_ln_2 * gd_fac[..., None] * vals.real
    z = (vals[..., :, None] - f64[..., None, :]) * (const.sqrt_ln_2 / gamd)[..., :, None]
    cdt = torch.complex64 if dt == torch.float32 else torch.complex128
    wv = wofz(z.to(cdt))
    shape = ((eqv_str / gamd).to(cdt)[..., :, None] * wv).sum(-2).real

    scl = -f64 * torch.expm1(-(const.h * f64) / kT[..., None])
    return (const.sqrt_ln_2 / const.sqrt_pi * vmr_self[..., None] * iso_ratio * scl
            * shape).to(dt)
