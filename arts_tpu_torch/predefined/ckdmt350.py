"""MT_CKD 3.50 H2O self/foreign continuum (AER; port of
arts_tpu/predefined/ckdmt350.py), with its tables.

The AER coefficient tables on a uniform wavenumber grid (-20..20000
cm^-1, 10 cm^-1 steps), temperature-interpolated (self) or RHUBC-scaled
(foreign), times the radiation-field term RADFN and the column
densities, 4-point XINT-interpolated onto the output frequencies.  The
per-node values are computed on the whole table grid at once and the
output is a 4-neighbour gather, batched over points and differentiable in
(T, p, vmr).  Table positions are formed in float64 (common.kayser).
"""

import functools
import pathlib

import numpy as np
import torch

from .common import at_nodes, col, const_like, kayser

_XLOSMT = 2.68675e19  # Loschmidt [molecules/cm^3]
_T0 = 296.0
_T1 = 273.0
_P0 = 1013.0  # [hPa]
_RADCN2 = 1.4387752  # [cm K]

# Foreign correction factors, RHUBC-II/I joint analysis (XFAC_RHU; F77
# DIMENSION -1:61 flattened to 0-based)
_XFAC_RHU = np.array([
    0.7620, 0.7840, 0.7820, 0.7840, 0.7620, 0.7410, 0.7970, 0.9140, 0.9980,
    0.9830, 0.9330, 0.8850, 0.8420, 0.8070, 0.8000, 0.8010, 0.8100, 0.8090,
    0.8320, 0.8180, 0.7970, 0.8240, 0.8640, 0.8830, 0.8830, 0.8470, 0.8380,
    0.8660, 0.9410, 1.0400, 1.0680, 1.1410, 1.0800, 1.0340, 1.1550, 1.0990,
    1.0270, 0.9500, 0.8950, 0.8150, 0.7830, 0.7700, 0.7000, 0.7650, 0.7750,
    0.8500, 0.9000, 0.9050, 0.9540, 1.0200, 1.0200, 1.0250, 1.0200, 1.1000,
    1.1250, 1.1200, 1.1110, 1.1370, 1.1600, 1.1490, 1.1070, 1.0640, 1.0450,
])


def _fscal(v, xfac, shift):
    """The foreign RHUBC/analytic scale factor per table node (FSCAL); the
    low-wavenumber table is indexed at JFAC + shift."""
    fscal = np.ones_like(v)
    low = v < 600.0
    jfac = ((v + 10.0) / 10.0 + 0.00001).astype(np.int64)
    fscal[low] = xfac[np.clip(jfac[low] + shift, 0, 62)]
    hi = ~low
    vj = v[hi]
    vdelsq1 = (vj - 255.67) ** 2
    vdelmsq1 = (vj + 255.67) ** 2
    vf1 = ((vj - 255.67) / 57.83) ** 8
    vmf1 = ((vj + 255.67) / 57.83) ** 8
    vf2 = (vj / 630.0) ** 8
    fscal[hi] = 1.0 + (
        0.06 + (-0.42) * (57600.0 / (vdelsq1 + 57600.0 + vf1)
                          + 57600.0 / (vdelmsq1 + 57600.0 + vmf1))
    ) / (1.0 + 0.3 * vf2)
    return fscal


@functools.lru_cache(maxsize=1)
def _tables():
    """(v, sl296, sl260, fh2o * FSCAL, dv) as numpy float64."""
    d = np.load(pathlib.Path(__file__).parent / "_ckdmt350_data.npz")
    v = d["v1"] + d["dv"] * np.arange(d["sl296"].shape[0])  # [cm^-1]
    return v, d["sl296"], d["sl260"], d["fh2o"] * _fscal(v, _XFAC_RHU, 1), float(d["dv"])


def _radfn(xvi, xkt):
    """RADFN_FUN, branch-free: xvi [N] nodes, xkt [..., 1]; the clip keeps
    the untaken branch finite for the gradient."""
    xviokt = xvi / xkt
    small = 0.5 * xviokt * xvi
    expvkt = torch.expm1(-torch.clamp(xviokt, 0.0, 50.0))
    mid = -xvi * expvkt / (2.0 + expvkt)
    return torch.where(xviokt <= 0.01, small, torch.where(xviokt <= 10.0, mid, xvi))


def _xint(f_grid, v0, dv, k_node, v_max):
    """4-point XINT interpolation of the per-node k [..., N] (nodes v0 + dv
    j) onto the frequencies (XINT_FUN) as a 4-neighbour gather; the node
    and its fraction from the float64 wavenumbers."""
    x = kayser(f_grid)
    n = k_node.shape[-1]
    # reference: J = int((VI - V1A)/DVA + 1.001) 1-based -> 0-based + 0.001
    j = torch.floor((x - v0) / dv + 0.001)
    p = ((x - (v0 + dv * j)) / dv).to(k_node.dtype)
    j = j.long()
    C = (3.0 - 2.0 * p) * p * p
    B = 0.5 * p * (1.0 - p)
    B1 = B * (1.0 - p)
    B2 = B * p
    g = lambda off: at_nodes(k_node, j + off, n)
    out = -g(-1) * B1 + g(0) * (1.0 - C + B2) + g(1) * (C + B1) - g(2) * B2
    inside = (x > 0.0) & (x < v_max)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


def h2o_self_ckdmt350(f_grid, t, p_pa, vmrs):
    """H2O-SelfContCKDMT350 absorption [..., F] [1/m] (compute_self_h2o)."""
    v_np, sl296_np, sl260_np, _, dv = _tables()
    v, sl296, sl260 = (const_like(a, f_grid) for a in (v_np, sl296_np, sl260_np))
    vmr, t = col(vmrs["H2O"]), col(t)
    pave = col(p_pa) * 1e-2  # [hPa]
    patm = pave / _P0
    rh2o = vmr * patm * (_T0 / t)
    tfac = (t - _T0) / (260.0 - _T0)
    wtot = _XLOSMT * (pave / 1.013e3) * (2.73e2 / t)
    w1 = vmr * wtot
    xkt = t / _RADCN2

    pos = sl296 > 0.0
    safe = torch.where(pos, sl296, torch.ones_like(sl296))
    sh2o = torch.where(pos, sl296 * (sl260 / safe) ** tfac, torch.zeros_like(sl296))
    k_node = w1 * rh2o * (sh2o * 1e-20) * _radfn(v, xkt)  # [..., N] [1/cm]
    return 1e2 * _xint(f_grid, float(v_np[0]), dv, k_node, 20000.0)


def h2o_foreign_ckdmt350(f_grid, t, p_pa, vmrs):
    """H2O-ForeignContCKDMT350 absorption [..., F] [1/m]
    (compute_foreign_h2o; the RHUBC/analytic FSCAL folded into the table)."""
    v_np, _, _, fh2o_np, dv = _tables()
    v, fh2o_scaled = const_like(v_np, f_grid), const_like(fh2o_np, f_grid)
    vmr, t = col(vmrs["H2O"]), col(t)
    pave = col(p_pa) * 1e-2
    pfrgn = (pave / _P0) * (1.0 - vmr)
    rfrgn = pfrgn * (_T0 / t)
    wtot = _XLOSMT * (pave / _P0) * (_T1 / t)
    w1 = vmr * wtot
    xkt = t / _RADCN2

    k_node = w1 * rfrgn * (fh2o_scaled * 1e-20) * _radfn(v, xkt)
    return 1e2 * _xint(f_grid, float(v_np[0]), dv, k_node, 20000.0)
