"""MT_CKD 3.20 H2O self/foreign continuum (AER; port of
arts_tpu/predefined/ckdmt320.py), with its tables.

Unlike 3.50, the 3.20 self continuum applies static correction factors
(XFACREV in 820-960 cm^-1, the MT_CKD 2.4 microwave term and the MT_CKD
3.0 RHUBC-II term); the foreign RHUBC table differs in its first entries
and is indexed without the +1 shift 3.50 uses.  Shares RADFN and XINT
with ckdmt350.
"""

import functools
import pathlib

import numpy as np
import torch

from .ckdmt350 import _P0, _RADCN2, _T0, _T1, _XLOSMT, _fscal, _radfn, _xint
from .common import col, const_like

# XFACREV self-continuum window correction, 820-960 cm^-1 (CKDMT320.cc:59-74)
_XFACREV = np.array([
    1.003, 1.009, 1.015, 1.023, 1.029, 1.033, 1.037, 1.039, 1.040, 1.046,
    1.036, 1.027, 1.01, 1.002, 1.00,
])

# Foreign correction factors (CKDMT320.cc:1411-1418); first entries differ
# from the 3.50 table, and the lookup is XFAC_RHU[JFAC] (no +1)
_XFAC_RHU_320 = np.array([
    0.7810, 0.8330, 0.8500, 0.8330, 0.7810, 0.7540, 0.8180, 0.9140, 0.9980,
    0.9830, 0.9330, 0.8850, 0.8420, 0.8070, 0.8000, 0.8010, 0.8100, 0.8090,
    0.8320, 0.8180, 0.7970, 0.8240, 0.8640, 0.8830, 0.8830, 0.8470, 0.8380,
    0.8660, 0.9410, 1.0400, 1.0680, 1.1410, 1.0800, 1.0340, 1.1550, 1.0990,
    1.0270, 0.9500, 0.8950, 0.8150, 0.7830, 0.7700, 0.7000, 0.7650, 0.7750,
    0.8500, 0.9000, 0.9050, 0.9540, 1.0200, 1.0200, 1.0250, 1.0200, 1.1000,
    1.1250, 1.1200, 1.1110, 1.1370, 1.1600, 1.1490, 1.1070, 1.0640, 1.0450,
])


@functools.lru_cache(maxsize=1)
def _tables():
    """(v, sl296, sl260, SFAC, fh2o * FSCAL, dv) as numpy float64."""
    d = np.load(pathlib.Path(__file__).parent / "_ckdmt320_data.npz")
    v = d["v1"] + d["dv"] * np.arange(d["sl296"].shape[0])  # [cm^-1]

    # static self-continuum SFAC per table node
    sfac = np.ones_like(v)
    win = (v >= 820.0) & (v <= 960.0)
    jfac = ((v - 820.0) / 10.0 + 0.00001).astype(np.int64)
    sfac[win] = _XFACREV[np.clip(jfac[win], 0, 14)]
    sfac *= 1.0 + 0.25 / (1.0 + (v / 350.0) ** 6)
    sfac *= 1.0 + 0.08 / (1.0 + (v / 40.0) ** 6)
    return (v, d["sl296"], d["sl260"], sfac, d["fh2o"] * _fscal(v, _XFAC_RHU_320, 0),
            float(d["dv"]))


def h2o_self_ckdmt320(f_grid, t, p_pa, vmrs):
    """H2O-SelfContCKDMT320 absorption [..., F] [1/m] (compute_self_h2o)."""
    v_np, sl296_np, sl260_np, sfac_np, _, dv = _tables()
    v, sl296, sl260, sfac = (const_like(a, f_grid) for a in (v_np, sl296_np, sl260_np,
                                                               sfac_np))
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
    sh2o = torch.where(pos, sfac * sl296 * (sl260 / safe) ** tfac, torch.zeros_like(sl296))
    k_node = w1 * rh2o * (sh2o * 1e-20) * _radfn(v, xkt)  # [..., N] [1/cm]
    return 1e2 * _xint(f_grid, float(v_np[0]), dv, k_node, 20000.0)


def h2o_foreign_ckdmt320(f_grid, t, p_pa, vmrs):
    """H2O-ForeignContCKDMT320 absorption [..., F] [1/m]
    (compute_foreign_h2o; the RHUBC/analytic FSCAL folded into the table)."""
    v_np, _, _, _, fh2o_np, dv = _tables()
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
