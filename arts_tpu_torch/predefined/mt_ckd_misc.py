"""MT_CKD 2.52 / 1.00 band models (port of
arts_tpu/predefined/mt_ckd_misc.py): the CO2 continuum, the O2 visible
and near-IR CIA bands, and the N2 fundamental and rotational CIA bands,
with their tables (_mt_ckd_misc_data.npz, public AER model data).

The 2.52-family models reproduce the reference's cursor linear
interpolation (lerp(k[J], k[J+1], 1 + (V - VJ)/DVC) with VJ the first
lattice node >= V, its one-node-up quirk included); the 1.00-family
models use the 4-point XINT of ckdmt350.  O2-v1v0 evaluates its analytic
band on the band-anchored lattice (9100..11000 cm^-1 at 2 cm^-1), as the
JAX package does, rather than the reference's frequency-anchored window;
the difference is interpolation error of a smooth band, < 1e-5 relative.
Table positions are formed in float64 (common.kayser).
"""

import functools
import pathlib

import numpy as np
import torch

from .ckdmt350 import _radfn, _xint
from .common import at_nodes, col, const_like, kayser

_XLOSMT = 2.686763e19  # Loschmidt [molecules/cm^3]
_T1 = 273.0
_T0 = 296.0
_P0 = 1013.0  # [hPa]
_RADCN2 = 1.4387752


@functools.lru_cache(maxsize=1)
def _tables():
    """The raw tables and the static per-node arrays, numpy float64."""
    d = np.load(pathlib.Path(__file__).parent / "_mt_ckd_misc_data.npz")
    tab = {k: d[k] for k in d.files}
    # CO2: raw[i] at v = -4 + 2 i; the v3-bandhead temperature exponent
    # (raw i in [1195, 1219]) and the mt_ckd_2.5 Xfac, 2000 < v < 2998
    n = tab["fco2"].shape[0]
    e = np.zeros(n)
    e[1195:1220] = tab["tdep_bandhead"]
    vnp = -4.0 + 2.0 * np.arange(n)
    xfac = np.ones(n)
    sel = (vnp > 2000.0) & (vnp < 2998.0)
    jfac = ((vnp[sel] - 1998.0) / 2.0 + 0.00001).astype(np.int64)
    xfac[sel] = tab["xfac_co2"][jfac - 1]
    tab.update(co2_v=vnp, co2_e=e, co2_has_e=(e != 0.0).astype(np.float64), co2_xfac=xfac)
    # O2 visible: raw[i] at v = 15000 + 10 i
    v = 15000.0 + 10.0 * np.arange(tab["o2_vis"].shape[0])
    tab.update(vis_v=v, vis_co=tab["o2_vis"] / v)
    # N2 fundamental: raw[i] at v = v1 + dv i
    tab["n2f_v"] = 2001.766357 + 3.981461525 * np.arange(tab["n2f"].shape[0])
    # N2 rotational: raw[i] at v = -10 + 5 i; i in [0, 72] is read
    for k in ("n2r_ct296", "n2r_sf296", "n2r_ct220", "n2r_sf220"):
        tab[k + "_73"] = np.ascontiguousarray(tab[k][:73])
    tab["n2r_v"] = -10.0 + 5.0 * np.arange(73)
    # O2 CIA and v0v0: 1-based raw with a pad
    tab["o2f_1"], tab["o2ft_1"] = tab["o2f"][1:], tab["o2ft"][1:]
    tab["o2f_v"] = 1340.0 + 5.0 * np.arange(tab["o2f_1"].shape[0])
    tab["o2_00_1"] = tab["o2_00"][1:]
    tab["o2_00_v"] = 7536.0 + 2.0 * np.arange(tab["o2_00_1"].shape[0])
    tab["o2_00_co"] = tab["o2_00_1"] / tab["o2_00_v"]
    # O2 v1v0: the analytic two-oscillator band on its lattice
    v = 9100.0 + 2.0 * np.arange(int((11000.0 - 9100.0) / 2.0) + 1)
    dv1, dv2 = v - 9375.0, v - 9439.0
    damp1 = np.where(dv1 < 0.0, np.exp(dv1 / 176.1), 1.0)
    damp2 = np.where(dv2 < 0.0, np.exp(dv2 / 176.1), 1.0)
    o2inf = 0.31831 * ((1.166e-4 * damp1 / 58.96) / (1.0 + (dv1 / 58.96) ** 2)
                       + (3.086e-5 * damp2 / 45.04) / (1.0 + (dv2 / 45.04) ** 2)) * 1.054
    c = o2inf / v
    tab.update(v1v0_v=v, v1v0_c=np.where(c > 0.0, c, 0.0))
    return tab


def _t(name, like):
    return const_like(_tables()[name], like)


def _lerp_cursor(f_grid, v0, dv, k_node, lo, hi):
    """The 2.52 cursor interpolation, vectorized: for each V take the first
    lattice node VJ >= V and evaluate lerp(k[J], k[J+1], 1 + (V - VJ)/dv).
    Nodes outside the table read 0 and the lerp still runs: the reference
    windows the table into a zero-initialized array one step wider on
    each side, so the last half-interval below `hi` interpolates toward
    an implicit 0 at v_max + dv."""
    x = kayser(f_grid)
    n = k_node.shape[-1]
    i = torch.ceil((x - v0) / dv)  # first node >= V
    t = (1.0 + (x - (v0 + dv * i)) / dv).to(k_node.dtype)
    i = i.long()
    a = at_nodes(k_node, i, n)
    b = at_nodes(k_node, i + 1, n)
    out = a + t * (b - a)
    inside = (x > lo) & (x < hi)
    return torch.where(inside, out, torch.zeros((), dtype=out.dtype, device=out.device))


def co2_ckdmt252(f_grid, t, p_pa, vmrs):
    """CO2-CKDMT252 continuum [..., F] [1/m] (carbon_dioxide)."""
    c = lambda name: _t(name, f_grid)
    fco2, e, v = c("fco2"), c("co2_e"), c("co2_v")
    t = col(t)
    fco2 = torch.where(c("co2_has_e") > 0, (t / 246.0) ** e * fco2, fco2)
    fco2 = fco2 * c("co2_xfac")

    pave = col(p_pa) * 1e-2
    rhoave = (pave / _P0) * (_T0 / t)
    wtot = _XLOSMT * (pave / _P0) * (_T1 / t)
    xkt = t / _RADCN2
    k_node = wtot * rhoave * (fco2 * 1e-20) * _radfn(v, xkt)
    n = fco2.shape[-1]
    return col(vmrs["CO2"]) * 1e2 * _lerp_cursor(f_grid, -4.0, 2.0, k_node, 0.0,
                                                 -4.0 + 2.0 * (n - 1))


def o2_vis_ckdmt252(f_grid, t, p_pa, vmrs):
    """O2-visCKDMT252 [..., F] [1/m] (oxygen_vis, Greenblatt 1990)."""
    v, co = _t("vis_v", f_grid), _t("vis_co", f_grid)
    t = col(t)
    pave = col(p_pa) * 1e-2
    wtot = 1e-20 * _XLOSMT * (pave / _P0) * (_T1 / t)
    tau_fac = wtot * (pave / _P0) * (_T1 / t)
    factor = 1.0 / (_XLOSMT * 1e-20 * (55.0 * 273.0 / 296.0) ** 2 * 89.5)
    xkt = t / _RADCN2
    k_node = co * factor * tau_fac * _radfn(v, xkt)
    return col(vmrs["O2"]) * 1e2 * _lerp_cursor(f_grid, 15000.0, 10.0, k_node,
                                                15000.0, 29870.0)


def n2_fun_ckdmt252(f_grid, t, p_pa, vmrs):
    """N2-CIAfunCKDMT252 [..., F] [1/m] (nitrogen_fun, Lafferty 1996)."""
    xn2, xn2t, v = (_t(k, f_grid) for k in ("n2f", "n2ft", "n2f_v"))
    v1, dv, v2 = 2001.766357, 3.981461525, 2710.45
    n2 = col(vmrs["N2"])
    o2, h2o = col(vmrs.get("O2", 0.0)), col(vmrs.get("H2O", 0.0))
    t = col(t)
    pave = col(p_pa) * 1e-2
    wtot = _XLOSMT * (pave / _P0) * (_T1 / t)
    tau_fac = wtot * (pave / _P0) * (_T1 / t)
    a_o2 = 1.294 - 0.4545 * t / 296.0
    xktfac = ((1.0 / t) - (1.0 / 272.0)) / ((1.0 / 228.0) - (1.0 / 272.0))
    xt_lin = (t - 272.0) / (228.0 - 272.0)
    factor = (1.0 / _XLOSMT) * (n2 + a_o2 * o2 + 1.0 * h2o)
    both = (xn2 > 0.0) & (xn2t > 0.0)
    safe = torch.where(both, xn2, torch.ones_like(xn2))
    c0 = torch.where(both, factor * xn2 * (xn2t / safe) ** xktfac / v,
                     factor * (xn2 + (xn2t - xn2) * xt_lin) / v)
    xkt = t / _RADCN2
    k_node = tau_fac * c0 * _radfn(v, xkt)
    return n2 * 1e2 * _lerp_cursor(f_grid, v1, dv, k_node, v1, v2)


def n2_rot_ckdmt252(f_grid, t, p_pa, vmrs):
    """N2-CIArotCKDMT252 [..., F] [1/m] (nitrogen_rot, Borysow-Frommhold
    with O2 scale factors)."""
    c296, sf296, c220, sf220, v = (_t(k, f_grid) for k in (
        "n2r_ct296_73", "n2r_sf296_73", "n2r_ct220_73", "n2r_sf220_73", "n2r_v"))
    n2 = col(vmrs["N2"])
    o2, h2o = col(vmrs.get("O2", 0.0)), col(vmrs.get("H2O", 0.0))
    t = col(t)
    pave = col(p_pa) * 1e-2
    facfac = n2 * (pave / _P0) ** 2 * (_T1 / t) ** 2
    tfac = (t - _T0) / (220.0 - _T0)
    both = (c296 > 0.0) & (c220 > 0.0)
    safe_c = torch.where(both, c296, torch.ones_like(c296))
    safe_sf = torch.where(both, sf296, torch.ones_like(sf296))
    cmix = c296 * (c220 / safe_c) ** tfac
    sf = (sf296 * (sf220 / safe_sf) ** tfac - 1.0) * (0.79 / 0.21)
    sn2 = torch.where(both, facfac * cmix * (n2 + sf * o2 + h2o), torch.zeros_like(cmix))
    xkt = t / _RADCN2
    k_node = sn2 * _radfn(v, xkt)
    return n2 * 1e2 * _lerp_cursor(f_grid, -10.0, 5.0, k_node, 0.0, 350.0)


def o2_cia_ckdmt100(f_grid, t, p_pa, vmrs):
    """O2-CIAfunCKDMT100 [..., F] [1/m] (oxygen_cia)."""
    xo2, xo2t, v = (_t(k, f_grid) for k in ("o2f_1", "o2ft_1", "o2f_v"))
    t = col(t)
    pave = col(p_pa) * 1e-2
    wtot = _XLOSMT * (pave / _P0) * (_T1 / t)
    tau_fac = wtot * (pave / _P0) * (_T1 / t)
    xktfac = (1.0 / _T0) - (1.0 / t)
    factor = 1.0 / _XLOSMT
    c0 = torch.where(xo2 > 0.0, factor * xo2 * torch.exp(xo2t * xktfac) / v,
                     torch.zeros_like(xo2))
    xkt = t / _RADCN2
    k_node = tau_fac * c0 * _radfn(v, xkt)
    out = 1e2 * _xint(f_grid, 1340.0, 5.0, k_node, 1850.0)
    return col(vmrs["O2"]) * torch.where(kayser(f_grid) > 1340.0, out, torch.zeros_like(out))


def o2_v0v0_ckdmt100(f_grid, t, p_pa, vmrs):
    """O2-v0v0CKDMT100 [..., F] [1/m] (oxygen_v0v0, Mate 1999)."""
    co, v = _t("o2_00_co", f_grid), _t("o2_00_v", f_grid)
    o2, n2 = col(vmrs["O2"]), col(vmrs.get("N2", 0.0))
    t = col(t)
    pave = col(p_pa) * 1e-2
    adjwo2 = (o2 + 0.3 * n2) / 0.446 * (pave / _P0) ** 2 * (_T1 / t) ** 2
    so2 = torch.where(co > 0.0, adjwo2 * co, torch.zeros_like(co))
    xkt = t / _RADCN2
    k_node = so2 * _radfn(v, xkt)
    out = 1e2 * _xint(f_grid, 7536.0, 2.0, k_node, 8500.0)
    return o2 * torch.where(kayser(f_grid) > 7536.0, out, torch.zeros_like(out))


def o2_v1v0_ckdmt100(f_grid, t, p_pa, vmrs):
    """O2-v1v0CKDMT100 [..., F] [1/m] (oxygen_v0v1, Mlawer 1998): the
    analytic two-oscillator near-IR band, evaluated on the band lattice."""
    c, v = _t("v1v0_c", f_grid), _t("v1v0_v", f_grid)
    o2, t = col(vmrs["O2"]), col(t)
    pave = col(p_pa) * 1e-2
    wtot = 1e-20 * _XLOSMT * (pave / _P0) * (_T1 / t)
    adjwo2 = (o2 / 0.209) * wtot * (pave / _P0) * (_T0 / t)
    xkt = t / _RADCN2
    k_node = adjwo2 * c * _radfn(v, xkt)
    out = 1e2 * _xint(f_grid, 9100.0, 2.0, k_node, 11000.0)
    return o2 * torch.where(kayser(f_grid) > 9100.0, out, torch.zeros_like(out))
