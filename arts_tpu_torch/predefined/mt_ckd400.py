"""MT_CKD 4.0 and 4.3 H2O continua (AER; port of
arts_tpu/predefined/mt_ckd400.py), evaluated from coefficient tables the
caller supplies (convert.mtckd_data_from_numpy).

The reference tables scaled by the radiation-field term RADFN, the
density ratio and (self) a temperature power law, 4-point XINT
interpolated onto the frequencies as a 4-neighbour gather, batched over
points.  The tables ship with arts-cat-data (predef/H2O-*ContCKDMT400.xml
and 430), which this repository does not hold.  Table positions are
formed in float64 (common.kayser).
"""

import dataclasses

import torch

from .. import constants as const
from .._cuda import move, resolve
from .common import col, gather, kayser

_RADCN2 = 1.4387752  # cm K (AER second radiation constant)


@dataclasses.dataclass(frozen=True)
class MTCKD400Data:
    """WaterData: a uniform ascending wavenumber grid [cm^-1] and its
    tables [N]; ref_press [mbar], ref_temp [K]."""

    wavenumbers: torch.Tensor
    self_absco_ref: torch.Tensor
    for_absco_ref: torch.Tensor
    self_texp: torch.Tensor
    ref_press: torch.Tensor
    ref_temp: torch.Tensor


@dataclasses.dataclass(frozen=True)
class MTCKD430Data:
    """MT_CKD 4.3 WaterData: 4.0's layout plus the foreign-closure table."""

    wavenumbers: torch.Tensor
    self_absco_ref: torch.Tensor
    for_absco_ref: torch.Tensor
    for_closure_absco_ref: torch.Tensor
    self_texp: torch.Tensor
    ref_press: torch.Tensor
    ref_temp: torch.Tensor


def _radfn(xvi, xkt):
    """RADFN_FUN, branch-free."""
    xviokt = xvi / xkt
    small = 0.5 * xviokt * xvi
    expvkt = torch.expm1(-torch.clamp(xviokt, 0.0, 50.0))
    mid = -xvi * expvkt / (2.0 + expvkt)
    out = torch.where(xviokt <= 0.01, small, torch.where(xviokt <= 10.0, mid, xvi))
    return torch.where(xkt > 0.0, out, xvi)


def _xint(p, a0, a1, a2, a3):
    """XINT_FUN 4-point interpolation."""
    C = (3.0 - 2.0 * p) * p * p
    B = 0.5 * p * (1.0 - p)
    B1 = B * (1.0 - p)
    B2 = B * p
    return -a0 * B1 + a1 * (1.0 - C + B2) + a2 * (C + B1) - a3 * B2


def _eval(f_grid, t, p_pa, vmrs, data, mode, device, dtype):
    """Shared MT_CKD 4.x evaluation (modes: self | foreign |
    foreign_closure); 4.3's scaling laws are 4.0's, and 4.3 adds the
    closure table."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    f_grid, t, p_pa, vmrh2o = as_t(f_grid), col(as_t(t)), col(as_t(p_pa)), col(as_t(vmrs["H2O"]))
    data = move(data, dev, dt)
    v = data.wavenumbers
    v64 = v.double()
    dvc = v64[1] - v64[0]
    x = kayser(f_grid)
    P0 = 1e2 * data.ref_press  # bar2pa(1e-3 * ref_press)
    T0 = data.ref_temp
    xkt = t / _RADCN2
    rho_rat = (p_pa / P0) * (T0 / t)
    num_den_cm2 = 1e-6 * vmrh2o * p_pa / (const.k * t)

    if mode == "self":
        scl_node = (data.self_absco_ref * (T0 / t) ** data.self_texp * vmrh2o * rho_rat
                    * _radfn(v, xkt))
    else:
        absco = data.for_closure_absco_ref if mode == "foreign_closure" else data.for_absco_ref
        scl_node = absco * (1.0 - vmrh2o) * rho_rat * _radfn(v, xkt)

    # 4-neighbour gather: nodes i-1, i, i+1, i+2 around x with i = floor
    n = v.shape[0]
    i = torch.clamp(torch.floor((x - v64[0]) / dvc).long(), 0, n - 2)
    pfrac = ((x - v64[i]) / dvc).to(dt)
    g = lambda off: gather(scl_node, torch.clamp(i + off, 0, n - 1))
    out = 1e2 * num_den_cm2 * _xint(pfrac, g(-1), g(0), g(1), g(2))
    inside = (x >= v64[0]) & (x <= v64[-1])
    return torch.where(inside, torch.clamp(out, min=0.0), torch.zeros_like(out))


def h2o_self_mtckd400(f_grid, t, p_pa, vmrs, data: MTCKD400Data, device=None, dtype=None):
    """H2O-SelfContCKDMT400 absorption [..., F] [1/m]."""
    return _eval(f_grid, t, p_pa, vmrs, data, "self", device, dtype)


def h2o_foreign_mtckd400(f_grid, t, p_pa, vmrs, data: MTCKD400Data, device=None,
                         dtype=None):
    """H2O-ForeignContCKDMT400 absorption [..., F] [1/m]."""
    return _eval(f_grid, t, p_pa, vmrs, data, "foreign", device, dtype)


def h2o_self_mtckd430(f_grid, t, p_pa, vmrs, data: MTCKD430Data, device=None, dtype=None):
    """H2O-SelfContCKDMT430 absorption [..., F] [1/m]."""
    return _eval(f_grid, t, p_pa, vmrs, data, "self", device, dtype)


def h2o_foreign_mtckd430(f_grid, t, p_pa, vmrs, data: MTCKD430Data, device=None,
                         dtype=None):
    """H2O-ForeignContCKDMT430 absorption [..., F] [1/m]."""
    return _eval(f_grid, t, p_pa, vmrs, data, "foreign", device, dtype)


def h2o_foreign_closure_mtckd430(f_grid, t, p_pa, vmrs, data: MTCKD430Data, device=None,
                                 dtype=None):
    """H2O-ForeignContClosureCKDMT430 absorption [..., F] [1/m]."""
    return _eval(f_grid, t, p_pa, vmrs, data, "foreign_closure", device, dtype)
