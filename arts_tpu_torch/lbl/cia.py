"""Collision-induced absorption (port of arts_tpu/lbl/cia.py): per species
pair, tables of the binary cross-section over temperature and frequency,
interpolated bilinearly (temperature clamped to the table, frequencies
outside it 0) and multiplied by the number densities of the two species.

The scaled form.  A binary cross-section is about 1e-70 m^5 and the
product of two number densities about 1e50 m^-6: in float32 the one is
below the smallest subnormal and the other beyond the largest finite
value.  So a dataset holds alpha_l0 = xsec * L0^2 [1/m], the pair's
absorption at Loschmidt density L0 = 101325 Pa / (k 273.15 K) of each
species (about 1e-20, formed in float64 when the dataset is built,
convert.cia_dataset_from_numpy), and the densities are taken in units of
L0: n / L0 = (p / 101325 Pa) (273.15 K / T).  The product
alpha_l0 (n1 / L0) (n2 / L0) is the same function, with every factor in
float32's range.
"""

import dataclasses

import torch

from .. import constants as const
from .._cuda import move, resolve
from ..predefined.common import gather

T_LOSCHMIDT = 273.15  # [K]
LOSCHMIDT = const.standard_pressure / (const.k * T_LOSCHMIDT)  # [1/m^3]


def locate(grid, x):
    """(i0, i1, w) of x [...] on the ascending grid [N] in float64: the
    bracketing nodes and the fraction, extrapolating linearly outside."""
    g, x = grid.double(), x.double()
    i1 = torch.clamp(torch.searchsorted(g, x.reshape(-1)).reshape(x.shape), 1, g.shape[0] - 1)
    i0 = i1 - 1
    return i0, i1, (x - g[i0]) / (g[i1] - g[i0])


@dataclasses.dataclass(frozen=True)
class CIADataset:
    """One CIA table for a species pair (spec1, spec2 index the VMR rows):
    f_grid [F0] Hz, t_grid [T0] K, alpha_l0 [T0, F0] = xsec * L0^2 [1/m]."""

    f_grid: torch.Tensor
    t_grid: torch.Tensor
    alpha_l0: torch.Tensor
    spec1: int = 0
    spec2: int = 0

    def absorption(self, f_grid, T, P, vmr):
        """alpha [..., F] [1/m] at the points T, P [...], vmr [..., S] on
        f_grid [F] or [..., F] (0 outside the table's frequencies).
        Differentiable in T, P and vmr."""
        g = self.t_grid
        ti1 = torch.clamp(torch.searchsorted(g, T.reshape(-1)).reshape(T.shape), 1,
                          g.shape[0] - 1)
        ti0 = ti1 - 1
        tw = torch.clamp((T - g[ti0]) / (g[ti1] - g[ti0]), 0.0, 1.0)[..., None]
        row = (1.0 - tw) * self.alpha_l0[ti0] + tw * self.alpha_l0[ti1]  # [..., F0]
        fi0, fi1, fw = locate(self.f_grid, f_grid)
        fw = fw.to(row.dtype)
        x = (1.0 - fw) * gather(row, fi0) + fw * gather(row, fi1)
        f64, g64 = f_grid.double(), self.f_grid.double()
        inside = (f64 >= g64[0]) & (f64 <= g64[-1])
        x = torch.where(inside, x, torch.zeros_like(x))
        n = ((P / const.standard_pressure) * (T_LOSCHMIDT / T))[..., None]  # n / L0
        return x * (n * vmr[..., self.spec1, None]) * (n * vmr[..., self.spec2, None])


def cia_absorption(datasets, f_grid, T, P, vmr, device=None, dtype=None):
    """Sum of the CIA datasets' absorption [..., F] [1/m] at the points T, P
    [...], vmr [..., S]."""
    return sum_absorption(datasets, f_grid, T, P, vmr, device, dtype)


def sum_absorption(datasets, f_grid, T, P, vmr, device=None, dtype=None):
    """Sum of the datasets' absorption(f_grid, T, P, vmr) [..., F], each
    dataset moved to the device and dtype of the call."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    f_grid, T, P, vmr = as_t(f_grid), as_t(T), as_t(P), as_t(vmr)
    shape = torch.broadcast_shapes(T.shape + (1,), P.shape + (1,), f_grid.shape)
    alpha = torch.zeros(shape, dtype=dt, device=dev)
    for ds in datasets:
        alpha = alpha + move(ds, dev, dt).absorption(f_grid, T, P, vmr)
    return alpha
