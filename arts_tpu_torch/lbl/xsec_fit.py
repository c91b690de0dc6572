"""HITRAN cross-section fit absorption (port of arts_tpu/lbl/xsec_fit.py):
per fitted band a frequency grid and 4 fit coefficients per frequency,
xsec = P00 + P10 T + P01 p + P20 T^2, clipped at 0, interpolated linearly
to the requested grid (positions in float64) and 0 outside the band.
"""

import dataclasses

import torch

from .. import constants as const
from ..predefined.common import gather
from .cia import locate, sum_absorption


@dataclasses.dataclass(frozen=True)
class XsecFitDataset:
    """One fitted band of one species (spec_idx indexes the VMR rows):
    f_grid [N] Hz, coeffs [N, 4] (P00, P10, P01, P20)."""

    f_grid: torch.Tensor
    coeffs: torch.Tensor
    spec_idx: int = 0

    def xsec(self, f_grid, T, P):
        """Cross-section [..., F] [m^2] at the points T, P [...] on f_grid
        [F] or [..., F] (0 outside the band)."""
        c = self.coeffs
        T, P = T[..., None], P[..., None]
        x = torch.clamp(c[:, 0] + c[:, 1] * T + c[:, 2] * P + c[:, 3] * T * T, min=0.0)
        i0, i1, w = locate(self.f_grid, f_grid)
        w = w.to(x.dtype)
        out = (1.0 - w) * gather(x, i0) + w * gather(x, i1)
        f64, g64 = f_grid.double(), self.f_grid.double()
        inside = (f64 >= g64[0]) & (f64 <= g64[-1])
        return torch.where(inside, out, torch.zeros_like(out))

    def absorption(self, f_grid, T, P, vmr):
        """alpha [..., F] [1/m] = xsec * n_species."""
        n = P / (const.k * T) * vmr[..., self.spec_idx]
        return self.xsec(f_grid, T, P) * n[..., None]


def xsec_fit_absorption(datasets, f_grid, T, P, vmr, device=None, dtype=None):
    """Sum of the fitted bands' absorption [..., F] [1/m] at the points T, P
    [...], vmr [..., S]."""
    return sum_absorption(datasets, f_grid, T, P, vmr, device, dtype)
