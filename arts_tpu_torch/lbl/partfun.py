"""Partition functions Q(T) per isotopologue (port of
arts_tpu/lbl/partfun.py: PartFunTable.Q and rigid_rotor_table)."""

import dataclasses

import numpy as np
import torch

from .._cuda import resolve


@dataclasses.dataclass(frozen=True)
class PartFunTable:
    """A sampled table ``t_grid`` [n_t] / ``q_grid`` [n_iso, n_t],
    interpolated linearly (the polynomial ``coeffs`` form of arts_tpu is
    not ported yet)."""

    t_grid: torch.Tensor
    q_grid: torch.Tensor

    def Q(self, T, iso_idx):
        """Q at temperatures T [...] for isotopologues iso_idx [L]:
        [..., L]."""
        t = self.t_grid
        i1 = torch.clamp(torch.searchsorted(t, T), 1, t.shape[0] - 1)
        i0 = i1 - 1
        w = (T - t[i0]) / (t[i1] - t[i0])
        q = self.q_grid[:, i0] * (1.0 - w) + self.q_grid[:, i1] * w
        return torch.movedim(q, 0, -1)[..., iso_idx]


def rigid_rotor_table(n_iso: int, q296, exponent=1.0, device=None, dtype=None):
    """Q(T) = Q296 (T/296)^exponent sampled on a 50-500 K grid."""
    dev, dt = resolve(device, dtype)
    t = np.linspace(50.0, 500.0, 451)
    q296 = np.broadcast_to(np.asarray(q296, dtype=np.float64), (n_iso,))
    q = q296[:, None] * (t[None, :] / 296.0) ** exponent
    return PartFunTable(t_grid=torch.as_tensor(t, dtype=dt, device=dev),
                        q_grid=torch.as_tensor(q, dtype=dt, device=dev))
