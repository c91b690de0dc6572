"""Partition functions Q(T) per isotopologue (port of
arts_tpu/lbl/partfun.py: PartFunTable.Q in its table and polynomial forms,
and rigid_rotor_table)."""

import dataclasses

import numpy as np
import torch

from .._cuda import resolve


@dataclasses.dataclass(frozen=True)
class PartFunTable:
    """Q(T) per isotopologue: a sampled table ``t_grid`` [n_t] /
    ``q_grid`` [n_iso, n_t], interpolated linearly, or polynomial
    coefficients ``coeffs`` [n_iso, n_coef], Q(T) = sum_k coeffs[i, k]
    T^k.  The table wins when both are given."""

    t_grid: torch.Tensor | None = None
    q_grid: torch.Tensor | None = None
    coeffs: torch.Tensor | None = None

    def Q(self, T, iso_idx):
        """Q at temperatures T [...] for isotopologues iso_idx (an index or
        an index tensor [L]): [...] or [..., L]."""
        if self.t_grid is not None:
            t = self.t_grid
            i1 = torch.clamp(torch.searchsorted(t, T), 1, t.shape[0] - 1)
            i0 = i1 - 1
            w = (T - t[i0]) / (t[i1] - t[i0])
            q = self.q_grid[:, i0] * (1.0 - w) + self.q_grid[:, i1] * w
            return torch.movedim(q, 0, -1)[..., iso_idx]
        # Horner in T, every isotopologue at once: [..., n_iso]
        T = T[..., None]
        q = self.coeffs[:, -1] * torch.ones_like(T)
        for k in range(self.coeffs.shape[-1] - 2, -1, -1):
            q = q * T + self.coeffs[:, k]
        return q[..., iso_idx]


def rigid_rotor_table(n_iso: int, q296, exponent=1.0, device=None, dtype=None):
    """Q(T) = Q296 (T/296)^exponent sampled on a 50-500 K grid."""
    dev, dt = resolve(device, dtype)
    t = np.linspace(50.0, 500.0, 451)
    q296 = np.broadcast_to(np.asarray(q296, dtype=np.float64), (n_iso,))
    q = q296[:, None] * (t[None, :] / 296.0) ** exponent
    return PartFunTable(t_grid=torch.as_tensor(t, dtype=dt, device=dev),
                        q_grid=torch.as_tensor(q, dtype=dt, device=dev))
