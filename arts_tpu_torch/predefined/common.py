"""Pieces shared by the predefined models: point quantities as columns
against the frequencies, constant tables on the device of a call, table
positions and line detunings of the frequencies formed in float64, and a
gather of per-node values.

Every model takes the points t, p [...] and a dict of VMRs [...] (or
floats), and f [F] or one grid per point [..., F]; it returns [..., F].
A point quantity becomes a column [..., 1], so that it broadcasts against
the frequencies [..., F] and against a line table [L] alike ([..., L]);
the line sums run over [..., F, L].
"""

import numpy as np
import torch

from .. import constants as const

_CONST = {}


def col(x):
    """A point quantity [...] as [..., 1]; a float passes as it is."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def const_like(arr, like):
    """The numpy table arr as a tensor of like's dtype on like's device,
    made once per (table, dtype, device)."""
    key = (id(arr), like.dtype, like.device)
    hit = _CONST.get(key)
    if hit is None:
        hit = _CONST[key] = (arr, torch.as_tensor(np.asarray(arr, dtype=np.float64),
                                                  dtype=like.dtype, device=like.device))
    return hit[1]


def kayser(f_grid):
    """The frequencies as wavenumbers [cm^-1] in float64: table positions
    are formed from these, so that a float32 grid finds the same node and
    the same fraction as its float64 counterpart (float32 wavenumbers near
    1e4 cm^-1 are 1e-3 cm^-1 coarse, and an index would flip at a node)."""
    return f_grid.double() / (100.0 * const.c)


def detuning(f_grid, centres):
    """f [GHz] - centres [L]: [..., F, L] in f_grid's dtype, formed in
    float64.  Float32 frequencies in GHz near 60 are 4 kHz coarse, a few
    1e-5 of a line's pressure width at 100 hPa; a shift that depends on
    the point is subtracted from this in the caller's dtype."""
    fd = f_grid.double()
    return (fd[..., None] * 1e-9 - const_like(centres, fd)).to(f_grid.dtype)


def gather(k, idx):
    """k [..., N] at the indices idx [F] or [..., F]: [..., F], the leading
    axes of k and idx broadcast."""
    if idx.dim() == 1:
        return k[..., idx]
    shape = torch.broadcast_shapes(k.shape[:-1], idx.shape[:-1])
    return torch.gather(k.expand(shape + k.shape[-1:]), -1,
                        idx.expand(shape + idx.shape[-1:]))


def at_nodes(k, idx, n):
    """gather(k, idx) with indices outside [0, n) reading 0."""
    ok = (idx >= 0) & (idx < n)
    return torch.where(ok, gather(k, idx.clamp(0, n - 1)), torch.zeros((), dtype=k.dtype,
                                                                       device=k.device))
