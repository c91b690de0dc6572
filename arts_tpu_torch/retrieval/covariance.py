"""Dense covariance-matrix builders for small state vectors (port of
arts_tpu/retrieval/covariance.py).  They return float64 tensors on the
CPU; oem() moves them to its device."""

import numpy as np
import torch


def diagonal(sd):
    """Diagonal covariance from per-element standard deviations."""
    sd = torch.as_tensor(np.asarray(sd, dtype=np.float64))
    return torch.diag(sd * sd)


def _correlated(grid, sd, corr):
    g = np.asarray(grid, dtype=np.float64)
    d = np.abs(g[:, None] - g[None, :])
    sd = np.broadcast_to(np.asarray(sd, dtype=np.float64), g.shape)
    return torch.as_tensor(np.outer(sd, sd) * corr(d))


def exponential(grid, sd, corr_length):
    """exp(-|dz|/l) correlated covariance on a spatial grid."""
    return _correlated(grid, sd, lambda d: np.exp(-d / corr_length))


def gaussian(grid, sd, corr_length):
    """exp(-(dz/l)^2) correlated covariance."""
    return _correlated(grid, sd, lambda d: np.exp(-((d / corr_length) ** 2)))


def block_diag(*blocks):
    """Per-target covariance blocks stacked into the full S_a."""
    return torch.block_diag(*(torch.as_tensor(np.asarray(b, dtype=np.float64))
                              for b in blocks))
