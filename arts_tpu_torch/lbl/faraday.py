"""Faraday rotation by free electrons (port of arts_tpu/lbl/faraday.py),
after ARTS's spectral_propmatAddFaraday: the U component of the
propagation matrix gains n_e 2 FRconst (B . k) / f^2 with
FRconst = |e^3 / (8 pi^2 c eps0 m_e^2)|.  On the tensors' device;
differentiable by autograd.
"""

import math

import torch

from .. import constants as const

ELECTRON_MASS = 9.1093837015e-31  # [kg]
VACUUM_PERMITTIVITY = 8.8541878128e-12  # [F/m]

FRCONST = abs(const.e**3 / (8.0 * math.pi**2 * const.c * VACUUM_PERMITTIVITY
                            * ELECTRON_MASS**2))


def faraday_propmat_u(f_grid, n_e, mag, los_za_deg, los_aa_deg=0.0):
    """U component [1/m] of the Faraday propagation matrix: electron
    density n_e [1/m^3], field mag [..., 3] (east, north, up) [T] and the
    propagation direction's angles [deg] (its unit vector k directly; ARTS
    mirrors the line of sight to the same direction)."""
    za = torch.deg2rad(torch.as_tensor(los_za_deg, dtype=mag.dtype, device=mag.device))
    aa = torch.deg2rad(torch.as_tensor(los_aa_deg, dtype=mag.dtype, device=mag.device))
    khat = torch.stack(torch.broadcast_tensors(torch.sin(za) * torch.sin(aa),
                                               torch.sin(za) * torch.cos(aa), torch.cos(za)),
                       -1)
    b_par = (mag * khat).sum(-1)
    c1 = 2.0 * FRCONST * b_par
    return n_e * c1 / (f_grid * f_grid)


def add_faraday(propmat, f_grid, n_e, mag, los_za_deg, los_aa_deg=0.0):
    """A packed [..., F, 7] propagation matrix with Faraday rotation added
    to its U component (index 4); a new tensor."""
    u = faraday_propmat_u(f_grid, n_e, mag, los_za_deg, los_aa_deg)
    return torch.cat([propmat[..., :4], (propmat[..., 4] + u)[..., None], propmat[..., 5:]], -1)
