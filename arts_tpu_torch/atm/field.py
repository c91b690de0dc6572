"""1D atmosphere on an ascending altitude grid (port of arts_tpu/atm/field.py).

t, vmr, the magnetic field and the wind interpolate linearly in altitude, p
log-linearly, clamped at the grid ends.  Any leading shape of the query
altitudes is kept.
"""

import dataclasses

import torch

from .. import constants as const


@dataclasses.dataclass(frozen=True)
class AtmPointData:
    t: torch.Tensor  # [...] temperature [K]
    p: torch.Tensor  # [...] pressure [Pa]
    vmr: torch.Tensor  # [..., S] volume mixing ratios
    mag: torch.Tensor  # [..., 3] magnetic field (u=E, v=N, w=Up) [T]
    wind: torch.Tensor  # [..., 3] wind (u=E, v=N, w=Up) [m/s]


@dataclasses.dataclass(frozen=True)
class Atmosphere1D:
    z: torch.Tensor  # [N] altitude [m], ascending
    t: torch.Tensor  # [N]
    p: torch.Tensor  # [N]
    vmr: torch.Tensor  # [S, N]
    mag: torch.Tensor | None = None  # [3, N] magnetic field [T]; None = 0
    wind: torch.Tensor | None = None  # [3, N] wind [m/s]; None = 0

    def at(self, alt) -> AtmPointData:
        z = self.z
        i1 = torch.clamp(torch.searchsorted(z, alt), 1, z.shape[0] - 1)
        i0 = i1 - 1
        w = torch.clamp((alt - z[i0]) / (z[i1] - z[i0]), 0.0, 1.0)

        def lin(f):
            return f[..., i0] * (1.0 - w) + f[..., i1] * w

        t = lin(self.t)
        vec = lambda f: (t.new_zeros(t.shape + (3,)) if f is None
                         else torch.movedim(lin(f), 0, -1))
        return AtmPointData(
            t=t,
            p=torch.exp(lin(torch.log(self.p))),
            vmr=torch.movedim(lin(self.vmr), 0, -1),
            mag=vec(self.mag),
            wind=vec(self.wind),
        )


def hydrostatic_pressure(z, t, p0):
    """Hydrostatic p(z) of dry air from T(z) and the surface pressure;
    gravity decays as g0 (R/(R+z))^2 with the Earth's mean radius R."""
    g0, radius = const.standard_gravity, 6.371e6
    m = 28.9647 * 1e-3 / const.NA  # mean molecule mass of dry air [kg]
    zbar = 0.5 * (z[1:] + z[:-1])
    g = g0 * (radius / (radius + zbar)) ** 2
    tbar = 0.5 * (t[1:] + t[:-1])
    dlnp = -m * g * (z[1:] - z[:-1]) / (const.k * tbar)
    lnp = torch.cat([torch.zeros(1, dtype=t.dtype, device=t.device),
                     torch.cumsum(dlnp, 0)])
    return p0 * torch.exp(lnp)
