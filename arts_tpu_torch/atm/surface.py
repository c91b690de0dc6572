"""Surface property fields on a (lat, lon) grid (port of
arts_tpu/atm/surface.py, after ARTS's SurfaceField): temperature,
elevation and emissivity, each [NLat, NLon], evaluated bilinearly and
clamped at the grid's edges; a constant field is a 1 x 1 grid."""

import dataclasses

import torch

from .._cuda import resolve, tensor


@dataclasses.dataclass(frozen=True)
class SurfaceField:
    """Surface properties on ascending lat [NLat] and lon [NLon] grids
    [deg]."""

    lat: torch.Tensor
    lon: torch.Tensor
    temperature: torch.Tensor  # [NLat, NLon] [K]
    elevation: torch.Tensor  # [NLat, NLon] [m]
    emissivity: torch.Tensor  # [NLat, NLon]

    @classmethod
    def constant(cls, temperature=288.0, elevation=0.0, emissivity=1.0, device=None,
                 dtype=None):
        """A field of the same properties everywhere (1 x 1 grids)."""
        dev, dt = resolve(device, dtype)
        one = lambda v: tensor(v, dev, dt).reshape(1, 1)
        zero = torch.zeros(1, dtype=dt, device=dev)
        return cls(lat=zero, lon=zero.clone(), temperature=one(temperature),
                   elevation=one(elevation), emissivity=one(emissivity))

    def at(self, lat, lon):
        """{"temperature", "elevation", "emissivity"} at the points (lat,
        lon) [deg] (broadcast): bilinear, clamped at the grid's edges."""
        t = lambda x: tensor(x, self.lat.device, self.lat.dtype)
        lat, lon = torch.broadcast_tensors(t(lat), t(lon))

        def locate(grid, x):
            if grid.shape[0] == 1:
                z = torch.zeros(x.shape, dtype=torch.long, device=x.device)
                return z, z, torch.zeros_like(x)
            i1 = torch.clamp(torch.searchsorted(grid, x.contiguous()), 1, grid.shape[0] - 1)
            i0 = i1 - 1
            return i0, i1, torch.clamp((x - grid[i0]) / (grid[i1] - grid[i0]), 0.0, 1.0)

        ia0, ia1, wa = locate(self.lat, lat)
        io0, io1, wo = locate(self.lon, lon)

        def bil(f):
            return (1 - wa) * ((1 - wo) * f[ia0, io0] + wo * f[ia0, io1]) + wa * (
                (1 - wo) * f[ia1, io0] + wo * f[ia1, io1])

        return dict(temperature=bil(self.temperature), elevation=bil(self.elevation),
                    emissivity=bil(self.emissivity))
