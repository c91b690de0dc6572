"""US-Standard-1976 atmosphere (port of arts_tpu/atm/standard.py, US-76
temperature structure and the analytic trace-gas profiles only)."""

import numpy as np
import torch

from .._cuda import resolve
from .field import Atmosphere1D, hydrostatic_pressure

# US Standard Atmosphere 1976 layer structure: (base z [m], lapse [K/m])
_US76_LAYERS = [
    (0.0, -6.5e-3),
    (11e3, 0.0),
    (20e3, 1.0e-3),
    (32e3, 2.8e-3),
    (47e3, 0.0),
    (51e3, -2.8e-3),
    (71e3, -2.0e-3),
    (84.852e3, 0.0),
]
_T0 = 288.15
_P0 = 101325.0


def us76_temperature(z):
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    t = np.full_like(z, _T0)
    tb = _T0
    for i, (zb, lr) in enumerate(_US76_LAYERS):
        zt = _US76_LAYERS[i + 1][0] if i + 1 < len(_US76_LAYERS) else 1e9
        seg = (z >= zb) & (z < zt)
        t[seg] = tb + lr * (z[seg] - zb)
        tb = tb + lr * (zt - zb) if zt < 1e9 else tb
    t[z >= _US76_LAYERS[-1][0]] = 186.87
    return t


def standard_atmosphere(n_levels=101, z_top=100e3,
                        species=("N2", "O2", "H2O", "CO2", "O3"),
                        device=None, dtype=None):
    """US-Standard-like Atmosphere1D with the requested species rows."""
    dev, dt = resolve(device, dtype)
    z = np.linspace(0.0, z_top, n_levels)
    t = us76_temperature(z)
    h2o = np.clip(0.02 * np.exp(-z / 2.2e3) + 3e-6, 3e-6, 0.035)
    o3 = 8e-6 * np.exp(-0.5 * ((z - 25e3) / 9e3) ** 2) + 3e-8
    co2 = np.full_like(z, 4.2e-4)
    dry = 1.0 - h2o - o3 - co2
    table = {
        "N2": 0.7808 / (0.7808 + 0.2095) * dry,
        "O2": 0.2095 / (0.7808 + 0.2095) * dry,
        "H2O": h2o, "CO2": co2, "O3": o3,
    }
    vmr = np.stack([table[s] for s in species])
    as_t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    zt, tt = as_t(z), as_t(t)
    return Atmosphere1D(z=zt, t=tt, p=hydrostatic_pressure(zt, tt, _P0),
                        vmr=as_t(vmr))
