"""Carry a scene across from numpy arrays.

scene_from_numpy takes the leaves of an all-sky scene as a nested dict of
numpy arrays, so that the port computes from exactly the state another
implementation holds:

    {"atm": {"z", "t", "p", "vmr"},
     "cat": {the LineCatalog fields},
     "pf": {"t_grid", "q_grid"},
     "scatterers": [{"ext", "ssa", "g"}, ...],   # Henyey-Greenstein
     "surface_temperature": scalar,
     "surface_albedo": scalar (optional, default 0)}
"""

import numpy as np
import torch

from ._cuda import resolve
from .atm import Atmosphere1D
from .fwd_allsky import AllskyScene
from .lbl.catalog import catalog_from_arrays
from .lbl.partfun import PartFunTable
from .scattering import HenyeyGreenstein


def scene_from_numpy(d, device=None, dtype=None) -> AllskyScene:
    dev, dt = resolve(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    atm = Atmosphere1D(**{k: t(d["atm"][k]) for k in ("z", "t", "p", "vmr")})
    return AllskyScene(
        atm=atm, cat=catalog_from_arrays(d["cat"], dev, dt),
        pf=PartFunTable(t_grid=t(d["pf"]["t_grid"]), q_grid=t(d["pf"]["q_grid"])),
        scatterers=tuple(HenyeyGreenstein(**{k: t(s[k]) for k in ("ext", "ssa", "g")})
                         for s in d.get("scatterers", ())),
        surface_temperature=t(d["surface_temperature"]),
        surface_albedo=t(d.get("surface_albedo", 0.0)),
    )
