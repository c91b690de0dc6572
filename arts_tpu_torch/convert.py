"""Carry a scene or a catalog across from numpy arrays, so that the port
computes from exactly the state another implementation holds.

scene_from_numpy takes the leaves of an all-sky scene as a nested dict of
numpy arrays:

    {"atm": {"z", "t", "p", "vmr"},
     "cat": {the LineCatalog fields},
     "pf": {"t_grid", "q_grid"},
     "scatterers": [{"ext", "ssa", "g"}, ...],   # Henyey-Greenstein
     "surface_temperature": scalar,
     "surface_albedo": scalar (optional, default 0)}

clearsky_scene_from_numpy takes a clear-sky scene the same way:

    {"atm": {"z", "t", "p", "vmr", "wind" (optional)},
     "cat": {...} (optional), "pf": {"t_grid", "q_grid"} (optional),
     "surface_temperature": scalar,
     "surface_emissivity": scalar (optional, default 1),
     "nlte": {"z", "r", "cat", "up_idx", "lo_idx"} (optional)}

and zeeman_scene_from_numpy a polarized one:

    {"atm": {"z", "t", "p", "vmr", "mag"},
     "zcat": {zeeman_catalog_from_numpy's dict}, "pf": {"t_grid", "q_grid"},
     "surface_temperature": scalar,
     "surface_reflectance": scalar (optional, default 0),
     "nlte": {...} (optional)}

sensor_from_numpy a sensor's weights: {"row", "geo", "freq", "w",
"n_elements"}.  zeeman_catalog_from_numpy and
padded_zeeman_catalog_from_numpy take a Zeeman catalog and its bucketed
form the same way.
"""

import numpy as np
import torch

from ._cuda import resolve
from .atm import Atmosphere1D
from .fwd import ClearskyScene, ZeemanScene
from .fwd_allsky import AllskyScene
from .lbl.catalog import catalog_from_arrays
from .lbl.nlte import NlteField
from .lbl.partfun import PartFunTable
from .lbl.zeeman import PaddedZeemanCatalog, ZeemanCatalog
from .scattering import HenyeyGreenstein
from .sensor import SensorArray


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


def clearsky_scene_from_numpy(d, device=None, dtype=None) -> ClearskyScene:
    dev, dt = resolve(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    a = d["atm"]
    atm = Atmosphere1D(**{k: t(a[k]) for k in ("z", "t", "p", "vmr")},
                       wind=None if a.get("wind") is None else t(a["wind"]))
    return ClearskyScene(
        atm=atm,
        cat=None if d.get("cat") is None else catalog_from_arrays(d["cat"], dev, dt),
        pf=None if d.get("pf") is None else PartFunTable(t_grid=t(d["pf"]["t_grid"]),
                                                          q_grid=t(d["pf"]["q_grid"])),
        surface_temperature=t(d["surface_temperature"]),
        surface_emissivity=t(d.get("surface_emissivity", 1.0)),
        nlte=None if d.get("nlte") is None else nlte_field_from_numpy(d["nlte"], dev, dt),
    )


def nlte_field_from_numpy(d, device=None, dtype=None) -> NlteField:
    """NlteField from {"z", "r", "cat": {the LineCatalog fields}, "up_idx",
    "lo_idx"}."""
    dev, dt = resolve(device, dtype)
    ints, flts = _tensors(dev, dt)
    return NlteField(z=flts(d["z"]), r=flts(d["r"]), cat=catalog_from_arrays(d["cat"], dev, dt),
                     up_idx=ints(d["up_idx"]), lo_idx=ints(d["lo_idx"]))


def zeeman_scene_from_numpy(d, device=None, dtype=None) -> ZeemanScene:
    dev, dt = resolve(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    return ZeemanScene(
        atm=Atmosphere1D(**{k: t(d["atm"][k]) for k in ("z", "t", "p", "vmr", "mag")}),
        zcat=zeeman_catalog_from_numpy(d["zcat"], dev, dt),
        pf=PartFunTable(t_grid=t(d["pf"]["t_grid"]), q_grid=t(d["pf"]["q_grid"])),
        surface_temperature=t(d["surface_temperature"]),
        surface_reflectance=t(d.get("surface_reflectance", 0.0)),
        nlte=None if d.get("nlte") is None else nlte_field_from_numpy(d["nlte"], dev, dt),
    )


def sensor_from_numpy(d, device=None, dtype=None) -> SensorArray:
    """SensorArray from {"row", "geo", "freq", "w", "n_elements"}; rows
    sorted."""
    dev, dt = resolve(device, dtype)
    ints, flts = _tensors(dev, dt)
    return SensorArray(row=ints(d["row"]), geo=ints(d["geo"]), freq=ints(d["freq"]),
                       w=flts(d["w"]), n_elements=int(d["n_elements"]))


def _tensors(dev, dt):
    """(integer arrays -> int64 tensors, float arrays -> dt tensors) on dev."""
    ints = lambda a: torch.tensor(np.asarray(a).astype(np.int64), device=dev)
    flts = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    return ints, flts


def zeeman_catalog_from_numpy(d, device=None, dtype=None) -> ZeemanCatalog:
    """ZeemanCatalog from {"cat": {the LineCatalog fields}, "idx": [3],
    "split": [3], "strength": [3]} numpy arrays (pi, sigma-, sigma+)."""
    dev, dt = resolve(device, dtype)
    ints, flts = _tensors(dev, dt)
    return ZeemanCatalog(
        cat=catalog_from_arrays(d["cat"], dev, dt),
        idx=tuple(map(ints, d["idx"])),
        split=tuple(map(flts, d["split"])),
        strength=tuple(map(flts, d["strength"])),
    )


def padded_zeeman_catalog_from_numpy(d, device=None, dtype=None) -> PaddedZeemanCatalog:
    """PaddedZeemanCatalog from {"cat": {...}, "parent", "split",
    "strength", "polidx": one numpy array per bucket}."""
    dev, dt = resolve(device, dtype)
    ints, flts = _tensors(dev, dt)
    return PaddedZeemanCatalog(
        cat=catalog_from_arrays(d["cat"], dev, dt),
        parent=tuple(map(ints, d["parent"])),
        split=tuple(map(flts, d["split"])),
        strength=tuple(map(flts, d["strength"])),
        polidx=tuple(map(ints, d["polidx"])),
    )
