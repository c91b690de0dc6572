"""Carry a scene or a catalog across from numpy arrays, so that the port
computes from exactly the state another implementation holds.

scene_from_numpy takes the leaves of an all-sky scene as a nested dict of
numpy arrays:

    {"atm": {"z", "t", "p", "vmr"},
     "cat": {the LineCatalog fields} (optional),
     "pf": {"t_grid", "q_grid"} (optional),
     "scatterers": [{"ext", "ssa", "g"}, ...],   # Henyey-Greenstein
     "surface_temperature": scalar,
     "surface_albedo": scalar (optional, default 0),
     "predef": (model names) and "species_names": (the rows of vmr)
     (optional; the predefined absorption models)}

clearsky_scene_from_numpy takes a clear-sky scene the same way:

    {"atm": {"z", "t", "p", "vmr", "wind" (optional)},
     "cat": {...} (optional), "pf": {"t_grid", "q_grid"} (optional),
     "surface_temperature": scalar,
     "surface_emissivity": scalar (optional, default 1),
     "nlte": {"z", "r", "cat", "up_idx", "lo_idx"} (optional),
     "predef", "species_names" (optional, as above),
     "ecs_bands": [(band, spec_idx, iso_idx, iso_ratio), ...] (optional;
     band ecs_band_from_numpy's dict)}

and zeeman_scene_from_numpy a polarized one:

    {"atm": {"z", "t", "p", "vmr", "mag"},
     "zcat": {zeeman_catalog_from_numpy's dict}, "pf": {"t_grid", "q_grid"},
     "surface_temperature": scalar,
     "surface_reflectance": scalar (optional, default 0),
     "nlte": {...} (optional)}

sensor_from_numpy a sensor's weights: {"row", "geo", "freq", "w",
"n_elements"}.  ecs_band_from_numpy an ECS line-mixing band: its fields
(lbl.ecs.EcsBand) as numpy arrays and direct_at_ji as a bool, kept in
float64 whatever the dtype.  zeeman_catalog_from_numpy and
padded_zeeman_catalog_from_numpy take a Zeeman catalog and its bucketed
form the same way.  cia_dataset_from_numpy, xsec_fit_dataset_from_numpy,
lookup_table_from_numpy and mtckd_data_from_numpy take the absorption
datasets: a CIA table, a cross-section fit, a lookup table and the
MT_CKD 4.x water tables, each as a dict of its fields.  sun_from_numpy
takes a sun ({"spectrum", "radius", "distance", "latitude", "longitude"},
the geometry optional), surface_field_from_numpy a surface field ({"lat",
"lon", "temperature", "elevation", "emissivity"}) and
subsurface_field_from_numpy a subsurface field ({"depth", "t",
"absorption", "ssa" and "g" optional}).
"""

import dataclasses

import numpy as np
import torch

from ._cuda import resolve
from .atm import Atmosphere1D
from .atm.subsurface import SubsurfaceField
from .atm.surface import SurfaceField
from .fwd import ClearskyScene, ZeemanScene
from .fwd_allsky import AllskyScene
from .lbl.catalog import catalog_from_arrays
from .lbl.cia import LOSCHMIDT, CIADataset
from .lbl.ecs import ecs_band_from_numpy
from .lbl.lookup import AbsLookupTable
from .lbl.nlte import NlteField
from .lbl.partfun import PartFunTable
from .lbl.xsec_fit import XsecFitDataset
from .lbl.zeeman import PaddedZeemanCatalog, ZeemanCatalog
from .predefined.mt_ckd400 import MTCKD400Data, MTCKD430Data
from .scattering import HenyeyGreenstein
from .sensor import SensorArray
from .sun import AU, SUN_RADIUS, Sun


def scene_from_numpy(d, device=None, dtype=None) -> AllskyScene:
    dev, dt = resolve(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    atm = Atmosphere1D(**{k: t(d["atm"][k]) for k in ("z", "t", "p", "vmr")})
    return AllskyScene(
        atm=atm, cat=_catalog(d, dev, dt), pf=_partfun(d, t),
        scatterers=tuple(HenyeyGreenstein(**{k: t(s[k]) for k in ("ext", "ssa", "g")})
                         for s in d.get("scatterers", ())),
        surface_temperature=t(d["surface_temperature"]),
        surface_albedo=t(d.get("surface_albedo", 0.0)),
        predef=tuple(d.get("predef", ())), species_names=tuple(d.get("species_names", ())),
    )


def _catalog(d, dev, dt):
    return None if d.get("cat") is None else catalog_from_arrays(d["cat"], dev, dt)


def _partfun(d, t):
    pf = d.get("pf")
    return None if pf is None else PartFunTable(t_grid=t(pf["t_grid"]), q_grid=t(pf["q_grid"]))


def clearsky_scene_from_numpy(d, device=None, dtype=None) -> ClearskyScene:
    dev, dt = resolve(device, dtype)
    t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dt, device=dev)
    a = d["atm"]
    atm = Atmosphere1D(**{k: t(a[k]) for k in ("z", "t", "p", "vmr")},
                       wind=None if a.get("wind") is None else t(a["wind"]))
    return ClearskyScene(
        atm=atm, cat=_catalog(d, dev, dt), pf=_partfun(d, t),
        surface_temperature=t(d["surface_temperature"]),
        surface_emissivity=t(d.get("surface_emissivity", 1.0)),
        predef=tuple(d.get("predef", ())), species_names=tuple(d.get("species_names", ())),
        nlte=None if d.get("nlte") is None else nlte_field_from_numpy(d["nlte"], dev, dt),
        ecs_bands=tuple((ecs_band_from_numpy(b, dev), int(s), int(i), float(r))
                        for b, s, i, r in d.get("ecs_bands", ())),
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


def cia_dataset_from_numpy(d, device=None, dtype=None) -> CIADataset:
    """CIADataset from {"f_grid", "t_grid", "xsec" [T0, F0] binary
    cross-section [m^5], "spec1", "spec2"}: the scaled table xsec * L0^2
    (lbl/cia.py) is formed in float64 before the cast."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    return CIADataset(f_grid=flts(d["f_grid"]), t_grid=flts(d["t_grid"]),
                      alpha_l0=flts(np.asarray(d["xsec"], dtype=np.float64) * LOSCHMIDT**2),
                      spec1=int(d.get("spec1", 0)), spec2=int(d.get("spec2", 0)))


def xsec_fit_dataset_from_numpy(d, device=None, dtype=None) -> XsecFitDataset:
    """XsecFitDataset from {"f_grid" [N], "coeffs" [N, 4], "spec_idx"}."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    return XsecFitDataset(f_grid=flts(d["f_grid"]), coeffs=flts(d["coeffs"]),
                          spec_idx=int(d.get("spec_idx", 0)))


def lookup_table_from_numpy(d, device=None, dtype=None) -> AbsLookupTable:
    """AbsLookupTable from its fields (log_p_grid, t_ref, w_ref, t_pert,
    w_pert, f_grid, xsec; spec_idx)."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    names = ("log_p_grid", "t_ref", "w_ref", "t_pert", "w_pert", "f_grid", "xsec")
    return AbsLookupTable(**{k: flts(d[k]) for k in names}, spec_idx=int(d.get("spec_idx", 0)))


def mtckd_data_from_numpy(d, device=None, dtype=None):
    """MTCKD400Data from {"wavenumbers", "self_absco_ref", "for_absco_ref",
    "self_texp", "ref_press", "ref_temp"}; MTCKD430Data when the dict also
    holds "for_closure_absco_ref"."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    cls = MTCKD430Data if "for_closure_absco_ref" in d else MTCKD400Data
    return cls(**{f.name: flts(d[f.name]) for f in dataclasses.fields(cls)})


def sun_from_numpy(d, device=None, dtype=None) -> Sun:
    """Sun from {"spectrum", "radius", "distance", "latitude", "longitude"}
    (the geometry defaults to sun.py's)."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    geo = dict(radius=SUN_RADIUS, distance=AU, latitude=0.0, longitude=0.0)
    return Sun(spectrum=flts(d["spectrum"]), **{k: flts(d.get(k, v)) for k, v in geo.items()})


def surface_field_from_numpy(d, device=None, dtype=None) -> SurfaceField:
    """SurfaceField from {"lat", "lon", "temperature", "elevation",
    "emissivity"}."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    return SurfaceField(**{f.name: flts(d[f.name]) for f in dataclasses.fields(SurfaceField)})


def subsurface_field_from_numpy(d, device=None, dtype=None) -> SubsurfaceField:
    """SubsurfaceField from {"depth", "t", "absorption"} and optionally
    "ssa" and "g"."""
    dev, dt = resolve(device, dtype)
    _, flts = _tensors(dev, dt)
    return SubsurfaceField(**{f.name: None if d.get(f.name) is None else flts(d[f.name])
                              for f in dataclasses.fields(SubsurfaceField)})
