"""Line catalog as a padded struct of tensors (port of arts_tpu/lbl/catalog.py:
Cutoff, SpeciesMeta, LineCatalog, build_catalog, concat_catalogs, hitran_s
and keep_strongest)."""

import dataclasses
from enum import IntEnum
from typing import Sequence

import numpy as np
import torch

from .. import constants as const
from .._cuda import resolve
from .tmodel import NV, VARS


class Cutoff(IntEnum):
    NONE = 0
    BY_LINE = 1  # subtract the shape's value at f0 +/- cutoff, zero outside


# sentinel perturber indices in ls_spec
BATH = -2
PAD = -1


@dataclasses.dataclass(frozen=True)
class SpeciesMeta:
    """Host-side description of the species and isotopologue tables."""

    species: tuple  # species tag names, index = position in the VMR vector
    isotopologues: tuple  # (species_idx, name, mass [g/mol], abundance) rows

    @property
    def n_species(self):
        return len(self.species)

    @property
    def n_iso(self):
        return len(self.isotopologues)


@dataclasses.dataclass(frozen=True)
class LineCatalog:
    """L lines, P perturber slots, NV=9 line-shape variables; SI units."""

    f0: torch.Tensor  # [L] line center [Hz]
    a: torch.Tensor  # [L] Einstein A
    e0: torch.Tensor  # [L] lower state energy [J]
    gu: torch.Tensor  # [L] upper state degeneracy
    gl: torch.Tensor  # [L] lower state degeneracy
    iso_mass: torch.Tensor  # [L] molecular mass [g/mol]
    iso_ratio: torch.Tensor  # [L] isotopologue abundance ratio
    spec_idx: torch.Tensor  # [L] int index into the VMR vector
    iso_idx: torch.Tensor  # [L] int index into the partition function table
    band_idx: torch.Tensor  # [L] int band id
    t0: torch.Tensor  # [L] line-shape reference temperature
    cutoff: torch.Tensor  # [L] cutoff frequency (inf = none)
    ls_spec: torch.Tensor  # [L, P] int perturber vmr index, BATH or PAD
    ls_law: torch.Tensor  # [L, P, NV] int temperature-law ids
    ls_x: torch.Tensor  # [L, P, NV, 4] law coefficients

    @property
    def n_lines(self):
        return self.f0.shape[0]

    @property
    def n_perturbers(self):
        return self.ls_spec.shape[1]


def catalog_arrays(lines: Sequence[dict], n_perturbers: int | None = None):
    """The LineCatalog fields as numpy arrays (float64 and int64) from a
    list of per-line dicts (read_par's output), with n_perturbers slots
    (None: as many as the line with the most)."""
    L = len(lines)
    P = n_perturbers or max(1, max(len(ln.get("ls", {})) for ln in lines))

    def arr(key, default=0.0):
        return np.array([ln.get(key, default) for ln in lines], dtype=np.float64)

    ls_spec = np.full((L, P), PAD, dtype=np.int64)
    ls_law = np.zeros((L, P, NV), dtype=np.int64)
    ls_x = np.zeros((L, P, NV, 4), dtype=np.float64)
    for i, ln in enumerate(lines):
        for j, (pert, vars_) in enumerate(ln.get("ls", {}).items()):
            ls_spec[i, j] = BATH if pert == "bath" else int(pert)
            for vname, (law, x) in vars_.items():
                v = VARS.index(vname)
                ls_law[i, j, v] = int(law)
                ls_x[i, j, v, : len(x)] = x
    return dict(
        f0=arr("f0"), a=arr("a"), e0=arr("e0"), gu=arr("gu"),
        gl=arr("gl", 1.0), iso_mass=arr("iso_mass"),
        iso_ratio=arr("iso_ratio", 1.0),
        spec_idx=arr("spec_idx").astype(np.int64),
        iso_idx=arr("iso_idx").astype(np.int64),
        band_idx=arr("band_idx").astype(np.int64),
        t0=arr("t0", 296.0), cutoff=arr("cutoff", np.inf),
        ls_spec=ls_spec, ls_law=ls_law, ls_x=ls_x,
    )


def catalog_from_arrays(d, device, dtype):
    """LineCatalog on `device` from numpy arrays: floats cast to `dtype`,
    integers to int64."""
    def t(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a.astype(np.int64), device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    return LineCatalog(**{f.name: t(d[f.name]) for f in dataclasses.fields(LineCatalog)})


def build_catalog(lines: Sequence[dict], n_perturbers: int | None = None, device=None,
                  dtype=None):
    """LineCatalog from per-line dicts (host side)."""
    dev, dt = resolve(device, dtype)
    return catalog_from_arrays(catalog_arrays(lines, n_perturbers), dev, dt)


def concat_catalogs(cats: Sequence[LineCatalog]) -> LineCatalog:
    """The catalogs' lines one after another, perturber slots padded to the
    widest (PAD, law 0)."""
    P = max(c.n_perturbers for c in cats)
    pad = torch.nn.functional.pad

    def padp(c):
        dp = P - c.n_perturbers
        if dp == 0:
            return c
        return dataclasses.replace(c, ls_spec=pad(c.ls_spec, (0, dp), value=PAD),
                                   ls_law=pad(c.ls_law, (0, 0, 0, dp)),
                                   ls_x=pad(c.ls_x, (0, 0, 0, 0, 0, dp)))

    cats = [padp(c) for c in cats]
    return LineCatalog(**{f.name: torch.cat([getattr(c, f.name) for c in cats])
                          for f in dataclasses.fields(LineCatalog)})


def hitran_s(cat: LineCatalog, q296_per_line, T0: float = 296.0):
    """HITRAN-convention intensities S(T0) [Hz m^2] of every line (numpy,
    float64): the inverse of the Einstein-A conversion, weighted by the
    isotopologue abundance; q296_per_line is Q(T0) per line or one
    value."""
    f0, a, gu, e0, ratio = (getattr(cat, k).detach().cpu().double().numpy()
                            for k in ("f0", "a", "gu", "e0", "iso_ratio"))
    q = np.broadcast_to(np.asarray(q296_per_line, dtype=np.float64), f0.shape)
    s_lte = a * gu * np.exp(-e0 / (const.k * T0)) / (f0**3 * q)
    scl = -f0 * np.expm1(-const.h * f0 / (const.k * T0)) * (const.c**2 / (8.0 * np.pi))
    return ratio * s_lte * scl


def keep_strongest(cat: LineCatalog, q296_per_line, percentile: float):
    """The catalog without the weakest `percentile` % of its lines by
    HITRAN intensity (hitran_s)."""
    s = hitran_s(cat, q296_per_line)
    keep = torch.as_tensor(np.nonzero(s >= np.percentile(s, percentile))[0],
                           device=cat.f0.device)
    return dataclasses.replace(cat, **{f.name: getattr(cat, f.name)[keep]
                                       for f in dataclasses.fields(LineCatalog)})
