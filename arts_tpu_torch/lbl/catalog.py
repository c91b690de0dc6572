"""Line catalog as a padded struct of tensors (port of arts_tpu/lbl/catalog.py:
LineCatalog and build_catalog)."""

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .._cuda import resolve
from .tmodel import NV, VARS

# sentinel perturber indices in ls_spec
BATH = -2
PAD = -1


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


def catalog_arrays(lines: Sequence[dict]):
    """The LineCatalog fields as numpy arrays (float64 and int64) from a
    list of per-line dicts (read_par's output)."""
    L = len(lines)
    P = max(1, max(len(ln.get("ls", {})) for ln in lines))

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


def build_catalog(lines: Sequence[dict], device=None, dtype=None):
    """LineCatalog from per-line dicts (host side)."""
    dev, dt = resolve(device, dtype)
    return catalog_from_arrays(catalog_arrays(lines), dev, dt)
