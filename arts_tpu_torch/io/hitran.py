"""HITRAN .par (160-char fixed-width) reader: parse_par_line and read_par,
ported from arts_tpu/io/hitran.py (pure Python; no tensors here).

Not ported yet: files as input, strengths from S (with Q(296)), frequency
windows and the extended format's trailing quantum states.
"""

import dataclasses

import numpy as np

from .. import constants as const
from ..lbl.tmodel import Law
from .species import ISOTOPOLOGUES

# HITRAN molecule number -> (species, [iso code per local iso number])
HITRAN_MOLECULES = {
    1: ("H2O", ["161", "181", "171", "162", "182", "172", "262"]),
    2: ("CO2", ["626", "636", "628", "627", "638", "637", "828", "827"]),
    3: ("O3", ["666", "668", "686", "667", "676"]),
    4: ("N2O", ["446", "456", "546", "448", "447"]),
    5: ("CO", ["26", "36", "28", "27", "38", "37"]),
    6: ("CH4", ["211", "311", "212", "312"]),
    7: ("O2", ["66", "68", "67"]),
    8: ("NO", ["46", "56", "48"]),
    9: ("SO2", ["626", "646"]),
    10: ("NO2", ["646"]),
    11: ("NH3", ["4111", "5111"]),
    12: ("HNO3", ["146"]),
    13: ("OH", ["61", "81", "62"]),
    14: ("HF", ["19"]),
    15: ("HCl", ["15", "17"]),
    18: ("ClO", ["56", "76"]),
    19: ("OCS", ["622", "624", "632", "623", "822"]),
    20: ("H2CO", ["126", "136", "128"]),
    22: ("N2", ["44", "45"]),
    23: ("HCN", ["124", "134", "125"]),
    45: ("H2", ["11", "12"]),
    31: ("H2S", ["121", "141", "131"]),
}

_KAYCM2HZ = 100.0 * const.c
_ATM = 101325.0


@dataclasses.dataclass
class HitranRecord:
    isotopologue: str
    f0: float  # Hz
    S: float  # Hz m^2 (line intensity, SI)
    A: float  # Einstein A [1/s]
    gamma_air: float  # Hz/Pa
    gamma_self: float  # Hz/Pa
    e0: float  # J
    n_air: float
    delta_air: float  # Hz/Pa
    g_upp: float
    g_low: float
    q_upper: str
    q_lower: str
    q_local_upper: str = ""
    q_local_lower: str = ""


def parse_par_line(line: str) -> HitranRecord:
    """One .par record (field widths and units of the HITRAN 160 format)."""
    mol = int(line[0:2])
    iso_ch = line[2]
    iso = int(iso_ch, 36) if not iso_ch.isdigit() else int(iso_ch)  # 'A' = 10
    if mol not in HITRAN_MOLECULES:
        raise KeyError(f"unknown HITRAN molecule number {mol}")
    spec, isos = HITRAN_MOLECULES[mol]
    if not 1 <= iso <= len(isos):
        raise KeyError(f"unknown isotopologue {iso} for {spec}")
    return HitranRecord(
        isotopologue=f"{spec}-{isos[iso - 1]}",
        f0=float(line[3:15]) * _KAYCM2HZ,
        S=float(line[15:25]) * _KAYCM2HZ * 1e-4,
        A=float(line[25:35]),
        gamma_air=float(line[35:40]) * _KAYCM2HZ / _ATM,
        gamma_self=float(line[40:45]) * _KAYCM2HZ / _ATM,
        e0=float(line[45:55]) * const.h * _KAYCM2HZ,
        n_air=float(line[55:59]),
        delta_air=float(line[59:67]) * _KAYCM2HZ / _ATM,
        g_upp=float(line[146:153]),
        g_low=float(line[153:160]),
        q_upper=line[67:82].strip(),
        q_lower=line[82:97].strip(),
        q_local_upper=line[97:112],
        q_local_lower=line[112:127],
    )


def read_par(rows, species_list, cutoff=np.inf):
    """build_catalog line dicts from .par rows, with the Einstein A of each
    record (arts_tpu's strength_option="A").  Rows of other species, and
    unknown molecules, are skipped; iso_idx is assigned by first appearance
    of each isotopologue."""
    out = []
    iso_ids = {}
    for row in rows:
        if len(row.rstrip("\n")) < 120:
            continue
        try:
            r = parse_par_line(row)
        except KeyError:
            continue
        meta = ISOTOPOLOGUES.get(r.isotopologue)
        if meta is None or meta.species not in species_list:
            continue
        spec_idx = species_list.index(meta.species)
        iso_idx = iso_ids.setdefault(r.isotopologue, len(iso_ids))
        ls = {
            spec_idx: {"G0": (Law.T1, [r.gamma_self, r.n_air])},
            "bath": {"G0": (Law.T1, [r.gamma_air, r.n_air])},
        }
        if r.delta_air != 0.0:
            ls[spec_idx]["D0"] = (Law.T0, [r.delta_air])
            ls["bath"]["D0"] = (Law.T0, [r.delta_air])
        out.append(dict(
            f0=r.f0, a=r.A, e0=r.e0, gu=r.g_upp, gl=r.g_low,
            iso_mass=meta.mass, iso_ratio=meta.abundance,
            spec_idx=spec_idx, iso_idx=iso_idx, band_idx=0, t0=296.0,
            cutoff=cutoff, ls=ls, isotopologue=r.isotopologue,
        ))
    return out
