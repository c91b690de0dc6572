"""HITRAN .par (160-char fixed-width) reader: parse_par_line, read_par,
read_par_records, record_state and zeeman_catalog_from_par, ported from
arts_tpu/io/hitran.py.  Parsing is pure Python; only
zeeman_catalog_from_par builds tensors.

Not ported yet: files as input, strengths from S (with Q(296)) and
frequency windows.
"""

import dataclasses

import numpy as np

from .. import constants as const
from ..lbl.tmodel import Law
from .quantum import (
    QuantumState,
    from_hitran,
    global_quanta_diatomic,
    local_quanta_diatomic,
    merge_states,
    zeeman_g,
)
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
    state: QuantumState | None = None  # extended-format trailing states


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
        state=_trailing_state(line),
    )


def _trailing_state(line: str):
    """Extended-format trailing quantum states (after column 160)."""
    rest = line.rstrip("\n")[160:]
    if not rest.startswith(","):
        return None
    parts = rest.split(",")
    if len(parts) < 3:
        return None
    return from_hitran(parts[1], parts[2])


def record_state(rec: HitranRecord):
    """Best-available QuantumState for a record: the extended trailing
    states when present, else the classic global+local quanta fields."""
    if rec.state is not None:
        return rec.state
    loc = local_quanta_diatomic(rec.q_local_upper, rec.q_local_lower)
    glo = global_quanta_diatomic(rec.q_upper, rec.q_lower)
    if loc is None and not (glo.upper or glo.lower):
        return None
    return merge_states(glo, loc)


def read_par_records(rows):
    """HitranRecords of the parseable rows (others, and unknown molecules,
    are skipped)."""
    out = []
    for row in rows:
        if len(row.rstrip("\n")) < 120:
            continue
        try:
            out.append(parse_par_line(row))
        except KeyError:  # molecule/isotopologue outside the registry
            continue
    return out


def read_par(rows, species_list, cutoff=np.inf):
    """build_catalog line dicts from .par rows, with the Einstein A of each
    record (arts_tpu's strength_option="A").  Rows of other species, and
    unknown molecules, are skipped; iso_idx is assigned by first appearance
    of each isotopologue."""
    out = []
    iso_ids = {}
    for r in read_par_records(rows):
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


def zeeman_catalog_from_par(rows, species_list, cutoff=np.inf, device=None,
                            dtype=None):
    """ZeemanCatalog straight from .par rows, with Lande g factors from
    each record's quantum state (record_state, then io.quantum.zeeman_g);
    lines whose state lacks J stay unsplit (g = 0).  Strengths from the
    Einstein A of each record, as read_par."""
    from ..lbl.catalog import build_catalog
    from ..lbl.zeeman import expand_zeeman

    lines = read_par(rows, species_list, cutoff=cutoff)
    records = [
        r for r in read_par_records(rows)
        if ISOTOPOLOGUES.get(r.isotopologue) is not None
        and ISOTOPOLOGUES[r.isotopologue].species in species_list
    ]
    if len(records) != len(lines):
        raise RuntimeError("read_par and read_par_records disagree on the rows")
    jus, jls, gus, gls = [], [], [], []
    for r in records:
        st = record_state(r)
        if st is None or not st.has("J"):
            ju = jl = gu = gl = 0.0
        else:
            ju, jl = (float(x) for x in st.at("J"))
            gu, gl = zeeman_g(r.isotopologue, st)
        jus.append(ju)
        jls.append(jl)
        gus.append(gu)
        gls.append(gl)
    order = np.argsort([ln["f0"] for ln in lines])
    pick = lambda a: [a[i] for i in order]
    cat = build_catalog(pick(lines), device=device, dtype=dtype)
    return expand_zeeman(cat, pick(jus), pick(jls), pick(gus), pick(gls))
