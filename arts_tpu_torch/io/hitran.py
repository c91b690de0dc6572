"""HITRAN .par (160-char fixed-width) reader: parse_par_line, read_par,
read_par_records, record_state, the O2 ECS band's lines
(parse_o2_local_quanta, o2_lines_from_par, einstein_a_from_s), the
isotopologue indices (iso_index_of_lines, assign_iso_indices),
catalog_from_par and zeeman_catalog_from_par, ported from
arts_tpu/io/hitran.py.  Readers take a file's path or its rows.  Parsing
is pure Python; only catalog_from_par and zeeman_catalog_from_par build
tensors.  catalog_from_par takes the per-line dict route through
read_par: the JAX package's native loader (io/native) is not ported.
"""

import dataclasses
import math
import re

import numpy as np

from .. import constants as const
from ..lbl.catalog import build_catalog
from ..lbl.tmodel import Law
from ..lbl.zeeman_g import o2_line_g
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


_BRANCH = {"O": -2, "P": -1, "Q": 0, "R": 1, "S": 2}


def parse_o2_local_quanta(rec: HitranRecord):
    """(Nu, Nl, Ju, Jl) from the O2 .par local lower quanta, HITRAN group 2:
    [dN branch][N''] [dJ branch][J''] (e.g. " Q  3 P  4"), N' = N'' + dN,
    J' = J'' + dJ; None if the field does not parse."""
    m = re.findall(r"([OPQRS])\s*(\d+)", rec.q_local_lower)
    if len(m) < 2:
        return None
    (bn, nl), (bj, jl) = m[0], m[1]
    Nl, Jl = float(nl), float(jl)
    return Nl + _BRANCH[bn], Nl, Jl + _BRANCH[bj], Jl


def o2_lines_from_par(records, pf_Q296, iso_abundance=0.995262, zeeman=True):
    """O2-66 line dicts for lbl.ecs.make_o2_band from parsed .par records,
    skipping records of other isotopologues or whose quanta do not parse;
    A from S (einstein_a_from_s with pf_Q296) where a record has none.

    Returns (lines, gus, gls): make_o2_band's input and each line's Lande
    g factors from the advanced O2 model (empty without zeeman)."""
    lines, gus, gls = [], [], []
    for r in records:
        if not r.isotopologue.startswith("O2-66"):
            continue
        qn = parse_o2_local_quanta(r)
        if qn is None:
            continue
        Nu, Nl, Ju, Jl = qn
        a = r.A if r.A > 0 else einstein_a_from_s(r.S, r.g_upp, r.e0, r.f0, pf_Q296,
                                                    iso_abundance)
        lines.append(dict(f0=r.f0, a=a, e0=r.e0, gu=r.g_upp, Ju=Ju, Jl=Jl, Nu=Nu, Nl=Nl,
                          g0=(r.gamma_air, r.n_air), d0=(r.delta_air, 0.0), t0=296.0))
        if zeeman:
            gu, gl = o2_line_g(Ju, Jl, Nu, Nl)
            gus.append(gu)
            gls.append(gl)
    return lines, gus, gls


def einstein_a_from_s(S, gu, e0, f0, Q296, iso_abundance, T0=296.0):
    """Einstein A from the HITRAN intensity S [Hz m^2] at T0, de-weighted by
    the isotopologue abundance; Q296 is the partition function at T0."""
    s = S / iso_abundance
    return (-8.0 * math.pi * Q296 * s
            / (gu * math.exp(-e0 / (const.k * T0)) * math.expm1(-(const.h * f0) / (const.k * T0))
               * (const.c / f0) ** 2))


def _rows(path_or_lines):
    if isinstance(path_or_lines, (list, tuple)):
        return path_or_lines
    with open(path_or_lines) as fh:
        return fh.readlines()


def read_par_records(path_or_lines, fmin=0.0, fmax=np.inf):
    """HitranRecords of a .par file (or its rows) with fmin <= f0 <= fmax;
    short rows, and molecules or isotopologues outside the registry, are
    skipped."""
    out = []
    for row in _rows(path_or_lines):
        if len(row.rstrip("\n")) < 120:
            continue
        try:
            r = parse_par_line(row)
        except KeyError:  # molecule/isotopologue outside the registry
            continue
        if fmin <= r.f0 <= fmax:
            out.append(r)
    return out


def read_par(path_or_lines, species_list, q296=None, strength_option="A", cutoff=np.inf,
             fmin=0.0, fmax=np.inf):
    """build_catalog line dicts from a .par file (or its rows) with
    fmin <= f0 <= fmax.  strength_option "A" (the default here) takes each
    record's Einstein A; "S" (the JAX package's default) forms A from the
    intensity S with q296 {isotopologue: Q(296 K)}.  Rows of other
    species, and unknown molecules, are skipped; iso_idx is assigned by
    first appearance of each isotopologue (iso_index_of_lines)."""
    out = []
    iso_ids = {}
    for r in read_par_records(path_or_lines, fmin, fmax):
        meta = ISOTOPOLOGUES.get(r.isotopologue)
        if meta is None or meta.species not in species_list:
            continue
        spec_idx = species_list.index(meta.species)
        iso_idx = iso_ids.setdefault(r.isotopologue, len(iso_ids))
        if strength_option == "S":
            if q296 is None or r.isotopologue not in q296:
                raise KeyError(f"Q(296) required for {r.isotopologue} with strength 'S'")
            a = einstein_a_from_s(r.S, r.g_upp, r.e0, r.f0, q296[r.isotopologue],
                                  meta.abundance)
        else:
            a = r.A
        ls = {
            spec_idx: {"G0": (Law.T1, [r.gamma_self, r.n_air])},
            "bath": {"G0": (Law.T1, [r.gamma_air, r.n_air])},
        }
        if r.delta_air != 0.0:
            ls[spec_idx]["D0"] = (Law.T0, [r.delta_air])
            ls["bath"]["D0"] = (Law.T0, [r.delta_air])
        out.append(dict(
            f0=r.f0, a=a, e0=r.e0, gu=r.g_upp, gl=r.g_low,
            iso_mass=meta.mass, iso_ratio=meta.abundance,
            spec_idx=spec_idx, iso_idx=iso_idx, band_idx=0, t0=296.0,
            cutoff=cutoff, ls=ls, isotopologue=r.isotopologue,
        ))
    return out


def iso_index_of_lines(lines):
    """{isotopologue: iso_idx} as read_par assigned them (first
    appearance)."""
    out = {}
    for ln in lines:
        tag = ln.get("isotopologue")
        if tag is not None and tag not in out:
            out[tag] = ln["iso_idx"]
    return out


def assign_iso_indices(lines):
    """Reassign iso_idx in place by isotopologue tag, in order of first
    appearance in the merged list, so that lines from several readers or
    files share one partition-function row per tag.  Returns {tag:
    iso_idx}."""
    ids = {}
    for ln in lines:
        tag = ln.get("isotopologue")
        if tag is None:
            continue
        ln["iso_idx"] = ids.setdefault(tag, len(ids))
    return ids


def catalog_from_par(path_or_lines, species_list, q296=None, strength_option="S",
                     cutoff=np.inf, fmin=0.0, fmax=np.inf, n_perturbers=2, device=None,
                     dtype=None):
    """LineCatalog of a .par file (or its rows), lines sorted by f0, with
    n_perturbers slots (self and air): read_par's dicts through
    build_catalog.  strength_option as read_par's, with the JAX package's
    default "S"."""
    lines = read_par(path_or_lines, species_list, q296=q296, strength_option=strength_option,
                     cutoff=cutoff, fmin=fmin, fmax=fmax)
    lines.sort(key=lambda ln: ln["f0"])
    return build_catalog(lines, n_perturbers=n_perturbers, device=device, dtype=dtype)


def zeeman_catalog_from_par(rows, species_list, cutoff=np.inf, device=None,
                            dtype=None):
    """ZeemanCatalog straight from .par rows, with Lande g factors from
    each record's quantum state (record_state, then io.quantum.zeeman_g);
    lines whose state lacks J stay unsplit (g = 0).  Strengths from the
    Einstein A of each record, as read_par."""
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
