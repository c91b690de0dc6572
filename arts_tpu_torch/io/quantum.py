"""Quantum states of transitions and the Zeeman g factors derived from them
(port of arts_tpu/io/quantum.py, without the ECS band construction).

States are maps of quantum-number names to exact rationals, upper and
lower, after ARTS's Quantum::State: parsed from the extended .par
format's trailing "key=value;..." strings, or from the classic 160-char
.par local and global quanta of diatomics.  zeeman_g picks the advanced
O2/CO/OCS/CO2 models first, then the simple Hund case (a)/(b) models.
Host-side pure Python.
"""

import dataclasses
import re
from fractions import Fraction

from ..lbl.zeeman_g import (
    LANDE_GL,
    lande_spin_constant,
    o2_advanced_g,
    simple_g_case_a,
    simple_g_case_b,
)

# proton/electron mass ratio (CODATA; the reference's
# Constant::mass_ratio_electrons_per_proton)
_MP_OVER_ME = 1836.15267343


def parse_rational(s):
    """'3/2' | '1.5' | '4' | 'X' -> Fraction or the original string."""
    s = str(s).strip()
    try:
        if "/" in s:
            num, den = s.split("/")
            return Fraction(int(num), int(den))
        if "." in s:
            return Fraction(s).limit_denominator(2)
        return Fraction(int(s))
    except (ValueError, ZeroDivisionError):
        return s


@dataclasses.dataclass(frozen=True)
class QuantumState:
    """Upper/lower quantum numbers of one transition (quantum.h State)."""

    upper: dict
    lower: dict

    def has(self, *names):
        return all(n in self.upper and n in self.lower for n in names)

    def at(self, name):
        """(upper, lower) values for a quantum number."""
        return self.upper[name], self.lower[name]


def _parse_level(s: str) -> dict:
    out = {}
    for kv in s.split(";"):
        kv = kv.strip()
        if not kv or "=" not in kv:
            continue
        k, v = kv.split("=", 1)
        out[k.strip()] = parse_rational(v)
    return out


def from_hitran(qn_up: str, qn_lo: str) -> QuantumState:
    """Extended .par trailing-state parser (Quantum::from_hitran parity,
    quantum.h; format 'ElecStateLabel=X;v1=0;...;J=4;Ka=2;Kc=2')."""
    return QuantumState(upper=_parse_level(qn_up), lower=_parse_level(qn_lo))


_BRANCH = {"O": -2, "P": -1, "Q": 0, "R": 1, "S": 2}


def local_quanta_diatomic(q_local_upper: str, q_local_lower: str):
    """Classic 160-char local quanta for diatomics -> partial QuantumState.

    HITRAN2004 group 2 (O2: [dN][N''] [dJ][J''], integer) and group 3
    (NO/OH/ClO: [dJ][J''] with half-integer J'') both reduce to
    branch-letter + number pairs; two pairs mean (N, J), one means J only.
    Returns None if nothing parses.
    """
    pairs = re.findall(
        r"([OPQRS])\s*([0-9]+(?:\.[0-9]+)?)", q_local_lower or ""
    )
    if not pairs:
        return None
    up, lo = {}, {}
    if len(pairs) >= 2:  # group 2: dN N'' dJ J''
        (bn, nl), (bj, jl) = pairs[0], pairs[1]
        Nl, Jl = parse_rational(nl), parse_rational(jl)
        up["N"], lo["N"] = Nl + _BRANCH[bn], Nl
        up["J"], lo["J"] = Jl + _BRANCH[bj], Jl
    else:  # group 3: dJ J'' (half-integer)
        bj, jl = pairs[0]
        Jl = parse_rational(jl)
        up["J"], lo["J"] = Jl + _BRANCH[bj], Jl
    return QuantumState(upper=up, lower=lo)


def global_quanta_diatomic(q_upper: str, q_lower: str):
    """Classic global quanta for diatomics: electronic label X/A...,
    Omega tag ('X3/2' / 'X1/2' for the 2-Pi species), vibrational v."""

    def level(s):
        out = {}
        s = s or ""
        m = re.search(r"([XABC])\s*([0-9]+/[0-9]+)?", s)
        if m:
            out["ElecStateLabel"] = m.group(1)
            if m.group(2):
                out["Omega"] = parse_rational(m.group(2))
        mv = re.search(r"(?:v1?\s*=?\s*|\s)([0-9]+)\s*$", s)
        if mv:
            out["v"] = parse_rational(mv.group(1))
        return out

    return QuantumState(upper=level(q_upper), lower=level(q_lower))


def merge_states(*states) -> QuantumState:
    up, lo = {}, {}
    for s in states:
        if s is None:
            continue
        up.update(s.upper)
        lo.update(s.lower)
    return QuantumState(upper=up, lower=lo)


# ---------------------------------------------------------------------------
# Zeeman g-factors from states (lbl_zeeman.cpp:122-260)
# ---------------------------------------------------------------------------
def _closed_shell_trilinear(k, j, gperp, gpara):
    """closed_shell_trilinear (lbl_zeeman.cpp:112-118)."""
    jj = float(j) * (float(j) + 1.0)
    if jj == 0.0:
        return gperp
    return gperp + (gperp + gpara) * (float(k) ** 2 / jj)


def _advanced_g(isotopologue: str, st: QuantumState):
    """GetAdvancedModel parity (lbl_zeeman.cpp:128-255); None if the
    species/state has no advanced model."""
    if isotopologue in ("O2-66", "O2-68"):
        if st.has("J", "N", "v") or st.has("J", "N", "v1"):
            vkey = "v" if "v" in st.upper else "v1"
            vu, vl = st.at(vkey)
            if vu == 0 and vl == 0:
                iso = isotopologue[-2:]
                ju, jl = st.at("J")
                nu, nl = st.at("N")
                return (
                    o2_advanced_g(float(ju), float(nu), iso),
                    o2_advanced_g(float(jl), float(nl), iso),
                )
        return None
    if isotopologue == "CO-26":  # Flygare & Benson 1971
        gperp = -0.2689 / _MP_OVER_ME
        return gperp, gperp
    trilinear = {
        "OCS-622": (-0.02889 / _MP_OVER_ME, 0.0),
        "OCS-624": (-0.0285 / _MP_OVER_ME, -0.061 / _MP_OVER_ME),
        "CO2-626": (-0.05508 / _MP_OVER_ME, 0.0),
    }
    if isotopologue in trilinear and st.has("J") and (
        st.has("Ka") or st.has("K")
    ):
        gperp, gpara = trilinear[isotopologue]
        kkey = "Ka" if "Ka" in st.upper else "K"
        ju, jl = st.at("J")
        ku, kl = st.at(kkey)
        return (
            _closed_shell_trilinear(ku, ju, gperp, gpara),
            _closed_shell_trilinear(kl, jl, gperp, gpara),
        )
    return None


def _simple_g(species: str, st: QuantumState):
    """SimpleG parity (lbl_zeeman.cpp:38-67): Hund case (a) with
    (Omega, J, Lambda, S), case (b) with (N, J, Lambda, S).  Lambda/S
    default from the 2-Pi doublet convention when only Omega is tagged
    (the classic .par global quanta carry X3/2 but not Lambda/S)."""
    GS = lande_spin_constant(species)
    up, lo = dict(st.upper), dict(st.lower)
    for lev in (up, lo):
        if "Omega" in lev:
            lev.setdefault("Lambda", Fraction(1))
            lev.setdefault("S", Fraction(1, 2))
    stx = QuantumState(upper=up, lower=lo)
    if stx.has("Omega", "J", "Lambda", "S"):
        gu = simple_g_case_a(
            float(up["Omega"]), float(up["J"]), float(up["Lambda"]),
            float(up["S"]), GS, LANDE_GL,
        )
        gl = simple_g_case_a(
            float(lo["Omega"]), float(lo["J"]), float(lo["Lambda"]),
            float(lo["S"]), GS, LANDE_GL,
        )
        return gu, gl
    if stx.has("N", "J", "Lambda", "S"):
        gu = simple_g_case_b(
            float(up["N"]), float(up["J"]), float(up["Lambda"]),
            float(up["S"]), GS, LANDE_GL,
        )
        gl = simple_g_case_b(
            float(lo["N"]), float(lo["J"]), float(lo["Lambda"]),
            float(lo["S"]), GS, LANDE_GL,
        )
        return gu, gl
    return None


def zeeman_g(isotopologue: str, state: QuantumState):
    """(gu, gl) Lande g-factors for one line, advanced model first then
    the simple Hund-case models (lbl::zeeman::model::model parity,
    lbl_zeeman.cpp:257-261).  Returns (0, 0) when no model applies."""
    species = isotopologue.split("-")[0]
    g = _advanced_g(isotopologue, state)
    if g is None or g == (0.0, 0.0):
        # O2 case (b) needs Lambda = 0, S = 1 (triplet-Sigma ground state)
        up, lo = dict(state.upper), dict(state.lower)
        if species == "O2":
            for lev in (up, lo):
                lev.setdefault("Lambda", Fraction(0))
                lev.setdefault("S", Fraction(1))
        g = _simple_g(species, QuantumState(upper=up, lower=lo))
    return g if g is not None else (0.0, 0.0)
