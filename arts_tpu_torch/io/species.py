"""Isotopologue registry: the ISOTOPOLOGUES table of arts_tpu/io/species.py,
copied so the port imports nothing of arts_tpu, with register_isotopologue
and split_tag."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class IsotopologueMeta:
    name: str  # e.g. "H2O-161"
    species: str  # "H2O"
    mass: float  # [g/mol]
    abundance: float  # natural isotopologue ratio


# Standard HITRAN isotopologue metadata (mass in g/mol, Earth abundance).
ISOTOPOLOGUES = {
    m.name: m
    for m in [
        IsotopologueMeta("H2O-161", "H2O", 18.010565, 0.997317),
        IsotopologueMeta("H2O-181", "H2O", 20.014811, 1.99983e-3),
        IsotopologueMeta("H2O-171", "H2O", 19.014780, 3.71884e-4),
        IsotopologueMeta("H2O-162", "H2O", 19.016740, 3.10693e-4),
        IsotopologueMeta("H2O-182", "H2O", 21.020985, 6.23003e-7),
        IsotopologueMeta("H2O-172", "H2O", 20.020956, 1.15853e-7),
        IsotopologueMeta("H2O-262", "H2O", 20.022915, 2.41970e-8),
        IsotopologueMeta("CO2-626", "CO2", 43.989830, 0.984204),
        IsotopologueMeta("CO2-636", "CO2", 44.993185, 1.10574e-2),
        IsotopologueMeta("CO2-628", "CO2", 45.994076, 3.94707e-3),
        IsotopologueMeta("CO2-627", "CO2", 44.994045, 7.33989e-4),
        IsotopologueMeta("CO2-638", "CO2", 46.997431, 4.43446e-5),
        IsotopologueMeta("CO2-637", "CO2", 45.997400, 8.24623e-6),
        IsotopologueMeta("O3-666", "O3", 47.984745, 0.992901),
        IsotopologueMeta("O3-668", "O3", 49.988991, 3.98194e-3),
        IsotopologueMeta("O3-686", "O3", 49.988991, 1.99097e-3),
        IsotopologueMeta("O3-667", "O3", 48.988960, 7.40475e-4),
        IsotopologueMeta("O3-676", "O3", 48.988960, 3.70237e-4),
        IsotopologueMeta("N2O-446", "N2O", 44.001062, 0.990333),
        IsotopologueMeta("N2O-456", "N2O", 44.998096, 3.64093e-3),
        IsotopologueMeta("N2O-546", "N2O", 44.998096, 3.64093e-3),
        IsotopologueMeta("N2O-448", "N2O", 46.005308, 1.98582e-3),
        IsotopologueMeta("CO-26", "CO", 27.994915, 0.986544),
        IsotopologueMeta("CO-36", "CO", 28.998270, 1.10836e-2),
        IsotopologueMeta("CO-28", "CO", 29.999161, 1.97822e-3),
        IsotopologueMeta("CH4-211", "CH4", 16.031300, 0.988274),
        IsotopologueMeta("CH4-311", "CH4", 17.034655, 1.11031e-2),
        IsotopologueMeta("CH4-212", "CH4", 17.037475, 6.15751e-4),
        IsotopologueMeta("O2-66", "O2", 31.989830, 0.995262),
        IsotopologueMeta("O2-68", "O2", 33.994076, 3.99141e-3),
        IsotopologueMeta("O2-67", "O2", 32.994045, 7.42235e-4),
        IsotopologueMeta("NO-46", "NO", 29.997989, 0.993974),
        IsotopologueMeta("SO2-626", "SO2", 63.961901, 0.945678),
        IsotopologueMeta("NO2-646", "NO2", 45.992904, 0.991616),
        IsotopologueMeta("NH3-4111", "NH3", 17.026549, 0.995872),
        IsotopologueMeta("HNO3-146", "HNO3", 62.995644, 0.989110),
        IsotopologueMeta("OH-61", "OH", 17.002740, 0.997473),
        IsotopologueMeta("HF-19", "HF", 20.006229, 0.999844),
        IsotopologueMeta("HCl-15", "HCl", 35.976678, 0.757587),
        IsotopologueMeta("HCl-17", "HCl", 37.973729, 0.242257),
        IsotopologueMeta("ClO-56", "ClO", 50.963768, 0.755908),
        IsotopologueMeta("ClO-76", "ClO", 52.960819, 0.241720),
        IsotopologueMeta("OCS-622", "OCS", 59.966986, 0.937395),
        IsotopologueMeta("H2CO-126", "H2CO", 30.010565, 0.986237),
        IsotopologueMeta("N2-44", "N2", 28.006148, 0.992687),
        IsotopologueMeta("N2-45", "N2", 29.003182, 7.47809e-3),
        IsotopologueMeta("HCN-124", "HCN", 27.010899, 0.985114),
        IsotopologueMeta("H2-11", "H2", 2.015650, 0.999688),
        IsotopologueMeta("H2-12", "H2", 3.021825, 3.11432e-4),
        IsotopologueMeta("H2S-121", "H2S", 33.987721, 0.949884),
        IsotopologueMeta("He-4", "He", 4.002603, 0.999999),
        IsotopologueMeta("Ar-8", "Ar", 39.962383, 0.996035),
    ]
}


def register_isotopologue(name, species, mass, abundance):
    """Add (or replace) an isotopologue in the registry."""
    ISOTOPOLOGUES[name] = IsotopologueMeta(name, species, mass, abundance)


def split_tag(tag: str):
    """'H2O-161' -> ('H2O', '161'); 'H2O' -> ('H2O', None)."""
    if "-" in tag:
        spec, iso = tag.split("-", 1)
        return spec, iso
    return tag, None
