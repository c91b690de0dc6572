"""Central registry of string-option families (port of arts_tpu/options.py).

Plain ``StrEnum``-style classes (values ARE the strings used at call
sites, so passing raw strings keeps working) plus :func:`check_option`,
which every dispatch site can call to turn a typo into an error that
lists the valid choices.
"""

from enum import Enum


class StrOption(str, Enum):
    """str-valued enum: members compare/hash equal to their string."""

    def __str__(self) -> str:  # so f-strings show the bare value
        return str(self.value)

    @classmethod
    def values(cls):
        return tuple(m.value for m in cls)


def check_option(family, value):
    """Validate ``value`` against a StrOption family; returns the string.

    Raises ValueError naming the family and listing the choices —
    mirroring the reference's enum parse errors (arts_options codegen
    emits to<Enum>() throwers)."""
    v = str(value)
    if v not in family.values():
        raise ValueError(
            f"invalid {family.__name__} option {value!r}; "
            f"valid: {', '.join(family.values())}"
        )
    return v


class RteOption(StrOption):
    """Layer discretization of the transmittance/source integral
    (reference TransmittanceOption / rte_option)."""

    constant = "constant"  # average-K per layer
    lintau = "lintau"  # source linear in optical depth
    linprop = "linprop"  # propagation matrix linear along the layer


class PathBackground(StrOption):
    """End-of-path radiation background (ray_pointBackground classes)."""

    space = "space"
    surface = "surface"
    surface_reflect = "surface_reflect"


class SpectralRadianceUnit(StrOption):
    """Unit transform applied to radiance + Jacobian
    (SpectralRadianceUnitType; operators.py)."""

    raw = "raw"
    one = "1"
    Tb = "Tb"  # Planck brightness temperature
    RJBT = "RJBT"  # Rayleigh-Jeans brightness temperature


class OemMethod(StrOption):
    """OEM minimizer (reference OEM WSM method strings, m_oem.cc)."""

    li = "li"
    gn = "gn"
    lm = "lm"
    li_cg = "li_cg"
    gn_cg = "gn_cg"
    lm_cg = "lm_cg"


class RetrievalTransform(StrOption):
    """State-vector bijectors (jacobian transforms: jac_rel/log/...)."""

    id = "id"
    log = "log"
    rel = "rel"
    logrel = "logrel"
    rh = "rh"


class LineStrengthOption(StrOption):
    """HITRAN .par ingestion strength column ('S' intensities need Q(296),
    'A' Einstein coefficients do not; io/hitran.py)."""

    S = "S"
    A = "A"


class LineshapeTLaw(StrOption):
    """Lineshape-parameter temperature laws (LineShapeModelType,
    arts_options.cc:495-519; lbl/tmodel.py)."""

    T0 = "T0"
    T1 = "T1"
    T2 = "T2"
    T3 = "T3"
    T4 = "T4"
    T5 = "T5"
    AER = "AER"
    DPL = "DPL"
    POLY = "POLY"


class PsdKind(StrOption):
    """Particle size distributions (reference psd.h: MGDSingleMoment,
    BinnedPSD; scattering/psd.py)."""

    mgd = "mgd"
    binned = "binned"
