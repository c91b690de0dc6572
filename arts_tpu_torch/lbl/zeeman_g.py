"""Lande g-factor models for Zeeman splitting (port of arts_tpu/lbl/zeeman_g.py).

The Hund case (a)/(b) simple models, the per-species Lande spin
constants, and the O2 advanced case-(b) model with the spin-rotation
Hamiltonian mixing angle, after ARTS's lbl_zeeman.{h,cpp}.  Host-side
pure Python: g factors are per-line catalog constants computed once at
catalog build time.
"""

import math

LANDE_GS = {
    "O2": 2.002064,
    "NO": 2.00071,
    "OH": 2.00089,
    "ClO": 2.00072,
    "SO": 2.002106,
}
LANDE_GS_DEFAULT = 2.00231930436182  # free electron
LANDE_GL = 1.0


def lande_spin_constant(species: str) -> float:
    return LANDE_GS.get(species, LANDE_GS_DEFAULT)


def simple_g_case_b(N, J, Lambda, S, GS=None, GL=LANDE_GL, species=None):
    """Hund case (b) Lande g (lbl_zeeman.h SimpleGCaseB)."""
    GS = lande_spin_constant(species) if GS is None else GS
    JJ = J * (J + 1.0)
    NN = N * (N + 1.0)
    SS = S * (S + 1.0)
    LL = Lambda * Lambda
    if JJ == 0:
        return 0.0
    if NN != 0:
        return GS * (JJ + SS - NN) / JJ / 2.0 + GL * (
            (JJ - SS + NN) * LL / NN / JJ / 2.0
        )
    return GS * (JJ + SS - NN) / JJ / 2.0


def simple_g_case_a(Omega, J, Lambda, Sigma, GS=None, GL=LANDE_GL,
                    species=None):
    """Hund case (a) Lande g (lbl_zeeman.h SimpleGCaseA)."""
    GS = lande_spin_constant(species) if GS is None else GS
    JJ = J * (J + 1.0)
    if JJ == 0:
        return 0.0
    div = Omega / JJ
    return GS * Sigma * div + GL * Lambda * div


# O2 ground-state effective Hamiltonian constants [Hz]
# (lbl_zeeman.cpp GetAdvancedModel:134-145 for 66, :166-177 for 68)
_O2_ADV = {
    "66": dict(GS=2.002084, GLE=2.77e-3, GR=-1.16e-4, B=43100.44276e6,
               D=145.1271e3, H=49e-3, lB=59501.3438e6, lD=58.3680e3,
               lH=290.8e-3, gB=-252.58634e6, gD=-243.42, gH=-1.46e-3),
    "68": dict(GS=2.002025, GLE=2.813e-3, GR=-1.26e-4, B=40707.38657e6,
               D=129.4142e3, H=0.0, lB=59499.0375e6, lD=54.9777e3,
               lH=272.1e-3, gB=-238.51530e6, gD=-217.77, gH=-1.305e-3),
}


def o2_advanced_g(J, N, iso="66"):
    """O2 advanced case-(b) g with the spin-rotation mixing angle
    (lbl_zeeman.cpp case_b_g_coefficient_o2)."""
    c = _O2_ADV[iso]
    GS, GR, GLE = c["GS"], c["GR"], c["GLE"]
    B, D, H = c["B"], c["D"], c["H"]
    gB, gD, gH = c["gB"], c["gD"], c["gH"]
    lB, lD, lH = c["lB"], c["lD"], c["lH"]

    if J == 0:
        return 0.0
    JJ1 = J * J + J + 1.0
    nom = (lB + lD * JJ1 + lH * JJ1**2) * (
        2.0 * math.sqrt(J * J + J) / (2.0 * J + 1.0)
    )
    a = J * (J - 1.0)
    b = (J + 2.0) * (J + 1.0)
    denom = (
        B * a - D * a**2 + H * a**3
        + (gB + gD * a + gH * a**2) * (J - 1.0)
        + (lB + lD * a + lH * a**2) * (2.0 / 3.0 - 2.0 * J / (2.0 * J + 1.0))
        - (
            B * b - D * b**2 + H * b**3
            - (gB + gD * b + gH * b**2) * (J + 2.0)
            + (lB + lD * b + lH * b**2)
            * (2.0 / 3.0 - 2.0 * (J + 1.0) / (2.0 * J + 1.0))
        )
    )
    phi = math.atan2(2.0 * nom, denom) / 2.0

    if J == N:
        return (GS + GR) / (J * (J + 1.0)) - GR
    if J < N:
        return (
            (GS + GR) * (math.cos(phi) ** 2 / J - math.sin(phi) ** 2 / (J + 1.0))
            + 2.0 * GLE * math.cos(2.0 * phi) / (2.0 * J + 1.0)
            - GR
        )
    return (
        (GS + GR) * (math.sin(phi) ** 2 / J - math.cos(phi) ** 2 / (J + 1.0))
        - 2.0 * GLE * math.cos(2.0 * phi) / (2.0 * J + 1.0)
        - GR
    )


def o2_line_g(Ju, Jl, Nu, Nl, iso="66"):
    """(gu, gl) for an O2 microwave line."""
    return o2_advanced_g(Ju, Nu, iso), o2_advanced_g(Jl, Nl, iso)
