"""Predefined (continuum and full) absorption models (port of
arts_tpu/predefined/models.py): PWR98 H2O and O2 (Rosenkranz 1998), the
standard N2 and H2O self/foreign continua (Rosenkranz 1993), the ELL07
liquid cloud (Ellison 2007) and O2-MPM2020 (Makarov et al. 2020), the
PREDEF_MODELS registry of all 27 models, and predefined_absorption.

Each model maps (f_grid [Hz], t [K], p [Pa], vmrs) to the absorption
coefficient [1/m] with the species VMR folded in, batched over points
(predefined/common.py: points [...], f [F] or [..., F], result
[..., F]).  The models compute on the device of their tensors;
predefined_absorption is the entry point, which places them.
Coefficient tables are the published model data, as in the JAX package.
"""

import math

import numpy as np
import torch

from .._cuda import resolve
from .common import col, const_like, detuning

# ---------------------------------------------------------------------------
# PWR98 H2O (Rosenkranz 1998): 15 lines + empirical continuum
# ---------------------------------------------------------------------------
_PWR_FL = np.array([
    22.2350800, 183.3101170, 321.2256400, 325.1529190, 380.1973720,
    439.1508120, 443.0182950, 448.0010750, 470.8889470, 474.6891270,
    488.4911330, 556.9360020, 620.7008070, 752.0332270, 916.1715820,
])
_PWR_S1 = np.array([
    1.31e-14, 2.273e-12, 8.036e-14, 2.694e-12, 2.438e-11,
    2.179e-12, 4.624e-13, 2.562e-11, 8.369e-13, 3.263e-12,
    6.659e-13, 1.531e-9, 1.707e-11, 1.011e-9, 4.227e-11,
])
_PWR_B2 = np.array([
    2.144, 0.668, 6.179, 1.541, 1.048, 3.595, 5.048, 1.405,
    3.597, 2.379, 2.852, 0.159, 2.391, 0.396, 1.441,
])
_PWR_W3 = np.array([
    0.00281, 0.00281, 0.00230, 0.00278, 0.00287, 0.00210, 0.00186,
    0.00263, 0.00215, 0.00236, 0.00260, 0.00321, 0.00244, 0.00306, 0.00267,
])
_PWR_X = np.array([
    0.69, 0.64, 0.67, 0.68, 0.54, 0.63, 0.60, 0.66, 0.66, 0.65,
    0.69, 0.69, 0.71, 0.68, 0.70,
])
_PWR_WS = np.array([
    0.01349, 0.01491, 0.01080, 0.01350, 0.01541, 0.00900, 0.00788,
    0.01275, 0.00983, 0.01095, 0.01313, 0.01320, 0.01140, 0.01253, 0.01275,
])
_PWR_XS = np.array([
    0.61, 0.85, 0.54, 0.74, 0.89, 0.52, 0.50, 0.67, 0.65, 0.64,
    0.72, 1.00, 0.68, 0.84, 0.78,
])



def h2o_pwr98(f_grid, t, p_pa, vmrs):
    """H2O lines + continuum (PWR98). Returns alpha [..., F] [1/m]."""
    c = lambda a: const_like(a, f_grid)
    t, p_pa, vmr = col(t), col(p_pa), col(vmrs["H2O"])
    pvap_dummy = 1e-2 * p_pa
    pvap = 1e-2 * p_pa * vmr
    pda = 1e-2 * p_pa - pvap
    den_dummy = 3.335e16 * (2.1667 * p_pa / t)
    ti = 300.0 / t
    ti2 = ti**2.5
    con = pvap_dummy * ti**3 * 1.0e-9 * (0.543 * pda + 17.96 * pvap * ti**4.5)

    ff = f_grid * 1e-9  # [..., F] GHz
    fl = c(_PWR_FL)  # [L]
    width = c(_PWR_W3) * pda * ti ** c(_PWR_X) + c(_PWR_WS) * pvap * ti ** c(_PWR_XS)
    wsq = width * width  # [..., L]
    strength = c(_PWR_S1) * ti2 * torch.exp(c(_PWR_B2) * (1.0 - ti))
    ffc = ff[..., None]
    df0 = detuning(f_grid, _PWR_FL)  # [..., F, L]
    df1 = ffc + fl
    width_, wsq_ = width[..., None, :], wsq[..., None, :]
    base = (width / (wsq + 562500.0))[..., None, :]
    zero = torch.zeros((), dtype=ff.dtype, device=ff.device)
    res = torch.where(df0.abs() < 750.0, width_ / (df0 * df0 + wsq_) - base, zero) + torch.where(
        df1.abs() < 750.0, width_ / (df1 * df1 + wsq_) - base, zero)
    sums = (strength[..., None, :] * res * (ffc / fl) ** 2).sum(-1)
    absl = 0.3183e-4 * den_dummy * sums
    return vmr * 1.0e-3 * (absl + con * ff * ff)


# ---------------------------------------------------------------------------
# PWR98 O2: 60-GHz complex + mm lines + continuum (Rosenkranz 1993/98)
# ---------------------------------------------------------------------------
_O2_F = np.array([
    118.7503, 56.2648, 62.4863, 58.4466, 60.3061, 59.5910, 59.1642,
    60.4348, 58.3239, 61.1506, 57.6125, 61.8002, 56.9682, 62.4112,
    56.3634, 62.9980, 55.7838, 63.5685, 55.2214, 64.1278, 54.6712,
    64.6789, 54.1300, 65.2241, 53.5957, 65.7648, 53.0669, 66.3021,
    52.5424, 66.8368, 52.0214, 67.3696, 51.5034, 67.9009, 368.4984,
    424.7632, 487.2494, 715.3931, 773.8397, 834.1458,
])
_O2_S300 = np.array([
    0.2936e-14, 0.8079e-15, 0.2480e-14, 0.2228e-14, 0.3351e-14, 0.3292e-14,
    0.3721e-14, 0.3891e-14, 0.3640e-14, 0.4005e-14, 0.3227e-14, 0.3715e-14,
    0.2627e-14, 0.3156e-14, 0.1982e-14, 0.2477e-14, 0.1391e-14, 0.1808e-14,
    0.9124e-15, 0.1230e-14, 0.5603e-15, 0.7842e-15, 0.3228e-15, 0.4689e-15,
    0.1748e-15, 0.2632e-15, 0.8898e-16, 0.1389e-15, 0.4264e-16, 0.6899e-16,
    0.1924e-16, 0.3229e-16, 0.8191e-17, 0.1423e-16, 0.6494e-15, 0.7083e-14,
    0.3025e-14, 0.1835e-14, 0.1158e-13, 0.3993e-14,
])
_O2_Y300 = np.array([
    -0.0233, 0.2408, -0.3486, 0.5227, -0.5430, 0.5877, -0.3970, 0.3237,
    -0.1348, 0.0311, 0.0725, -0.1663, 0.2832, -0.3629, 0.3970, -0.4599,
    0.4695, -0.5199, 0.5187, -0.5597, 0.5903, -0.6246, 0.6656, -0.6942,
    0.7086, -0.7325, 0.7348, -0.7546, 0.7702, -0.7864, 0.8083, -0.8210,
    0.8439, -0.8529, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
])
_O2_W300 = np.array([
    1.630, 1.646, 1.468, 1.449, 1.382, 1.360, 1.319, 1.297, 1.266, 1.248,
    1.221, 1.207, 1.181, 1.171, 1.144, 1.139, 1.110, 1.108, 1.079, 1.078,
    1.050, 1.050, 1.020, 1.020, 1.000, 1.000, 0.970, 0.970, 0.940, 0.940,
    0.920, 0.920, 0.890, 0.890, 1.920, 1.920, 1.920, 1.810, 1.810, 1.810,
])
_O2_BE = np.array([
    0.009, 0.015, 0.083, 0.084, 0.212, 0.212, 0.391, 0.391, 0.626, 0.626,
    0.915, 0.915, 1.260, 1.260, 1.660, 1.665, 2.119, 2.115, 2.624, 2.625,
    3.194, 3.194, 3.814, 3.814, 4.484, 4.484, 5.224, 5.224, 6.004, 6.004,
    6.844, 6.844, 7.744, 7.744, 0.048, 0.044, 0.049, 0.145, 0.141, 0.145,
])
_O2_V = np.array([
    0.0079, -0.0978, 0.0844, -0.1273, 0.0699, -0.0776, 0.2309, -0.2825,
    0.0436, -0.0584, 0.6056, -0.6619, 0.6451, -0.6759, 0.6547, -0.6675,
    0.6135, -0.6139, 0.2952, -0.2895, 0.2654, -0.2590, 0.3750, -0.3680,
    0.5085, -0.5002, 0.6206, -0.6091, 0.6526, -0.6393, 0.6640, -0.6475,
    0.6729, -0.6545, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0,
])
_O2_IS118 = (np.abs(_O2_F - 118.75) < 0.10).astype(np.float64)



def o2_pwr98(f_grid, t, p_pa, vmrs):
    """O2 60-GHz complex + mm lines + continuum (PWR98)."""
    c = lambda a: const_like(a, f_grid)
    t, p_pa = col(t), col(p_pa)
    vmr, h2o = col(vmrs["O2"]), col(vmrs.get("H2O", 0.0))
    WB300, X = 0.56, 0.80
    TH = 300.0 / t
    TH1 = TH - 1.0
    B = TH**X
    PRESWV = 1e-2 * p_pa * h2o
    PRESDA = 1e-2 * p_pa * (1.0 - h2o)
    DEN = 0.001 * (PRESDA * B + 1.1 * PRESWV * TH)
    DENS = 0.001 * (PRESDA + 1.1 * PRESWV) * TH
    DFNR = WB300 * DEN
    CCONT = 1.23e-10 * TH**2 * p_pa

    ff = f_grid * 1e-9
    CONT = CCONT * (ff * ff * DFNR / (ff * ff + DFNR * DFNR))

    DF = c(_O2_W300) * torch.where(c(_O2_IS118) > 0, DENS, DEN)  # [..., L]
    Y = 0.001 * 0.01 * p_pa * B * (c(_O2_Y300) + c(_O2_V) * TH1)
    STR = c(_O2_S300) * torch.exp(-c(_O2_BE) * TH1)
    fl = c(_O2_F)
    ffc = ff[..., None]
    dm = detuning(f_grid, _O2_F)
    dp = ffc + fl
    DF_, Y_ = DF[..., None, :], Y[..., None, :]
    SF1 = (DF_ + dm * Y_) / (dm * dm + DF_ * DF_)
    SF2 = (DF_ - dp * Y_) / (dp * dp + DF_ * DF_)
    SUM = (STR[..., None, :] * (SF1 + SF2) * (ffc / fl) ** 2).sum(-1)
    return vmr * (CONT + 2.414322e7 * SUM * p_pa * TH**3 / math.pi)


# ---------------------------------------------------------------------------
# Standard (Rosenkranz 1993) continua
# ---------------------------------------------------------------------------
def n2_self_standard(f_grid, t, p_pa, vmrs):
    """N2-N2 continuum: C (300/T)^3.55 f^2 p^2 n2."""
    n2, t, p_pa = col(vmrs["N2"]), col(t), col(p_pa)
    C, xf, xt, xp = 1.05e-38, 2.0, 3.55, 2.0
    return n2 * C * (300.0 / t) ** xt * f_grid**xf * p_pa**xp * n2 ** (xp - 1)


def h2o_self_standard(f_grid, t, p_pa, vmrs):
    """H2O self continuum: C (300/T)^(x+3) p_h2o^2 f^2."""
    vmr, t, p_pa = col(vmrs["H2O"]), col(t), col(p_pa)
    C, x = 1.796e-33, 4.5
    return vmr * C * (300.0 / t) ** (x + 3.0) * (p_pa * vmr) * p_pa * f_grid**2


def h2o_foreign_standard(f_grid, t, p_pa, vmrs):
    """H2O foreign continuum: C (300/T)^(x+3) p p_dry f^2."""
    vmr, t, p_pa = col(vmrs["H2O"]), col(t), col(p_pa)
    C, x = 5.43e-35, 0.0
    pdry = p_pa * (1.0 - vmr)
    return vmr * C * (300.0 / t) ** (x + 3.0) * p_pa * pdry * f_grid**2


# ---------------------------------------------------------------------------
# ELL07 liquid water cloud (Ellison 2007 permittivity + Rayleigh absorption)
# ---------------------------------------------------------------------------
_ELL_A = (79.23882, 3.815866, 1.634967)
_ELL_B = (0.004300598, 0.01117295, 0.006841548)
_ELL_C = (1.382264e-13, 3.510354e-16, 6.30035e-15)
_ELL_D = (652.7648, 1249.533, 405.5169)


def liquidcloud_ell07(f_grid, t, p_pa, vmrs):
    """Suspended-droplet absorption [1/m] from the Ellison (2007) pure-water
    permittivity; vmrs["liquidcloud"] is the LWC [kg/m^3]."""
    lwc = col(vmrs["liquidcloud"])
    tc = col(t) - 273.15
    eps_s = 87.9144 - 0.404399 * tc - 9.58726e-4 * tc**2 - 1.32802e-6 * tc**3
    TC = 133.1383
    delta = [a * torch.exp(-b * tc) for a, b in zip(_ELL_A, _ELL_B)]
    tau = [c * torch.exp(d / (tc + TC)) for c, d in zip(_ELL_C, _ELL_D)]
    delta4 = 0.8379692 - 0.006118594 * tc - 0.000012936798 * tc**2
    f0 = 4235901e6 + (-1426088e4) * tc + 27381570e1 * tc**2 + (-1246943.0) * tc**3
    tau4 = 9.618642e-14 + 1.795786e-16 * tc - 9.310017e-18 * tc**2 + 1.655473e-19 * tc**3
    delta5 = 0.6165532 + 0.007238532 * tc - 0.00009523366 * tc**2
    f1 = 15983170e6 + (-7441357e4) * tc + 497448e3 * tc**2
    tau5 = 2.882476e-14 - 3.142118e-16 * tc + 3.528051e-18 * tc**2

    w = 2.0 * math.pi * f_grid  # [..., F]

    def relax(tt, dd):
        return tt * dd / (1.0 + (w * tt) ** 2), tt**2 * dd / (1.0 + (w * tt) ** 2)

    im3 = sum(relax(tau[i], delta[i])[0] for i in range(3))
    re3 = sum(relax(tau[i], delta[i])[1] for i in range(3))

    def resonant(tt, dd, fr):
        tp2 = (2.0 * math.pi * tt) ** 2
        rep = f_grid * (fr + f_grid) / (1.0 + tp2 * (fr + f_grid) ** 2)
        rem = f_grid * (fr - f_grid) / (1.0 + tp2 * (fr - f_grid) ** 2)
        re = tp2 * dd / 2.0 * (rep - rem)
        im = (math.pi * f_grid * tt * dd
              * (1.0 / (1.0 + tp2 * (fr + f_grid) ** 2)
                 + 1.0 / (1.0 + tp2 * (fr - f_grid) ** 2)))
        return re, im

    re4, im4 = resonant(tau4, delta4, f0)
    re5, im5 = resonant(tau5, delta5, f1)

    re_eps = eps_s - w**2 * re3 - re4 - re5
    im_eps = w * im3 + im4 + im5

    m = 1.0e3  # droplet density [kg/m^3]
    ImNw = 1.5 / m * (3.0 * im_eps / ((re_eps + 2.0) ** 2 + im_eps**2))
    dB_km_to_1_m = 1e-3 / (10.0 * math.log10(math.e))
    return lwc * 1.0e6 * dB_km_to_1_m * 0.1820 * (f_grid * 1e-9) * ImNw


# ---------------------------------------------------------------------------
# MPM2020 O2 (Makarov et al. 2020): 60 GHz band, 2nd-order line mixing
# ---------------------------------------------------------------------------
_M20_C = np.array([
    940.3, 543.4, 1503.0, 1442.1, 2103.4, 2090.7, 2379.9, 2438.0,
    2363.7, 2479.5, 2120.1, 2275.9, 1746.6, 1915.4, 1331.8, 1490.2,
    945.3, 1078.0, 627.1, 728.7, 389.7, 461.3, 227.3, 274.0,
    124.6, 153.0, 64.29, 80.40, 31.24, 39.80, 14.32, 18.56,
    6.193, 8.172, 2.529, 3.397, 0.975, 1.334])
_M20_A2 = np.array([
    0.01, 0.014, 0.083, 0.083, 0.207, 0.207, 0.387, 0.386, 0.621, 0.621,
    0.910, 0.910, 1.255, 1.255, 1.654, 1.654, 2.109, 2.108, 2.618, 2.617,
    3.182, 3.181, 3.800, 3.800, 4.474, 4.473, 5.201, 5.200, 5.983, 5.982,
    6.819, 6.818, 7.709, 7.708, 8.653, 8.652, 9.651, 9.650])
_M20_GA = np.array([
    1.685, 1.703, 1.513, 1.495, 1.433, 1.408, 1.353, 1.353, 1.303, 1.319,
    1.262, 1.265, 1.238, 1.217, 1.207, 1.207, 1.137, 1.137, 1.101, 1.101,
    1.037, 1.038, 0.996, 0.996, 0.955, 0.955, 0.906, 0.906, 0.858, 0.858,
    0.811, 0.811, 0.764, 0.764, 0.717, 0.717, 0.669, 0.669])
_M20_Y0 = np.array([
    -0.041, 0.277, -0.372, 0.559, -0.573, 0.618, -0.366, 0.278,
    -0.089, -0.021, 0.060, -0.152, 0.216, -0.293, 0.373, -0.436,
    0.491, -0.542, 0.571, -0.613, 0.636, -0.670, 0.690, -0.718,
    0.740, -0.763, 0.788, -0.807, 0.834, -0.849, 0.876, -0.887,
    0.915, -0.922, 0.950, -0.955, 0.987, -0.988])
_M20_Y1 = np.array([
    0.0, 0.124, -0.002, 0.008, 0.045, -0.093, 0.264, -0.351,
    0.359, -0.416, 0.326, -0.353, 0.484, -0.503, 0.579, -0.590,
    0.616, -0.619, 0.611, -0.609, 0.574, -0.568, 0.574, -0.566,
    0.60, -0.59, 0.63, -0.62, 0.64, -0.63, 0.65, -0.64,
    0.65, -0.64, 0.65, -0.64, 0.64, -0.62])
_M20_G0 = np.array([
    -0.000695, -0.090, -0.103, -0.239, -0.172, -0.171, 0.028, 0.150,
    0.132, 0.170, 0.087, 0.069, 0.083, 0.067, 0.007, 0.016,
    -0.021, -0.066, -0.095, -0.115, -0.118, -0.140, -0.173, -0.186,
    -0.217, -0.227, -0.234, -0.242, -0.266, -0.272, -0.301, -0.304,
    -0.334, -0.333, -0.361, -0.358, -0.348, -0.344])
_M20_G1 = np.array([
    0., -0.045, 0.007, 0.033, 0.081, 0.162, 0.179, 0.225,
    0.054, 0.003, 0.0004, -0.047, -0.034, -0.071, -0.180, -0.210,
    -0.285, -0.323, -0.363, -0.380, -0.378, -0.387, -0.392, -0.394,
    -0.424, -0.422, -0.465, -0.46, -0.51, -0.50, -0.55, -0.54,
    -0.58, -0.56, -0.62, -0.59, -0.68, -0.65])
_M20_DV0 = np.array([
    -0.00028, 0.00597, -0.0195, 0.032, -0.0475, 0.0541, -0.0232, 0.0154,
    0.0007, -0.0084, -0.0025, -0.0014, -0.0004, -0.0020, 0.005, -0.0066,
    0.0072, -0.008, 0.0064, -0.0070, 0.0056, -0.0060, 0.0047, -0.0049,
    0.0040, -0.0041, 0.0036, -0.0037, 0.0033, -0.0034, 0.0032, -0.0032,
    0.0030, -0.0030, 0.0028, -0.0029, 0.0029, -0.0029])
_M20_DV1 = np.array([
    -0.00039, 0.009, -0.012, 0.016, -0.027, 0.029, 0.006, -0.015,
    0.010, -0.014, -0.013, 0.013, 0.004, -0.005, 0.010, -0.010,
    0.010, -0.011, 0.008, -0.009, 0.003, -0.003, 0.0009, -0.0009,
    0.0017, -0.0016, 0.0024, -0.0023, 0.0024, -0.0024, 0.0024, -0.0020,
    0.0017, -0.0016, 0.0013, -0.0012, 0.0005, -0.0004])
_M20_F0 = np.array([
    118.750334, 56.264774, 62.486253, 58.446588, 60.306056, 59.590983,
    59.164204, 60.434778, 58.323877, 61.150562, 57.612486, 61.800158,
    56.968211, 62.411220, 56.363399, 62.997984, 55.783815, 63.568526,
    55.221384, 64.127775, 54.671180, 64.678910, 54.130025, 65.224078,
    53.595775, 65.764779, 53.066934, 66.302096, 52.542418, 66.836834,
    52.021429, 67.369601, 51.503360, 67.900868, 50.987745, 68.431006,
    50.474214, 68.960312])

_M20_CF = _M20_C / _M20_F0


def o2_mpm2020(f_grid, t, p_pa, vmrs):
    """O2 60-GHz band, Makarov et al. (2020) 2nd-order line mixing (38
    ground-state lines, theta-power adaptation, y/g/dv pressure-scaled
    mixing). Returns alpha [..., F] [1/m]."""
    c = lambda a: const_like(a, f_grid)
    o2 = col(vmrs["O2"])
    p = col(p_pa) * 1e-5  # pa2bar
    theta = 300.0 / col(t)
    dt = theta - 1.0
    tadapt = theta**0.754

    y = (c(_M20_Y0) + c(_M20_Y1) * dt) * (tadapt * p)  # [..., L]
    g = (c(_M20_G0) + c(_M20_G1) * dt) * (tadapt * p) ** 2
    dv = (c(_M20_DV0) + c(_M20_DV1) * dt) * (tadapt * p) ** 2
    ga = c(_M20_GA) * (tadapt * p)
    cc = c(_M20_CF) * (theta**3 * p) * torch.exp(-c(_M20_A2) * dt)

    f = f_grid * 1e-9  # hz2ghz
    fc = f[..., None]
    dv_ = dv[..., None, :]
    dm = detuning(f_grid, _M20_F0) - dv_
    dp = fc + (c(_M20_F0) + dv)[..., None, :]
    ga_, g_, y_ = ga[..., None, :], g[..., None, :], y[..., None, :]
    a = (cc[..., None, :] * ((ga_ * (1.0 + g_) + y_ * dm) / (ga_**2 + dm**2)
                             + (ga_ * (1.0 + g_) - y_ * dp) / (ga_**2 + dp**2))).sum(-1)
    conv = 0.1820 * 1e-7 / (2.0946 * math.log10(math.e))
    # the reference adds only positive sums
    return torch.clamp(conv * o2 * f**2 * a, min=0.0)


from .ckdmt320 import h2o_foreign_ckdmt320, h2o_self_ckdmt320  # noqa: E402
from .ckdmt350 import h2o_foreign_ckdmt350, h2o_self_ckdmt350  # noqa: E402
from .mpm import h2o_mpm89, n2_mpm93, o2_mpm89, o2_tre05  # noqa: E402
from .mt_ckd_misc import (  # noqa: E402
    co2_ckdmt252,
    n2_fun_ckdmt252,
    n2_rot_ckdmt252,
    o2_cia_ckdmt100,
    o2_v0v0_ckdmt100,
    o2_v1v0_ckdmt100,
    o2_vis_ckdmt252,
)
from .pwr20xx import h2o_pwr2021, h2o_pwr2022, n2_pwr2021, o2_pwr2021, o2_pwr2022  # noqa: E402

# the JAX package's registry, in its order
PREDEF_MODELS = {
    "H2O-PWR98": h2o_pwr98,
    "O2-PWR98": o2_pwr98,
    "N2-SelfContStandardType": n2_self_standard,
    "H2O-SelfContStandardType": h2o_self_standard,
    "H2O-ForeignContStandardType": h2o_foreign_standard,
    "liquidcloud-ELL07": liquidcloud_ell07,
    "O2-MPM2020": o2_mpm2020,
    "H2O-SelfContCKDMT350": h2o_self_ckdmt350,
    "H2O-ForeignContCKDMT350": h2o_foreign_ckdmt350,
    "H2O-MPM89": h2o_mpm89,
    "O2-MPM89": o2_mpm89,
    "N2-SelfContMPM93": n2_mpm93,
    "O2-TRE05": o2_tre05,
    "H2O-PWR2021": h2o_pwr2021,
    "H2O-PWR2022": h2o_pwr2022,
    "O2-PWR2021": o2_pwr2021,
    "O2-PWR2022": o2_pwr2022,
    "N2-SelfContPWR2021": n2_pwr2021,
    "H2O-SelfContCKDMT320": h2o_self_ckdmt320,
    "H2O-ForeignContCKDMT320": h2o_foreign_ckdmt320,
    "CO2-CKDMT252": co2_ckdmt252,
    "O2-visCKDMT252": o2_vis_ckdmt252,
    "N2-CIAfunCKDMT252": n2_fun_ckdmt252,
    "N2-CIArotCKDMT252": n2_rot_ckdmt252,
    "O2-CIAfunCKDMT100": o2_cia_ckdmt100,
    "O2-v0v0CKDMT100": o2_v0v0_ckdmt100,
    "O2-v1v0CKDMT100": o2_v1v0_ckdmt100,
}


def predefined_absorption(names, f_grid, t, p_pa, vmrs, device=None, dtype=None):
    """Sum of the named predefined models' absorption [1/m]: [..., F] at the
    points t, p_pa [...] with vmrs {species: [...] or float}, on f_grid
    [F] or one grid per point [..., F].  Differentiable in t, p and the
    VMRs."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    f_grid, t, p_pa = as_t(f_grid), as_t(t), as_t(p_pa)
    vmrs = {k: as_t(v) for k, v in vmrs.items()}
    shape = torch.broadcast_shapes(t.shape + (1,), p_pa.shape + (1,), f_grid.shape)
    alpha = torch.zeros(shape, dtype=dt, device=dev)
    for name in names:
        alpha = alpha + PREDEF_MODELS[name](f_grid, t, p_pa, vmrs)
    return alpha
