"""Refractivity and refracted pencil-beam paths in a spherically symmetric
atmosphere (port of arts_tpu/path/refraction.py).

The path tracer is host-side numpy, as the port's path/geometry.py: it
marches the Bouguer invariant n(r) r sin(za) = const between radius
shells.  The microwave refractivity is the Smith-Weintraub relation.
"""

import numpy as np
import torch

from .geometry import EARTH_RADIUS, PathGeometry


def microwave_refractivity(p, t, h2o_vmr=0.0):
    """n - 1 from the Smith-Weintraub formula (N-units 77.6 (p - e) / T +
    72 e / T + 3.75e5 e / T^2, p and e in hPa).  Plain arithmetic: numpy
    arrays, floats or tensors (simulate_clearsky's refracted sun leg
    calls it on the levels' tensors)."""
    p_hpa = p / 100.0
    e_hpa = p_hpa * h2o_vmr
    N = 77.6 * (p_hpa - e_hpa) / t + 72.0 * e_hpa / t + 3.75e5 * e_hpa / t**2
    return N * 1e-6


def _numpy(x):
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def refractivity_profile(atm, h2o_index=None):
    """(z, n) numpy arrays [N] of an Atmosphere1D's levels; h2o_index, the
    row of atm.vmr holding H2O (None: dry)."""
    z, t, p = _numpy(atm.z), _numpy(atm.t), _numpy(atm.p)
    h2o = _numpy(atm.vmr)[h2o_index] if h2o_index is not None else np.zeros_like(z)
    return z, 1.0 + microwave_refractivity(p, t, h2o)


def refracted_path_1d(alt_obs, za_obs, z_surf, z_toa, z_n, n_of_z, max_step=1000.0,
                      radius=EARTH_RADIUS) -> PathGeometry:
    """Refracted pencil-beam path (observer first) for a 1-D atmosphere.

    z_n, n_of_z: samples of the refractive index, interpolated linearly
    (n = 1 above the top sample).  Marches the Bouguer invariant in radius
    shells of at most max_step; handles surface hits and refracted
    tangent points (found by bisection)."""
    z_n, n_of_z = _numpy(z_n), _numpy(n_of_z)

    def n_at(alt):
        return np.interp(alt, z_n, n_of_z, left=n_of_z[0], right=1.0)

    r_obs = radius + alt_obs
    r_surf = radius + z_surf
    r_toa = radius + z_toa
    za0 = np.deg2rad(za_obs)
    # the Bouguer constant at the observer (n = 1 above the top)
    B = (1.0 if alt_obs >= z_toa else n_at(min(alt_obs, z_toa))) * r_obs * np.sin(za0)

    def za_at(r):
        return np.arcsin(np.clip(B / (n_at(r - radius) * r), 0.0, 1.0))

    nshell = max(int(np.ceil((z_toa - z_surf) / max_step)), 2)
    shells = radius + np.linspace(z_surf, z_toa, nshell + 1)
    alts, esses, zas = [], [], []
    s_acc = 0.0

    def push(r, za_rad, descending):
        alts.append(r - radius)
        esses.append(s_acc)
        zas.append(180.0 - np.degrees(za_rad) if descending else np.degrees(za_rad))

    def path(background):
        return PathGeometry(alt=np.asarray(alts), s=np.asarray(esses), za=np.asarray(zas),
                            background=background)

    if za_obs > 90.0:
        # down from the top (or the observer) to the tangent point or the
        # surface
        r = min(r_obs, r_toa)
        descending = True
        push(r, za_at(r), True)
        for r2 in shells[shells < r][::-1]:
            if n_at(r2 - radius) * r2 <= B:
                # turning point below r: bisect for the tangent radius
                lo, hi = r2, r
                for _ in range(60):
                    mid = 0.5 * (lo + hi)
                    if n_at(mid - radius) * mid <= B:
                        lo = mid
                    else:
                        hi = mid
                s_acc += _step_len(r, hi, za_at(r), za_at(hi))
                push(hi, np.pi / 2, True)
                descending = False
                break
            s_acc += _step_len(r, r2, za_at(r), za_at(r2))
            push(r2, za_at(r2), True)
            r = r2
        if descending and r <= r_surf + 1e-6:
            return path("surface")
        # back up and out through the top
        r = alts[-1] + radius
        for r2 in shells[shells > r + 1e-9]:
            s_acc += _step_len(r, r2, za_at(r), za_at(r2))
            push(r2, za_at(r2), False)
            r = r2
        return path("space")
    r = max(r_obs, r_surf)
    push(r, za_at(r), False)
    for r2 in shells[shells > r + 1e-9]:
        s_acc += _step_len(r, r2, za_at(r), za_at(r2))
        push(r2, za_at(r2), False)
        r = r2
    return path("space")


def _step_len(r1, r2, za1, za2):
    """Arc length between two shells from the mean of cos(za); near the
    tangent (mean cosine below 1e-3) the straight-chord limit
    sqrt(|r2^2 - r1^2|)."""
    cbar = 0.5 * (np.cos(za1) + np.cos(za2))
    if cbar < 1e-3:
        return np.sqrt(abs(r2**2 - r1**2))
    return abs(r2 - r1) / cbar
