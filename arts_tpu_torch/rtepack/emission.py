"""Layer-recursion polarized emission (port of arts_tpu/rtepack/emission.py:
emission_polarized, the "constant" discretization of ARTS's rte_emission).

From the background radiance at the far end of the path,

    I_i = T_{i+1} (I_{i+1} - Jbar) + Jbar,   Jbar = 0.5 (J_i + J_{i+1}),

T_{i+1} = exp(-0.5 (K_i + K_{i+1}) r_{i+1}) the layer's transmittance.
JAX scans over layers; here it is a Python loop over layers with the
whole frequency axis in each step.  Path point 0 is the observer, point
np-1 the background.  Not ported yet: the lintau and linprop forms.
"""

from .propmat import expm, matvec


def emission_polarized(k, J, r, I0):
    """Stokes radiance at point 0 [F, 4]: k [np, F, 7], J [np, F, 4],
    r [np-1] layer lengths, I0 [F, 4] background."""
    k_lay = 0.5 * (k[:-1] + k[1:])  # [np-1, F, 7]
    T = expm(k_lay, r[:, None])  # [np-1, F, 4, 4]
    j_lay = 0.5 * (J[:-1] + J[1:])
    I = I0
    for i in reversed(range(T.shape[0])):
        I = matvec(T[i], I - j_lay[i]) + j_lay[i]
    return I
