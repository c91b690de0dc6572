"""Gas absorption assembly shared by the forward operators (port of
arts_tpu/fwd.py:species_absorption, line-catalog branch only)."""

from .lbl.voigt import absorption_kernel


def species_absorption(scene, fg, t, p, v, plain=False):
    """Absorption [Z, F] at the points t, p [Z], v [Z, S] through the
    Voigt kernel (its plain version on CPU tensors, or anywhere with
    plain=True)."""
    return absorption_kernel(fg, scene.cat, scene.pf, t, p, v, plain=plain,
                             device=fg.device, dtype=fg.dtype)
