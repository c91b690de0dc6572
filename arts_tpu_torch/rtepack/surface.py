"""Surface reflection of Stokes vectors (port of the scalar and Mueller
reflections of arts_tpu/rtepack/surface.py, after ARTS's
rtepack_surface.cc).  Not ported yet: the Fresnel and BRDF parts
(ROADMAP §A 6)."""

import torch


def _sign_v(I):
    """[1, 1, 1, -1]: reflection mirrors V."""
    return torch.tensor([1.0, 1.0, 1.0, -1.0], dtype=I.dtype, device=I.device)


def flat_scalar_reflection(I, R, B):
    """[R, R, R, -R] * I + (1 - R) * B for Stokes I, B [..., 4] and a scalar
    reflectance R [...]: V mirrored, emissivity 1 - R."""
    R = torch.as_tensor(R, dtype=I.dtype, device=I.device)[..., None]
    return _sign_v(I) * R * I + (1.0 - R) * B


def reflection(I, R, B):
    """Mueller reflection R I (V mirrored) + (1 - R) B, for I, B [..., 4] and
    R [..., 4, 4]."""
    ri = torch.einsum("...ij,...j->...i", R, I) * _sign_v(I)
    eb = B - torch.einsum("...ij,...j->...i", R, B)
    return ri + eb
