"""Surface reflection of Stokes vectors (port of arts_tpu/rtepack/surface.py,
after ARTS's rtepack_surface.cc and physics_funcs.cc): the scalar and
Mueller reflections, the Fresnel amplitude coefficients, the Fresnel
Mueller matrix in the surface frame and rotated into the frames of the
incoming and outgoing directions, the specular direction and radiance,
and the non-specular radiance summed over visible surface patches.

Complex amplitudes take the complex dtype that matches the real one:
complex128 for float64, complex64 for float32.  Every division by a norm
that can vanish, and every arcsin that can leave its domain, takes a safe
argument in its untaken branch, so derivatives stay finite.
"""

import math

import torch

from .._cuda import resolve, tensor
from ..sun import _sph2cart

_COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


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


def _cplx(x, dev, dt):
    return tensor(x, dev, _COMPLEX[dt])


def fresnel(n1, n2, theta_deg, device=None, dtype=None):
    """Complex Fresnel amplitude coefficients (Rv, Rh) for incidence at
    theta_deg from the normal, from a medium of refractive index n1 onto
    one of n2 (complex or real; broadcast).  The power reflectance is
    |R|^2; total internal reflection gives (1, 1), as ARTS's pair
    overload."""
    dev, dt = resolve(device, dtype)
    n1, n2 = _cplx(n1, dev, dt), _cplx(n2, dev, dt)
    th = torch.deg2rad(tensor(theta_deg, dev, dt))
    cos1 = torch.cos(th)
    sin2 = n1.real * torch.sin(th) / n2.real
    tir = sin2.abs() > 1.0
    cos2 = torch.cos(torch.asin(torch.where(tir, torch.zeros_like(sin2), sin2)))
    a, b = n2 * cos1, n1 * cos2
    c, d = n1 * cos1, n2 * cos2
    rv, rh = (a - b) / (a + b), (c - d) / (c + d)
    one = torch.ones_like(rv)
    return torch.where(tir, one, rv), torch.where(tir, one, rh)


def fresnel_reflectance(rv, rh, device=None, dtype=None):
    """The 4 x 4 Mueller reflectance matrix [..., 4, 4] from the complex
    amplitudes (rv, rh) [...] (ARTS's rtepack::fresnel_reflectance)."""
    dev, dt = resolve(device, dtype)
    rv, rh = _cplx(rv, dev, dt), _cplx(rh, dev, dt)
    pv, ph = rv.abs() ** 2, rh.abs() ** 2
    rmean, rdiff = 0.5 * (pv + ph), 0.5 * (pv - ph)
    a, b = rh * rv.conj(), rv * rh.conj()
    c, d = 0.5 * (a + b).real, 0.5 * (a - b).imag
    z = torch.zeros_like(rmean)
    rows = [(rmean, rdiff, z, z), (rdiff, rmean, z, z), (z, z, c, d), (z, z, -d, c)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _unit(x, fallback=None):
    """(x / |x|, |x| < 1e-12) over the last axis: `fallback` (or x itself)
    where the norm vanishes."""
    n2 = (x * x).sum(-1, keepdim=True)
    small = n2 < 1e-24
    u = x / torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    return (u if fallback is None else torch.where(small, fallback, u)), small[..., 0]


def _pol_basis(k):
    """(v, h) polarization basis [..., 3] for the propagation direction k
    [..., 3], local z up (ARTS's pol_basis)."""
    zhat = torch.tensor([0.0, 0.0, 1.0], dtype=k.dtype, device=k.device)
    xhat = torch.tensor([1.0, 0.0, 0.0], dtype=k.dtype, device=k.device)
    h, _ = _unit(torch.linalg.cross(k, zhat.expand_as(k)), xhat)
    return torch.linalg.cross(h, k), h


def _stokes_rotation(cos2psi, sin2psi):
    z, o = torch.zeros_like(cos2psi), torch.ones_like(cos2psi)
    rows = [(o, z, z, z), (z, cos2psi, sin2psi, z), (z, -sin2psi, cos2psi, z), (z, z, z, o)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _stokes_rotation_refl(cos2psi, sin2psi):
    z, o = torch.zeros_like(cos2psi), torch.ones_like(cos2psi)
    rows = [(o, z, z, z), (z, cos2psi, -sin2psi, z), (z, sin2psi, -cos2psi, z), (z, z, z, -o)]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _flip_uv(m):
    return torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=m.dtype, device=m.device)[:, None] * m


def _incidence_frame(k_inc, n_surface):
    """(m, normal): the unit normal of the plane of incidence, k_inc x n, and
    where the incidence is normal (k_inc parallel to n)."""
    return _unit(torch.linalg.cross(k_inc, n_surface.expand_as(k_inc)))


def fresnel_reflectance_specular(rv, rh, k_inc, n_surface, device=None, dtype=None):
    """The Fresnel Mueller matrix [..., 4, 4] rotated into the frames of
    the incoming and the specular direction (ARTS's
    rtepack::fresnel_reflectance_specular); k_inc [..., 3] points toward
    the surface, n_surface [..., 3] is the outward normal.  At normal
    incidence U and V flip."""
    dev, dt = resolve(device, dtype)
    k_inc, n_surface = tensor(k_inc, dev, dt), tensor(n_surface, dev, dt)
    mf = fresnel_reflectance(rv, rh, device=dev, dtype=dt)
    m, normal = _incidence_frame(k_inc, n_surface)
    v_i, h_i = _pol_basis(k_inc)
    cp, sp = (h_i * m).sum(-1), (v_i * m).sum(-1)
    c2, s2 = 2.0 * cp * cp - 1.0, 2.0 * sp * cp
    rot = _stokes_rotation_refl(c2, -s2) @ mf @ _stokes_rotation(c2, s2)
    return torch.where(normal[..., None, None], _flip_uv(mf), rot)


def fresnel_reflectance_nonspecular(rv, rh, k_inc, k_out, n_surface, device=None, dtype=None):
    """The Fresnel Mueller matrix [..., 4, 4] for independent incoming and
    outgoing directions k_inc, k_out [..., 3] (ARTS's
    rtepack::fresnel_reflectance_nonspecular)."""
    dev, dt = resolve(device, dtype)
    k_inc, k_out, n_surface = (tensor(x, dev, dt) for x in (k_inc, k_out, n_surface))
    mf = fresnel_reflectance(rv, rh, device=dev, dtype=dt)
    m, normal = _incidence_frame(k_inc, n_surface)
    v_i, h_i = _pol_basis(k_inc)
    cp1, sp1 = (h_i * m).sum(-1), (v_i * m).sum(-1)
    l1 = _stokes_rotation(2 * cp1 * cp1 - 1, 2 * sp1 * cp1)
    v_r, h_r = _pol_basis(k_out.expand_as(k_inc))
    cp2, sp2 = (m * h_r).sum(-1), (m * v_r).sum(-1)
    l2 = _stokes_rotation_refl(2 * cp2 * cp2 - 1, 2 * sp2 * cp2)
    return torch.where(normal[..., None, None], _flip_uv(mf), l2 @ mf @ l1)


def specular_reflected_direction(k_inc, n_surface, device=None, dtype=None):
    """k_out = k_inc - 2 (k_inc . n) n, normalized."""
    dev, dt = resolve(device, dtype)
    k_inc, n_surface = tensor(k_inc, dev, dt), tensor(n_surface, dev, dt)
    out = k_inc - 2.0 * (k_inc * n_surface).sum(-1, keepdim=True) * n_surface
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True)


def specular_radiance(I_in, J, rv, rh, k_inc, n_surface, device=None, dtype=None):
    """I_out = J + R_spec (I_in - J) for Stokes I_in, J [..., 4] (ARTS's
    specular_radiance)."""
    dev, dt = resolve(device, dtype)
    R = fresnel_reflectance_specular(rv, rh, k_inc, n_surface, device=dev, dtype=dt)
    I_in, J = tensor(I_in, dev, dt), tensor(J, dev, dt)
    return J + torch.einsum("...ij,...j->...i", R, I_in - J)


def nonspecular_radiance_from_patches(coords_latlon, patch_alt, sources, J, rv, rh, pos_latlon,
                                      h_pos, n_surface, k_out, radius, dlat_deg, dlon_deg,
                                      device=None, dtype=None):
    """The radiance [4] leaving a scatter point on rough terrain toward
    k_out: J plus the non-specular reflection of the radiance arriving from
    the visible surface patches (ARTS's
    rtepack::nonspecular_radiance_from_patches),

        L_out = J + (1 / pi) sum_j R(k_j, k_out) L_j cos(theta_P) dOmega_j,
        dOmega_j = A_j cos(alpha_j) / r_j^2,

    summed over all patches at once.  coords_latlon [P, 2] the patches'
    (lat, lon) [deg] and patch_alt [P] their heights; sources [P, 4] the
    Stokes radiance leaving each patch toward the point; J [4] the
    point's emission; pos_latlon, h_pos the point; n_surface, k_out [3]
    unit vectors (ECEF); radius the spherical planet's; dlat_deg, dlon_deg
    the patch grid's spacing."""
    dev, dt = resolve(device, dtype)
    t = lambda x: tensor(x, dev, dt)
    coords, patch_alt, sources, J = t(coords_latlon), t(patch_alt), t(sources), t(J)
    pos_latlon, n_surface, k_out = t(pos_latlon), t(n_surface), t(k_out)
    lat_j, lon_j = coords[:, 0], coords[:, 1]
    r_j = radius + patch_alt
    pos_j = _sph2cart(r_j, lat_j, lon_j)  # [P, 3]
    pos_P = _sph2cart(radius + t(h_pos), pos_latlon[0], pos_latlon[1])
    rvec = pos_P - pos_j
    r = torch.linalg.vector_norm(rvec, dim=-1)
    ok_r = r > 1.0
    r_safe = torch.where(ok_r, r, torch.ones_like(r))
    k_inc = rvec / r_safe[:, None]
    n_j = _sph2cart(torch.ones_like(r_j), lat_j, lon_j)
    cos_alpha = (n_j * k_inc).sum(-1)  # the emission angle at patch j
    cos_theta = -(n_surface * k_inc).sum(-1)  # the incidence angle at the point
    vis = ok_r & (cos_alpha > 0.0) & (cos_theta > 0.0)
    area = (r_j * r_j * abs(math.radians(dlat_deg) * math.radians(dlon_deg))
            * torch.cos(torch.deg2rad(lat_j)).abs())
    d_omega = area * cos_alpha / (r_safe * r_safe)
    R = fresnel_reflectance_nonspecular(rv, rh, k_inc, k_out, n_surface, device=dev, dtype=dt)
    wgt = torch.where(vis, cos_theta * d_omega / math.pi, torch.zeros_like(r))
    return J + torch.einsum("p,pij,pj->i", wgt, R, sources)
