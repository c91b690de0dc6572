"""Polarized radiative-transfer algebra on packed tensors (port of
arts_tpu/rtepack/propmat.py).

A propagation matrix is packed as its 7 components (A, B, C, D, U, V, W),
after ARTS's rtepack; it expands to

    [[A, B, C, D],
     [B, A, U, V],
     [C,-U, A, W],
     [D,-V,-W, A]].

`expm` is the closed-form Cayley-Hamilton transmittance of a layer, with
series forms at the degenerate eigenvalue limits.
"""

import torch

# component indices
A, B, C, D, U, V, W = range(7)


def propmat(a=0.0, b=0.0, c=0.0, d=0.0, u=0.0, v=0.0, w=0.0):
    """Pack the 7 components (tensors or numbers) into [..., 7]."""
    comps = [torch.as_tensor(x) for x in (a, b, c, d, u, v, w)]
    dtype = torch.promote_types(comps[0].dtype, torch.get_default_dtype())
    for x in comps[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    return torch.stack(torch.broadcast_tensors(*(x.to(dtype) for x in comps)), -1)


def to_matrix(k):
    """Expand a packed [..., 7] propagation matrix to [..., 4, 4]."""
    a, b, c, d, u, v, w = k.unbind(-1)
    rows = [[a, b, c, d], [b, a, u, v], [c, -u, a, w], [d, -v, -w, a]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _cos_sqrt(t):
    ts = t < 1e-8
    series = 1.0 - t / 2.0 * (1.0 - t / 12.0)
    return torch.where(ts, series, torch.cos(torch.sqrt(torch.where(ts, 1.0, t))))


def _sinc_sqrt(t):  # sin(sqrt t) / sqrt t
    ts = t < 1e-8
    series = 1.0 - t / 6.0 * (1.0 - t / 20.0)
    st = torch.sqrt(torch.where(ts, 1.0, t))
    return torch.where(ts, series, torch.sin(st) / st)


def expm(k, r):
    """Transmittance T = exp(-r K) of a layer with the (averaged) packed
    propagation matrix k [..., 7] and path length r [...]: [..., 4, 4].

    With the traceless part K' of -r K (components b..w),
    T = exp(a) (C0 I + C1 K' + C2 K'^2 + C3 K'^3); the eigenvalues of K'
    are +-x and +-iy with x^2 = (S - Bq)/2, y^2 = (S + Bq)/2.
    """
    a, b, c, d, u, v, w = (-r * x for x in k.unbind(-1))
    b2, c2, d2 = b * b, c * c, d * d
    u2, v2, w2 = u * u, v * v, w * w

    Bq = u2 + v2 + w2 - b2 - c2 - d2
    Cq = -((d * u - c * v + b * w) ** 2)
    disc = torch.clamp(Bq * Bq - 4.0 * Cq, min=0.0)
    # at disc -> 0 the coefficients are entire in (Bq, Cq): Taylor heads
    degen = disc < 1e-16
    S = torch.sqrt(torch.where(degen, 1.0, disc))
    x2 = torch.clamp(0.5 * (S - Bq), min=0.0)
    y2 = torch.clamp(0.5 * (S + Bq), min=0.0)

    # exp(a) folded into the coefficients: for passive media a + x <= 0,
    # so exp(a) cosh(x) as exp(a + x)(1 + e^-2x)/2 never overflows
    x = torch.sqrt(x2)
    ea = torch.exp(a)
    eax = torch.exp(a + x)
    em2x = torch.exp(-2.0 * x)
    e_cx = eax * 0.5 * (1.0 + em2x)  # e^a cosh x
    xs_small = x2 < 1e-8
    e_shx = torch.where(  # e^a sinh(x) / x
        xs_small,
        ea * (1.0 + x2 / 6.0 * (1.0 + x2 / 20.0)),
        eax * 0.5 * (1.0 - em2x) / torch.where(xs_small, 1.0, x),
    )
    e_cy = ea * _cos_sqrt(y2)
    e_sny = ea * _sinc_sqrt(y2)

    inv_s = 1.0 / torch.where(degen, 1.0, x2 + y2)
    C0 = torch.where(degen, ea * (1.0 - Cq / 24.0), (e_cy * x2 + e_cx * y2) * inv_s)
    C1 = torch.where(degen, ea * (1.0 - Cq / 120.0), (e_sny * x2 + e_shx * y2) * inv_s)
    C2 = torch.where(degen, ea * (0.5 - Bq / 24.0), (e_cx - e_cy) * inv_s)
    C3 = torch.where(degen, ea * (1.0 / 6.0 - Bq / 120.0), (e_shx - e_sny) * inv_s)

    C2b = C2 * (c * u + d * v)
    C2c = C2 * (b * u - d * w)
    C2d = C2 * (b * v + c * w)
    C2u = C2 * (b * c - v * w)
    C2v = C2 * (b * d + u * w)
    C2w = C2 * (c * d - u * v)

    C3b = C3 * (b * (Bq - w2) + w * (c * v - d * u))
    C3c = C3 * (c * (v2 - Bq) - v * (d * u + b * w))
    C3d = C3 * (d * (u2 - Bq) - u * (c * v - b * w))
    C3u = C3 * (d * (c * v - b * w) - u * (Bq + d2))
    C3v = C3 * (c * (d * u + b * w) - v * (Bq + c2))
    C3w = C3 * (b * (c * v - d * u) - w * (Bq + b2))

    M00 = C0 + C2 * (b2 + c2 + d2)
    M11 = C0 + C2 * (b2 - u2 - v2)
    M22 = C0 + C2 * (c2 - u2 - w2)
    M33 = C0 + C2 * (d2 - v2 - w2)

    rows = [
        [M00, C1 * b - C2b - C3b, C1 * c + C2c + C3c, C1 * d + C2d + C3d],
        [C1 * b + C2b - C3b, M11, C1 * u + C2u + C3u, C1 * v + C2v + C3v],
        [C1 * c - C2c + C3c, -C1 * u + C2u - C3u, M22, C1 * w + C2w + C3w],
        [C1 * d - C2d + C3d, -C1 * v + C2v - C3v, -C1 * w + C2w - C3w, M33],
    ]
    return torch.stack([torch.stack(rr, -1) for rr in rows], -2)


def inv(k):
    """Inverse of the packed propagation matrix, [..., 4, 4]."""
    return torch.linalg.inv(to_matrix(k))


def matvec(m, s):
    """[..., 4, 4] @ [..., 4]."""
    return (m * s[..., None, :]).sum(-1)


def matmul(m1, m2):
    """[..., 4, 4] @ [..., 4, 4]."""
    return (m1[..., :, :, None] * m2[..., None, :, :]).sum(-2)
