"""The lines x frequencies Voigt contraction: the CUDA kernels, their plain
PyTorch versions, and the tensor code around them (port of
arts_tpu/ops/voigt_kernel.py).

    out[z, f] = Re sum_l s_l (w(z_l(f)) - wcut_l)  over |f - f0_l| <= cut_l,
    z_l(f) = inv_gd_l (f - f0_l) + i z_imag_l,

for every atmospheric level z at once (JAX vmaps the kernel over levels;
here levels are an explicit leading axis and one launch covers them all).
The polarized form (voigt_sum_pol, for Zeeman pseudo-lines) weights each
line's term with its polarization's row of a per-level [3, 7] table,

    out[z, c, f] = sum_l tab[z, pol_l, c] Re s_l (w(z_l(f)) - wcut_l),

sharing one w(z) per (line, frequency) across the 7 components.

Around the kernel, in tensor code on the device:
  * lines are padded to whole blocks of tl (padded lines: z_imag = 1,
    cutoff = -1 and zero strength, so they never land inside a window) and
    frequencies to whole tiles of tf (repeating the last frequency); the
    polarized form pads each polarization's lines to whole blocks, so that
    every block holds one polarization (blkpol [nl]);
  * the kernel reads each block's lines as 8-wide records (REC_COLS);
  * `_classify_visits` marks the (level, tile, block) pairs whose cutoff
    windows meet the tile; `_multipole_far` takes the provably far pairs
    out of that set and evaluates them as a 12-term pole expansion;
  * `_visit_lists` turns the marks into per-(level, tile) lists of visited
    blocks, which the kernel walks.
The far field of the polarized form carries the 7 components: each
line's moments are weighted by its [7] row (its block's polarization's)
before the block sums.

Per (tile, block) the kernel chooses the cheapest valid w(z) tier from the
lower bound |z|^2 >= (igd_min gap)^2 + zi_min^2: deep (1-term Laurent),
asym (3 terms at f32, 4 at f64), mid (6 / 8 terms) or the Weideman rational
blended with the asymptotic series.  The plain version applies the same
rule with dense masked tensor ops, so the two agree to roundoff.

Not ported, because they exist for the TPU's static grid: max_visits,
voigt_visit_bound and tune_lbl_kernel (a CUDA block reads its own visit
count), sub-tiles (nsub), the coarse-grid far field, and the approximate
reciprocal with its Newton step (the card divides exactly).
"""

import ctypes
import math

import torch

from .. import _cuda
from .wofz import _weideman_coeffs

_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_ASYM_R2 = 512.0
_DEEP_R2 = 1.0e6
_MP_TERMS = 12
_MP_KAPPA = 3.5
TF, TL = 256, 128  # frequency tile and line block (fixed in csrc/voigt_sum.cu)
# Laurent coefficients c_k = (2k-1)!!/2^k of w ~ i/(sqrt(pi) z) sum c_k z^-2k
_LAURENT_C = (1.0, 0.5, 0.75, 15.0 / 8.0, 105.0 / 16.0, 945.0 / 32.0,
              10395.0 / 64.0, 135135.0 / 128.0)

LINE_COLS = ("f0", "inv_gd", "z_imag", "s_re", "s_im", "cutoff", "swc", "res")
# the kernel's line record: two 16-byte halves in float32.  The line's
# centre is f0 + res: res is what rounding f0 left out (0 unless given),
# subtracted after f - f0, which is exact where f is near f0
REC_COLS = ("f0", "inv_gd", "z_imag", "cutoff", "s_re", "s_im", "swc", "res")
_F0, _IGD, _ZI, _CUT, _SR, _SI, _SWC, _RES = range(8)
EXT_COLS = ("f0_min", "f0_max", "igd_min", "zi_min")


def _tier_params(dtype):
    """(mid gate |z|^2, mid terms, asym terms) per precision."""
    return (36.0, 6, 3) if dtype == torch.float32 else (150.0, 8, 4)


def weideman_order(dtype):
    """Weideman rational order: 16 reaches float32 roundoff, 24 float64."""
    return 16 if dtype == torch.float32 else 24


def pair_flops(dtype):
    """Floating-point operations per (line, frequency) pair of each tier,
    counted from the tier arithmetic of the plain version below (add,
    multiply and divide count 1, a fused multiply-add 2): the work, which
    the kernel may do in fewer instructions.  Includes the 7 shared by
    every tier (the
    frequency offset, z, the strength product, the cutoff subtraction and
    the accumulation).  "weideman_series" is a pair of a Weideman-tier
    block whose own |z|^2 > 512 takes the series instead of the rational.
    """
    _, mid_terms, asym_terms = _tier_params(dtype)
    n = weideman_order(dtype)
    series = lambda k: 23 + 7 * (k - 1)
    return {
        "deep": 7 + 7,
        "asym": 7 + series(asym_terms),
        "mid": 7 + series(mid_terms),
        "weideman_series": 7 + 3 + series(asym_terms),
        "weideman": 7 + 3 + 33 + 7 * n,
    }


# ---------------------------------------------------------------------------
# w(z) tiers as real pairs (the plain version's arithmetic, as in the kernel)
# ---------------------------------------------------------------------------


def _wofz_weideman(zr, zi, Lw, a):
    dr = Lw + zi  # Re(L - iz)
    di = -zr  # Im(L - iz)
    inv_d2 = 1.0 / (dr * dr + di * di)
    nr = Lw - zi  # Re(L + iz)
    ni = zr
    Zr = (nr * dr + ni * di) * inv_d2
    Zi = (ni * dr - nr * di) * inv_d2
    pr = torch.zeros_like(zr)
    pi = torch.zeros_like(zr)
    for c in a:
        pr, pi = pr * Zr - pi * Zi + c, pr * Zi + pi * Zr
    t_r = (2.0 * (pr * dr + pi * di)) * inv_d2 + _INV_SQRT_PI
    t_i = (2.0 * (pi * dr - pr * di)) * inv_d2
    return (t_r * dr + t_i * di) * inv_d2, (t_i * dr - t_r * di) * inv_d2


def _wofz_asym(zr, zi, terms):
    inv_r2 = 1.0 / (zr * zr + zi * zi)
    u_r = (zr * zr - zi * zi) * inv_r2 * inv_r2
    u_i = (-2.0 * zr * zi) * inv_r2 * inv_r2
    cs = _LAURENT_C[:terms]
    s_r = torch.full_like(zr, cs[-1])
    s_i = torch.zeros_like(zr)
    for c in reversed(cs[:-1]):
        s_r, s_i = s_r * u_r - s_i * u_i + c, s_r * u_i + s_i * u_r
    f_r = zi * inv_r2 * _INV_SQRT_PI
    f_i = zr * inv_r2 * _INV_SQRT_PI
    return f_r * s_r - f_i * s_i, f_r * s_i + f_i * s_r


def _wofz_deep(zr, zi):
    inv = 1.0 / (zr * zr + zi * zi) * _INV_SQRT_PI
    return zi * inv, zr * inv


def _wofz_parts(zr, zi, Lw, a, asym_terms):
    """Weideman blended with the asymptotic series at |z|^2 > 512."""
    big = zr * zr + zi * zi > _ASYM_R2
    w_r, w_i = _wofz_weideman(zr, zi, Lw, a)
    safe = torch.full_like(zr, 100.0)
    wa_r, wa_i = _wofz_asym(torch.where(big, zr, safe), torch.where(big, zi, safe),
                            asym_terms)
    return torch.where(big, wa_r, w_r), torch.where(big, wa_i, w_i)


# ---------------------------------------------------------------------------
# tensor code around the kernel
# ---------------------------------------------------------------------------


def _multipole_far(f_flat, t_lo, t_hi, f0, igd, zi, sr, si, cutoff, swc,
                   igd_min, zi_min, nl, tl, pw=None, terms=_MP_TERMS,
                   kappa=_MP_KAPPA):
    """Fast-multipole Lorentzian far field.

    Beyond the asymptotic gate each line's s w(z) is a rational function
    with poles at f0_l - i G0_l; a block of lines collapses to one
    `terms`-term expansion around its pole centroid c,
    sum_l s_l w_l(f) ~ sum_j M_j (R/(f - c))^j, valid for |f - c| >= kappa R.
    Line arrays are [Z, nl*tl]; t_lo/t_hi [nf]; pw None or [Z, nl*tl, C]
    per-line component weights.  Returns (far [Z, nf, nl] bool, mp
    [Z, nf*tf], or [Z, nf*tf, C] with pw).
    """
    dtype = f_flat.dtype
    Z = f0.shape[0]
    blk = lambda x: x.view(Z, nl, tl)
    igd_b = blk(igd)
    igd_s = torch.where(igd_b > 0, igd_b, torch.ones_like(igd_b))
    G0 = blk(zi) / igd_s  # Lorentz HWHM in frequency
    f0b = blk(f0)
    c_re = f0b.mean(-1)  # [Z, nl] pole centroid
    c_im = -G0.mean(-1)
    dp = torch.complex(f0b - c_re[..., None], -(G0 + c_im[..., None]))
    R = torch.clamp(torch.sqrt((dp.abs() ** 2).amax(-1)), min=1.0)
    q = dp / R[..., None]  # scaled pole offsets, |q| <= 1

    # per-line pole strengths b_k = (i s/sqrt(pi)) c_k / igd^(2k+1), scaled
    # by R^-(2k+1) so every moment term is O(1) in float32
    is_c = 1j * torch.complex(blk(sr), blk(si)) * _INV_SQRT_PI
    A = [is_c * (_LAURENT_C[k] / (igd_s * R[..., None]) ** (2 * k + 1))
         for k in range(3)]
    qp = [torch.ones_like(q)]
    for _ in range(terms - 1):
        qp.append(qp[-1] * q)
    if pw is None:
        msum = lambda x: x.sum(-1)[..., None]  # [Z, nl, 1]
    else:  # weighted block sums [Z, nl, C]
        pw_b = pw.view(Z, nl, tl, -1)
        msum = lambda x: torch.einsum(
            "zbt,zbtc->zbc", x, pw_b.to(x.dtype))
    M = []  # M_j = sum_l sum_k binom(j-1, 2k) A_kl q_l^(j-2k-1)
    for j in range(1, terms + 1):
        acc = 0.0
        for k in range(3):
            m = j - 2 * k - 1
            if m >= 0:
                acc = acc + math.comb(j - 1, 2 * k) * (A[k] * qp[m])
        M.append(msum(acc))  # [Z, nl, C] complex
    swc_sum = msum(blk(swc))

    # far classification per (tile, block)
    gap = torch.clamp(torch.maximum(c_re[:, None, :] - t_hi[None, :, None],
                                    t_lo[None, :, None] - c_re[:, None, :]), min=0.0)
    far = gap * gap + (c_im * c_im)[:, None, :] >= ((kappa * R) ** 2)[:, None, :]
    # every line's |z|^2 must clear the asymptotic gate
    gmin = igd_min[:, None, :] * gap
    far &= gmin * gmin + (zi_min * zi_min)[:, None, :] > 2.0 * _ASYM_R2
    # the tile must sit inside every line's cutoff window (padded lines'
    # inverted windows exclude their block)
    win_in_lo = (f0b - blk(cutoff)).amax(-1)
    win_in_hi = (f0b + blk(cutoff)).amin(-1)
    far &= (t_lo[None, :, None] >= win_in_lo[:, None, :]) & (
        t_hi[None, :, None] <= win_in_hi[:, None, :])

    # evaluation: u = R/(f - c), powers contracted over blocks
    tf = f_flat.shape[0] // t_lo.shape[0]
    farf = far.repeat_interleave(tf, dim=1)  # [Z, F, nl]
    den = torch.complex(f_flat[None, :, None] - c_re[:, None, :],
                        (-c_im)[:, None, :].expand(farf.shape))
    u = torch.where(farf, R[:, None, :] / den, torch.zeros_like(den))
    mp = torch.zeros(farf.shape[:2] + swc_sum.shape[-1:], dtype=dtype,
                     device=f_flat.device)
    U = u
    with _cuda.full_f32_matmul():
        for j in range(terms):
            Mc = M[j]  # [Z, nl, C]
            mp = mp + (U.real @ Mc.real - U.imag @ Mc.imag)
            if j < terms - 1:
                U = U * u
        mp = mp - farf.to(dtype) @ swc_sum
    return far, (mp[..., 0] if pw is None else mp)


_PAD_FILL = dict(z_imag=1.0, cutoff=-1.0)


def _pad_lines(nl, tl, *cols):
    """Pad [Z, L] line columns (f0, inv_gd, z_imag, s_re, s_im, cutoff,
    swc) to nl*tl lines: z_imag 1 keeps the block minima meaningful,
    cutoff -1 keeps padded lines out of every window."""
    L = cols[0].shape[-1]
    pad = nl * tl - L
    if not pad:
        return cols
    return tuple(
        torch.nn.functional.pad(c, (0, pad), value=_PAD_FILL.get(name, 0.0))
        for name, c in zip(LINE_COLS, cols)
    )


def _group_lines(polidx, tl, cols):
    """Polarization-pure blocks: ([Z, nl*tl] line columns, blkpol [nl]
    int32).  Each polarization's lines, in their given order, are padded
    as _pad_lines pads to whole blocks of tl, pi first; a polarization
    without lines has no block."""
    c = torch.bincount(polidx.clamp(-1, 3) + 1, minlength=5).tolist()
    if c[0] or c[4]:
        raise ValueError("voigt_inputs: polarization indices must be 0, 1 or 2")
    counts = c[1:4]
    nb = [-(-n // tl) for n in counts]
    dev = polidx.device
    order = torch.argsort(polidx, stable=True)
    p_sorted = polidx[order]
    start = torch.tensor([0, counts[0], counts[0] + counts[1]], device=dev)
    base = torch.tensor([0, nb[0] * tl, (nb[0] + nb[1]) * tl], device=dev)
    dest = torch.arange(order.shape[0], device=dev) - start[p_sorted] + base[p_sorted]
    Z, Lp = cols[0].shape[0], sum(nb) * tl
    out = []
    for name, col in zip(LINE_COLS, cols):
        g = torch.full((Z, Lp), _PAD_FILL.get(name, 0.0), dtype=col.dtype, device=dev)
        g[:, dest] = col[:, order]
        out.append(g)
    blkpol = torch.repeat_interleave(torch.arange(3, dtype=torch.int32, device=dev),
                                     torch.tensor(nb, device=dev))
    return tuple(out), blkpol.contiguous()


def _classify_visits(f_grid, f0, inv_gd, z_imag, s_re, s_im, cutoff, swc,
                     nf, tf, nl, tl, pw=None):
    """visit [Z, nf, nl]: the block's cutoff windows meet the tile and it
    is not left to the multipole far field.  Also returns the far field
    ([Z, nf*tf], or [Z, nf*tf, C] with per-line weights pw [Z, nl*tl, C])
    and the block extrema [Z, 4, nl] the kernel reads."""
    Z = f0.shape[0]
    blk = lambda x: x.view(Z, nl, tl)
    win_lo = blk(f0 - cutoff).amin(-1)
    win_hi = blk(f0 + cutoff).amax(-1)
    ext = torch.stack([blk(f0).amin(-1), blk(f0).amax(-1),
                       blk(inv_gd).amin(-1), blk(z_imag).amin(-1)], 1)
    tiles = f_grid.view(nf, tf)
    t_lo, t_hi = tiles[:, 0], tiles[:, -1]
    visit = (win_hi[:, None, :] >= t_lo[None, :, None]) & (
        win_lo[:, None, :] <= t_hi[None, :, None])
    far, mp = _multipole_far(f_grid, t_lo, t_hi, f0, inv_gd, z_imag, s_re, s_im,
                             cutoff, swc, ext[:, 2], ext[:, 3], nl, tl, pw)
    return visit & ~far, mp, ext.contiguous()


def _visit_lists(visit):
    """(blkidx [Z, nf, nl] int32, nvisit [Z, nf] int32): the visited
    blocks of each (level, tile) first, in ascending order; the slots past
    nvisit repeat the last visited block."""
    nl = visit.shape[-1]
    nvisit = visit.sum(-1).to(torch.int32)
    order = torch.argsort((~visit).to(torch.int32), dim=-1, stable=True)
    last = order.gather(-1, (nvisit.long() - 1).clamp(min=0)[..., None])
    jidx = torch.arange(nl, device=visit.device)
    blkidx = torch.where(jidx < nvisit[..., None], order, last)
    return blkidx.to(torch.int32).contiguous(), nvisit.contiguous()


def weideman_table(n, dtype, device):
    """[n + 1]: the Weideman scale L, then the n polynomial coefficients."""
    Lw, a = _weideman_coeffs(n)
    return torch.tensor((Lw,) + a, dtype=dtype, device=device)


def _line_records(cols):
    """[Z, L, 8] kernel records (REC_COLS) from the LINE_COLS columns."""
    f0, igd, zi, sr, si, cut, swc, res = cols
    return torch.stack([f0, igd, zi, cut, sr, si, swc, res], -1).contiguous()


def voigt_inputs(f_grid, f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re,
                 wcut_im, polidx=None, table=None, res=None):
    """The kernel's inputs (f, lines, ext, blkidx, nvisit, wcoef) and the
    multipole far field for [Z, L] line columns on an [F] grid; lines are
    [Z, nl*tl, 8] records (REC_COLS).  res [Z, L] (0 when None): each
    centre's remainder after rounding to f0, subtracted after f - f0 for
    the pairs the kernel evaluates; the visit lists and the far field take
    f0.

    With a polarization index per line, polidx [L] in 0..2, and per-level
    weight rows table [Z, 3, 7], the lines are grouped into
    polarization-pure blocks, the inputs also carry (blkpol [nl] int32,
    the polarization of each block, and table) and the far field has 7
    components."""
    tf, tl = TF, TL
    F = f_grid.shape[0]
    L = f0.shape[-1]
    nf = -(-F // tf)
    if nf * tf > F:
        f_grid = torch.cat([f_grid, f_grid[-1:].expand(nf * tf - F)])
    swc = s_re * wcut_re - s_im * wcut_im
    cols = (f0, inv_gd, z_imag, s_re, s_im, cutoff, swc,
            torch.zeros_like(f0) if res is None else res)
    blkpol = pw = None
    if polidx is None:
        nl = -(-L // tl)
        cols = _pad_lines(nl, tl, *cols)
    else:
        cols, blkpol = _group_lines(polidx, tl, cols)
        nl = blkpol.shape[0]
        table = table.to(f_grid.dtype).contiguous()
        pw = table[:, blkpol.long().repeat_interleave(tl)]  # [Z, nl*tl, 7]
    visit, mp, ext = _classify_visits(f_grid, *cols[:_RES], nf, tf, nl, tl, pw)
    blkidx, nvisit = _visit_lists(visit)
    wcoef = weideman_table(weideman_order(f_grid.dtype), f_grid.dtype, f_grid.device)
    args = (f_grid.contiguous(), _line_records(cols), ext, blkidx, nvisit, wcoef)
    if blkpol is not None:
        args += (blkpol, table)
    return args, mp


def voigt_sum(f_grid, f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re, wcut_im,
              plain=False):
    """Re sum_l s_l (w(z_l(f)) - wcut_l) masked to |f - f0_l| <= cut_l.

    f_grid [F]; line columns [L] or [Z, L] (one row per level); returns
    [F] or [Z, F].  Frequencies and f0 should share a common anchor shift
    for float32.  cutoff must be finite (1e30 with wcut 0 means none).
    plain=True runs the kernel's plain PyTorch version on any device.
    """
    one = f0.dim() == 1
    cols = [c[None] if one else c for c in
            (f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re, wcut_im)]
    args, mp = voigt_inputs(f_grid, *cols)
    out = ((voigt_kernel_plain if plain else voigt_kernel)(*args) + mp)[:, : f_grid.shape[0]]
    return out[0] if one else out


def voigt_sum_pol(f_grid, f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re,
                  wcut_im, polidx, table, res=None):
    """The polarized contraction: out[c] = sum_l tab[pol_l, c]
    Re s_l (w(z_l(f)) - wcut_l) inside the window, c < 7.

    Arguments as voigt_sum, plus polidx [L] (0, 1, 2 = pi, sigma-,
    sigma+), table [3, 7] (or [Z, 3, 7] with [Z, L] line columns) and the
    centres' rounding remainders res (voigt_inputs).
    Returns [7, F] or [Z, 7, F].
    """
    one = f0.dim() == 1
    cols = [c[None] if one else c for c in
            (f0, inv_gd, z_imag, s_re, s_im, cutoff, wcut_re, wcut_im)]
    if res is not None and one:
        res = res[None]
    args, mp = voigt_inputs(f_grid, *cols, polidx=polidx,
                            table=table[None] if one else table, res=res)
    out = (voigt_kernel_pol(*args) + mp.transpose(1, 2))[..., : f_grid.shape[0]]
    return out[0] if one else out


# ---------------------------------------------------------------------------
# the kernel and its plain version
# ---------------------------------------------------------------------------


def _check_inputs(name, f, lines, ext, blkidx, nvisit, wcoef):
    """Raise unless the kernel inputs are consistent CUDA tensors in the
    kernel's tiling (TF frequencies x TL lines); returns (Z, nf, nl, n)."""
    dev, dt = f.device, f.dtype
    Z, Lp, nc = lines.shape
    nl = ext.shape[-1]
    nf = nvisit.shape[-1]
    n = wcoef.shape[0] - 1
    if dev.type != "cuda" or dt not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: unsupported {dt} on {dev}")
    if nc != len(REC_COLS) or Lp != nl * TL or f.shape[0] != nf * TF:
        raise ValueError(f"{name}: the kernel takes tiles of {TF} frequencies and "
                         f"blocks of {TL} line records")
    if n != weideman_order(dt):
        raise ValueError(f"{name}: the kernel's Weideman order is {weideman_order(dt)}, "
                         f"got a table of order {n}")
    _cuda.check("f", f, dev, dt)
    _cuda.check("lines", lines, dev, dt, (Z, Lp, nc))
    _cuda.check("ext", ext, dev, dt, (Z, 4, nl))
    _cuda.check("blkidx", blkidx, dev, torch.int32, (Z, nf, nl))
    _cuda.check("nvisit", nvisit, dev, torch.int32, (Z, nf))
    _cuda.check("wcoef", wcoef, dev, dt)
    return Z, nf, nl, n


def default_split(nl):
    """Chunks per (level, tile) visit list, about sqrt(nl) and at most 16.
    A list holds at most nl blocks, and each chunk costs a fixed epilogue
    and a partial sum: sqrt balances that cost against the time of the
    longest chunk, the tail of the launch."""
    return max(1, min(16, round(math.sqrt(nl))))


def _launch(name, npol, f, lines, ext, blkidx, nvisit, wcoef, blkpol, table, split):
    Z, nf, nl, n = _check_inputs(name, f, lines, ext, blkidx, nvisit, wcoef)
    split = default_split(nl) if split is None else int(split)
    if split < 1:
        raise ValueError(f"{name}: split must be >= 1, got {split}")
    shape = (Z, nf * TF) if npol == 1 else (Z, 7, nf * TF)
    out = torch.empty(shape, dtype=f.dtype, device=f.device)
    part = (torch.empty((Z * nf * split, npol, TF), dtype=f.dtype, device=f.device)
            if split > 1 else out)
    if Z and nf:
        none = ctypes.c_void_p()
        _cuda.launch(
            name, f.dtype, _cuda.ptr(f), _cuda.ptr(lines), _cuda.ptr(ext),
            _cuda.ptr(blkidx), _cuda.ptr(nvisit), _cuda.ptr(wcoef),
            none if blkpol is None else _cuda.ptr(blkpol),
            none if table is None else _cuda.ptr(table),
            _cuda.ptr(part), _cuda.ptr(out), Z, nf, nl, n, split,
        )
    return out


def voigt_kernel(f, lines, ext, blkidx, nvisit, wcoef, split=None):
    """[Z, nf*tf] contraction over each (level, tile)'s visited blocks.

    f [nf*tf]; lines [Z, nl*tl, 8] (REC_COLS); ext [Z, 4, nl] (EXT_COLS);
    blkidx [Z, nf, nl] and nvisit [Z, nf] int32; wcoef [n+1].  On a CUDA
    tensor this launches csrc/voigt_sum.cu, each (level, tile)'s visit
    list cut into `split` chunks (default_split(nl) when None); on a CPU
    tensor it runs the plain version.
    """
    if f.device.type == "cpu":
        return voigt_kernel_plain(f, lines, ext, blkidx, nvisit, wcoef)
    return _launch("voigt_sum", 1, f, lines, ext, blkidx, nvisit, wcoef, None, None, split)


def voigt_kernel_pol(f, lines, ext, blkidx, nvisit, wcoef, blkpol, table, split=None):
    """[Z, 7, nf*tf] polarized contraction: voigt_kernel's inputs plus the
    polarization of each block, blkpol [nl] int32, and the per-level
    weight rows table [Z, 3, 7].  On a CUDA tensor this launches the
    polarized instance of csrc/voigt_sum.cu; on a CPU tensor it runs the
    plain version."""
    if f.device.type == "cpu":
        return voigt_kernel_pol_plain(f, lines, ext, blkidx, nvisit, wcoef, blkpol, table)
    _cuda.check("blkpol", blkpol, f.device, torch.int32, (ext.shape[-1],))
    _cuda.check("table", table, f.device, f.dtype, (lines.shape[0], 3, 7))
    return _launch("voigt_sum_pol", 3, f, lines, ext, blkidx, nvisit, wcoef, blkpol, table,
                   split)


_PLAIN_CHUNK = 1 << 24  # (slot, line, frequency) elements per dense chunk


def _pair_chunks(f, lines, ext, blkidx, nvisit):
    """Dense views of the visited (line, frequency) pairs, one level and a
    run of tiles at a time: yields (z, tile slice, tier [nt, S] with 4 =
    slot not visited, block indices jb [nt, S], line records
    [8, nt, S, tl, 1] (REC_COLS), frequency offsets df [nt, S, tl, tf])."""
    Z = lines.shape[0]
    nl = ext.shape[-1]
    nf = nvisit.shape[-1]
    tl = lines.shape[1] // nl
    tiles = f.view(nf, -1)
    S = int(nvisit.max()) if nvisit.numel() else 0
    if not S:
        return
    nt = max(1, _PLAIN_CHUNK // (S * tl * tiles.shape[1]))
    mid_r2 = _tier_params(f.dtype)[0]
    slot = torch.arange(S, device=f.device)
    for z in range(Z):
        for t0 in range(0, nf, nt):
            ts = slice(t0, min(t0 + nt, nf))
            tz = tiles[ts]
            t_lo, t_hi = tz[:, 0:1], tz[:, -1:]
            jb = blkidx[z, ts, :S].long()  # [nt, S]
            e = ext[z][:, jb]  # [4, nt, S]
            gap = torch.clamp(torch.maximum(e[0] - t_hi, t_lo - e[1]), min=0.0)
            gmin = e[2] * gap
            bound2 = gmin * gmin + e[3] * e[3]
            tier = torch.where(bound2 > 2.0 * _DEEP_R2, 0,
                               torch.where(bound2 > 2.0 * _ASYM_R2, 1,
                                           torch.where(bound2 > 2.0 * mid_r2, 2, 3)))
            tier = torch.where(slot < nvisit[z, ts, None], tier, 4)
            blk = lines[z].view(nl, tl, -1)[jb].movedim(-1, 0)[..., None]  # [8, nt, S, tl, 1]
            df = (tz[:, None, None, :] - blk[_F0]) - blk[_RES]
            yield z, ts, tier, jb, blk, df


def _plain(f, lines, ext, blkidx, nvisit, wcoef, blkpol=None, table=None):
    """Both kernels' plain version: the same visit lists and tier rule,
    each tier evaluated densely and selected per block; with blkpol and
    table each block's sum goes to its polarization and the three sums
    are weighted by the level's table rows."""
    Z = lines.shape[0]
    nf = nvisit.shape[-1]
    tf = f.shape[0] // nf
    _, mid_terms, asym_terms = _tier_params(f.dtype)
    Lw, a = wcoef[0], wcoef[1:].tolist()
    shape = (Z, nf, tf) if blkpol is None else (Z, 7, nf, tf)
    out = torch.zeros(shape, dtype=f.dtype, device=f.device)
    for z, ts, tier, jb, blk, df in _pair_chunks(f, lines, ext, blkidx, nvisit):
        igd, zi, cut, sr, si, swc = (blk[i] for i in (_IGD, _ZI, _CUT, _SR, _SI, _SWC))
        zr = igd * df
        zim = zi.expand_as(zr)
        t = tier[..., None, None]
        parts = _wofz_parts(zr, zim, Lw, a, asym_terms)
        mid = _wofz_asym(zr, zim, mid_terms)
        asym = _wofz_asym(zr, zim, asym_terms)
        deep = _wofz_deep(zr, zim)
        wr, wi = (
            torch.where(t == 0, d, torch.where(t == 1, s, torch.where(t == 2, m, p)))
            for d, s, m, p in zip(deep, asym, mid, parts)
        )
        vals = (sr * wr - si * wi) - swc
        keep = (t < 4) & (df.abs() <= cut)
        vals = torch.where(keep, vals, torch.zeros_like(vals))
        if blkpol is None:
            out[z, ts] = vals.sum((1, 2))
            continue
        bsum = vals.sum(2)  # [nt, S, tf] block sums
        pol = blkpol[jb][..., None]  # [nt, S, 1]
        sums = torch.stack([torch.where(pol == p, bsum, torch.zeros_like(bsum)).sum(1)
                            for p in range(3)])  # [3, nt, tf]
        out[z, :, ts] = (table[z][:, :, None, None] * sums[:, None]).sum(0)
    return out.view(Z, -1) if blkpol is None else out.view(Z, 7, -1)


def voigt_kernel_plain(f, lines, ext, blkidx, nvisit, wcoef):
    """The plain PyTorch version of voigt_kernel."""
    return _plain(f, lines, ext, blkidx, nvisit, wcoef)


def voigt_kernel_pol_plain(f, lines, ext, blkidx, nvisit, wcoef, blkpol, table):
    """The plain PyTorch version of voigt_kernel_pol."""
    return _plain(f, lines, ext, blkidx, nvisit, wcoef, blkpol, table)


def pair_counts(f, lines, ext, blkidx, nvisit):
    """(line, frequency) pairs the kernel evaluates, per tier of
    pair_flops: {"visited": {...}, "in_window": {...}}; in-window pairs
    lie inside their line's cutoff window."""
    names = ("deep", "asym", "mid", "weideman_series", "weideman")
    visited = dict.fromkeys(names, 0)
    inwin = dict.fromkeys(names, 0)
    for _, _, tier, _, blk, df in _pair_chunks(f, lines, ext, blkidx, nvisit):
        zr = blk[_IGD] * df
        big = zr * zr + blk[_ZI] * blk[_ZI] > _ASYM_R2
        t = tier[..., None, None].expand_as(df)
        inside = df.abs() <= blk[_CUT]
        cls = {
            "deep": t == 0, "asym": t == 1, "mid": t == 2,
            "weideman_series": (t == 3) & big, "weideman": (t == 3) & ~big,
        }
        for k, m in cls.items():
            visited[k] += int(m.sum())
            inwin[k] += int((m & inside).sum())
    return {"visited": visited, "in_window": inwin}
