"""Parent-pole expansion of Zeeman polarized absorption: the CUDA kernel,
its plain PyTorch version and the tensor code around them (port of
arts_tpu/ops/zeeman_mp_kernel.py).

The Zeeman components of one parent line spread only ~MHz around the
parent centre, while the Voigt asymptotic radius is ~10 MHz and the
cutoff window ~GHz.  Beyond a small per-parent near radius the whole
component structure collapses into a P-term pole expansion around the
parent,

    sum_k pw_kc s_k w_k(f)  ~  sum_j M_jc (R_p / (f - c_p))^j,

so the contraction runs over (parents x frequencies) instead of
(pseudo-lines x frequencies).  Three steps, all levels at once:

  1. `zeeman_pole_moments` (tensor code): per-level, per-pole moments
     from the padded [CM, NP] component grids of lbl.zeeman.
  2. `zeeman_mp_eval`: the dense (level, parent, frequency) evaluation,
     csrc/zeeman_mp.cu on the card (2 frequencies per thread, the
     parents whose window reaches a block's frequencies staged in shared
     memory by cp.async, each warp summing those that reach its own),
     in full float32 / float64.
  3. `near_correction` (tensor code): the few grid points inside each
     pole's near radius, selected and evaluated exactly per component,
     then added with a deterministic segment sum (sorted keys, ranks
     within a key, a dense sum in fixed order), so float32 runs on the
     card repeat bit for bit.

Not ported: the bf16 tail of the TPU's MXU contraction, the
padding of parents and frequencies to whole TPU blocks (the kernel masks
its own ragged edge), and the near correction's static candidate grid
with its one-hot MXU scatter.
"""

import math

import torch

from .. import _cuda
from .voigt_kernel import _ASYM_R2, _INV_SQRT_PI, _LAURENT_C, _tier_params, _wofz_parts
from .wofz import _weideman_coeffs

NCOMP = 7  # propagation-matrix components
MP_TERMS = 5  # expansion terms P; csrc/zeeman_mp.cu is built for this P
SPLIT = 4  # blocks over the parents of one (tile, level): kSplit of csrc/zeeman_mp.cu


def wofz_parts(zr, zi, n):
    """w(z) as (re, im) for Im z >= 0: the Weideman rational of order n
    blended with the asymptotic series (3 terms at float32, 4 at float64)."""
    Lw, a = _weideman_coeffs(n)
    return _wofz_parts(zr, zi, Lw, a, _tier_params(zr.dtype)[2])


def zeeman_pole_moments(f0_k, igd_k, zi_k, sr_k, si_k, swc_k, pw_k, terms, kappa):
    """Per-pole expansion data from padded [Z, CM, NP] component grids
    (strength 0 marks padding); pw_k [CM, NP, C].  Returns a dict of
    [Z, NP] arrays (c_re, g0, R, rnear, rnear2, count) and moments
    M_re, M_im [Z, NP, P, C], swcsum [Z, NP, C]."""
    mask = sr_k != 0.0
    zero = torch.zeros((), dtype=f0_k.dtype, device=f0_k.device)
    cnt = torch.clamp(mask.sum(1).to(f0_k.dtype), min=1.0)
    igd_s = torch.where(igd_k > 0, igd_k, torch.ones_like(igd_k))
    msum = lambda x: torch.where(mask, x, zero).sum(1)
    c_re = msum(f0_k) / cnt
    G0_p = msum(zi_k / igd_s) / cnt  # shared per parent
    igd_p = msum(igd_k) / cnt
    igd_ps = torch.where(igd_p > 0, igd_p, torch.ones_like(igd_p))

    # R floor = the pole's Doppler width: igd R >= 1 keeps the scaled
    # Laurent strengths and the powers u^j within float32 range
    dp = torch.where(mask, f0_k - c_re[:, None], zero)
    R = torch.maximum(torch.sqrt((dp * dp).amax(1)), 1.0 / igd_ps)
    q = dp / R[:, None]  # real, |q| <= 1

    # per-component Laurent strengths i s c_k / (igd R)^(2k+1) / sqrt(pi)
    igdR = torch.clamp(igd_k * R[:, None], min=1e-3)
    A = []
    for k in range(3):
        scale = _LAURENT_C[k] / igdR ** (2 * k + 1) * _INV_SQRT_PI
        A.append((-si_k * scale, sr_k * scale))

    # M_j[c] = sum_k pw_kc sum_kk binom(j-1, 2kk) A_kk q^(j-2kk-1)
    qp = [torch.ones_like(q)]
    for _ in range(terms - 1):
        qp.append(qp[-1] * q)
    pw = pw_k.to(f0_k.dtype)

    def wsum(x):
        with _cuda.full_f32_matmul():
            return torch.einsum("zkp,kpc->zpc", torch.where(mask, x, zero), pw)

    M_re, M_im = [], []
    for j in range(1, terms + 1):
        ar = torch.zeros_like(q)
        ai = torch.zeros_like(q)
        for k in range(3):
            m = j - 2 * k - 1
            if m < 0:
                continue
            cb = math.comb(j - 1, 2 * k)
            ar = ar + cb * A[k][0] * qp[m]
            ai = ai + cb * A[k][1] * qp[m]
        M_re.append(wsum(ar))  # [Z, NP, C]
        M_im.append(wsum(ai))

    # near radius: moment truncation (kappa R) and every component's
    # Laurent-3 asymptotic gate (|z|^2 >= 2 ASYM_R2 at distance r - R)
    zi_p = G0_p * igd_p
    asym_gap = torch.sqrt(torch.clamp(2.0 * _ASYM_R2 - zi_p * zi_p, min=0.0)) / igd_ps
    r_near = torch.maximum(kappa * R, R + asym_gap)
    return dict(
        c_re=c_re, g0=G0_p, R=R, rnear2=r_near * r_near, rnear=r_near,
        M_re=torch.stack(M_re, 2), M_im=torch.stack(M_im, 2),
        swcsum=wsum(swc_k), count=cnt,
    )


def record_width(P):
    """Values per pole record: 12 + 14 P padded to a multiple of 4, so that
    a record is whole 16-byte pieces in float32 and float64 (84 at P = 5)."""
    return (12 + 2 * NCOMP * P + 3) // 4 * 4


def pole_records(c_re, g0, R, rnear2, cutoff, M_re, M_im, swcsum):
    """The kernel's pole records [Z, NP, record_width(P)]:
    [c_re, g0, R, rnear2, cut, swcsum[7], M_re[P][7], M_im[P][7], 0...]."""
    Z, NP, P, C = M_re.shape
    if C != NCOMP:
        raise ValueError(f"pole_records: expected {NCOMP} components, got {C}")
    cols = [x[..., None] for x in (c_re, g0, R, rnear2, cutoff.expand(Z, NP))]
    pad = c_re.new_zeros((Z, NP, record_width(P) - 12 - 2 * NCOMP * P))
    return torch.cat(cols + [swcsum, M_re.reshape(Z, NP, P * C),
                             M_im.reshape(Z, NP, P * C), pad], -1).contiguous()


def zeeman_mp_eval(f_grid, c_re, g0, R, rnear2, cutoff, M_re, M_im, swcsum):
    """Dense parent-pole expansion field [Z, 7, F].

    f_grid [F]; c_re, g0, R, rnear2 [Z, NP]; cutoff [NP]; M_re, M_im
    [Z, NP, P, 7]; swcsum [Z, NP, 7]."""
    rec = pole_records(c_re, g0, R, rnear2, cutoff, M_re, M_im, swcsum)
    return zeeman_mp_kernel(f_grid.contiguous(), rec)


def _terms(rec):
    """P of pole records of width 12 + 14 P or record_width(P)."""
    w = rec.shape[-1]
    P = (w - 12) // (2 * NCOMP)
    if P < 1 or w not in (12 + 2 * NCOMP * P, record_width(P)):
        raise ValueError(f"pole records of width {w} are neither 12 + 14 P nor "
                         "record_width(P)")
    return P


def zeeman_mp_kernel(f, rec):
    """[Z, 7, F] from the pole records rec [Z, NP, record_width(P)].  On a
    CUDA tensor this launches csrc/zeeman_mp.cu: blocks of 128 threads
    over (tile of frequencies, level, one of SPLIT parts of the parents),
    then a second kernel that adds the parts' slabs in order; on a CPU
    tensor it runs the plain version."""
    if f.device.type == "cpu":
        return zeeman_mp_plain(f, rec)
    dev, dt = f.device, f.dtype
    Z, NP, W = rec.shape
    P = _terms(rec)
    F = f.shape[0]
    if dev.type != "cuda" or dt not in (torch.float32, torch.float64) or P != MP_TERMS:
        raise ValueError(f"zeeman_mp_kernel: unsupported {dt} on {dev} with P={P}")
    if W != record_width(P) or rec.data_ptr() % 16:
        raise ValueError(f"zeeman_mp_kernel: records must be padded to {record_width(P)} "
                         f"values and 16-byte aligned (width {W})")
    _cuda.check("f", f, dev, dt, (F,))
    _cuda.check("rec", rec, dev, dt)
    out = torch.empty((Z, NCOMP, F), dtype=dt, device=dev)
    if Z and F:
        if NP == 0:
            return out.zero_()
        part = torch.empty((SPLIT, Z, NCOMP, F), dtype=dt, device=dev)
        _cuda.launch("zeeman_mp", dt, _cuda.ptr(f), _cuda.ptr(rec), _cuda.ptr(out),
                     _cuda.ptr(part), Z, F, NP, P, SPLIT)
    return out


def zeeman_mp_plain(f, rec):
    """The plain PyTorch version of zeeman_mp_kernel, one level at a time:
    the same masks and powers as dense [NP, F] tensors, the contraction
    as matrix products in full precision."""
    Z, NP, _ = rec.shape
    P = _terms(rec)
    out = torch.zeros((Z, NCOMP, f.shape[0]), dtype=f.dtype, device=f.device)
    zero = torch.zeros((), dtype=f.dtype, device=f.device)
    with _cuda.full_f32_matmul():
        for z in range(Z):
            r = rec[z]
            cre, g0, R, rn2, cut = (r[:, i, None] for i in range(5))
            swc = r[:, 5:12]
            Mr = r[:, 12:12 + NCOMP * P].view(NP, P, NCOMP)
            Mi = r[:, 12 + NCOMP * P:12 + 2 * NCOMP * P].view(NP, P, NCOMP)
            dr = f[None, :] - cre
            d2 = dr * dr + g0 * g0
            inwin = dr.abs() <= cut
            mask = inwin & (d2 >= rn2)
            invR = R / d2
            ur = torch.where(mask, dr * invR, zero)
            ui = torch.where(mask, -(g0 * invR), zero)
            o = -(swc.T @ inwin.to(f.dtype))
            Ur, Ui = ur, ui
            for j in range(P):
                o = o + (Mr[:, j].T @ Ur - Mi[:, j].T @ Ui)
                if j < P - 1:
                    Ur, Ui = Ur * ur - Ui * ui, Ur * ui + Ui * ur
            out[z] = o
    return out


def pair_flops(P):
    """Operations per (parent, frequency) pair of csrc/zeeman_mp.cu by
    class (add, multiply, divide 1, fused multiply-add 2)."""
    return {"far": 8 + 34 * P, "near": 11, "outside": 4}


def pair_counts(f, rec):
    """(parent, frequency) pairs per class of pair_flops for these inputs:
    in window and far, in window and near, out of window."""
    counts = dict(far=0, near=0, outside=0)
    for z in range(rec.shape[0]):
        r = rec[z]
        dr = f[None, :] - r[:, 0, None]
        d2 = dr * dr + r[:, 1, None] * r[:, 1, None]
        inwin = dr.abs() <= r[:, 4, None]
        far = inwin & (d2 >= r[:, 3, None])
        counts["far"] += int(far.sum())
        counts["near"] += int((inwin & ~far).sum())
        counts["outside"] += int((~inwin).sum())
    return counts


def _segment_sum(vals, key, n_keys):
    """sum of vals [N, C] by key [N] into [n_keys, C], deterministically:
    a stable sort by key, each entry's rank within its key, one dense
    [n_keys, K, C] placement with unique indices, and a sum over K in
    sorted order (no atomics, so repeated runs agree bit for bit)."""
    out = vals.new_zeros((n_keys, vals.shape[-1]))
    if not key.numel():
        return out
    key_s, order = torch.sort(key, stable=True)
    pos = torch.arange(key.numel(), device=key.device)
    first = torch.ones_like(key_s, dtype=torch.bool)
    first[1:] = key_s[1:] != key_s[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    dense = vals.new_zeros((n_keys, int(rank.max()) + 1, vals.shape[-1]))
    dense[key_s, rank] = vals[order]
    return dense.sum(1)


def near_points(f_grid, c_re, g0, rnear, cutoff, noff):
    """The grid points inside each pole's near radius and window among its
    noff candidates around the centre: (mask, grid index, frequency), each
    [Z, NP, noff]; c_re, g0, rnear [Z, NP], cutoff [NP].  The near mask
    is the exact complement of the kernel's far mask (the same products,
    separately rounded), so every in-window pair the kernel leaves out is
    here once, if noff covers it."""
    F = f_grid.shape[0]
    i0 = torch.searchsorted(f_grid, c_re.contiguous())  # [Z, NP]
    offs = torch.arange(noff, device=f_grid.device) - noff // 2
    tgt = i0[..., None] + offs  # [Z, NP, O]
    inrange = (tgt >= 0) & (tgt < F)
    fo = f_grid[tgt.clamp(0, F - 1)]
    dr = fo - c_re[..., None]
    d2 = dr * dr + (g0 * g0)[..., None]
    near = inrange & (d2 < (rnear * rnear)[..., None]) & (dr.abs() <= cutoff[None, :, None])
    return near, tgt, fo


def near_correction(f_grid, out, c_re, g0, rnear, cutoff, f0_k, igd_k, zi_k,
                    sr_k, si_k, pw_k, off_k=None, noff=6, wofz_n=16):
    """Exact per-component values at the grid points inside each pole's
    near radius, added onto the expansion field.

    out [Z, 7, F] from zeeman_mp_eval; c_re, g0, rnear [Z, NP]; cutoff
    [NP]; component grids f0_k, igd_k, zi_k, sr_k, si_k [Z, CM, NP];
    pw_k [CM, NP, C].  With off_k [Z, CM, NP] the centres are f0_k + off_k
    and the offset is subtracted after f - f0_k (exact in float32 where f
    and f0_k are close, while f0_k + off_k would round to the float32
    spacing of f0_k).  noff candidate points per pole must cover
    ceil(2 max rnear / spacing) + 2 (tune_zeeman_profile).  Only the
    candidates inside the near radius (near_points) are evaluated: JAX
    evaluates the whole static [Z, noff, CM, NP] grid and masks it.
    Returns the corrected field.
    """
    Z, F = c_re.shape[0], f_grid.shape[0]
    pmask, tgt, fo = near_points(f_grid, c_re, g0, rnear, cutoff, noff)

    z, p, o = pmask.nonzero(as_tuple=True)  # the near (level, pole, offset)
    comp = lambda x: x[z, :, p]  # [N, CM]
    df = fo[z, p, o][:, None] - comp(f0_k)
    if off_k is not None:
        df = df - comp(off_k)
    zr = comp(igd_k) * df
    wr, wi = wofz_parts(zr, comp(zi_k).expand_as(zr), wofz_n)
    val = comp(sr_k) * wr - comp(si_k) * wi
    with _cuda.full_f32_matmul():
        corr = torch.einsum("nk,knc->nc", val, pw_k.to(val.dtype)[:, p])  # [N, C]
    dense = _segment_sum(corr, z * F + tgt[z, p, o], Z * F)
    return out + dense.view(Z, F, -1)[..., :out.shape[1]].transpose(1, 2)
