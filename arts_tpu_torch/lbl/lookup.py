"""Absorption lookup table (port of arts_tpu/lbl/lookup.py): trained with
the Voigt kernel, evaluated by differentiable Lagrange interpolation.

The table holds one species' cross-section per molecule,
alpha / (n vmr) [m^2], over temperature offsets from a reference profile
x water (self) VMR factors x log pressure x frequency, around the
reference profile (t_ref, w_ref on the pressure grid), as the reference's
lookup tables do; it is evaluated with per-axis Lagrange orders.
"""

import dataclasses

import torch

from .. import constants as const
from .._cuda import move, resolve
from ..ops.interp import lagrange_weights
from .catalog import LineCatalog
from .partfun import PartFunTable
from .voigt import absorption_kernel


@dataclasses.dataclass(frozen=True)
class AbsLookupTable:
    """Lookup for one species (spec_idx indexes the VMR rows).

    log_p_grid [P] ascending log(p); t_ref, w_ref [P] the reference
    temperature and water (self) VMR profiles; t_pert [NT] temperature
    offsets; w_pert [NW] water factors (1 = the reference); f_grid [F];
    xsec [NT, NW, P, F] cross-section per molecule [m^2]."""

    log_p_grid: torch.Tensor
    t_ref: torch.Tensor
    w_ref: torch.Tensor
    t_pert: torch.Tensor
    w_pert: torch.Tensor
    f_grid: torch.Tensor
    xsec: torch.Tensor
    spec_idx: int = 0

    def absorption(self, T, P, vmr, t_order: int = 1, w_order: int = 1, p_order: int = 1):
        """alpha [..., F] [1/m] at the points T, P [...], vmr [..., S], on the
        table's device and dtype; differentiable in T, P and vmr.

        t/w/p_order: the Lagrange order of each axis (1 is multilinear),
        clamped to the grid sizes."""
        as_t = lambda x: torch.as_tensor(x, dtype=self.xsec.dtype, device=self.xsec.device)
        T, P, vmr = as_t(T), as_t(P), as_t(vmr)
        p_order = min(p_order, self.log_p_grid.shape[0] - 1)
        t_order = min(t_order, self.t_pert.shape[0] - 1)
        w_order = min(w_order, self.w_pert.shape[0] - 1)

        pi0, pw = lagrange_weights(self.log_p_grid, torch.log(P), p_order)
        # the reference profile at this pressure (the same pressure weights)
        tr = sum(pw[..., c] * self.t_ref[pi0 + c] for c in range(p_order + 1))
        wr = sum(pw[..., c] * self.w_ref[pi0 + c] for c in range(p_order + 1))
        ti0, tw = lagrange_weights(self.t_pert, T - tr, t_order)
        x_spec = vmr[..., self.spec_idx]
        wi0, ww = lagrange_weights(self.w_pert, x_spec / torch.clamp(wr, min=1e-30), w_order)

        xs = 0.0
        for a in range(t_order + 1):
            for b in range(w_order + 1):
                for c in range(p_order + 1):
                    wgt = (tw[..., a] * ww[..., b] * pw[..., c])[..., None]
                    xs = xs + wgt * self.xsec[ti0 + a, wi0 + b, pi0 + c]
        n = P / (const.k * T)
        return xs * (n * x_spec)[..., None]


def training_points(p_grid, t_ref, w_ref, vmr_ref, spec_idx, t_pert, w_pert):
    """A table's training points: (p_grid, t_ref, w_ref) sorted ascending in
    pressure, then T, P and the species' VMR w [NT, NW, P] and the VMRs
    [NT, NW, P, S] (vmr_ref with its spec_idx entry w = w_ref * w_pert)."""
    order = torch.argsort(p_grid)
    p_grid, t_ref, w_ref = p_grid[order], t_ref[order], w_ref[order]
    NT, NW, NP = t_pert.shape[0], w_pert.shape[0], p_grid.shape[0]
    T = (t_ref[None, None, :] + t_pert[:, None, None]).expand(NT, NW, NP)
    P = p_grid.expand(NT, NW, NP)
    w = (w_ref[None, None, :] * w_pert[None, :, None]).expand(NT, NW, NP)
    is_spec = torch.arange(vmr_ref.shape[0], device=vmr_ref.device) == spec_idx
    return p_grid, t_ref, w_ref, T, P, w, torch.where(is_spec, w[..., None], vmr_ref)


def train_lookup(f_grid, cat: LineCatalog, pf: PartFunTable, p_grid, t_ref, w_ref, vmr_ref,
                 spec_idx: int, t_pert, w_pert, block: int = 256, device=None, dtype=None):
    """Train the table (abs_lookup_dataPrecompute): the absorption at every
    (t_pert, w_pert, p) point, without the clip at 0, through the Voigt
    kernel, all NT x NW x P points in one launch (absorption_kernel; its
    plain version on the CPU).  The JAX package's train_lookup takes the
    dense route instead; block is its line-block size, which the kernel
    route does not use.  p_grid, t_ref, w_ref [P] (stored ascending in
    pressure), vmr_ref [S] (its spec_idx entry is replaced by
    w_ref * w_pert), t_pert [NT], w_pert [NW]."""
    dev, dt = resolve(device, dtype)
    as_t = lambda x: torch.as_tensor(x, dtype=dt, device=dev)
    f_grid, t_pert, w_pert = as_t(f_grid), as_t(t_pert), as_t(w_pert)
    cat, pf = move((cat, pf), dev, dt)
    p_grid, t_ref, w_ref, T, P, w, vmr = training_points(
        *map(as_t, (p_grid, t_ref, w_ref, vmr_ref)), spec_idx, t_pert, w_pert)
    a = absorption_kernel(f_grid, cat, pf, T.reshape(-1), P.reshape(-1),
                          vmr.reshape(-1, vmr.shape[-1]), no_negative_absorption=False,
                          device=dev, dtype=dt)
    n = P / (const.k * T)
    xsec = a.view(T.shape + (-1,)) / (n * torch.clamp(w, min=1e-30))[..., None]
    return AbsLookupTable(log_p_grid=torch.log(p_grid), t_ref=t_ref, w_ref=w_ref, t_pert=t_pert,
                          w_pert=w_pert, f_grid=f_grid, xsec=xsec, spec_idx=spec_idx)
