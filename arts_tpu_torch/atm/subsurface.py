"""Depth profiles below the surface and the thermal emission they send up
(port of arts_tpu/atm/subsurface.py, after ARTS's SubsurfaceField and its
DISORT subsurface emission, spectral_radSubsurfaceDisortEmission).

emerging_radiance runs the scalar layer recursion (rtepack/emission)
along one direction; emerging_radiance_disort solves all frequencies as
the lanes of one DISORT call, on the fused route (stage 1's thermal
instance and stages 2+3, one launch each) unless asked otherwise.
"""

import dataclasses

import torch

from .._cuda import move, resolve, tensor
from ..disort.solver import DisortInput, disort
from ..ops.planck import planck
from ..rtepack.emission import emission_unpolarized


@dataclasses.dataclass(frozen=True)
class SubsurfaceField:
    """Profiles on depths [ND] ascending from 0 at the surface [m]:
    temperature t [ND] [K], volume absorption [ND] or [ND, F] [1/m], and
    optional volume scattering (snow, firn, regolith): single scattering
    albedo ssa [ND] and Henyey-Greenstein asymmetry g [ND]."""

    depth: torch.Tensor
    t: torch.Tensor
    absorption: torch.Tensor
    ssa: torch.Tensor | None = None
    g: torch.Tensor | None = None

    def _on(self, f_grid, device, dtype):
        dev, dt = resolve(device, dtype)
        f = tensor(f_grid, dev, dt)
        sub = move(self, dev, dt)
        k = sub.absorption
        k = k[:, None] * torch.ones_like(f) if k.ndim == 1 else k
        return sub, f, k, planck(f[None, :], sub.t[:, None])  # [ND, F] each

    def emerging_radiance(self, f_grid, mu=1.0, device=None, dtype=None):
        """Upwelling radiance [F] at the surface from below along a direction
        of cosine mu below the surface (refraction at the surface is the
        caller's), by the scalar layer recursion; the deepest level is a
        half-space, its Planck radiance the bottom boundary."""
        sub, f, k, J = self._on(f_grid, device, dtype)
        return emission_unpolarized(k, J, torch.diff(sub.depth) / mu, J[-1])

    def disort_input(self, f_grid, I_down=None, nquad: int = 16, min_optical_depth=1e-11,
                     device=None, dtype=None) -> DisortInput:
        """The DisortInput of emerging_radiance_disort: F lanes of ND - 1
        layers, the surface at the top."""
        sub, f, k, b_levels = self._on(f_grid, device, dtype)
        F, nd = f.shape[0], sub.depth.shape[0]
        k_lay = 0.5 * (k[:-1] + k[1:])
        tau = torch.clamp(k_lay * torch.diff(sub.depth)[:, None], min=min_optical_depth).T
        zeros = torch.zeros(nd, dtype=f.dtype, device=f.device)
        ssa = zeros if sub.ssa is None else sub.ssa
        gg = zeros if sub.g is None else sub.g
        omega_lay = 0.5 * (ssa[:-1] + ssa[1:])
        g_lay = 0.5 * (gg[:-1] + gg[1:])
        leg = g_lay[:, None] ** torch.arange(nquad, device=f.device)  # [ND-1, nquad]
        I_down = torch.zeros_like(f) if I_down is None else tensor(I_down, f.device, f.dtype)
        zero = torch.zeros_like(f)
        return DisortInput(
            tau=tau.contiguous(), omega=omega_lay.expand(F, nd - 1).contiguous(),
            leg=leg.expand(F, nd - 1, nquad).contiguous(), f=torch.zeros_like(tau),
            b_levels=b_levels.T.contiguous(), fisot=I_down, albedo=zero,
            b_surf=b_levels[-1].contiguous(), b_top=zero)

    def emerging_radiance_disort(self, f_grid, I_down=None, nquad: int = 16,
                                 min_optical_depth=1e-11, fast_linalg=None, plain=False,
                                 device=None, dtype=None):
        """The DISORT solve over the depth profile (ARTS's
        spectral_radSubsurfaceDisortEmission): the depth grid is the layer
        stack, the surface its top; each layer's optical depth is
        max(midpoint absorption x thickness, min_optical_depth) (ARTS's
        convention: the single scattering albedo applies on top of it), its
        phase moments g^l of the Henyey-Greenstein g, thermal emission
        linear in tau from the levels' Planck radiances, the deepest
        level's blackbody as the bottom boundary, and I_down [F] (the
        downwelling atmospheric radiance; None: 0) as isotropic
        illumination at the top (disort_input).

        All F frequencies are the lanes of one disort() call (fast_linalg,
        plain as there; by default the fused route).  Returns its
        DisortOutput: u0 [F, ND, nquad] holds the upwelling intensities at
        the positive cosines, so the emerging radiance is
        out.u0[:, 0, nquad // 2:].  out.mu is [nquad], where the JAX
        package's output, vmapped over frequency, has [F, nquad]."""
        inp = self.disort_input(f_grid, I_down, nquad, min_optical_depth, device, dtype)
        return disort(inp, nquad=nquad, nleg=nquad, nfourier=1, fast_linalg=fast_linalg,
                      plain=plain, device=inp.tau.device, dtype=inp.tau.dtype)
