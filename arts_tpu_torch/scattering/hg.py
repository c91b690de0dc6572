"""Henyey-Greenstein scatterer (port of arts_tpu/scattering/hg.py); its
Legendre moments are exactly g^l."""

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class HenyeyGreenstein:
    """Bulk HG properties on the atmosphere's altitude grid: ext [1/m],
    ssa and g, each [..., Z] (leading axes may carry frequency)."""

    ext: torch.Tensor
    ssa: torch.Tensor
    g: torch.Tensor

    def bulk_properties(self, nleg: int):
        """(k_ext [.., Z], k_sca [.., Z], leg [.., Z, nleg]), leg being the
        scattering-coefficient-weighted phase moments."""
        k_sca = self.ext * self.ssa
        ls = torch.arange(nleg, device=self.g.device)
        return self.ext, k_sca, k_sca[..., None] * self.g[..., None] ** ls
