"""Observer operators of the measurement pipeline (port of
arts_tpu/sensor/observers.py).  An observer maps a stacked geometry batch
to radiances,

    observer(scene, f_grid, alts [G, NP], drs [G, NP-1], zas [G, NP],
             background) -> I [G, F]

(an observer with wants_azimuth also takes aas [G], the line-of-sight
azimuths)

on the device and in the dtype of f_grid; sensor/measurement.py runs the
scalar clear-sky, polarized (Zeeman) and DISORT observers through one
deduplication and contraction path.
"""

import dataclasses

import numpy as np
import torch


def _on(f_grid):
    return dict(device=f_grid.device, dtype=f_grid.dtype)


def clearsky_observer(**kw):
    """Scalar clear-sky emission observer (the default): simulate_clearsky
    on the whole batch at once, keywords passed on."""
    from ..fwd import simulate_clearsky

    def run(scene, f_grid, alts, drs, zas, background):
        return simulate_clearsky(scene, f_grid, alts, drs, background=background,
                                 path_za=zas, **kw, **_on(f_grid))

    return run


def _transformed(tensors):
    """True under a torch.func transform or when a tensor needs grad: a
    cached value would then stand for another state."""
    if torch._C._functorch.peek_interpreter_stack() is not None:
        return True
    return any(t.requires_grad or torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in tensors)


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in _leaves(o)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _leaves(getattr(obj, f.name))]
    return []


def clearsky_observer_cached(backend: str = "xla", block: int = 256,
                             rte_option: str = "constant", plain: bool = False):
    """Level-cached scalar clear-sky observer for many-geometry batches.

    The gas absorption is computed once on the scene's level grid
    (gas_absorption_levels; backend "pallas": one launch of the Voigt
    kernel for all levels) and interpolated at each path point, so its
    cost does not grow with the number of geometries.  Exact against
    clearsky_observer where path points sit on level altitudes, O(dz^2)
    between them.  Not for wind (Doppler) scenes.

    A memo keyed on the identity of (scene, f_grid) keeps the levels'
    absorption across the background groups of one batch; it holds the
    keyed objects, so that their ids cannot be reused.  It is bypassed
    under torch.func transforms and when a tensor needs grad, where the
    scene's tensors stand for a state of their own on every call."""
    from ..fwd import gas_absorption_levels, simulate_clearsky_from_levels

    memo = {}

    def run(scene, f_grid, alts, drs, zas, background):
        compute = lambda: gas_absorption_levels(scene, f_grid, block=block, backend=backend,
                                                plain=plain, **_on(f_grid))
        if _transformed(_leaves((scene, f_grid))):
            k_lvl = compute()
        else:
            key = (id(scene), id(f_grid))
            if memo.get("key") != key:
                memo.clear()
                memo.update(key=key, ref=(scene, f_grid), k=compute())
            k_lvl = memo["k"]
        return simulate_clearsky_from_levels(k_lvl, scene, f_grid, alts, drs,
                                             background=background, rte_option=rte_option,
                                             **_on(f_grid))

    return run


def polarized_observer(component: int = 0, **kw):
    """Polarized (Zeeman) observer: one Stokes component per geometry
    (component=None: the full [G, F, 4] field)."""
    from ..fwd import simulate_clearsky_polarized

    def run(scene, f_grid, alts, drs, zas, background):
        I = torch.stack([simulate_clearsky_polarized(scene, f_grid, a, z, d,
                                                     background=background, **kw,
                                                     **_on(f_grid))
                         for a, z, d in zip(alts, zas, drs)])
        return I if component is None else I[..., component]

    return run


def _interp(x, xp, fp, col=None):
    """np.interp of each x [G] on the ascending grid xp [N] for every row
    of fp [F, N]: [G, F], clamped at the grid ends.  With col [G], fp is
    [F, N, C] and geometry g reads its column col[g]."""
    i1 = torch.clamp(torch.searchsorted(xp, x), 1, xp.shape[0] - 1)
    i0 = i1 - 1
    w = torch.clamp((x - xp[i0]) / (xp[i1] - xp[i0]), 0.0, 1.0)[:, None]
    if col is None:
        return fp[:, i0].T * (1.0 - w) + fp[:, i1].T * w
    return fp[:, i0, col].T * (1.0 - w) + fp[:, i1, col].T * w


def allsky_observer(nquad: int = 16, nfourier: int | None = 1, level: str = "toa",
                    fast_linalg: bool | None = None, **kw):
    """DISORT observer: one radiation-field solve per (scene, f_grid), read
    at each geometry's viewing angle (its first path point's zenith angle;
    the radiance arriving from za propagates with mu = -cos za), at the
    top ("toa", upwelling) or the bottom level ("surface", downwelling).
    Keywords (nleg, mu0, fbeam, phi0, thermal, k_gas, ...) go to
    simulate_allsky.

    A thermal field is azimuth-symmetric, so the azimuthal mean u0 is
    exact.  With a solar beam (fbeam != 0) and more than one Fourier mode
    the observer is azimuth-resolved (run.wants_azimuth): given each
    geometry's line-of-sight azimuth aas [G] (degrees), the solve
    synthesizes the Fourier series at the group's distinct azimuths, with
    the TMS/IMS corrections, and each geometry reads u at its own (mu,
    phi); without aas it reads u0."""
    from ..fwd_allsky import simulate_allsky

    if level not in ("toa", "surface"):
        raise ValueError(f"allsky_observer: level {level!r} (toa, surface)")
    beam_on = float(torch.as_tensor(kw.get("fbeam", 0.0)).abs().max()) != 0.0
    resolved = beam_on and (nfourier is None or nfourier > 1)
    lvl = 0 if level == "toa" else -1

    def run(scene, f_grid, alts, drs, zas, background, aas=None):
        mu_v = -torch.cos(torch.deg2rad(zas[:, 0]))  # [G]
        if resolved and aas is not None:
            # the distinct azimuths of this geometry group, on the host
            aa0 = np.round(torch.as_tensor(aas).detach().cpu().double().numpy(), 6)
            phis = tuple(np.unique(aa0).tolist())
            pidx = torch.as_tensor([phis.index(a) for a in aa0.tolist()], device=f_grid.device)
            out = simulate_allsky(scene, f_grid, nquad=nquad, nfourier=nfourier,
                                  fast_linalg=fast_linalg, phis=phis,
                                  intensity_correction=True, **kw, **_on(f_grid))
            mu = torch.as_tensor(out.mu, dtype=f_grid.dtype, device=f_grid.device)
            return _interp(mu_v, mu, out.u[:, lvl], pidx)
        out = simulate_allsky(scene, f_grid, nquad=nquad, nfourier=nfourier,
                              fast_linalg=fast_linalg, **kw, **_on(f_grid))
        mu = torch.as_tensor(out.mu, dtype=f_grid.dtype, device=f_grid.device)
        return _interp(mu_v, mu, out.u0[:, lvl, :])  # u0: [F, NQuad], mu ascending

    run.wants_azimuth = resolved
    return run
