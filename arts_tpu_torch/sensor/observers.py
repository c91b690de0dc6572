"""Observer operators of the measurement pipeline (port of
arts_tpu/sensor/observers.py).  An observer maps a stacked geometry batch
to radiances,

    observer(scene, f_grid, alts [G, NP], drs [G, NP-1], zas [G, NP],
             background) -> I [G, F]

on the device and in the dtype of f_grid; sensor/measurement.py runs the
scalar clear-sky, polarized (Zeeman) and DISORT observers through one
deduplication and contraction path.
"""

import dataclasses

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


def _interp(x, xp, fp):
    """np.interp of each x [G] on the ascending grid xp [N] for every row
    of fp [F, N]: [G, F], clamped at the grid ends."""
    i1 = torch.clamp(torch.searchsorted(xp, x), 1, xp.shape[0] - 1)
    i0 = i1 - 1
    w = torch.clamp((x - xp[i0]) / (xp[i1] - xp[i0]), 0.0, 1.0)[:, None]
    return fp[:, i0].T * (1.0 - w) + fp[:, i1].T * w


def allsky_observer(nquad: int = 16, nfourier: int = 1, level: str = "toa",
                    fast_linalg: bool | None = None, **kw):
    """DISORT observer for thermal fields: one radiation-field solve per
    (scene, f_grid), read at each geometry's viewing angle (its first path
    point's zenith angle; the radiance arriving from za propagates with
    mu = -cos za), at the top ("toa", upwelling) or the bottom level
    ("surface", downwelling).  A thermal field is azimuth-symmetric, so
    the azimuthal mean u0 is exact.  A solar beam (fbeam) or an
    azimuth-resolved request raises NotImplementedError: the beam is not
    ported yet (ROADMAP §A 6)."""
    from ..fwd_allsky import simulate_allsky

    fbeam = torch.as_tensor(kw.pop("fbeam", 0.0))
    if bool((fbeam != 0).any()) or kw.pop("phis", ()):
        raise NotImplementedError("allsky_observer: the solar beam and azimuth-resolved "
                                  "fields are not ported yet (ROADMAP §A 6)")
    if level not in ("toa", "surface"):
        raise ValueError(f"allsky_observer: level {level!r} (toa, surface)")

    def run(scene, f_grid, alts, drs, zas, background):
        out = simulate_allsky(scene, f_grid, nquad=nquad, nfourier=nfourier,
                              fast_linalg=fast_linalg, **kw, **_on(f_grid))
        u = out.u0[:, 0 if level == "toa" else -1, :]  # [F, NQuad], mu ascending
        mu = torch.as_tensor(out.mu, dtype=f_grid.dtype, device=f_grid.device)
        return _interp(-torch.cos(torch.deg2rad(zas[:, 0])), mu, u)

    return run
