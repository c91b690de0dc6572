"""Measurement-vector pipeline: batched geometries -> sensor contraction
(port of arts_tpu/sensor/measurement.py).

The deduplicated simulation batch is one call of the observer on the
stacked paths (padded to a common length with zero-length segments, which
are exact no-ops); the contraction is SensorArray.apply; dy/dx is
torch.func through the whole pipeline.
"""

import dataclasses

import numpy as np
import torch

from .._cuda import move, resolve
from .obsel import SensorArray
from .observers import clearsky_observer


def stack_paths(paths, device=None, dtype=None):
    """Pad PathGeometry objects to a common length: (alt [G, NP],
    dr [G, NP-1], za [G, NP], backgrounds).  Padding repeats the last
    point with zero-length segments."""
    dev, dt = resolve(device, dtype)
    npmax = max(p.n_points for p in paths)
    alts = np.zeros((len(paths), npmax))
    drs = np.zeros((len(paths), npmax - 1))
    zas = np.zeros((len(paths), npmax))
    for i, p in enumerate(paths):
        n = p.n_points
        alts[i, :n] = p.alt
        alts[i, n:] = p.alt[-1]
        za = getattr(p, "za", None)
        if za is not None:
            zas[i, :n] = za
            zas[i, n:] = za[-1]
        drs[i, : n - 1] = p.dr
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    return t(alts), t(drs), t(zas), [p.background for p in paths]


def stack_azimuths(paths, device=None, dtype=None):
    """First path point's line-of-sight azimuth per geometry [G] (degrees;
    0 for geometries without an `aa`)."""
    dev, dt = resolve(device, dtype)
    out = np.zeros(len(paths))
    for i, p in enumerate(paths):
        aa = getattr(p, "aa", None)
        if aa is not None:
            out[i] = float(np.ravel(np.asarray(aa))[0])
    return torch.as_tensor(out, dtype=dt, device=dev)


def _simulate_batch(scene, f_grid, alts, drs, zas, backgrounds, observer=None):
    """Radiances [G, F] for stacked geometries: mixed backgrounds run as one
    sub-batch each, in order of first appearance, and are put back in the
    geometries' order."""
    observer = observer or clearsky_observer()
    groups = {}
    for i, b in enumerate(backgrounds):
        groups.setdefault(b, []).append(i)
    parts, order = [], []
    for bg, idx in groups.items():
        sel = torch.as_tensor(idx, device=alts.device)
        parts.append(observer(scene, f_grid, alts[sel], drs[sel], zas[sel], bg))
        order += idx
    I = torch.cat(parts, 0)
    if order == sorted(order):
        return I
    inv = torch.as_tensor(np.argsort(order), device=I.device)
    return I[inv]


def _prepare(scene, f_grid, device, dtype):
    dev, dt = resolve(device, dtype)
    return move(scene, dev, dt), torch.as_tensor(f_grid).to(device=dev, dtype=dt)


def measurement_vector(scene, sensor: SensorArray, f_grid, paths, background="surface",
                       observer=None, device=None, dtype=None):
    """y [n_elements] for a batch of geometries sharing one f_grid, on
    `device` (None: the card) in `dtype` (None: float32).  A path's own
    background wins over `background`."""
    scene, f_grid = _prepare(scene, f_grid, device, dtype)
    alts, drs, zas, bgs = stack_paths(paths, f_grid.device, f_grid.dtype)
    I = _simulate_batch(scene, f_grid, alts, drs, zas, [b or background for b in bgs],
                        observer=observer)
    return sensor.apply(I)


@dataclasses.dataclass(frozen=True)
class Obsel:
    """One observation element group: sensor weights over a shared
    (f_grid, paths) simulation grid; observer None means the scalar
    clear-sky observer."""

    sensor: SensorArray
    f_grid: object
    paths: tuple
    background: str = "surface"
    observer: object = None


def _host_bytes(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).tobytes()


def collect_simulations(obsels):
    """Deduplicate shared (f_grid, paths, background, observer) across
    obsels: by the identity of the objects first, then by value (the bytes
    of the grid and of each path's altitudes and layer lengths), so that
    equal grids built apart still share one batch.  Returns (groups,
    obsel_to_group), groups a list of (f_grid, paths, background,
    observer)."""
    groups, keymap, obsel_to_group = [], {}, []

    def value_key(ob):
        pk = tuple((_host_bytes(p.alt), _host_bytes(p.dr)) for p in ob.paths)
        return (_host_bytes(ob.f_grid), pk, ob.background, id(ob.observer))

    for ob in obsels:
        ident = (id(ob.f_grid), id(ob.paths), ob.background, id(ob.observer))
        if ident in keymap:
            obsel_to_group.append(keymap[ident])
            continue
        vk = value_key(ob)
        if vk in keymap:
            keymap[ident] = keymap[vk]
            obsel_to_group.append(keymap[vk])
            continue
        gi = len(groups)
        groups.append((ob.f_grid, ob.paths, ob.background, ob.observer))
        keymap[ident] = keymap[vk] = gi
        obsel_to_group.append(gi)
    return groups, obsel_to_group


def measurement_vector_from_obsels(scene, obsels, device=None, dtype=None):
    """(y, number of simulation batches) for a list of obsels: each unique
    batch runs once, every obsel contracts its weights from it, and the
    results are concatenated in obsel order."""
    dev, dt = resolve(device, dtype)
    scene = move(scene, dev, dt)
    groups, o2g = collect_simulations(obsels)
    cache = []
    for f_grid, paths, bg, observer in groups:
        f_grid = torch.as_tensor(f_grid).to(device=dev, dtype=dt)
        alts, drs, zas, bgs = stack_paths(paths, dev, dt)
        cache.append(_simulate_batch(scene, f_grid, alts, drs, zas, [b or bg for b in bgs],
                                     observer=observer))
    y = torch.cat([ob.sensor.apply(cache[g]) for ob, g in zip(obsels, o2g)])
    return y, len(groups)


def measurement_jacobian(scene, sensor, f_grid, paths, mapping, background="surface",
                         observer=None, chunk_size=None, device=None, dtype=None):
    """(y, K) with K = dy/dx [n_elements, n_state] at the state of `scene`
    through the state mapping (retrieval.targets.StateMapping), by forward
    mode (torch.func.jvp under vmap, one tangent per state element: the
    state is the shorter side).  chunk_size bounds the tangents carried at
    once, and so the memory, at the cost of one primal evaluation per
    chunk."""
    scene, f_grid = _prepare(scene, f_grid, device, dtype)
    alts, drs, zas, _ = stack_paths(paths, f_grid.device, f_grid.dtype)
    observer = observer or clearsky_observer()

    def fwd(x):
        return sensor.apply(observer(mapping.to_scene(x), f_grid, alts, drs, zas, background))

    x0 = mapping.to_vector(scene)
    y = fwd(x0)
    eye = torch.eye(x0.numel(), dtype=x0.dtype, device=x0.device)
    column = lambda v: torch.func.jvp(fwd, (x0,), (v,))[1]
    step = chunk_size or x0.numel()
    K = torch.cat([torch.func.vmap(column)(eye[i : i + step])
                   for i in range(0, x0.numel(), step)], 0).T
    return y, K
