"""Retrieval targets: map between a flat state vector and scene leaves
(port of arts_tpu/retrieval/targets.py).

A target is a (leaf accessor, transform bijector) pair; the state vector is
the concatenation of the transformed leaves.  Scenes are frozen
dataclasses of tensors, so model updates are functional
(`dataclasses.replace`, `torch.where`, `Tensor.index_put`) and never write
in place: autograd and the torch.func transforms (jacfwd, jacrev, vmap)
differentiate the composed map x -> scene -> measurement.
"""

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from .._cuda import move, resolve
from ..options import RetrievalTransform, check_option


class Transform:
    """Bijector between model space (leaf values) and retrieval space.

    `scene` is the scene the leaf lives in, for transforms that couple to
    other state (RH needs T and p).  Shape-changing transforms (polyfit)
    are allowed: the state slice takes the shape of `fwd`'s output.
    """

    name = "id"

    def fwd(self, v, ref, scene=None):
        return v

    def inv(self, x, ref, scene=None):
        return x


class LogTransform(Transform):
    name = "log"

    def fwd(self, v, ref, scene=None):
        return torch.log(v)

    def inv(self, x, ref, scene=None):
        return torch.exp(x)


class RelTransform(Transform):
    """x = v / v_ref (reference profile)."""

    name = "rel"

    def fwd(self, v, ref, scene=None):
        return v / ref

    def inv(self, x, ref, scene=None):
        return x * ref


class LogRelTransform(Transform):
    """x = log(v / v_ref)."""

    name = "logrel"

    def fwd(self, v, ref, scene=None):
        return torch.log(v / ref)

    def inv(self, x, ref, scene=None):
        return ref * torch.exp(x)


@dataclasses.dataclass(frozen=True)
class RHTransform(Transform):
    """Relative humidity: x = vmr * p / psat(T), optionally clamped at 0.
    T and p come from the live scene at each evaluation, through the `atm`
    accessor."""

    name = "rh"
    psat: Callable[[Any], Any] = None  # T [K] -> saturation pressure [Pa]
    atm: Callable[[Any], Any] = lambda scene: scene.atm  # scene -> (has .t, .p)
    fix_negative: bool = True

    def fwd(self, v, ref, scene=None):
        a = self.atm(scene)
        out = v * a.p / self.psat(a.t)
        return torch.clamp(out, min=0.0) if self.fix_negative else out

    def inv(self, x, ref, scene=None):
        a = self.atm(scene)
        out = x * self.psat(a.t) / a.p
        return torch.clamp(out, min=0.0) if self.fix_negative else out


@dataclasses.dataclass(frozen=True)
class PolyFitTransform(Transform):
    """Additive polynomial over a grid: v = ref + sum_i x_i t^i, t the grid
    normalized to [-1, 1]; fwd is the least-squares fit of the deviation
    from the reference leaf."""

    name = "polyfit"
    grid: Any = None  # [N] abscissa
    order: int = 1

    def _vander(self, like):
        t = torch.as_tensor(self.grid, dtype=like.dtype, device=like.device)
        half = torch.clamp((t.max() - t.min()) / 2, min=1e-300)
        t = (t - t.mean()) / half
        return torch.stack([t**i for i in range(self.order + 1)], -1)

    def fwd(self, v, ref, scene=None):
        V = self._vander(ref)
        return torch.linalg.lstsq(V, (v - ref).reshape(-1, 1)).solution[:, 0]

    def inv(self, x, ref, scene=None):
        return ref + (self._vander(ref) @ x).reshape(ref.shape)


def saturation_pressure_water(t):
    """Murphy & Koop (2005) saturation vapor pressure over liquid water [Pa]
    (smooth and differentiable)."""
    return torch.exp(
        54.842763
        - 6763.22 / t
        - 4.210 * torch.log(t)
        + 0.000367 * t
        + torch.tanh(0.0415 * (t - 218.8))
        * (53.878 - 1331.22 / t - 9.44523 * torch.log(t) + 0.014025 * t)
    )


TRANSFORMS = {
    "id": Transform(),
    "log": LogTransform(),
    "rel": RelTransform(),
    "logrel": LogRelTransform(),
    "rh": RHTransform(psat=saturation_pressure_water),
}


@dataclasses.dataclass(frozen=True)
class RetrievalTarget:
    """One retrieved quantity.

    get: scene -> leaf tensor; set: (scene, leaf) -> scene, without
    writing in place.  transform: a name in TRANSFORMS or a Transform.
    """

    name: str
    get: Callable[[Any], torch.Tensor]
    set: Callable[[Any, torch.Tensor], Any]
    transform: Any = "id"

    @property
    def tf(self) -> Transform:
        if isinstance(self.transform, str):
            return TRANSFORMS[check_option(RetrievalTransform, self.transform)]
        return self.transform


@dataclasses.dataclass(frozen=True)
class StateMapping:
    """Flatten/unflatten a list of targets against a reference scene.

    The reference scene is moved to `device` (None: the card) and its
    floating tensors cast to `dtype` (None: float32) when the mapping is
    made, so that to_vector and to_scene work on the device the forward
    model runs on."""

    targets: Sequence[RetrievalTarget]
    ref_scene: Any  # frozen reference (transform anchors + non-retrieved leaves)
    device: Any = None
    dtype: Any = None

    def __post_init__(self):
        dev, dt = resolve(self.device, self.dtype)
        object.__setattr__(self, "device", dev)
        object.__setattr__(self, "dtype", dt)
        object.__setattr__(self, "ref_scene", move(self.ref_scene, dev, dt))

    def _refs(self):
        return [t.get(self.ref_scene) for t in self.targets]

    def _xshapes(self):
        # the state slice of a target has the shape of the fwd image of its
        # reference leaf (the leaf's own shape except for polyfit)
        return [tuple(t.tf.fwd(r, r, self.ref_scene).shape)
                for t, r in zip(self.targets, self._refs())]

    @property
    def sizes(self):
        return [math.prod(s) for s in self._xshapes()]

    @property
    def n_state(self):
        return sum(self.sizes)

    def to_vector(self, scene):
        parts = [t.tf.fwd(t.get(scene), t.get(self.ref_scene), scene).reshape(-1)
                 for t in self.targets]
        if not parts:
            return torch.zeros(0, dtype=self.dtype, device=self.device)
        return torch.cat(parts)

    def to_scene(self, x, scene=None):
        scene = self.ref_scene if scene is None else scene
        off = 0
        for t, sz, xsh in zip(self.targets, self.sizes, self._xshapes()):
            ref = t.get(self.ref_scene)
            leaf = t.tf.inv(x[off : off + sz].reshape(xsh), ref, scene)
            scene = t.set(scene, leaf)
            off += sz
        return scene
