"""The port's batched emission recursion and wofz's derivative rule
against arts_tpu on the CPU at float64."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from arts_tpu.ops import wofz as JW
from arts_tpu_torch.ops.wofz import wofz
from arts_tpu_torch.rtepack import emission as E
from test_torch_clearsky import T, _emission_inputs, one_thread, ref_jit  # noqa: F401


def test_batched_recursion_is_per_path():
    """A [np, G, F] batch with per-path layer lengths gives each path's own
    radiance (the layout the observers use)."""
    k, J, r, I0 = _emission_inputs(6)
    k2, J2, r2, _ = _emission_inputs(7)
    for fn in (E.emission_unpolarized, E.emission_unpolarized_linprop):
        both = fn(T(np.stack([k, k2], 1)), T(np.stack([J, J2], 1)),
                  T(np.stack([r, r2], 1)), T(I0))
        for g, (kk, JJ, rr) in enumerate(((k, J, r), (k2, J2, r2))):
            np.testing.assert_array_equal(both[g].numpy(),
                                          fn(T(kk), T(JJ), T(rr), T(I0)).numpy())


def test_wofz_derivative_matches_jax_custom_jvp():
    """d Re w / d(x, y) and d Im w / d(x, y) by jacfwd (the jvp rule) and
    jacrev (the backward rule) against jax.jacfwd / jax.jacrev through the
    JAX package's custom_jvp, inside the far gate and beyond it, and under
    vmap."""
    x = np.array([0.0, 0.3, 2.5, 8.0, 15.0, 22.0, 40.0, 300.0])
    y = np.array([1e-3, 0.5, 1.0, 3.0, 0.2, 10.0, 25.0, 1e-2])

    def jf(v):
        w = JW.wofz(jax.lax.complex(v[0], v[1]))
        return jnp.stack([w.real, w.imag])

    def tf(v):
        w = wofz(torch.complex(v[0], v[1]))
        return torch.stack([w.real, w.imag])

    v = np.stack([x, y])
    wants = ref_jit(lambda v: [jax.vmap(jt(jf), 1)(v) for jt in (jax.jacfwd, jax.jacrev)])(
        jnp.asarray(v))
    for want, tt in zip(wants, (torch.func.jacfwd, torch.func.jacrev)):
        want = np.asarray(want)
        got = torch.func.vmap(tt(tf), 1)(T(v)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
