"""The port's line-by-line absorption at single atmospheric points against
arts_tpu's dense `absorption` on the CPU at float64, by the dense route
and through the Voigt kernel's plain version (which the kernel wrapper
runs on CPU tensors)."""

import jax.numpy as jnp
import numpy as np
import pytest

from arts_tpu.atm.standard import standard_atmosphere as j_standard_atmosphere
from arts_tpu.io.hitran import read_par as j_read_par
from arts_tpu.lbl.catalog import build_catalog as j_build_catalog
from arts_tpu.lbl.partfun import rigid_rotor_table as j_rigid_rotor_table
from arts_tpu.lbl.voigt import absorption as j_absorption
from arts_tpu_torch.atm.standard import standard_atmosphere
from arts_tpu_torch.io.hitran import read_par
from arts_tpu_torch.lbl.catalog import build_catalog
from arts_tpu_torch.lbl.partfun import rigid_rotor_table
from arts_tpu_torch.lbl.voigt import absorption, absorption_kernel
from arts_tpu_torch.ops import voigt_kernel as V
from test_torch_lbl import CPU64, T, _lines, _mid_tier, one_thread  # noqa: F401 (fixture)


def test_voigt_kernel_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and counts no
    launch."""
    from arts_tpu_torch import _cuda

    f, *cols = map(T, _mid_tier())
    args, _ = V.voigt_inputs(f, *(c[None] for c in cols))
    before = dict(_cuda.LAUNCHES)
    np.testing.assert_array_equal(V.voigt_kernel(*args).numpy(),
                                  V.voigt_kernel_plain(*args).numpy())
    assert _cuda.LAUNCHES == before


@pytest.fixture(scope="module")
def point_inputs():
    """The bench catalog cut to 64 lines, a 256-point 160-260 GHz grid and
    the 10-level US-76 atmosphere, as numpy."""
    cat = j_build_catalog(_lines(j_read_par))
    pf = j_rigid_rotor_table(2, [174.6, 215.7], 1.5)
    atm = j_standard_atmosphere(n_levels=10, z_top=80e3, species=("H2O", "O2"))
    f = np.linspace(160e9, 260e9, 256)
    return cat, pf, atm, f


@pytest.mark.parametrize("level", [0, 4, 9])
@pytest.mark.parametrize("route", ["dense", "kernel"])
def test_absorption_matches_jax(point_inputs, route, level):
    """One atmospheric point against JAX's dense `absorption`.  The dense
    route repeats its arithmetic (rtol 1e-10: float64 roundoff); the kernel
    route adds the multipole far field and the tiered w(z), held at the
    JAX package's own multipole-vs-direct bound (3e-6 * scale, rtol 1e-4,
    tests/test_tpu_kernels.py:131)."""
    jcat, jpf, jatm, f = point_inputs
    t, p, v = (np.asarray(a) for a in (jatm.t[level], jatm.p[level], jatm.vmr[:, level]))
    want = np.asarray(j_absorption(jnp.asarray(f), jcat, jpf, t, p, v))
    cat = build_catalog(_lines(read_par), **CPU64)
    pf = rigid_rotor_table(2, [174.6, 215.7], 1.5, **CPU64)
    atm = standard_atmosphere(n_levels=10, z_top=80e3, species=("H2O", "O2"), **CPU64)
    np.testing.assert_allclose(atm.p.numpy(), np.asarray(jatm.p), rtol=1e-14)
    tt, pp, vv = T(t), T(p), T(v)
    if route == "dense":
        got = absorption(T(f), cat, pf, tt, pp, vv, **CPU64).numpy()
        tol = dict(rtol=1e-10, atol=1e-10 * np.abs(want).max())
    else:
        got = absorption_kernel(T(f), cat, pf, tt[None], pp[None], vv[None],
                                **CPU64)[0].numpy()
        tol = dict(rtol=1e-4, atol=3e-6 * np.abs(want).max())
    np.testing.assert_allclose(got, want, **tol)
