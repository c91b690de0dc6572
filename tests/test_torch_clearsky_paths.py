"""The port's simulate_clearsky against arts_tpu on the CPU at float64
(test_torch_clearsky.py's case fixture): the constant and lintau
rte_options over every background, the wind case and
simulate_clearsky_bt."""

import numpy as np
import pytest

from arts_tpu_torch import fwd as F
from test_torch_clearsky import (  # noqa: F401 (fixtures)
    BACKGROUNDS,
    CPU64,
    FREQ,
    OPTIONS,
    WIND_AA,
    WIND_PATH,
    case,
    check_simulate_clearsky,
    close,
    one_thread,
)


@pytest.mark.parametrize("bg", BACKGROUNDS)
@pytest.mark.parametrize("opt", OPTIONS[:2])
def test_simulate_clearsky_matches_jax(case, bg, opt):
    """Every background x the constant and lintau rte_options."""
    check_simulate_clearsky(case, bg, opt)


def test_wind_and_bt_match_jax(case):
    """A wind profile shifts each point's grid by its line-of-sight speed
    (a slant path, azimuth 30 deg); and the brightness temperatures of
    simulate_clearsky_bt; both at 1e-10 of scale."""
    ps, pw, nadir, ref = case
    path = WIND_PATH
    kw = dict(background="surface", path_za=path.za, path_aa=np.full(path.za.shape, WIND_AA))
    got = F.simulate_clearsky(pw, FREQ, path.alt, path.dr, **kw, **CPU64).numpy()
    still = F.simulate_clearsky(ps, FREQ, path.alt, path.dr, **kw, **CPU64).numpy()
    want = ref["wind"]
    assert np.abs(got - still).max() > 1e-3 * np.abs(want - still).max() > 0
    close(got, want, atol_scale=1e-10)
    bt = F.simulate_clearsky_bt(ps, FREQ, nadir.alt, nadir.dr, background="surface", **CPU64)
    close(bt.numpy(), ref["bt"], atol_scale=1e-10)
