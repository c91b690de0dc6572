"""The port's predefined absorption models (arts_tpu_torch.predefined)
against the 58 in-repo goldens and against arts_tpu.predefined on the CPU
at float64: every one of the 27 registered models at five levels of the
benchmark atmosphere over its own band, lattice nodes included; float32
against float64 on the same inputs; the temperature and VMR gradients of
predefined_absorption against jax.grad; the MT_CKD 4.0/4.3 evaluators on
synthetic tables; and the registry against the JAX package's.

The JAX references are compiled with `ref_jit`, once per module."""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arts_tpu import constants as jconst
from arts_tpu.predefined import PREDEF_MODELS as J_MODELS
from arts_tpu.predefined import ckdmt320 as J320
from arts_tpu.predefined import ckdmt350 as J350
from arts_tpu.predefined import mt_ckd400 as JK
from arts_tpu_torch.atm.standard import standard_atmosphere
from arts_tpu_torch.convert import mtckd_data_from_numpy
from arts_tpu_torch.predefined import PREDEF_MODELS, predefined_absorption
from arts_tpu_torch.predefined import mt_ckd400 as K

CPU64 = dict(device="cpu", dtype=torch.float64)
ref_jit = functools.partial(jax.jit, compiler_options={"xla_backend_optimization_level": 0})
# the JAX CKD modules cache their tables as arrays on first use: made
# outside any trace, so that each traced reference may read them
J350._tables()
J320._tables()
C100 = 100.0 * jconst.c  # Hz per cm^-1

GOLDENS = json.loads(
    (pathlib.Path(__file__).parent / "goldens" / "predef_goldens.json").read_text()
)["configs"]
# the golden's VMR key and the JAX test's relative tolerance
# (tests/test_predef_goldens.py): O2-v1v0's band lattice is anchored on
# the band here and on the grid in the reference
GOLDEN_VMR = {"O2-MPM2020": "O2", "liquidcloud-ELL07": "liquidcloud", "H2O-MPM89": "H2O",
              "H2O-SelfContCKDMT350": "H2O", "H2O-ForeignContCKDMT350": "H2O",
              "O2-MPM89": "O2", "O2-TRE05": "O2", "N2-SelfContMPM93": "N2",
              "H2O-PWR2021": "H2O", "H2O-PWR2022": "H2O", "O2-PWR2021": "O2",
              "O2-PWR2022": "O2", "N2-SelfContPWR2021": "N2", "H2O-SelfContCKDMT320": "H2O",
              "H2O-ForeignContCKDMT320": "H2O", "CO2-CKDMT252": "CO2",
              "O2-visCKDMT252": "O2", "N2-CIAfunCKDMT252": "N2", "N2-CIArotCKDMT252": "N2",
              "O2-CIAfunCKDMT100": "O2", "O2-v0v0CKDMT100": "O2", "O2-v1v0CKDMT100": "O2"}
GOLDEN_RTOL = {"O2-v1v0CKDMT100": 1e-4}

# each model's band: its golden frequencies (the five without goldens take
# 1-1000 GHz), plus lattice nodes of its table inside the band [cm^-1]
MW = np.linspace(1e9, 1000e9, 97)
NODES = {"CKDMT350": [10.0, 100.0, 1000.0, 5000.0, 15000.0],
         "CKDMT320": [10.0, 100.0, 1000.0, 5000.0, 15000.0],
         "CO2-CKDMT252": [600.0, 2002.0, 2500.0],
         "O2-visCKDMT252": [15010.0, 20000.0, 25000.0],
         "N2-CIAfunCKDMT252": [2001.766357 + 3.981461525 * i for i in (5, 60, 150)],
         "N2-CIArotCKDMT252": [5.0, 50.0, 100.0, 300.0],
         "O2-CIAfunCKDMT100": [1345.0, 1500.0, 1700.0],
         "O2-v0v0CKDMT100": [7540.0, 7800.0, 8000.0],
         "O2-v1v0CKDMT100": [9102.0, 9400.0, 10000.0]}


def band(name):
    f = next((np.asarray(c["f_hz"], float) for c in GOLDENS if c["model"] == name), MW)
    nodes = [v for key, vs in NODES.items() if key in name for v in vs]
    return np.sort(np.concatenate([f, np.asarray(nodes) * C100]))


# five levels of the benchmark atmosphere (US-76, 80 km top, 60 levels),
# with CO2 and a liquid cloud of 0.2 g/m^3 where it is warm enough
ATM = standard_atmosphere(n_levels=60, z_top=80e3, species=("N2", "O2", "H2O", "CO2"),
                          **CPU64)
LEVELS = [0, 3, 9, 20, 45]
T_L = ATM.t[LEVELS].numpy()
P_L = ATM.p[LEVELS].numpy()
VMRS = {s: ATM.vmr[i, LEVELS].numpy() for i, s in enumerate(("N2", "O2", "H2O", "CO2"))}
VMRS["liquidcloud"] = np.where(T_L > 250.0, 2e-4, 0.0)


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0 and np.isfinite(got).all(), what
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} of scale > {tol}"
    return err


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@ref_jit
def _jax_models(t, p, vmrs):
    """Every JAX model at the levels, each over its own band."""
    out = {}
    for name, fn in J_MODELS.items():
        f = jnp.asarray(band(name))
        out[name] = jax.vmap(lambda tt, pp, vv: fn(f, tt, pp, vv))(t, p, vmrs)
    return out


@pytest.fixture(scope="module")
def jax_models():
    ref = _jax_models(jnp.asarray(T_L), jnp.asarray(P_L),
                      {k: jnp.asarray(v) for k, v in VMRS.items()})
    return {k: np.asarray(v) for k, v in ref.items()}


def test_registry_matches_the_jax_package():
    assert list(PREDEF_MODELS) == list(J_MODELS)
    assert len(PREDEF_MODELS) == 27


def test_goldens():
    """The 22 models with goldens against the 58 in-repo goldens at the JAX
    test's tolerances: rtol 1e-10 and atol 1e-12 * scale (O2-v1v0 rtol
    1e-4)."""
    for cfg in GOLDENS:
        vmrs = {GOLDEN_VMR[cfg["model"]]: cfg["vmr"]}
        for key, spec in (("vmr_h2o", "H2O"), ("vmr_o2", "O2"), ("vmr_n2", "N2")):
            if key in cfg:
                vmrs[spec] = cfg[key]
        got = predefined_absorption((cfg["model"],), np.asarray(cfg["f_hz"], float),
                                    cfg["t"], cfg["p"], vmrs, **CPU64).numpy()
        want = np.asarray(cfg["alpha"])
        np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL.get(cfg["model"], 1e-10),
                                   atol=1e-12 * np.abs(want).max(),
                                   err_msg=f"{cfg['model']} T {cfg['t']}")


def test_every_model_matches_jax(jax_models):
    """All 27 models, batched over the five levels, against the JAX
    package's (vmapped over the levels) at 1e-10 of scale."""
    vmrs = {k: torch.tensor(v) for k, v in VMRS.items()}
    for name, fn in PREDEF_MODELS.items():
        got = fn(torch.tensor(band(name)), torch.tensor(T_L), torch.tensor(P_L), vmrs)
        assert got.shape == jax_models[name].shape, name
        close(got, jax_models[name], 1e-10, name)


# float32 against float64 on the same (float32) inputs, of each model's
# scale over the levels, per model: 1e-5 for the ELL07 cloud's
# permittivity sums and PWR2021/22's speed-dependent shape (2.6e-6 and
# 1.9e-6 here), 1e-6 for the rest (2.6e-7 or less), with the line
# detunings and table positions formed in float64
F32_TOL = {"liquidcloud-ELL07": 1e-5, "H2O-PWR2021": 1e-5, "H2O-PWR2022": 1e-5}


def test_float32_against_float64():
    f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
    t, p = f32(T_L), f32(P_L)
    vmrs = {k: f32(v) for k, v in VMRS.items()}
    for name in PREDEF_MODELS:
        f = f32(band(name))
        lo = predefined_absorption((name,), f, t, p, vmrs, device="cpu", dtype=torch.float32)
        hi = predefined_absorption((name,), f.double(), t.double(), p.double(),
                                   {k: v.double() for k, v in vmrs.items()}, **CPU64)
        close(lo.double(), hi, F32_TOL.get(name, 1e-6), f"{name} float32")


GRAD_F = np.concatenate([np.linspace(5e9, 1000e9, 40), np.linspace(10.0, 28000.0, 120) * C100])
GRAD_W = np.random.default_rng(4).uniform(0.5, 1.5, GRAD_F.size)
GRAD_POINT = (271.3, 7.3e4, {"N2": 0.78, "O2": 0.209, "H2O": 4e-3, "CO2": 4.2e-4,
                             "liquidcloud": 1e-4})


@ref_jit
def _jax_model_grads(t, vmrs):
    """d/dT and d/dVMR of each model's weighted sum over GRAD_F."""
    f = jnp.asarray(GRAD_F)
    loss = lambda fn: lambda tt, vv: jnp.sum(fn(f, tt, GRAD_POINT[1], vv) * GRAD_W)
    return {name: jax.grad(loss(fn), argnums=(0, 1))(t, vmrs)
            for name, fn in J_MODELS.items()}


def test_gradients_match_jax_grad():
    """d/dT and d/dVMR (each species) of each model's weighted sum over a
    band from the microwave to the visible, through predefined_absorption,
    against jax.grad at 1e-9 of the largest of that model's gradients."""
    t0, p0, v0 = GRAD_POINT
    ref = _jax_model_grads(jnp.asarray(t0), {k: jnp.asarray(x) for k, x in v0.items()})
    for name in PREDEF_MODELS:
        t = torch.tensor(t0, dtype=torch.float64, requires_grad=True)
        v = {k: torch.tensor(x, dtype=torch.float64, requires_grad=True) for k, x in v0.items()}
        a = predefined_absorption((name,), GRAD_F, t, p0, v, **CPU64)
        (a * torch.tensor(GRAD_W)).sum().backward()
        gt, gv = ref[name]
        want = np.array([float(gt)] + [float(gv[k]) for k in v0])
        got = np.array([float(t.grad)] + [0.0 if v[k].grad is None else float(v[k].grad)
                                          for k in v0])
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max(),
                                   err_msg=name)


def test_mt_ckd4_on_synthetic_tables():
    """The five MT_CKD 4.x functions on synthetic tables (tests/test_aux.py's
    layout, with structure along the grid) against the JAX package's at
    1e-10 of scale, float64, at nodes, between nodes and outside the
    table."""
    rng = np.random.default_rng(11)
    n = 201
    d = dict(wavenumbers=np.linspace(0.0, 2000.0, n),
             self_absco_ref=1e-22 * rng.uniform(0.5, 2.0, n),
             for_absco_ref=2e-23 * rng.uniform(0.5, 2.0, n),
             for_closure_absco_ref=8e-23 * rng.uniform(0.5, 2.0, n),
             self_texp=rng.uniform(4.0, 7.0, n), ref_press=1013.0, ref_temp=296.0)
    f = np.concatenate([np.linspace(3.0, 1990.0, 57), [0.0, 500.0, 1000.0, 2000.0, 2500.0]]) * C100
    t, p, vmrs = T_L[:3], P_L[:3], {"H2O": VMRS["H2O"][:3]}
    d400 = {k: v for k, v in d.items() if k != "for_closure_absco_ref"}
    j400 = JK.MTCKD400Data(**{k: jnp.asarray(v) for k, v in d400.items()})
    j430 = JK.MTCKD430Data(**{k: jnp.asarray(v) for k, v in d.items()})
    p400, p430 = mtckd_data_from_numpy(d400, **CPU64), mtckd_data_from_numpy(d, **CPU64)
    assert isinstance(p400, K.MTCKD400Data) and isinstance(p430, K.MTCKD430Data)
    for name, data, jdata in (("h2o_self_mtckd400", p400, j400),
                              ("h2o_foreign_mtckd400", p400, j400),
                              ("h2o_self_mtckd430", p430, j430),
                              ("h2o_foreign_mtckd430", p430, j430),
                              ("h2o_foreign_closure_mtckd430", p430, j430)):
        want = jax.vmap(lambda tt, pp, vv: getattr(JK, name)(jnp.asarray(f), tt, pp,
                                                                {"H2O": vv}, jdata))(
            jnp.asarray(t), jnp.asarray(p), jnp.asarray(vmrs["H2O"]))
        got = getattr(K, name)(f, t, p, vmrs, data, **CPU64)
        close(got, want, 1e-10, name)
        assert float(got[:, -1].abs().max()) == 0.0  # outside the table
