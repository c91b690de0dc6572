"""Rules of the arts_tpu_torch package: it imports nothing of JAX or
arts_tpu, its entry points run on the card unless told otherwise, and
importing it (or collecting the port's tests) builds nothing."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "arts_tpu_torch"
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "arts_tpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_arts_tpu_import(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.fixture(scope="module")
def cpu_objects():
    """Small CPU inputs for every entry point."""
    from arts_tpu_torch import ZeemanScene
    from arts_tpu_torch.disort import DisortInput
    from arts_tpu_torch.io.hitran import zeeman_catalog_from_par
    from arts_tpu_torch.lbl.zeeman import pad_zeeman_catalog
    from arts_tpu_torch.scene import build_scene, synth_par_rows

    scene, f = build_scene(n_lev=4, n_freq=8, n_lines=4, device="cpu", dtype=torch.float64)
    pts = scene.atm.at(scene.atm.z)
    F, L = 2, 3
    one = torch.ones(F, dtype=torch.float64)
    inp = DisortInput(tau=torch.ones(F, L, dtype=torch.float64), omega=0.5 * torch.ones(F, L, dtype=torch.float64),
                      leg=torch.ones(F, L, 16, dtype=torch.float64), f=torch.zeros(F, L, dtype=torch.float64),
                      b_levels=torch.ones(F, L + 1, dtype=torch.float64), fisot=0 * one,
                      albedo=0 * one, b_surf=one, b_top=0 * one)
    zcat = zeeman_catalog_from_par(synth_par_rows(4), ["H2O", "O2"], device="cpu",
                                   dtype=torch.float64)
    zscene = ZeemanScene(atm=scene.atm, zcat=zcat, pf=scene.pf)
    return scene, f, pts, inp, zcat, pad_zeeman_catalog(zcat), zscene


def _entry_points():
    from arts_tpu_torch import gas_absorption_profile, simulate_allsky, simulate_clearsky_polarized
    from arts_tpu_torch.atm.standard import standard_atmosphere
    from arts_tpu_torch.convert import (
        padded_zeeman_catalog_from_numpy,
        scene_from_numpy,
        zeeman_catalog_from_numpy,
    )
    from arts_tpu_torch.disort import disort
    from arts_tpu_torch.disort.eigen_kernel import fused_eigen
    from arts_tpu_torch.io.hitran import read_par, zeeman_catalog_from_par
    from arts_tpu_torch.lbl.catalog import build_catalog
    from arts_tpu_torch.lbl.partfun import rigid_rotor_table
    from arts_tpu_torch.lbl.voigt import absorption, absorption_kernel
    from arts_tpu_torch.lbl.zeeman import zeeman_propmat, zeeman_propmat_profile
    from arts_tpu_torch.ops.eigh_jacobi import eigh_jacobi
    from arts_tpu_torch.retrieval import RetrievalTarget, StateMapping, oem
    from arts_tpu_torch.scene import (
        build_cloud_retrieval,
        build_scene,
        build_zeeman_inputs,
        synth_par_rows,
        window_scene,
    )

    from arts_tpu_torch.atm.igrf import dipole_field, igrf13, magnetic_profile
    from arts_tpu_torch.convert import nlte_field_from_numpy, zeeman_scene_from_numpy
    from arts_tpu_torch.lbl.nlte import nlte_fit_profile
    from arts_tpu_torch.lbl.zeeman import zeeman_propmat_views
    from arts_tpu_torch.scene import build_zeeman_nlte_scene

    lines = lambda: read_par(synth_par_rows(4), ["H2O", "O2"])
    zrows = lambda: synth_par_rows(4)
    return {
        "igrf13": lambda o: igrf13(60.0, 0.0, 0.0),
        "dipole_field": lambda o: dipole_field(60.0, 0.0, 0.0),
        "magnetic_profile": lambda o: magnetic_profile(np.linspace(0.0, 1e4, 3)),
        "nlte_fit_profile": lambda o: nlte_fit_profile(
            o[1], o[0].atm.z, o[0].atm.t, o[0].atm.p, o[0].atm.vmr.T, o[0].cat, 2, [1] * 4,
            [0] * 4, np.zeros((4, 4)), np.zeros((4, 4)), np.ones(4), np.full((4, 2), 0.5), 288.0),
        "nlte_field_from_numpy": lambda o: nlte_field_from_numpy({}),
        "zeeman_scene_from_numpy": lambda o: zeeman_scene_from_numpy({}),
        "zeeman_propmat_views": lambda o: zeeman_propmat_views(
            o[1], o[4], o[0].pf, o[2].t, o[2].p, o[2].vmr, o[2].mag, [180.0, 0.0]),
        "build_zeeman_nlte_scene": lambda o: build_zeeman_nlte_scene(n_lev=3, n_freq=8,
                                                                     n_lines=4),
        "zeeman_catalog_from_par": lambda o: zeeman_catalog_from_par(zrows(), ["H2O", "O2"]),
        "zeeman_catalog_from_numpy": lambda o: zeeman_catalog_from_numpy({}),
        "padded_zeeman_catalog_from_numpy": lambda o: padded_zeeman_catalog_from_numpy({}),
        "build_zeeman_inputs": lambda o: build_zeeman_inputs(n_lev=3, n_freq=8, n_lines=4),
        "zeeman_propmat": lambda o: zeeman_propmat(o[1], o[4], o[0].pf, o[2].t, o[2].p,
                                                   o[2].vmr, o[2].mag, 180.0),
        "zeeman_propmat_pallas": lambda o: zeeman_propmat(o[1], o[4], o[0].pf, o[2].t, o[2].p,
                                                          o[2].vmr, o[2].mag, 180.0,
                                                          backend="pallas"),
        "zeeman_propmat_profile": lambda o: zeeman_propmat_profile(
            o[1], o[5], o[0].pf, o[2].t, o[2].p, o[2].vmr, o[2].mag[0], 180.0),
        "simulate_clearsky_polarized": lambda o: simulate_clearsky_polarized(
            o[6], o[1], o[2].t.new_tensor([0.0, 1e3]), o[2].t.new_tensor([0.0, 0.0]),
            o[2].t.new_tensor([1e3])),
        "standard_atmosphere": lambda o: standard_atmosphere(n_levels=4),
        "build_scene": lambda o: build_scene(n_lev=4, n_freq=8, n_lines=4),
        "build_catalog": lambda o: build_catalog(lines()),
        "rigid_rotor_table": lambda o: rigid_rotor_table(2, [174.6, 215.7]),
        "scene_from_numpy": lambda o: scene_from_numpy({}),
        "gas_absorption_profile": lambda o: gas_absorption_profile(o[0], o[1]),
        "simulate_allsky": lambda o: simulate_allsky(o[0], o[1]),
        "disort": lambda o: disort(o[3]),
        "disort_differentiable": lambda o: disort(o[3], fast_linalg=False),
        "simulate_allsky_differentiable": lambda o: simulate_allsky(o[0], o[1], fast_linalg=False),
        "eigh_jacobi": lambda o: eigh_jacobi(torch.eye(3, dtype=torch.float64)),
        "fused_eigen": lambda o: fused_eigen(torch.zeros(2, 4, 4), torch.zeros(2, 4, 4), 0.5, 1.0,
                                             np.linspace(0.2, 0.8, 4), np.full(4, 0.25)),
        "oem": lambda o: oem(lambda x: 2.0 * x, np.zeros(2), np.ones(2), np.ones(2), np.ones(2)),
        "StateMapping": lambda o: StateMapping(
            [RetrievalTarget("t", lambda s: s.surface_temperature[None], None)], o[0]),
        "window_scene": lambda o: window_scene(n_lev=4),
        "build_cloud_retrieval": lambda o: build_cloud_retrieval(n_lev=4, n_freq=8, nquad=4),
        "absorption": lambda o: absorption(o[1], o[0].cat, o[0].pf, o[2].t[0],
                                           o[2].p[0], o[2].vmr[0]),
        "absorption_kernel": lambda o: absorption_kernel(o[1], o[0].cat, o[0].pf,
                                                         o[2].t, o[2].p, o[2].vmr),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_defaults_to_the_card(name, cpu_objects):
    """Called without device=, an entry point asks for CUDA and raises
    where there is none, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name](cpu_objects)


def test_import_and_collection_need_no_triton_or_nvcc(tmp_path):
    """Every module imports, and the port's tests collect, with triton
    unimportable and no nvcc on PATH or under CUDA_HOME."""
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))
    )
    # third-party pytest plugins stay unloaded (they take no part in
    # collecting these files), and the interpreter ends without tearing
    # down JAX and torch: together ~3 of the subprocess's ~14 s
    env = dict(os.environ, PATH=path, CUDA_HOME=str(tmp_path / "no-cuda"),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    tests = sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py"))
    code = (
        "import importlib, os, pkgutil, sys\n"
        "sys.modules['triton'] = None\n"
        "import arts_tpu_torch\n"
        "for m in pkgutil.walk_packages(arts_tpu_torch.__path__, 'arts_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import pytest\n"
        f"rc = pytest.main(['--collect-only', '-q', '-p', 'no:cacheprovider', *{tests!r}])\n"
        "sys.stdout.flush()\n"
        "os._exit(int(rc))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "collected" in r.stdout, r.stdout[-2000:]
