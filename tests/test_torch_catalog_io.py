"""The port's catalog readers and helpers against arts_tpu on the CPU, on
.par rows written here (as tests/test_io.py and tests/test_quantum.py
write theirs): read_par_records and read_par from rows and from a file,
with frequency windows and strengths from A or from S; the O2 local
quanta, o2_lines_from_par and einstein_a_from_s; the isotopologue
indices and catalog_from_par; linear_band_lines_from_quanta; the
catalog helpers (Cutoff, SpeciesMeta, concat_catalogs, hitran_s,
keep_strongest); the isotopologue registry; and the polynomial form of
the partition function."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arts_tpu.io.hitran as JH
import arts_tpu.io.quantum as JQ
import arts_tpu.io.species as JSP
import arts_tpu.lbl.catalog as JC
from arts_tpu.lbl.partfun import PartFunTable as JPartFunTable
from arts_tpu_torch.io import hitran as H
from arts_tpu_torch.io import quantum as Q
from arts_tpu_torch.io import species as SP
from arts_tpu_torch.lbl import catalog as C
from arts_tpu_torch.lbl.partfun import PartFunTable

CPU64 = dict(device="cpu", dtype=torch.float64)
SPECIES = ["H2O", "O2", "CO2"]
Q296 = {"H2O-161": 174.6, "H2O-181": 176.1, "O2-66": 215.7, "O2-68": 455.2, "CO2-626": 286.1}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's tensor code: under parallel test
    workers the thread pool's waits after each small operation cost more
    than the operations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def par_row(mol, iso, nu_cm, S, A, gair, gself, e0_cm, n_air, delta, gu, gl, q_loc_lo="",
            trailing=""):
    row = (
        f"{mol:2d}" + str(iso) + f"{nu_cm:12.6f}" + f"{S:10.3E}" + f"{A:10.3E}"
        + f"{gair:5.4f}"[:5] + f"{gself:5.4f}"[:5] + f"{e0_cm:10.4f}" + f"{n_air:4.2f}"
        + f"{delta:8.6f}" + " " * 45 + q_loc_lo.ljust(15)
    ).ljust(146) + f"{gu:7.1f}" + f"{gl:7.1f}"
    return row + trailing


def mixed_rows():
    """H2O (two isotopologues), O2-66 and O2-68 with local quanta (two with
    A = 0, whose A comes from S), CO2, an unknown molecule and a short
    row, out of frequency order."""
    rng = np.random.default_rng(5)
    rows = []
    for i in range(24):
        mol, iso = [(1, 1), (7, 1), (1, 2), (2, 1), (7, 2)][i % 5]
        N = 2 * (i % 7) + 1
        rows.append(par_row(
            mol, iso, rng.uniform(1.5, 8.0), rng.uniform(1e-27, 1e-24),
            0.0 if i in (1, 11) else rng.uniform(1e-9, 1e-6), rng.uniform(0.02, 0.1),
            rng.uniform(0.05, 0.3), rng.uniform(0.0, 900.0), rng.uniform(0.5, 0.8),
            rng.uniform(-0.01, 0.01) if i % 3 else 0.0, 2.0 * N + 1.0, 2.0 * N - 1.0,
            q_loc_lo=f"  Q {N:2d}  {'RP'[i % 2]} {N + (i % 2) * 2 - 1:2d}" if mol == 7 else ""))
    rows.insert(7, par_row(99, 1, 3.0, 1e-25, 1e-7, 0.05, 0.1, 10.0, 0.7, 0.0, 3.0, 1.0))
    rows.insert(3, rows[0][:100])
    return rows


def _same_lines(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            if k == "ls":
                assert g[k].keys() == w[k].keys()
                for p in g[k]:
                    for var, (law, x) in g[k][p].items():
                        assert int(law) == int(w[k][p][var][0])
                        np.testing.assert_allclose(x, w[k][p][var][1], rtol=1e-15)
            elif isinstance(g[k], str):
                assert g[k] == w[k]
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-14, err_msg=k)


def _same_catalog(got, want):
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)),
                                   rtol=1e-14, err_msg=f.name)


def test_read_par_records_and_read_par_match_jax(tmp_path):
    """Records and line dicts from the rows and from a file, whole and in a
    60-150 GHz window, with A from the rows and from S with Q(296)."""
    rows = mixed_rows()
    path = tmp_path / "mixed.par"
    path.write_text("\n".join(rows) + "\n")
    for src in (rows, str(path)):
        for window in ((0.0, np.inf), (60e9, 150e9)):
            got, want = H.read_par_records(src, *window), JH.read_par_records(src, *window)
            assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
            for opt in ("A", "S"):
                kw = dict(q296=Q296, strength_option=opt, cutoff=25e9, fmin=window[0],
                          fmax=window[1])
                _same_lines(H.read_par(src, SPECIES, **kw), JH.read_par(src, SPECIES, **kw))
    assert len(H.read_par_records(rows, 60e9, 150e9)) < len(H.read_par_records(rows))
    with pytest.raises(KeyError, match="Q\\(296\\)"):
        H.read_par(rows, SPECIES, strength_option="S")


def test_o2_lines_from_par_and_einstein_a_match_jax():
    """The O2 local quanta of every record, o2_lines_from_par's lines and
    Lande g's (A from S where a row has none) and einstein_a_from_s at 296
    and 300 K, equal to the JAX package's."""
    recs = H.read_par_records(mixed_rows())
    jrecs = JH.read_par_records(mixed_rows())
    assert [H.parse_o2_local_quanta(r) for r in recs] == [JH.parse_o2_local_quanta(r)
                                                          for r in jrecs]
    got, want = H.o2_lines_from_par(recs, 215.7), JH.o2_lines_from_par(jrecs, 215.7)
    _same_lines(got[0], want[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-15)
    assert any(r.A == 0.0 and r.isotopologue == "O2-66" for r in recs)
    for T0 in (296.0, 300.0):
        args = (3e-20, 7.0, 1e-21, 60e9, 215.7, 0.995262)
        assert H.einstein_a_from_s(*args, T0=T0) == pytest.approx(
            JH.einstein_a_from_s(*args, T0=T0), rel=1e-15)


def test_iso_indices_and_catalog_from_par_match_jax(tmp_path):
    """iso_index_of_lines and assign_iso_indices on merged reads;
    catalog_from_par (the port's dict route through read_par) against the
    JAX package's on a file in frequency order, as HITRAN writes them, both
    strength options, with a window; and on the unordered rows against the
    JAX package's dict route (read_par, sorted, build_catalog), which
    numbers isotopologues in file order where its native loader numbers
    them in frequency order."""
    rows = mixed_rows()
    got = H.read_par(rows, SPECIES) + H.read_par(rows[::-1], SPECIES)
    want = JH.read_par(rows, SPECIES, strength_option="A") + JH.read_par(
        rows[::-1], SPECIES, strength_option="A")
    assert H.iso_index_of_lines(got) == JH.iso_index_of_lines(want)
    assert H.assign_iso_indices(got) == JH.assign_iso_indices(want)
    _same_lines(got, want)
    path = tmp_path / "sorted.par"
    path.write_text("\n".join(sorted((r for r in rows if len(r) >= 160),
                                     key=lambda r: float(r[3:15]))) + "\n")
    for kw in (dict(q296=Q296), dict(strength_option="A", fmin=60e9, fmax=150e9)):
        cat = H.catalog_from_par(str(path), SPECIES, cutoff=25e9, **kw, **CPU64)
        assert cat.n_perturbers == 2
        _same_catalog(cat, JH.catalog_from_par(str(path), SPECIES, cutoff=25e9, **kw))
    lines = JH.read_par(rows, SPECIES, q296=Q296, cutoff=25e9)
    lines.sort(key=lambda ln: ln["f0"])
    _same_catalog(H.catalog_from_par(rows, SPECIES, q296=Q296, cutoff=25e9, **CPU64),
                  JC.build_catalog(lines, n_perturbers=2))


def test_linear_band_lines_from_quanta_matches_jax():
    """CO2 R-branch rows with extended-format states (l2 tagged on the
    upper band): the lines and (li, lf) of both packages."""
    rows = []
    for J in range(6):
        up = f"ElecStateLabel=X;v1=0;v2=1;l2=1;v3=1;J={J + 1}"
        lo = f"ElecStateLabel=X;v1=0;v2=1;l2=1;v3=0;J={J}"
        rows.append(par_row(2, 1, 2349.0 + 0.78 * (J + 1), 1e-20, 1e-6 / (J + 1), 0.0534, 0.07,
                            0.39 * J * (J + 1), 0.70, -0.002, 2.0 * J + 3.0, 2.0 * J + 1.0,
                            trailing=f",{up},{lo}"))
    rows.append(par_row(2, 1, 2360.0, 1e-20, 1e-6, 0.05, 0.07, 10.0, 0.7, 0.0, 3.0, 1.0,
                        trailing=",ElecStateLabel=X,ElecStateLabel=X"))
    recs, jrecs = H.read_par_records(rows), JH.read_par_records(rows)
    got = Q.linear_band_lines_from_quanta(recs, [H.record_state(r) for r in recs])
    want = JQ.linear_band_lines_from_quanta(jrecs, [JH.record_state(r) for r in jrecs])
    _same_lines(got[0], want[0])
    assert got[1:] == want[1:] == (1.0, 1.0) and len(got[0]) == 6


def test_catalog_helpers_match_jax():
    """Cutoff and SpeciesMeta; concat_catalogs across perturber counts;
    hitran_s and keep_strongest at the 50th and 90th percentiles."""
    assert [(c.name, int(c)) for c in C.Cutoff] == [(c.name, int(c)) for c in JC.Cutoff]
    meta = dict(species=("H2O", "O2"), isotopologues=((0, "H2O-161", 18.0, 0.997),
                                                       (1, "O2-66", 32.0, 0.995)))
    assert (C.SpeciesMeta(**meta).n_species, C.SpeciesMeta(**meta).n_iso) == (
        JC.SpeciesMeta(**meta).n_species, JC.SpeciesMeta(**meta).n_iso) == (2, 2)
    lines = H.read_par(mixed_rows(), SPECIES, cutoff=25e9)
    one = [dict(ln, ls={"bath": ln["ls"]["bath"]}) for ln in lines[:5]]
    cats = [C.build_catalog(lines, **CPU64), C.build_catalog(one, **CPU64)]
    jcats = [JC.build_catalog(lines), JC.build_catalog(one)]
    assert [c.n_perturbers for c in cats] == [2, 1]
    _same_catalog(C.concat_catalogs(cats), JC.concat_catalogs(jcats))
    q = np.linspace(150.0, 250.0, len(lines))
    np.testing.assert_allclose(C.hitran_s(cats[0], q), JC.hitran_s(jcats[0], q), rtol=1e-14)
    for pct in (50.0, 90.0):
        _same_catalog(C.keep_strongest(cats[0], q, pct), JC.keep_strongest(jcats[0], q, pct))


def test_species_registry_matches_jax():
    """split_tag, and register_isotopologue adding a tag that read_par then
    accepts (both registries restored afterwards)."""
    for tag in ("H2O-161", "H2O", "CO2-626", "O2-66"):
        assert SP.split_tag(tag) == JSP.split_tag(tag)
    try:
        for reg in (SP, JSP):
            reg.register_isotopologue("O2-99", "O2", 36.0, 1e-6)
        assert SP.ISOTOPOLOGUES["O2-99"].mass == JSP.ISOTOPOLOGUES["O2-99"].mass == 36.0
        assert SP.ISOTOPOLOGUES["O2-99"].species == "O2"
    finally:
        for reg in (SP, JSP):
            reg.ISOTOPOLOGUES.pop("O2-99", None)


def test_partfun_polynomial_form_matches_jax():
    """PartFunTable's polynomial coefficients (Horner in T) against the JAX
    package's at scalar and batched temperatures, one isotopologue and an
    index list; the table form wins when both are given."""
    coeffs = np.array([[-1.5, 0.73, 1.2e-3, -2e-7], [3.0, 1.1, 5e-4, 0.0]])
    got = PartFunTable(coeffs=torch.tensor(coeffs))
    want = JPartFunTable(coeffs=jnp.asarray(coeffs))
    T = np.array([[150.0, 220.5], [296.0, 310.0]])
    for idx in (0, 1):
        np.testing.assert_allclose(got.Q(torch.tensor(T), idx).numpy(),
                                   np.asarray(want.Q(jnp.asarray(T), idx)), rtol=1e-14)
    both = got.Q(torch.tensor(T), torch.tensor([1, 0, 1]))
    assert both.shape == (2, 2, 3)
    np.testing.assert_allclose(both[..., 0].numpy(), np.asarray(want.Q(jnp.asarray(T), 1)),
                               rtol=1e-14)
    assert float(got.Q(torch.tensor(296.0, dtype=torch.float64), 0)) == pytest.approx(
        float(want.Q(296.0, 0)), rel=1e-14)
    table = dataclasses.replace(got, t_grid=torch.tensor([100.0, 400.0], dtype=torch.float64),
                                q_grid=torch.tensor([[1.0, 4.0], [2.0, 8.0]], dtype=torch.float64))
    assert float(table.Q(torch.tensor(250.0, dtype=torch.float64), 0)) == pytest.approx(2.5)
