"""The port's engine tools against the reference's, on the CPU:

- a build at ``dtype="float64"`` equals the reference's leaf for leaf (the
  reference never enables 64-bit JAX, so both are float32), with one
  warning naming the dtype;
- ``testsystems.generate_example`` (``chemlab-genmelt``) at 40 trimers
  writes the reference's ``topol.top`` and ``atrp.cfg`` byte for byte and
  a ``conf.gro`` with the reference melt's atoms, names and box;
- ``engine.tuning.tune_skin`` times every candidate and picks one;
- ``nve_drift.drift_fit`` equals ``scripts/nve_drift.py``'s on fixed
  records, and ``run_leg``'s row leg on the 40-trimer tabulated melt gives
  the reference's Etot block by block from one state carried across;
- the two NVE legs start from one particle state, each with its own
  neighbour state, and their step-0 potential energies differ only in the
  pair energy, within the reference's K1c-vs-row tolerance.

The reference runs its row path (plain XLA), compiled.
"""

import importlib.util
import types
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu_torch import bridge, nve_drift
from chemlab_tpu_torch import files_io as pfio
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, runner, tuning
from test_torch_bonded_tab import reference_trees
from test_torch_ext_builds import assert_builds_equal
from test_torch_tab import _assert_bit_equal

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_melt64():
    """The reference's 40-trimer melt at density 0.3 built at float64, on
    the cell kernels as the port builds it (the reference's default takes
    its row path on a CPU backend)."""
    with pytest.warns(UserWarning, match="float64"):
        return rts.build_melt(40, density=0.3, dtype="float64",
                              use_pallas=True)


def test_float64_build_equals_reference_leaf_for_leaf(ref_melt64):
    rb, _, _ = ref_melt64
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pb, _, _ = pts.build_melt(40, density=0.3, dtype="float64",
                                  device="cpu")
    assert [str(w.message) for w in caught if w.category is UserWarning] \
        == ["dtype float64 is not available: the state is float32, as in "
            "the reference"]
    for leaf in (pb.state.pos, pb.state.vel, pb.state.force, pb.state.mass):
        assert leaf.dtype == torch.float32
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p32, _, _ = pts.build_melt(40, density=0.3, device="cpu")
    _assert_bit_equal(bridge.tree_to_numpy(p32.state),
                      bridge.tree_to_numpy(pb.state))


def test_generate_example_writes_the_reference_files(tmp_path, ref_melt64):
    """At 40 trimers on the CPU (a short equilibration)."""
    rb, rsystop, rcoords = ref_melt64
    out = tmp_path / "melt"
    assert pts.generate_example(str(out), n_mols=40, density=0.3, seed=42,
                                equilibrate=20, device="cpu") == str(out)
    assert (out / "topol.top").read_text() == rts._melt_topology_text(40)
    assert (out / "atrp.cfg").read_text() == rts.ATRP_CFG_TEXT
    conf = pfio.read_gro(str(out / "conf.gro"))
    n = rsystop.n_atoms
    assert conf.n_atoms == n == 120
    names = [rsystop.atomtype_atomsym[int(t)]
             for t in np.asarray(rb.state.type_id)[:n]]
    assert conf.atom_names == names
    np.testing.assert_allclose(conf.box, rcoords.box, rtol=0, atol=5e-6)
    assert np.isfinite(conf.pos).all() and np.isfinite(conf.vel).all()
    assert ((conf.pos >= 0) & (conf.pos <= conf.box + 1e-3)).all()


def test_genmelt_cli_passes_its_flags(tmp_path, monkeypatch, capsys):
    """``python -m chemlab_tpu_torch.testsystems out_dir [--n_mols ...]``
    takes the reference CLI's flags and defaults."""
    calls = []
    monkeypatch.setattr(pts, "generate_example",
                        lambda *a, **kw: calls.append((a, kw)))
    assert pts._main([str(tmp_path), "--n_mols", "40", "--kT", "1.5"],
                     device="cpu") == 0
    assert pts._main([str(tmp_path)]) == 0
    assert calls == [((str(tmp_path), 40, 0.27, 1.5, 11), {"device": "cpu"}),
                     ((str(tmp_path), 2000, 0.27, 1.0, 11),
                      {"device": "cuda"})]
    assert capsys.readouterr().out == "wrote %s\n" % tmp_path * 2


def test_tune_skin_times_every_candidate(capsys):
    pb, systop, coords = pts.build_melt(40, density=0.3, reactive=False,
                                        device="cpu")
    opts = build.SimOptions(**pts.melt_options())
    best, results = tuning.tune_skin(systop, coords, opts,
                                     candidates=(0.3, 0.45), block_steps=4,
                                     device="cpu")
    assert sorted(results) == [0.3, 0.45] and best in results
    assert all(np.isfinite(v) and v > 0 for v in results.values())
    assert results[best] == max(results.values())
    printed = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in printed] == ["skin 0.30", "skin 0.45"]


def _script():
    spec = importlib.util.spec_from_file_location(
        "nve_drift_script", REPO / "scripts" / "nve_drift.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_recs", [2, 7, 40])
def test_drift_fit_matches_script(n_recs):
    rng = np.random.RandomState(n_recs)
    recs = [{"step": 200 * (k + 1),
             "etot": 1234.5 + 0.01 * k + rng.normal(scale=0.3)}
            for k in range(n_recs)]
    ref = _script().drift_fit(recs, 3000, kT=1.2)
    got = nve_drift.drift_fit(recs, 3000, kT=1.2)
    assert list(got) == list(ref)
    for k in ref:
        assert got[k] == ref[k] and type(got[k]) is type(ref[k]), k


@pytest.fixture(scope="module")
def tab_row(tmp_path_factory):
    """The 40-trimer tabulated melt on the row path, NVE, after a short
    descent on the port."""
    d = str(tmp_path_factory.mktemp("nve_tab"))
    pts.write_lj_pair_tables(d)
    pb, _, _ = pts.build_tabulated_melt(n_mols=40, reactive=False,
                                        use_pallas=False, thermostat="no",
                                        table_dir=d, device="cpu")
    assert not pb.cfg.use_pallas and pb.cfg.has_tabulated
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    return pb, pts.warmup(pb, st, steps=30)


def test_run_leg_row_leg_matches_reference(tab_row, capsys):
    """Two NVE blocks of 10 steps from one state, carried to the reference
    with the bridge: Etot per block within 1e-5 relative."""
    pb, st = tab_row
    rcfg, rspec, rst = reference_trees(pb.cfg, pb.spec, st)
    ref = _script().run_leg(types.SimpleNamespace(spec=rspec, cfg=rcfg),
                            rst, 20, 10, "nve_row")
    got = nve_drift.run_leg(pb, st, 20, 10, "nve_row")
    assert [r["step"] for r in got] == [r["step"] for r in ref] == [10, 20]
    for g, r in zip(got, ref):
        assert abs(g["etot"] - r["etot"]) <= 1e-5 * abs(r["etot"]), (g, r)
        assert not g["overflow"] and g["n_bonds"] == r["n_bonds"]
        assert g["P"] is None and g["events"] == 0
    assert '"leg": "nve_row", "wall_s"' in capsys.readouterr().out


def test_nve_legs_start_from_one_state():
    """The 70-trimer NVE pair: the kernel build (K1c) and the row build;
    each leg gets the row build's warmed particles with its own neighbour
    state and forces; the step-0 potential energies differ only in the
    pair energy, within the reference's K1c-vs-row tolerance
    (``test_tab_cheb.py``: 5e-3 of the pair energy)."""
    built_k, built_x = nve_drift.nve_builds(70, "cpu")
    assert built_k.cfg.tab_cheb and built_k.cfg.use_pallas
    assert not built_x.cfg.use_pallas
    st0 = nve_drift.nve_start(built_x, warmup_steps=20, settle_steps=4)
    assert int(st0.step) == 4
    epot = {}
    for label, built in (("cheb", built_k), ("row", built_x)):
        st = nve_drift.leg_start(built, st0)
        for f in ("step", "pos", "vel", "image", "box"):
            assert torch.equal(getattr(st, f), getattr(st0, f)), f
        assert st.nbr.buckets.shape[0] \
            == int(np.prod(built.cfg.cell_dims)) + 1
        assert not bool(st.nbr.overflow)
        torch.testing.assert_close(
            st.force, runner.initial_forces(built.spec, built.cfg,
                                            st).force, rtol=0, atol=0)
        m = runner.measure(built.spec, built.cfg, st)
        epot[label] = (float(m["epot"]), float(m["lj-tab"]))
    (e_k, p_k), (e_x, p_x) = epot["cheb"], epot["row"]
    assert abs(e_k - e_x) <= 5e-3 * abs(p_x), epot
    assert abs((e_k - p_k) - (e_x - p_x)) <= 1e-5 * (1.0 + abs(e_x - p_x))
    assert abs(p_k - p_x) > 0.0         # two evaluations, not one
