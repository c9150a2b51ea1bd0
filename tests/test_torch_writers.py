"""Output writers: the port's ``writers`` against the reference's on the
same input (mirroring ``test_writers.py``): the H5MD connectivity series
that follows a capacity change, frames and parameters, the energy CSV,
``state_to_coordinates`` and ``write_topology`` from one state (the
reference's state, and the port's copy of it through the bridge)."""

import dataclasses

import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu import writers as rwriters
from chemlab_tpu_torch import bridge, writers

h5py = pytest.importorskip("h5py")


def _dump_series(mod, path):
    w = mod.H5MDWriter(path, n_particles=4, box=np.ones(3))
    w.dump_connectivity("chem_bonds_0", 0, 0.0,
                        np.array([[0, 1], [1, 2], [-1, -1]], np.int32))
    w.dump_connectivity("chem_bonds_0", 10, 0.1, np.array(
        [[0, 1], [1, 2], [2, 3], [-1, -1], [-1, -1]], np.int32))
    w.dump_connectivity("chem_bonds_0", 20, 0.2,
                        np.array([[0, 1], [1, 2]], np.int32))
    pos = np.arange(12, dtype=np.float32).reshape(4, 3)
    w.dump(0, 0.0, position=pos, image=np.zeros((4, 3), np.int32),
           species=np.arange(4), state=np.ones(4, np.int32))
    w.dump(5, 0.5, position=torch.from_numpy(pos + 1),
           image=torch.ones((4, 3), dtype=torch.int32),
           species=torch.arange(4), state=torch.zeros(4, dtype=torch.int32))
    w.write_parameters(None, force_field={"MA": {"mass": 1.0, "sigma": 1.0,
                                                 "epsilon": 1.0, "state": 1}})
    w.close()


def _walk(f):
    out = {}
    f.visititems(lambda name, obj: out.__setitem__(name, obj[...]) if
                 isinstance(obj, h5py.Dataset) else None)
    return out


def test_h5md_matches_the_reference(tmp_path):
    _dump_series(writers, str(tmp_path / "p.h5"))
    _dump_series(rwriters, str(tmp_path / "r.h5"))
    with h5py.File(tmp_path / "p.h5", "r") as fp, \
            h5py.File(tmp_path / "r.h5", "r") as fr:
        p, r = _walk(fp), _walk(fr)
        assert sorted(p) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(p[k], r[k], err_msg=k)
        assert dict(fp["h5md"].attrs)["version"].tolist() == [1, 1]
        assert fp["h5md/creator"].attrs["name"] == "chemlab_tpu_torch"
        v = p["connectivity/chem_bonds_0/value"]
    assert v.shape == (3, 5, 2)
    assert (v[0, 3:] == -1).all() and (v[2, 2:] == -1).all()


def test_h5md_writer_names_h5py_when_missing(monkeypatch, tmp_path):
    import sys

    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        writers.H5MDWriter(str(tmp_path / "x.h5"), 4, np.ones(3))


def test_energy_csv_matches(tmp_path):
    rows = [{"step": 0, "T": 1.0, "epot": -3.25}, {"step": 10, "T": 0.9,
                                                   "epot": -3.5}]
    for mod, name in ((writers, "a.csv"), (rwriters, "b.csv")):
        m = mod.SystemMonitorCSV(str(tmp_path / name))
        for r in rows:
            m.row(r)
        m.close()
    assert (tmp_path / "a.csv").read_text() == \
        (tmp_path / "b.csv").read_text()


@pytest.fixture(scope="module")
def melt():
    built, systop, coords = rts.build_melt(n_mols=40, reactive=True)
    st = dataclasses.replace(
        built.state, image=built.state.image.at[0].set(1))
    _, _, pst = bridge.from_trees(built.cfg, built.spec, st, "cpu")
    return systop, coords, st, pst


@pytest.mark.parametrize("unfolded", [False, True])
def test_state_to_coordinates_matches(melt, unfolded):
    systop, coords, st, pst = melt
    a = writers.state_to_coordinates(pst, systop, coords, unfolded=unfolded)
    b = rwriters.state_to_coordinates(st, systop, coords, unfolded=unfolded)
    assert a.atom_names == b.atom_names
    for f in ("pos", "vel", "box"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_write_topology_matches(melt, tmp_path):
    systop, _, st, pst = melt
    writers.write_topology(str(tmp_path / "a.top"), systop, pst)
    rwriters.write_topology(str(tmp_path / "b.top"), systop, st)
    a = (tmp_path / "a.top").read_text()
    b = (tmp_path / "b.top").read_text()
    assert a.replace("chemlab_tpu_torch", "chemlab_tpu") == b
    assert "[ bonds ]" in a
