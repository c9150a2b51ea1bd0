"""Coordinate and table I/O: the port's ``files_io`` (and ``tools``)
against the reference's on the same files, mirroring ``test_files_io.py``.
Readers must return equal records; writers must write identical bytes."""

import math
import os

import numpy as np
import pytest

from chemlab_tpu import files_io as rfio
from chemlab_tpu import tools as rtools
from chemlab_tpu_torch import files_io, tools


def _write_sample_gro(path, n=4, with_vel=True):
    lines = ["sample system", str(n)]
    for k in range(n):
        base = "%5d%-5s%5s%5d%8.3f%8.3f%8.3f" % (k // 2 + 1, "MOL", "A%d" % k,
                                                 k + 1, 0.1 * k, 0.2 * k,
                                                 0.3 * k)
        if with_vel:
            base += "%8.3f%8.3f%8.3f" % (0.01 * k, -0.01 * k, 0.5)
        lines.append(base)
    lines.append("5.0 6.0 7.0")
    path.write_text("\n".join(lines) + "\n")


def _same_coords(a, b):
    assert a.title == b.title
    assert a.atom_names == b.atom_names and a.res_names == b.res_names
    for f in ("atom_ids", "res_idx", "pos", "box"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert (a.vel is None) == (b.vel is None)
    if a.vel is not None:
        np.testing.assert_array_equal(a.vel, b.vel)


@pytest.mark.parametrize("with_vel", [True, False])
def test_gro_read_matches(tmp_path, with_vel):
    p = tmp_path / "conf.gro"
    _write_sample_gro(p, with_vel=with_vel)
    c = files_io.read_gro(str(p))
    _same_coords(c, rfio.read_gro(str(p)))
    assert c.n_atoms == 4 and c.title == "sample system"
    np.testing.assert_allclose(c.pos[2], [0.2, 0.4, 0.6])
    assert c.res_idx[3] == 2


def test_example_gro_read_matches():
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "atrp_melt", "conf.gro")
    c = files_io.read_coordinates(path)
    # both read a .gro through their host library first (no title), and
    # through the Python reader where it is absent
    _same_coords(c, rfio.read_coordinates(path))
    _same_coords(files_io.read_gro(path), rfio.read_gro(path))
    assert c.n_atoms == 6000 and c.vel is not None


def test_gro_write_matches(tmp_path):
    p = tmp_path / "conf.gro"
    _write_sample_gro(p)
    c = files_io.read_gro(str(p))
    files_io.write_gro(str(tmp_path / "a.gro"), c, backup=False)
    rfio.write_gro(str(tmp_path / "b.gro"), c, backup=False)
    assert (tmp_path / "a.gro").read_text() == \
        (tmp_path / "b.gro").read_text()
    c2 = files_io.read_gro(str(tmp_path / "a.gro"))
    np.testing.assert_allclose(c2.pos, c.pos, atol=1e-3)


def test_gro_append_trajectory_matches(tmp_path):
    p = tmp_path / "conf.gro"
    _write_sample_gro(p, with_vel=False)
    c = files_io.read_gro(str(p))
    shifted = files_io.read_gro(str(p))
    shifted.pos = shifted.pos + 0.1
    for mod, name in ((files_io, "a.gro"), (rfio, "b.gro")):
        mod.write_gro(str(tmp_path / name), c, backup=False)
        mod.write_gro(str(tmp_path / name), shifted, append=True)
    text = (tmp_path / "a.gro").read_text()
    assert text == (tmp_path / "b.gro").read_text()
    lines = text.splitlines()
    frame_len = c.n_atoms + 3
    assert len([ln for ln in lines if ln.strip()]) == 2 * frame_len
    second = tmp_path / "second.gro"
    second.write_text("\n".join(lines[frame_len:]) + "\n")
    np.testing.assert_allclose(files_io.read_gro(str(second)).pos,
                               c.pos + 0.1, atol=1e-3)


def test_pdb_roundtrip_matches(tmp_path):
    p = tmp_path / "conf.gro"
    _write_sample_gro(p, with_vel=False)
    c = files_io.read_gro(str(p))
    c.box = np.array([5.0, 5.0, 5.0])
    files_io.write_pdb(str(tmp_path / "a.pdb"), c, backup=False)
    rfio.write_pdb(str(tmp_path / "b.pdb"), c, backup=False)
    assert (tmp_path / "a.pdb").read_text() == \
        (tmp_path / "b.pdb").read_text()
    c2 = files_io.read_pdb(str(tmp_path / "a.pdb"))
    _same_coords(c2, rfio.read_pdb(str(tmp_path / "a.pdb")))
    assert list(c2.atom_ids) == list(c.atom_ids)
    np.testing.assert_allclose(c2.pos, c.pos, atol=1e-3)
    c3 = files_io.read_coordinates(str(tmp_path / "a.pdb"))
    np.testing.assert_allclose(c3.pos, c.pos, atol=1e-3)
    files_io.write_coordinates(str(tmp_path / "w.gro"), c, backup=False)
    files_io.write_coordinates(str(tmp_path / "w.pdb"), c, backup=False)
    with pytest.raises(ValueError, match="unsupported"):
        files_io.read_coordinates(str(tmp_path / "w.xyz"))


def test_prepare_path_backs_up(tmp_path):
    p = tmp_path / "f.txt"
    p.write_text("old")
    files_io.prepare_path(str(p))
    assert not p.exists()
    assert (tmp_path / "_f.txt.1_").read_text() == "old"


def test_read_tables_match(tmp_path):
    b = tmp_path / "table_b1.xvg"
    b.write_text("\n".join("%g %g %g" % (r, r * r, -2 * r)
                           for r in np.linspace(0.0, 1.0, 11)))
    a = tmp_path / "table_a1.xvg"
    a.write_text("\n".join("%g %g %g" % (d, 1.0, 2.0)
                           for d in np.linspace(1.0, 180.0, 10)))
    for path in (b, a):
        got, ref = files_io.read_table(str(path)), rfio.read_table(str(path))
        for g, r in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(g, r)
        assert got[3] == ref[3]
    r_, _, f_, kind = files_io.read_table(str(a))
    assert kind == "angle" and r_[-1] == pytest.approx(math.pi)
    assert f_[0] == pytest.approx(2.0 * 180.0 / math.pi)


def test_convert_table_matches(tmp_path):
    p = tmp_path / "table_b2.xvg"
    p.write_text("\n".join("%g %g %g" % (r, r, 1.0)
                           for r in np.linspace(0.1, 1.0, 10)))
    pot = files_io.convert_table(str(p))
    assert pot.endswith("table_b2.pot") and os.path.exists(pot)
    text = open(pot).read()
    os.remove(pot)
    assert rfio.convert_table(str(p)) == pot
    assert open(pot).read() == text
    assert len(files_io.read_table(pot)[0]) == 10


def test_criteria_any_semantics():
    c1 = tools.StopCriterion(kind="conversion", stop_value=0.5, obs_idx=0)
    c2 = tools.StopCriterion(kind="bond_count", stop_value=10,
                             type_pair=(1, 2))
    for conv, bonds in (([0.1], {(1, 2): 3}), ([0.6], {(1, 2): 3}),
                        ([0.1], {(1, 2): 12})):
        assert tools.criteria_reached([c1, c2], conv, bonds) == \
            rtools.criteria_reached([c1, c2], conv, bonds)
    assert not tools.criteria_reached([c1, c2], [0.1], {(1, 2): 3})
    assert tools.criteria_reached([c1, c2], [0.1], {(1, 2): 12})
