"""The port's host tools against the reference's, on inputs made from a
seed with numpy:

- ``table_tools``: convert, fix and mix (and their CLI) write the same
  bytes;
- ``lammps_io``: a data file and an input script read to equal fields;
- ``analysis``: every census and statistic of a small H5MD-shaped file
  (written with ``h5py``) and the CLI's output are equal;
- ``native``: ``parse_gro``, ``generate_exclusions`` and
  ``files_io.read_coordinates`` equal the reference's (they skip without
  ``g++``); a failed build raises with the compiler's output, and without
  ``g++`` the Python paths take over.
"""

import contextlib
import io
import shutil

import numpy as np
import pytest

from chemlab_tpu import analysis as ran
from chemlab_tpu import files_io as rfio
from chemlab_tpu import lammps_io as rlio
from chemlab_tpu import native as rnat
from chemlab_tpu import table_tools as rtt
from chemlab_tpu import topology as rtop
from chemlab_tpu_torch import analysis as pan
from chemlab_tpu_torch import files_io as pfio
from chemlab_tpu_torch import lammps_io as plio
from chemlab_tpu_torch import native as pnat
from chemlab_tpu_torch import table_tools as ptt
from chemlab_tpu_torch import topology as ptop

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the host library builds with g++")


# ---- table_tools -------------------------------------------------------------

def _write_xvg(path, kind, seed):
    rng = np.random.RandomState(seed)
    n = 60
    if kind == "nonbonded":
        r = np.linspace(0.0, 3.0, n)
        cols = [r] + [rng.normal(size=n) for _ in range(6)]
    else:
        r = (np.linspace(0.0, 180.0, n) if kind in ("angle", "dihedral")
             else np.linspace(0.5, 1.5, n))
        cols = [r, rng.normal(size=n), rng.normal(size=n)]
    with open(path, "w") as f:
        f.write("# generated\n@ title\n")
        for row in zip(*cols):
            f.write(" ".join("%.10g" % x for x in row) + "\n")


def _write_pot(path, seed, n=50, zero_ends=False):
    rng = np.random.RandomState(seed)
    r = 0.02 + 0.05 * np.arange(n)
    d = np.stack([r, rng.normal(size=n), rng.normal(size=n)], 1)
    if zero_ends:
        d[0, 2] = d[-1, 2] = 0.0
    np.savetxt(path, d)


@pytest.mark.parametrize("name,kw", [
    ("table_A_B.xvg", dict(c6=0.7, c12=1.3, sigma=0.9, epsilon=2.0)),
    ("table_b0.xvg", dict(sigma=1.1, epsilon=0.5)),
    ("table_a1.xvg", dict(sigma=1.1, epsilon=0.5)),
    ("table_d2.xvg", {}),
])
def test_convert_writes_the_reference_bytes(tmp_path, name, kw):
    src = tmp_path / name
    _write_xvg(src, pfio.table_kind_from_name(name), seed=len(name))
    ref = rtt.convert(str(src), str(tmp_path / "ref.pot"), **kw)
    got = ptt.convert(str(src), str(tmp_path / "port.pot"), **kw)
    assert open(ref, "rb").read() == open(got, "rb").read()
    with pytest.raises(ValueError, match="overwrite"):
        ptt.convert(str(src), str(src))


def test_fix_writes_the_reference_bytes(tmp_path):
    for who in ("ref", "port"):
        _write_pot(tmp_path / ("%s.pot" % who), seed=4, zero_ends=True)
    rtt.fix(str(tmp_path / "ref.pot"))
    ptt.fix(str(tmp_path / "port.pot"))
    data = (tmp_path / "port.pot").read_bytes()
    assert data == (tmp_path / "ref.pot").read_bytes()
    d = np.loadtxt(tmp_path / "port.pot")
    assert d[0, 2] == d[1, 2] and d[-1, 2] == d[-2, 2]


@pytest.mark.parametrize("mix_type,coupling,constant", [
    ("arithmetic", 0.3, 0.0), ("geometric", 0.65, 0.2)])
def test_mix_writes_the_reference_bytes(tmp_path, mix_type, coupling,
                                        constant):
    _write_pot(tmp_path / "t1.pot", seed=1)
    _write_pot(tmp_path / "t2.pot", seed=2, n=45)
    args = (str(tmp_path / "t1.pot"), str(tmp_path / "t2.pot"))
    rtt.mix(*args, str(tmp_path / "ref.pot"), coupling, mix_type, constant)
    ptt.mix(*args, str(tmp_path / "port.pot"), coupling, mix_type, constant)
    assert (tmp_path / "port.pot").read_bytes() \
        == (tmp_path / "ref.pot").read_bytes()
    _write_pot(tmp_path / "t3.pot", seed=3)
    np.savetxt(tmp_path / "t3.pot", np.loadtxt(tmp_path / "t3.pot") * 1.01)
    with pytest.raises(RuntimeError, match="r columns"):
        ptt.mix(args[0], str(tmp_path / "t3.pot"), str(tmp_path / "x.pot"))


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_table_cli_matches_reference(tmp_path):
    """``python -m chemlab_tpu_torch.table_tools`` convert / fix / mix."""
    _write_xvg(tmp_path / "table_X_Y.xvg", "nonbonded", seed=9)
    _write_pot(tmp_path / "t1.pot", seed=5, zero_ends=True)
    _write_pot(tmp_path / "t2.pot", seed=6)
    out = {}
    for who, main in (("ref", rtt.main), ("port", ptt.main)):
        d = tmp_path / who
        d.mkdir()
        shutil.copy(tmp_path / "t1.pot", d / "t1.pot")
        printed = [_cli(main, ["convert", str(tmp_path / "table_X_Y.xvg"),
                               str(d / "c.pot"), "--c6", "2", "--sigma",
                               "0.8"]),
                   _cli(main, ["fix", str(d / "t1.pot")]),
                   _cli(main, ["mix", str(d / "t1.pot"),
                               str(tmp_path / "t2.pot"), str(d / "m.pot"),
                               "--mix_type", "geometric", "--coupling",
                               "0.4"])]
        out[who] = ([p.replace(str(d), "") for p in printed],
                    [(d / n).read_bytes() for n in ("c.pot", "t1.pot",
                                                     "m.pot")])
    assert out["port"] == out["ref"]


# ---- lammps_io ---------------------------------------------------------------

def _write_lammps(tmp_path, seed=0):
    rng = np.random.RandomState(seed)
    n, nb = 12, 8
    lines = ["LAMMPS data file (generated)", "", "%d atoms" % n,
             "%d bonds" % nb, "3 atom types", "",
             "0.0 %.4f xlo xhi" % rng.uniform(20, 30),
             "-1.5 %.4f ylo yhi" % rng.uniform(20, 30),
             "0.5 %.4f zlo zhi   # comment" % rng.uniform(20, 30), "",
             "Masses", ""]
    lines += ["%d %.5f" % (t, rng.uniform(1, 20)) for t in (1, 2, 3)]
    lines += ["", "Pair Coeffs # lj/cut", ""]
    lines += ["%d %.4f %.4f" % (t, rng.uniform(0, 1), rng.uniform(1, 4))
              for t in (1, 2, 3)]
    lines += ["", "Atoms # full", ""]
    lines += ["%d %d %d %.4f %.5f %.5f %.5f" % (
        i, 1 + i // 4, rng.randint(1, 4), rng.normal(), *rng.uniform(0, 20, 3))
        for i in range(1, n + 1)]
    lines += ["", "Velocities", ""]
    lines += ["%d %.6f %.6f %.6f" % (i, *rng.normal(size=3))
              for i in range(1, n + 1)]
    lines += ["", "Bonds", ""]
    lines += ["%d %d %d %d" % (b, rng.randint(1, 3), b, b + 1)
              for b in range(1, nb + 1)]
    lines += ["", "Angles", ""]
    lines += ["%d 1 %d %d %d" % (a, a, a + 1, a + 2) for a in range(1, 5)]
    lines += ["", "Dihedrals", ""]
    lines += ["%d 2 %d %d %d %d" % (a, a, a + 1, a + 2, a + 3)
              for a in range(1, 4)]
    lines += ["", "Impropers", ""]
    lines += ["1 1 1 2 3 4"]
    lines += ["", "Bond Coeffs", "", "1 300.0 1.5", "2 250.0 1.4"]
    (tmp_path / "sys.data").write_text("\n".join(lines) + "\n")
    (tmp_path / "sys.in").write_text("\n".join([
        "# input script", "units real", "atom_style full",
        "pair_style lj/cut/coul/long 10.0", "bond_style harmonic",
        "read_data sys.data", "pair_coeff 1 1 0.1 3.5",
        "pair_coeff * * 0.2 3.0  # wildcard", "bond_coeff 1 320.0 1.53",
        "angle_style harmonic", "angle_coeff 1 50.0 109.5", "run 100"]) + "\n")


def _same(a, b, path="."):
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=repr) \
            == sorted(b, key=repr), path
        for k in a:
            _same(a[k], b[k], path + "/" + repr(k))
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


@pytest.mark.parametrize("what", ["data_lj", "data_real_atomic", "input"])
def test_lammps_readers_match_reference(tmp_path, what):
    _write_lammps(tmp_path)
    if what == "data_lj":
        ref = rlio.read_data_file(str(tmp_path / "sys.data"))
        got = plio.read_data_file(str(tmp_path / "sys.data"))
    elif what == "data_real_atomic":
        # atomic style reads columns 1-4 of each Atoms line
        ref = rlio.read_data_file(str(tmp_path / "sys.data"), units="real",
                                  atom_style="atomic")
        got = plio.read_data_file(str(tmp_path / "sys.data"), units="real",
                                  atom_style="atomic")
    else:
        ref = rlio.read_input_file(str(tmp_path / "sys.in"))
        got = plio.read_input_file(str(tmp_path / "sys.in"))
        assert got.units == "real" and got.styles["pair"]
    assert got.n_atoms == ref.n_atoms == 12
    for f in ("units", "scale", "box", "masses", "atoms", "velocities",
              "bonds", "angles", "dihedrals", "impropers", "styles",
              "coeffs"):
        _same(getattr(ref, f), getattr(got, f), f)


# ---- analysis ----------------------------------------------------------------

@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """A small H5MD-shaped trajectory: species and state series, two pair
    connectivity lists and an angle list, -1 padded."""
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    path = tmp_path_factory.mktemp("h5md") / "trj.h5"
    n, frames = 40, 5
    with h5py.File(path, "w") as f:
        for name, hi in (("species", 5), ("state", 4)):
            g = f.create_group("particles/atoms/%s" % name)
            g["step"] = np.arange(frames) * 200
            g["value"] = rng.randint(0, hi, (frames, n)).astype(np.int32)
        for name, cap, width in (("chem_bonds_0", 30, 2), ("bonds_0", 25, 2),
                                 ("angles_0", 10, 3)):
            vals = np.full((frames, cap, width), -1, np.int32)
            for t in range(frames):
                k = rng.randint(cap // 3, cap)
                vals[t, :k] = rng.randint(0, n, (k, width))
            g = f.create_group("connectivity/%s" % name)
            g["step"] = np.arange(frames) * 200
            g["value"] = vals
    return path


def test_analysis_library_matches_reference(trajectory):
    import h5py

    with h5py.File(trajectory, "r") as f:
        for fn, args in (("load_species_series", ()),
                         ("species_census", ()), ("state_census", ()),
                         ("bond_count_series", ()),
                         ("bond_count_series", ("bonds_0",)),
                         ("molecule_statistics", ()),
                         ("molecule_statistics", (2, ["bonds_0"]))
                         , ("branching_census", ()),
                         ("branching_census", (1,))):
            ref = getattr(ran, fn)(f, *args)
            got = getattr(pan, fn)(f, *args)
            _same_results(ref, got, fn)
        # any mapping of arrays laid out as H5MD
        d = {"connectivity": {k: {"value": np.asarray(
            f["connectivity"][k]["value"])} for k in f["connectivity"]}}
        _same_results(ran.molecule_statistics(f),
                      pan.molecule_statistics(d), "dict")
    stats = pan.molecule_statistics(d)
    assert stats["n_molecules"] > 0 and stats["DPw"] >= stats["DPn"] >= 1.0


def _same_results(ref, got, path):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(ref) == len(got), path
        for k, (a, b) in enumerate(zip(ref, got)):
            _same_results(a, b, "%s[%d]" % (path, k))
    elif isinstance(ref, dict):
        assert list(ref) == list(got), path
        for k in ref:
            _same_results(ref[k], got[k], "%s/%r" % (path, k))
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ref, got, err_msg=path)
        assert ref.dtype == got.dtype, path
    else:
        assert type(ref) is type(got) and ref == got, (path, ref, got)


@pytest.mark.parametrize("what", ["species", "state", "bonds", "molecules",
                                  "branching"])
def test_analysis_cli_matches_reference(trajectory, what):
    argv = [str(trajectory), "--what", what, "--frame", "3"]
    assert _cli(pan.main, argv) == _cli(ran.main, argv)


# ---- native ------------------------------------------------------------------

CONF = "examples/atrp_melt/conf.gro"


def _coords_equal(a, b):
    for f in ("title", "atom_ids", "res_idx", "res_names", "atom_names",
              "pos", "vel", "box"):
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@needs_gxx
def test_parse_gro_and_read_coordinates_match_reference(repo_root):
    path = str(repo_root / CONF)
    assert pnat.available()
    text = open(path, "rb").read()
    ref, got = rnat.parse_gro(text), pnat.parse_gro(text)
    assert ref is not None and got["n_atoms"] == ref["n_atoms"] == 6000
    for k in ref:
        _same(ref[k], got[k], k)
    _coords_equal(rfio.read_gro_native(path), pfio.read_gro_native(path))
    _coords_equal(rfio.read_coordinates(path), pfio.read_coordinates(path))
    # the native read holds the Python reader's fields (title aside)
    slow = pfio.read_gro(path)
    fast = pfio.read_coordinates(path)
    assert fast.title == "" and slow.title == "generated melt"
    fast.title = slow.title
    _coords_equal(slow, fast)
    # a truncated count line is declined, not misread
    assert pnat.parse_gro(b"title\n") is None


@needs_gxx
@pytest.mark.parametrize("nrexcl", [0, 1, 3])
def test_generate_exclusions_matches_reference(nrexcl):
    rng = np.random.RandomState(nrexcl)
    n = 60
    bonds = [(i, i + 1) for i in range(1, n)]
    bonds += [tuple(int(x) for x in rng.choice(np.arange(1, n + 1), 2,
                                                replace=False))
              for _ in range(15)]
    ref = rnat.generate_exclusions(bonds, nrexcl)
    got = pnat.generate_exclusions(bonds, nrexcl)
    assert got == ref and len(got) >= n - 1
    assert ptop.generate_exclusions(bonds, nrexcl) \
        == rtop.generate_exclusions(bonds, nrexcl) == ref


@needs_gxx
def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "chemlab_host.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(pnat, "SOURCE", bad)
    monkeypatch.setattr(pnat, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        pnat.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_without_gxx_the_python_paths_run(tmp_path, monkeypatch, repo_root):
    monkeypatch.setattr(pnat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnat.shutil, "which", lambda name: None)
    monkeypatch.setattr(pnat, "_TRIED", False)
    monkeypatch.setattr(pnat, "_LIB", None)
    assert not pnat.available()
    assert pnat.parse_gro(b"t\n1\n") is None
    assert pnat.generate_exclusions([(1, 2)], 3) is None
    path = str(repo_root / CONF)
    got = pfio.read_coordinates(path)
    assert got.title == "generated melt" and got.n_atoms == 6000
    assert ptop.generate_exclusions([(1, 2), (2, 3)], 1) == {(1, 2), (2, 3)}


@pytest.fixture
def repo_root():
    from pathlib import Path

    return Path(__file__).resolve().parent.parent
