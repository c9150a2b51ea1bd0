"""The CLI: the port's ``start_simulation.main`` against the reference's on
the same input files.

The inputs are the 70-trimer melt (warmed by the port, written as a .gro
with 3 decimals), its .top, an ``atrp.cfg`` with ``interval: 10`` and a
``hooks.py`` that activates 20 initiators as ``examples/atrp_melt``'s does.
Both CLIs run ``--thermostat no --run 40 --int_step 20 --start_ar 0
--energy_collect 10 --rng_seed 7 --timers False --node_grid 1,1,1`` (NVE:
the reference's threefry noise cannot be matched) in their own directory;
the reference needs ``--node_grid 1,1,1`` or it shards over conftest's 8
virtual devices.  With the CLI's default Coulomb cutoff the reference
runs its row path and the port the cell kernel K1 (every charge is zero).
Tolerances: the energy-CSV rows relative 1e-4 (f32 sums, printed with 6
digits); reaction counters and the bonds of ``_topol.top`` exactly;
``_confout.gro`` positions within 2e-3 (the file holds 3 decimals; the
run's positions agree to ~1e-5 at 40 steps); the H5MD ``species`` and
``state`` exactly, ``position`` within 1e-4.
"""

import os
import sys

import numpy as np
import pytest
import torch

from chemlab_tpu import files_io as rfio
from chemlab_tpu import start_simulation as rsim
from chemlab_tpu_torch import files_io, start_simulation, testsystems, writers

h5py = pytest.importorskip("h5py")

_ESPP = ("espressopp", "espressopp.analysis")


@pytest.fixture(autouse=True)
def _own_espp_shim():
    """Each package's hook path registers its own ``espressopp`` stand-in in
    ``sys.modules`` and keeps one it finds there: each test here starts
    without one and leaves the entries as it found them, so that no test
    hands one package's stand-in to the other's on the same worker."""
    saved = {k: sys.modules.pop(k, None) for k in _ESPP}
    yield
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


HOOKS = '''"""Activate 20 random MA monomers as FA radicals when reactions start."""
import numpy as np


def hook_init_reaction(ctx):
    rng = np.random.RandomState(ctx.args.rng_seed)
    tid = np.asarray(ctx.state.type_id)
    active = np.asarray(ctx.state.active)
    rows = np.where((tid == ctx.type_id_of("MA")) & active)[0]
    for r in rng.choice(rows, 20, replace=False):
        ctx.modify_particle(int(r) + 1, type=ctx.type_id_of("FA"), state=3)
    print("hook: activated 20 initiators")
    return True
'''

PARAMS = """conf=conf.gro
top=topol.top
reactions=atrp.cfg
dt=0.0025
temperature=1.0
kb=1.0
mass_factor=1.0
thermostat_gamma=1.0
lj_cutoff=2.5
cg_cutoff=2.5
skin=0.4
gen_velocity=True
trj_collect=20
topol_collect=20
output_file=trjout.h5
output_prefix=melt
maximum_conversion=PL(1):200:210
"""

FLAGS = ["@params", "--thermostat", "no", "--run", "40", "--int_step", "20",
         "--start_ar", "0", "--energy_collect", "10", "--rng_seed", "7",
         "--timers", "False", "--node_grid", "1,1,1"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_inputs(d):
    built, systop, coords = testsystems.build_melt(n_mols=70, reactive=False,
                                                   device="cpu")
    st = testsystems.warmup(built, built.state, steps=100)
    out = writers.state_to_coordinates(st, systop, coords)
    out.vel = None
    files_io.write_gro(str(d / "conf.gro"), out, backup=False)
    (d / "topol.top").write_text(testsystems._melt_topology_text(70))
    (d / "atrp.cfg").write_text(testsystems.ATRP_CFG_TEXT.replace(
        "interval: 200", "interval: 10"))
    (d / "hooks.py").write_text(HOOKS)
    (d / "params").write_text(PARAMS)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    inputs = base / "inputs"
    inputs.mkdir()
    _write_inputs(inputs)
    dirs = {}
    for side in ("ref", "port"):
        d = base / side
        d.mkdir()
        for f in inputs.iterdir():
            (d / f.name).write_bytes(f.read_bytes())
        dirs[side] = d
    cwd = os.getcwd()
    try:
        for side, main, kw in (("ref", rsim.main, {}),
                               ("port", start_simulation.main,
                                {"device": "cpu"})):
            os.chdir(dirs[side])
            assert main(FLAGS, **kw) == 0
    finally:
        os.chdir(cwd)
    return dirs


def _csv(path):
    lines = path.read_text().splitlines()
    head = lines[0].split(",")
    return head, np.array([[float(x) for x in ln.split(",")]
                           for ln in lines[1:]])


def test_energy_rows_match(runs):
    h_r, v_r = _csv(runs["ref"] / "melt_energy.csv")
    h_p, v_p = _csv(runs["port"] / "melt_energy.csv")
    assert h_p == h_r
    assert v_p.shape == v_r.shape == (4, len(h_r))
    assert np.isfinite(v_p).all()
    np.testing.assert_allclose(v_p, v_r, rtol=1e-4, atol=1e-6)


def test_reaction_counters_match(runs):
    ref = (runs["ref"] / "melt_reaction_counters.csv").read_text()
    got = (runs["port"] / "melt_reaction_counters.csv").read_text()
    assert got == ref
    events = sum(int(ln.rsplit(",", 1)[1]) for ln in ref.splitlines()[:2])
    assert events > 0
    for name in ("melt_reaction_counters_series.csv",):
        assert (runs["port"] / name).read_text() == \
            (runs["ref"] / name).read_text()


def _bonds(path):
    out, on = [], False
    for ln in path.read_text().splitlines():
        if ln.startswith("["):
            on = ln.strip() == "[ bonds ]"
            continue
        if on and ln.strip():
            out.append(ln)
    return out


def test_topology_bonds_match(runs):
    ref = _bonds(runs["ref"] / "melt_topol.top")
    got = _bonds(runs["port"] / "melt_topol.top")
    assert got == ref and len(ref) > 140


def test_confout_positions_match(runs):
    for name in ("melt_confout.gro", "melt_confout_unfolded.gro"):
        r = rfio.read_gro(str(runs["ref"] / name))
        p = rfio.read_gro(str(runs["port"] / name))
        assert p.n_atoms == r.n_atoms == 210
        assert p.atom_names == r.atom_names
        np.testing.assert_allclose(p.pos, r.pos, rtol=0, atol=2e-3)
        np.testing.assert_allclose(p.box, r.box, rtol=0, atol=1e-6)


def test_h5md_matches(runs):
    with h5py.File(runs["ref"] / "trjout.h5", "r") as fr, \
            h5py.File(runs["port"] / "trjout.h5", "r") as fp:
        for name in ("species", "state", "position", "image", "mass",
                     "res_id"):
            r = fr["particles/atoms/%s" % name]
            p = fp["particles/atoms/%s" % name]
            np.testing.assert_array_equal(p["step"][...], r["step"][...])
            if name == "position":
                np.testing.assert_allclose(p["value"][...], r["value"][...],
                                           rtol=0, atol=1e-4)
            else:
                np.testing.assert_array_equal(p["value"][...],
                                              r["value"][...], err_msg=name)
        for g in ("bonds_0", "chem_bonds_0"):
            np.testing.assert_array_equal(
                fp["connectivity/%s/value" % g][...],
                fr["connectivity/%s/value" % g][...], err_msg=g)
        assert sorted(fp["parameters"].attrs) == sorted(fr["parameters"].attrs)


def test_main_defaults_to_the_card():
    import inspect

    assert inspect.signature(start_simulation.main).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU (the smoke's cli phase covers "
                    "it)")
    with pytest.raises(RuntimeError, match="CUDA"):
        start_simulation.main(["--conf", "x.gro", "--top", "x.top"])


INPUTS = ("conf.gro", "topol.top", "atrp.cfg", "hooks.py", "params")


def test_node_grid_raises_naming_m14(runs, tmp_path, capsys, monkeypatch):
    """(Named for the refusal it replaced.)  ``--node_grid 1,1,3`` runs the
    port's CLI on 3 gloo ranks of the CPU, each holding the whole state
    and summing one x-slab of the 3x3x3 grid: the mesh line, then the
    files of rank 0 alone, against the one-rank run of ``runs``: the
    reaction counters and the topology's bonds exactly, ``_confout.gro``
    byte for byte (the positions are equal bit for bit), the energy rows
    to the file's tolerance above (the pair energy is a sum of 3 partial
    sums)."""
    from chemlab_tpu_torch.parallel import launch

    for name in INPUTS:
        (tmp_path / name).write_bytes((runs["port"] / name).read_bytes())
    calls = []
    run_jobs = launch.run_jobs

    def recorded(*a, **kw):
        calls.append((a, kw, run_jobs(*a, **kw)))
        return calls[-1][2]

    monkeypatch.setattr(launch, "run_jobs", recorded)
    monkeypatch.chdir(tmp_path)
    assert start_simulation.main(FLAGS[:-1] + ["1,1,3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert "Device mesh: 3 x cpu" in out and "finished" in out
    ((args, kw, (res,)),) = calls
    assert args[1] == 3 and kw["backend"] == "gloo" and kw["device"] == "cpu"
    assert [r["rc"] for r in res] == [0, 0, 0]
    assert {"melt_energy.csv", "melt_confout.gro", "melt_topol.top",
            "melt_reaction_counters.csv", "melt_params.out",
            "melt_benchmark.pck"} <= set(res[0]["writes"])
    assert res[1]["writes"] == res[2]["writes"] == []
    one, many = runs["port"], tmp_path
    for name in ("melt_reaction_counters.csv",
                 "melt_reaction_counters_series.csv", "melt_confout.gro",
                 "melt_confout_unfolded.gro"):
        assert (many / name).read_text() == (one / name).read_text(), name
    assert _bonds(many / "melt_topol.top") == _bonds(one / "melt_topol.top")
    h_1, v_1 = _csv(one / "melt_energy.csv")
    h_3, v_3 = _csv(many / "melt_energy.csv")
    assert h_3 == h_1
    np.testing.assert_allclose(v_3, v_1, rtol=1e-4, atol=1e-6)


def test_no_node_grid_starts_no_ranks(runs, tmp_path, monkeypatch):
    """Without ``--node_grid`` (or with a product of 1) the CLI runs in the
    calling process: no ranks are started (the reference instead spreads
    over every local device); ``device="cuda"`` asks for one card a rank
    and refuses more ranks than cards."""
    from chemlab_tpu_torch.parallel import launch

    def refuse(*a, **kw):
        raise AssertionError("ranks started")

    for name in INPUTS:
        (tmp_path / name).write_bytes((runs["port"] / name).read_bytes())
    monkeypatch.setattr(launch, "run_jobs", refuse)
    monkeypatch.chdir(tmp_path)
    flags = FLAGS[:4] + ["10"] + FLAGS[5:-2]
    assert "--node_grid" not in flags
    assert start_simulation.main(flags, device="cpu") == 0
    assert [start_simulation.node_grid_ranks(g)
            for g in (None, "1,1,1", "1,1,3", "2,2,2")] == [1, 1, 3, 8]
    with pytest.raises(ValueError, match="requested %d devices"
                       % (torch.cuda.device_count() + 1)):
        start_simulation.run_ranks(flags, "cuda",
                                   torch.cuda.device_count() + 1)


def test_checkpoint_retune_and_restore(runs, tmp_path, capsys):
    """The port's CLI writes ``_checkpoint.npz`` every 2 blocks, reports its
    ``--retune_caps`` decision, and ``--restore`` resumes at the saved
    step."""
    for name in ("conf.gro", "topol.top", "atrp.cfg", "hooks.py", "params"):
        (tmp_path / name).write_bytes((runs["port"] / name).read_bytes())
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert start_simulation.main(
            FLAGS + ["--checkpoint_interval", "2", "--retune_caps", "10"],
            device="cpu") == 0
        first = capsys.readouterr().out
        assert start_simulation.main(
            FLAGS + ["--restore", "melt_checkpoint.npz", "--run", "20"],
            device="cpu") == 0
        second = capsys.readouterr().out
    finally:
        os.chdir(cwd)
    assert [ln for ln in first.splitlines()
            if ln.startswith(("caps retuned at step 10", "caps kept at step "
                              "10"))]
    assert "Restored device state from melt_checkpoint.npz (step 40)" \
        in second
    steps = [ln.split(",")[0] for ln in
             (tmp_path / "melt_energy.csv").read_text().splitlines()[1:]]
    assert steps == ["40", "50"]


FREEZE_ATRP_EXT = """
[ext_freeze]
ext_type=FreezeRegion
target_type=ML
width=0.5
directions=-x,x
prob=1.0
remove_particles=True

[ext_atrp]
ext_type=ATRPActivator
interval=10
num_particles=50
select_from_all=0
ratio_activator=1.0
ratio_deactivator=0.5
delta_catalyst=0.001
k_activate=0.0
k_deactivate=0.0
options=FA(3,A)->FA(1);DA(2,A)->DA(1)

[group_reaction_1]"""


def test_freeze_and_atrp_stats_match(runs, tmp_path):
    """A FreezeRegion (removal with probability 1: no draw decides) and an
    ATRPActivator (rates 0: no draw flips anything) added to the cfg: both
    CLIs write ``melt_7_freeze_stats.dat`` and ``melt_atrp_stats.dat`` with
    the same lines, counts included."""
    text = (runs["port"] / "atrp.cfg").read_text().replace(
        "[group_reaction_1]", FREEZE_ATRP_EXT).replace(
        "extensions=change_neighbour_type",
        "extensions=change_neighbour_type,freeze,atrp")
    cwd = os.getcwd()
    out = {}
    try:
        for side, main, kw in (("ref", rsim.main, {}),
                               ("port", start_simulation.main,
                                {"device": "cpu"})):
            d = tmp_path / side
            d.mkdir()
            for name in ("conf.gro", "topol.top", "hooks.py", "params"):
                (d / name).write_bytes((runs[side] / name).read_bytes())
            (d / "atrp.cfg").write_text(text)
            os.chdir(d)
            assert main(FLAGS[:4] + ["20"] + FLAGS[5:], **kw) == 0
            out[side] = [(d / f).read_text().splitlines() for f in
                         ("melt_7_freeze_stats.dat", "melt_atrp_stats.dat")]
    finally:
        os.chdir(cwd)
    assert out["port"] == out["ref"]
    freeze, atrp = out["port"]
    assert freeze[0] == "# step frozen_total" and int(
        freeze[-1].split()[1]) > 0
    assert atrp == ["activated 0", "deactivated 0", "ratio_activator 1",
                    "ratio_deactivator 0.5"]
