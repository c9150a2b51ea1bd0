"""The plain reference against the port's plain path (the kernels'
plain PyTorch versions on the CPU) at the 70-trimer melt: the start
topology, the forces, one Langevin step and a reaction step.  The
tabulated pair path (K1c in the program) is checked on the same melt with
a func-8 table on every type pair (``TABLE_PAIR``), which no cell runs
yet."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import ROOT
from portbench import check
from portbench.reference import forces as ref_forces
from portbench.reference import reactions as ref_rx
from portbench.reference import system as ref_system


# the trimer melt's pairs as func-8 tables: LJ epsilon 0.25, sigma 1,
# sampled every 0.002 sigma to 3 sigma, written into the test's directory
TABLE_PAIR = {"kind": "table", "cutoff": 2.5,
              "table": {"epsilon": 0.25, "sigma": 1.0, "dr": 0.002,
                        "r_max": 3.0}}


def _melt(config, tmp_path, n_mols=70, tabulated=False):
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import runner

    conf = json.loads((ROOT / "portbench" / "configs"
                       / (config + ".json")).read_text())
    if tabulated:
        conf["builder"] = "build_tabulated_melt"
        conf["system"]["pair"] = TABLE_PAIR
    sys_ = ref_system.load_system(conf["system"])
    kw = dict(conf["args"], n_mols=n_mols, device="cpu")
    tables = None
    if sys_.pair["kind"] == "table":
        ref_system.write_tables(str(tmp_path), sys_.types,
                                sys_.pair["table"])
        tables = ref_system.read_tables(str(tmp_path), sys_.types)
        kw["table_dir"] = str(tmp_path)
    built, systop, _ = getattr(testsystems, conf["builder"])(**kw)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=60)
    return sys_, built, systop, st, tables


@pytest.mark.parametrize("tabulated,tol", [(False, 1e-4), (True, 2e-3)])
def test_forces_match_the_port(tabulated, tol, tmp_path):
    from chemlab_tpu_torch.engine import integrate

    sys_, built, _, st, tables = _melt("atrp-lj-400k", tmp_path,
                                       tabulated=tabulated)
    n = check.active_count(st)
    snap = check.snapshot_topology(st)
    f_port, _, _ = integrate.compute_forces(built.spec, built.cfg, st)
    f_ref = ref_forces.forces(
        sys_, st.pos[:n], st.box, st.type_id[:n], snap["topo"].bonds,
        snap["topo"].angles, snap["topo"].excl, torch.float64, tables)
    gap = (f_port[:n].double() - f_ref).norm(dim=1).max()
    rms = f_ref.norm(dim=1).pow(2).mean().sqrt()
    assert float(gap / rms) < tol
    # the start: the reference's own topology is the port's
    assert check.start_mismatch(sys_, 70, check.snapshot_topology(
        built.state)) == 0


@pytest.mark.parametrize("side", [-0.5, 0.5])
def test_a_pair_at_the_cutoff_is_left_to_rounding(side):
    # r^2 half a band inside or outside the cutoff's: the pair is summed
    # by neither side of the split and returned apart, with its force
    rc, band = 2.5, 1e-4
    r = (rc * rc + side * band) ** 0.5
    pos = torch.tensor([[1.0, 1.0, 1.0], [1.0 + r, 1.0, 1.0]],
                       dtype=torch.float64)
    box = torch.tensor([20.0, 20.0, 20.0], dtype=torch.float64)
    pair = {"kind": "lj", "sigma": 1.0, "epsilon": 1.0, "cutoff": rc,
            "core": 0.75}
    excl = np.zeros((0, 2), dtype=np.int64)
    f, rows, amb = ref_forces.pair_forces(pos, box, torch.tensor([0, 0]),
                                          excl, pair, torch.float64,
                                          band=band)
    assert torch.all(f == 0) and sorted(rows.tolist()) == [0, 1]
    assert amb[rows == 0][0, 0] == pytest.approx(0.039, rel=0.02)
    # without the band the float64 r^2 decides
    f = ref_forces.pair_forces(pos, box, torch.tensor([0, 0]), excl, pair,
                               torch.float64)
    assert bool(torch.any(f != 0)) == (side < 0)


def test_one_step_matches_the_port(tmp_path):
    from chemlab_tpu_torch.engine import runner

    sys_, built, _, st, tables = _melt("atrp-lj-400k", tmp_path)
    n = check.active_count(st)
    noise = torch.randn(st.pos.shape, generator=torch.Generator().manual_seed(3))
    gates = {"reaction": False, "atrp": False, "cpt": False}
    s1 = runner.step_with_extensions(built.spec, built.cfg, st, 0,
                                     gates=gates, noise=noise)
    topo = check.snapshot_topology(st)["topo"]
    a = [check._np(t)[:n] for t in (st.pos, st.vel, st.force, st.mass,
                                     noise, s1.pos, s1.vel, s1.force)]
    fg, dg, vg = check.step_gaps(sys_, *a[:4], check._np(st.box), a[4],
                                 *a[5:], topo.type_id, topo.bonds,
                                 topo.angles, topo.excl, tables, "cpu")
    assert fg < 1e-4 and dg < 1e-3 and vg < 1e-5
    # a step that leaves the state as it was is caught
    fg, dg, vg = check.step_gaps(sys_, *a[:4], check._np(st.box), a[4],
                                 a[0], a[1], a[2], topo.type_id, topo.bonds,
                                 topo.angles, topo.excl, tables, "cpu")
    assert dg > 0.5


def test_reaction_step_matches_the_port(tmp_path):
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import runner

    sys_, built, systop, st, _ = _melt("atrp-lj-400k", tmp_path, 200)
    st = testsystems.activate_initiators(built, systop, st, n=60, seed=5)
    st = dataclasses.replace(st, step=torch.full_like(st.step, 200))
    pre = check.snapshot_topology(st)
    post_state = runner._fire_reactions(built.spec, built.cfg, st, 12345)
    post = check.snapshot_topology(post_state)
    bad, want = check.reaction_mismatch(
        sys_, pre, post, check._np(st.pos)[:600], check._np(st.box), 200,
        12345, ref_system.start_topology(sys_, 200).res)
    assert len(want["events"]) > 0 and bad == 0
    # an event's product type altered where the step writes it is caught
    tid = post_state.type_id.clone()
    tid[want["events"][0][1]] = 5
    post2 = check.snapshot_topology(dataclasses.replace(post_state,
                                                        type_id=tid))
    bad2, _ = check.reaction_mismatch(
        sys_, pre, post2, check._np(st.pos)[:600], check._np(st.box), 200,
        12345, ref_system.start_topology(sys_, 200).res)
    assert bad2 > 0


def test_pair_uniform_is_the_systems_hash():
    from chemlab_tpu_torch.engine import reactions

    lo = np.array([0, 5, 70000, 2**31 - 1])
    hi = np.array([1, 9, 99999, 2**31])
    got = ref_rx.pair_uniform(2**32 + 17, 4000, lo, hi, np.array([2, 3, 4, 5]))
    want = reactions.pair_uniform(2**32 + 17, torch.tensor(4000),
                                  torch.from_numpy(lo), torch.from_numpy(hi),
                                  torch.tensor([2, 3, 4, 5]))
    assert np.array_equal(got, want.numpy())
