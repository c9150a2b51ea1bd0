"""Capacity management (M7): the port's ``build`` cap functions against the
reference's on one state, and the reference's cap tests mirrored on the
port.

The compared state is the reference's 70-trimer reactive melt (3x3x3
cells, cap 24) as built, with 20 initiators on and reaction rates raised
40-fold; the port gets it through ``bridge.from_trees``.  Both packages'
functions run on their own copy; the new caps must be equal and every leaf
of the resulting state equal too (the neighbor rows, the re-padded tables,
the re-derived dense operands), since both do the same integer work on
equal positions.  Runs through a cap change use the port only, on the
port's own build of that melt, warmed by the port: they must equal, bit
for bit, the same run at the old caps (the reference's
``test_grow_term_caps_is_physics_inert`` and its siblings).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import build as rbuild
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, runner

INTERVAL = 10
STEPS = 30      # three reaction steps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reactive(pkg, built, systop, st):
    st = pkg.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    return dataclasses.replace(built.cfg, reaction_interval=INTERVAL), st


@pytest.fixture(scope="module")
def melt():
    """The reference's build and the port's copy of it (the cap functions
    move no particle, so the build's overlaps do not matter here)."""
    built, systop, _ = rts.build_melt(n_mols=70, reactive=True,
                                      use_pallas=True)
    rcfg, st = _reactive(rts, built, systop, built.state)
    cfg, spec, pst = bridge.from_trees(rcfg, built.spec, st, "cpu")
    return (rcfg, built.spec, st), (cfg, spec, pst)


@pytest.fixture(scope="module")
def warm():
    """The port's build of the melt, warmed by the port, for the runs."""
    built, systop, _ = pts.build_melt(n_mols=70, reactive=True,
                                      device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = pts.warmup(built, st, steps=50)
    cfg, st = _reactive(pts, built, systop, st)
    return cfg, built.spec, st


def _same_cfg(rcfg, cfg):
    assert bridge.config_to_dict(cfg) == bridge.config_to_dict(rcfg)


def _same_tree(ref, got, what="state"):
    r = bridge.tree_to_numpy(ref) if dataclasses.is_dataclass(ref) else ref
    g = bridge.tree_to_numpy(got) if dataclasses.is_dataclass(got) else got
    r = {k: v for k, v in r.items() if k != "key"}
    assert sorted(r) == sorted(g), what
    for k, v in r.items():
        if isinstance(v, dict):
            _same_tree(v, g[k], "%s.%s" % (what, k))
        elif v is None:
            assert g[k] is None, "%s.%s" % (what, k)
        else:
            np.testing.assert_array_equal(g[k], v, err_msg="%s.%s"
                                          % (what, k))
            assert g[k].dtype == v.dtype, "%s.%s" % (what, k)


def _counts(spec, cfg, st):
    mc = runner.measure_cheap(spec, cfg, st)
    keys = ["n_bonds", "n_angles", "n_dihedrals", "n_excl"]
    if "n_bonds_irr" in mc:
        keys += ["n_bonds_irr", "n_angles_irr"]
    c = {k: int(mc[k]) for k in keys}
    c["excl_pair_cap"] = st.excl.shape[0]
    return c


def _run(spec, cfg, st, steps=STEPS):
    return runner.run_block(spec, cfg, st, steps,
                            gen=runner.make_generator(5, "cpu"))


# ---- port against reference on one state --------------------------------

def test_grow_and_shrink_neighbor_caps_match(melt):
    (rcfg, rspec, rst), (cfg, spec, st) = melt
    rcfg_g, rst_g = rbuild.grow_neighbor_caps(rcfg, rspec, rst)
    cfg_g, st_g = build.grow_neighbor_caps(cfg, spec, st)
    _same_cfg(rcfg_g, cfg_g)
    assert cfg_g.cell_cap > cfg.cell_cap
    _same_tree(rst_g.nbr, st_g.nbr, "nbr")
    rcfg_s, rst_s = rbuild.shrink_neighbor_caps(rcfg_g, rspec, rst_g)
    cfg_s, st_s = build.shrink_neighbor_caps(cfg_g, spec, st_g)
    _same_cfg(rcfg_s, cfg_s)
    assert cfg_s.cell_cap < cfg_g.cell_cap
    assert cfg_s.cell_cap % 8 == 0
    _same_tree(rst_s.nbr, st_s.nbr, "nbr")


def test_apply_neighbor_caps_matches(melt):
    (rcfg, rspec, rst), (cfg, spec, st) = melt
    caps = {"cell_cap": 32, "max_neighbors": cfg.max_neighbors + 16}
    rcfg2, rst2 = rbuild.apply_neighbor_caps(rcfg, rspec, rst, caps)
    cfg2, st2 = build.apply_neighbor_caps(cfg, spec, st, caps)
    _same_cfg(rcfg2, cfg2)
    _same_tree(rst2.nbr, st2.nbr, "nbr")


@pytest.mark.parametrize("how", ["all", "counts", "shrink16", "shrink",
                                 "presize", "explicit_irr", "excl_only"])
def test_term_cap_changes_match(melt, how):
    """The term-cap functions on the same state and counts: equal caps and
    every leaf equal (tables, exclusions, derived operands, the flag)."""
    (rcfg, rspec, rst), (cfg, spec, st) = melt
    c = _counts(spec, cfg, st)
    prev = dict(c, n_bonds=c["n_bonds"] - 40, n_angles=c["n_angles"] - 80,
                n_excl=c["n_excl"] - 120, n_bonds_irr=c["n_bonds_irr"] - 40,
                n_angles_irr=c["n_angles_irr"] - 80)
    calls = {
        "all": lambda b, cf, s: b.grow_term_caps(cf, s),
        "counts": lambda b, cf, s: b.grow_term_caps(
            cf, s, counts=dict(c, n_angles=cf.angle_cap - 4),
            prev_counts=prev),
        "shrink16": lambda b, cf, s: b.shrink_term_caps(cf, s, headroom=16),
        "shrink": lambda b, cf, s: b.shrink_term_caps(cf, s),
        "presize": lambda b, cf, s: b.presize_term_caps(cf, s, c, prev, 200,
                                                        5000),
        "explicit_irr": lambda b, cf, s: b.apply_term_caps(
            cf, s, {"bond_cap": cf.bond_cap + 1024, "angle_cap":
                    cf.angle_cap + 2048, "bond_irr_cap": 256,
                    "angle_irr_cap": cf.angle_irr_cap + 128}, 4096),
        "excl_only": lambda b, cf, s: b.apply_term_caps(cf, s, {}, 2048),
    }
    rcfg2, rst2 = calls[how](rbuild, rcfg, rst)
    cfg2, st2 = calls[how](build, cfg, st)
    _same_cfg(rcfg2, cfg2)
    if how == "shrink":
        # a reacting system keeps half its free slice: nothing to cut here
        assert cfg2 is cfg and st2 is st
    else:
        assert bridge.config_to_dict(cfg2) != bridge.config_to_dict(cfg)
    _same_tree(rst2, st2)


def test_near_full_and_ladder_match(melt):
    (rcfg, _, _), (cfg, spec, st) = melt
    c = _counts(spec, cfg, st)
    cases = [(cfg, c, None), (cfg, dict(c, n_excl=int(0.95 * c[
        "excl_pair_cap"])), None),
        (dataclasses.replace(cfg, angle_cap=c["n_angles"] + 1), c, None),
        (dataclasses.replace(cfg, angle_irr_cap=c["n_angles_irr"] + 1), c,
         None),
        (cfg, c, dict(c, n_bonds=c["n_bonds"] - cfg.bond_cap // 2))]
    answers = [build.term_caps_near_full(cf, cc, prev_counts=p)
               for cf, cc, p in cases]
    ref_answers = [rbuild.term_caps_near_full(
        dataclasses.replace(rcfg, **{f: getattr(cf, f) for f in (
            "angle_cap", "angle_irr_cap")}), cc, prev_counts=p)
        for cf, cc, p in cases]
    assert answers == ref_answers == [False, True, True, True, True]
    rate = {"n_bonds": 0.4, "n_angles": 0.8, "n_excl": 1.2,
            "n_bonds_irr": 0.4, "n_angles_irr": 0.8}
    for rungs in (1, 3):
        lad = build.plan_cap_ladder(cfg, st, c, rate, 20000, rungs=rungs)
        assert lad == rbuild.plan_cap_ladder(rcfg, st, c, rate, 20000,
                                             rungs=rungs)
        assert len(lad) == rungs
    assert build.plan_cap_ladder(cfg, st, c, {k: 0.0 for k in rate},
                                 20000) == []


# ---- the reference's cap tests, on the port -------------------------------

def test_shrink_recovers_grown_caps(warm):
    cfg, spec, st = warm
    cfg_big, st_big = build.grow_neighbor_caps(cfg, spec, st)
    e_big = float(runner.measure(spec, cfg_big, st_big)["epot"])
    cfg_s, st_s = build.shrink_neighbor_caps(cfg_big, spec, st_big)
    assert cfg_s.cell_cap < cfg_big.cell_cap
    assert cfg_s.max_neighbors < cfg_big.max_neighbors
    e_s = float(runner.measure(spec, cfg_s, st_s)["epot"])
    assert abs(e_s - e_big) <= 1e-5 * abs(e_big)
    st_s = _run(spec, cfg_s, st_s, 20)
    m = runner.measure(spec, cfg_s, st_s)
    assert np.isfinite(float(m["epot"])) and not bool(m["overflow"])


def test_shrink_noop_when_tight(warm):
    cfg, spec, st = warm
    cfg2, st2 = build.shrink_neighbor_caps(cfg, spec, st)
    cfg3, st3 = build.shrink_neighbor_caps(cfg2, spec, st2)
    assert cfg3 is cfg2 and st3 is st2


def test_overflow_latches_and_regrowth_clears_it(warm):
    """A cap too small for the melt latches the sticky flag; regrowth clears
    it, and the next block runs with none."""
    cfg, spec, st = warm
    small = dataclasses.replace(cfg, cell_cap=8)
    _, st_small = build.apply_neighbor_caps(cfg, spec, st, {"cell_cap": 8})
    assert bool(st_small.nbr.overflow)
    cfg_g, st_g = small, st_small
    while bool(st_g.nbr.overflow):
        cfg_g, st_g = build.grow_neighbor_caps(cfg_g, spec, st_g)
    assert cfg_g.cell_cap % 8 == 0
    st_g = _run(spec, cfg_g, st_g, 10)
    assert not bool(st_g.nbr.overflow)


def test_shrink_term_caps(warm):
    cfg, spec, st = warm
    e0 = float(runner.measure(spec, cfg, st)["epot"])
    cfg_s, st_s = build.shrink_term_caps(cfg, st, headroom=16)
    assert cfg_s.bond_cap < cfg.bond_cap or cfg_s.angle_cap < cfg.angle_cap
    assert st_s.excl.shape[0] <= st.excl.shape[0]
    e_s = float(runner.measure(spec, cfg_s, st_s)["epot"])
    assert abs(e_s - e0) <= 1e-5 * abs(e0)
    a = _run(spec, cfg, st)
    b = _run(spec, cfg_s, st_s)
    assert int(b.bonds.valid.sum()) == int(a.bonds.valid.sum()) > \
        int(st.bonds.valid.sum())
    assert torch.equal(a.pos, b.pos)
    cfg2, _ = build.shrink_term_caps(cfg_s, b, headroom=16)
    assert (cfg2.bond_cap, cfg2.angle_cap) == (cfg_s.bond_cap,
                                               cfg_s.angle_cap)


def _assert_same_run(cfg, a, b):
    """``b`` ran at larger term caps than ``a``: the same bits."""
    assert torch.equal(a.pos, b.pos) and torch.equal(a.vel, b.vel)
    nb, na, ne = a.bonds.capacity, a.angles.capacity, a.excl.shape[0]
    assert torch.equal(a.bonds.idx, b.bonds.idx[:nb])
    assert (b.bonds.idx[nb:, 0] < 0).all()
    assert torch.equal(a.angles.idx, b.angles.idx[:na])
    assert torch.equal(a.excl, b.excl[:ne])
    assert int(a.n_excl) == int(b.n_excl)
    assert torch.equal(a.reaction_counts, b.reaction_counts)


def test_grow_term_caps_is_physics_inert(warm):
    cfg, spec, st = warm
    cfg_big, st_big = build.grow_term_caps(cfg, st)
    assert cfg_big.bond_cap > cfg.bond_cap
    assert cfg_big.angle_cap > cfg.angle_cap
    assert st_big.excl.shape[0] > st.excl.shape[0]
    assert int(st_big.bonds.count) == int(st.bonds.count)
    a = _run(spec, cfg, st)
    b = _run(spec, cfg_big, st_big)
    assert int(a.reaction_counts.sum()) > int(st.reaction_counts.sum())
    _assert_same_run(cfg, a, b)


def test_presize_term_caps_covers_planned_run(warm):
    cfg, spec, st = warm
    c0 = _counts(spec, cfg, st)
    st1 = _run(spec, cfg, st)
    c1 = _counts(spec, cfg, st1)
    appended = c1["n_bonds"] - c0["n_bonds"]
    assert appended > 0
    plan = 5000
    cfg2, st2 = build.presize_term_caps(cfg, st1, c1, c0, STEPS, plan,
                                        safety=1.6)
    assert cfg2.bond_cap >= c1["n_bonds"] + int(appended / STEPS * plan
                                                * 1.6)
    assert cfg2.dihedral_cap == cfg.dihedral_cap
    a = _run(spec, cfg, st1, 10)
    b = _run(spec, cfg2, st2, 10)
    assert torch.equal(a.pos, b.pos)
    assert int(a.bonds.count) == int(b.bonds.count)


def test_measure_cheap_reports_irregular_occupancy(warm):
    cfg, spec, st = warm
    assert cfg.bonded_dense
    c = _counts(spec, cfg, st)
    assert c["n_bonds_irr"] == int(st.bonds_irr.valid.sum())
    assert c["n_bonds"] == int(st.bonds_dense.valid.sum()) + c["n_bonds_irr"]
    assert c["n_angles"] == int(st.angles_dense.valid.sum()) \
        + c["n_angles_irr"]


def test_apply_term_caps_honors_explicit_irr_caps(warm):
    cfg, spec, st = warm
    irr_keep = cfg.bond_irr_cap
    cfg2, st2 = build.apply_term_caps(
        cfg, st, {"bond_cap": cfg.bond_cap + 10240,
                  "bond_irr_cap": irr_keep})
    assert cfg2.bond_cap == cfg.bond_cap + 10240
    assert cfg2.bond_irr_cap == irr_keep
    assert st2.bonds_irr.idx.shape[0] == irr_keep
    cfg3, _ = build.apply_term_caps(cfg, st,
                                    {"bond_cap": cfg.bond_cap + 10240})
    assert cfg3.bond_irr_cap == cfg.bond_irr_cap + 10240


def test_term_table_shrink_refuses_to_drop_rows(warm):
    cfg, spec, st = warm
    with pytest.raises(ValueError, match="drop valid rows"):
        build.apply_term_caps(cfg, st, {"bond_cap": 8})
    with pytest.raises(ValueError, match="drop pairs"):
        build.apply_term_caps(cfg, st, {}, 8)


def test_plan_cap_ladder_rungs_apply_and_preserve_physics(warm):
    cfg, spec, st = warm
    c0 = _counts(spec, cfg, st)
    st1 = _run(spec, cfg, st)
    c1 = _counts(spec, cfg, st1)
    assert c1["n_bonds"] > c0["n_bonds"]
    rate = {k: (c1[k] - c0[k]) / STEPS for k in c0 if k != "excl_pair_cap"}
    ladder = build.plan_cap_ladder(cfg, st1, c1, rate, plan_steps=20000,
                                   rungs=3)
    assert ladder
    seen = {f: getattr(cfg, f) for f in ("bond_cap", "angle_cap",
                                         "dihedral_cap", "bond_irr_cap",
                                         "angle_irr_cap")}
    excl_seen = st1.excl.shape[0]
    for caps_r, excl_r in ladder:
        for f, v in caps_r.items():
            assert v >= seen[f], (f, v, seen[f])
            seen[f] = v
        if excl_r is not None:
            assert excl_r > excl_seen
            excl_seen = excl_r
    assert seen["bond_cap"] >= c1["n_bonds"] + int(rate["n_bonds"] * 20000)
    cfg_r, st_r = cfg, st1
    for caps_r, excl_r in ladder:
        cfg_r, st_r = build.apply_term_caps(cfg_r, st_r, caps_r, excl_r)
    a = _run(spec, cfg, st1, 10)
    b = _run(spec, cfg_r, st_r, 10)
    assert torch.equal(a.pos, b.pos)
    assert int(a.bonds.count) == int(b.bonds.count)
    assert int(a.n_excl) == int(b.n_excl)
