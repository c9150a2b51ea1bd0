"""Full-row reaction matching against the reference, from one state.

When the type_1 side of the channels spans the bulk (step-growth
chemistry: E + E -> F:F on the chain melt, A + A on the constructed
topology of ``test_event_dedup.py``) the build leaves the compact path,
and ``reaction_step`` builds fresh neighbour rows on the reaction grid,
tests both directions of every channel for every slot and matches
mutually.  The acceptance draws are the integer hash ``pair_uniform`` and
every sort is stable, so the event lists, and the tables the events
write, must equal the reference's exactly; the event distances are f32
square roots of the same sums (``1e-6``).  The reference runs on the
port's arrays (``reference_trees``) with the port's config, so both take
the lazy-row full-row branch.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu_torch import bridge, reaction_parser, topfile
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, neighbor, runner
from chemlab_tpu_torch.engine import reactions as prx
from chemlab_tpu_torch.files_io import Coordinates
from chemlab_tpu_torch.topology import compile_system_topology
from test_event_dedup import CFG, TOPOL, _dih_multiset, _excl_multiset
from test_torch_bonded_tab import chain_melt, reference_trees

TABLES = ("bonds", "angles", "dihedrals")
FIELDS = ("ev_log_a", "ev_log_b", "ev_log_r", "ev_log_step", "excl", "n_excl",
          "adj", "type_id", "chem_state", "mol_id", "mass", "q",
          "reaction_counts", "intra_counts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_ref_step = jax.jit(rrx.reaction_step, static_argnums=(1,))


def _step_both(cfg, spec, st):
    """(reference output, port output) of one reaction step from ``st``."""
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    return _ref_step(rspec, rcfg, rst, 0), prx.reaction_step(spec, cfg, st, 0)


def _assert_same(r_out, p_out):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    for t in TABLES:
        ref = bridge.tree_to_numpy(getattr(r_out, t))
        got = bridge.tree_to_numpy(getattr(p_out, t))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg="%s.%s" % (t, k))
    np.testing.assert_allclose(p_out.ev_log_dist.numpy(),
                               np.asarray(r_out.ev_log_dist), rtol=0,
                               atol=1e-6)
    assert bool(p_out.nbr.overflow) == bool(r_out.nbr.overflow)


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    built, _ = chain_melt(tmp_path_factory.mktemp("chain_tables"))
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = pts.warmup(built, st, steps=20)
    return built, st


@pytest.mark.parametrize("rate_scale,step", [(1.0, 200), (2.5, 400)],
                         ids=["default", "boosted"])
def test_fullrow_events_identical_on_the_chain_melt(chain, rate_scale,
                                                    step):
    built, st = chain
    cfg, spec = built.cfg, built.spec
    assert not cfg.rx_compact
    st = dataclasses.replace(
        st, step=torch.full_like(st.step, step),
        reactions_on=torch.ones((), dtype=torch.bool),
        reaction_rates=st.reaction_rates * rate_scale)
    r_out, p_out = _step_both(cfg, spec, st)
    n_ev = int((p_out.ev_log_a >= 0).sum())
    assert n_ev > 0
    _assert_same(r_out, p_out)
    # one bond, two angles and three dihedrals per link
    assert int(p_out.bonds.count) - int(st.bonds.count) == n_ev
    assert int(p_out.angles.count) - int(st.angles.count) == 2 * n_ev
    assert int(p_out.dihedrals.count) - int(st.dihedrals.count) == 3 * n_ev


def test_fullrow_match_reads_the_reaction_grid(chain):
    """``match_reactions`` on the rows ``reaction_step`` builds: the same
    events as the whole step, and a slot whose pair is excluded never
    fires."""
    built, st = chain
    cfg, spec = built.cfg, built.spec
    st = dataclasses.replace(st, step=torch.full_like(st.step, 200),
                             reactions_on=torch.ones((), dtype=torch.bool))
    rows = neighbor.build_neighbor_state(
        st.pos, st.box, st.active, st.excl, cfg.rx_rc, dims=cfg.rx_dims,
        cell_cap=cfg.rx_cell_cap, max_neighbors=cfg.rx_k,
        excl_cap=cfg.excl_cap)
    ev = prx.match_reactions(spec, cfg, st, 0, rows.idx, rows.excl_mask)
    out = prx.reaction_step(spec, cfg, st, 0)
    for got, name in zip(ev[1:4], ("ev_log_a", "ev_log_b", "ev_log_r")):
        assert torch.equal(got, getattr(out, name))
    excl = {tuple(sorted(p)) for p in st.excl.tolist() if p[0] >= 0}
    fired = [(a, b) for a, b in zip(ev[1].tolist(), ev[2].tolist())
             if a >= 0]
    assert fired and not any(tuple(sorted(p)) in excl for p in fired)


def _constructed():
    """``test_event_dedup.py``'s topology built by the port: twelve A
    particles, an old 5-6 edge, and 4 5 6 7 on a line one sigma apart
    (the links 4-5 and 6-7 fire; every other particle is out of reach)."""
    systop = compile_system_topology(topfile.parse_lines(
        TOPOL.splitlines(), "<constructed>"))
    pos = np.array([[1, 1, 1], [1, 1, 4], [1, 4, 1], [4, 1, 1], [5, 7, 7],
                    [6, 7, 7], [7, 7, 7], [8, 7, 7], [1, 4, 4], [4, 4, 1],
                    [4, 1, 4], [1, 8, 1]], np.float64) + 0.05
    n = len(pos)
    coords = Coordinates(
        title="constructed", atom_ids=np.arange(1, n + 1),
        res_idx=np.arange(1, n + 1), res_names=["MON"] * n,
        atom_names=["X"] * n, pos=pos, vel=None, box=np.full(3, 10.0))
    opts = build.SimOptions(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4,
                            dt=0.0025, kT=1.0, thermostat="lv",
                            thermostat_gamma=1.0, rng_seed=0, max_events=16)
    built = build.build_system(
        systop, coords, opts, device="cpu",
        reaction_config=reaction_parser.parse_config_lines(CFG.splitlines()))
    st = built.state
    adj = torch.full_like(st.adj, -1)
    adj[5, 0], adj[6, 0] = 6, 5
    st = dataclasses.replace(
        st, adj=adj, step=torch.full_like(st.step, 10),
        reactions_on=torch.ones((), dtype=torch.bool),
        reaction_rates=st.reaction_rates * 40.0)
    return built, st


def test_fullrow_spanning_dihedral_on_the_constructed_topology():
    built, st = _constructed()
    cfg, spec = built.cfg, built.spec
    assert not cfg.rx_compact and cfg.dihedral_funcs == (1,)
    r_out, p_out = _step_both(cfg, spec, st)
    _assert_same(r_out, p_out)
    fired = sorted(tuple(sorted((a, b))) for a, b in
                   zip(p_out.ev_log_a.tolist(), p_out.ev_log_b.tolist())
                   if a >= 0)
    assert fired == [(4, 5), (6, 7)]
    # the dihedral spanning both new bonds exists once, in both packages
    r_dih = _dih_multiset(r_out.dihedrals)
    assert r_dih.count((4, 5, 6, 7)) == 1
    assert _dih_multiset(p_out.dihedrals) == r_dih
    assert _excl_multiset(p_out) == _excl_multiset(r_out)
