"""Exchange reactions: the port against the reference from one state.

The system is the reference's ``tests/test_exchange.py`` melt (60
trimers at density 0.4, ``EXCHANGE_CFG``: ``MA(1,2):ML(a,b) + MA(1,2) ->
FA(1):DA(1) + PL(1)``), built by ``testsystems.build_exchange_melt`` in
the port and held leaf for leaf to the reference's build; the 40-trimer
melt at the same density (a 2x2x2 grid) as well.  From one state (the
reference's, carried across by the bridge) one ``reaction_step`` must
give the same event lists, types, chemical states, counters, tables and
adjacency in both, exactly: the channel is virtual (no bond), the A and
C sides change type and state, and the B side (the A side's bonded ML)
changes by the level-1 neighbour transfer.  The event distances are f32
square roots of the same sums: 1e-6.  The same on the persistent rows
(``use_pallas=False``), against the reference's row path.  The parser's
exchange grammar is held to the reference's parser too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import reaction_parser as rrp
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge, reaction_parser
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import reactions as prx

from test_exchange import build_exchange
from test_torch_ext_builds import assert_builds_equal


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_build(n_mols, ml_window, rows):
    """The reference's system at ``n_mols`` trimers: on its row path
    ``test_exchange.build_exchange`` itself (its default ``use_pallas``),
    else the same build with ``use_pallas=True`` (the cell kernel, which
    the port's default takes)."""
    if rows:
        assert n_mols == 60
        return build_exchange(ml_window)[0]
    from chemlab_tpu import testsystems as rts
    from chemlab_tpu import topfile
    from chemlab_tpu.engine import build as rbuild
    from chemlab_tpu.topology import compile_system_topology

    import test_exchange

    systop = compile_system_topology(topfile.parse_lines(
        rts._melt_topology_text(n_mols).splitlines(), "<gen>"))
    coords = rts.melt_coordinates(n_mols, 0.4, seed=5)
    rcfg = rrp.parse_config_lines((test_exchange.EXCHANGE_CFG % {
        "mlmin": ml_window[0], "mlmax": ml_window[1]}).splitlines())
    return rbuild.build_system(systop, coords, rbuild.SimOptions(
        lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=1.0,
        gen_velocity=True, rng_seed=5, max_events=16, use_pallas=True),
        reaction_config=rcfg)


# (n_mols, ML state window, persistent rows)
CASES = {
    "60": (60, (0, 9), False),
    "40": (40, (0, 9), False),
    "60_blocked": (60, (5, 6), False),
    "60_rows": (60, (0, 9), True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both builds, the shared start (reactions on), and one reaction step
    from it in each package."""
    n_mols, window, rows = CASES[request.param]
    rb = _reference_build(n_mols, window, rows)
    pb, systop, _ = pts.build_exchange_melt(
        n_mols=n_mols, ml_window=window, device="cpu",
        **(dict(use_pallas=False) if rows else {}))
    st = rrun.initial_forces(rb.spec, rb.cfg, rb.state)
    st = dataclasses.replace(st, reactions_on=jnp.asarray(True))
    r_out = jax.jit(lambda s: rrx.reaction_step(rb.spec, rb.cfg, s, 3))(st)
    cfg, spec, pst = bridge.from_trees(rb.cfg, rb.spec, st, "cpu")
    p_out = prx.reaction_step(spec, cfg, pst, 3)
    return dict(name=request.param, rb=rb, pb=pb, systop=systop, start=pst,
                cfg=cfg, r_out=r_out, p_out=p_out)


@pytest.mark.parametrize("part", ["config", "spec", "state"])
def test_exchange_build_is_leaf_for_leaf_equal(case, part):
    assert_builds_equal(case["rb"], case["pb"], part)
    assert case["pb"].cfg.use_pallas == (case["name"] != "60_rows")


FIELDS = ("ev_log_a", "ev_log_b", "ev_log_r", "ev_log_step", "type_id",
          "chem_state", "reaction_counts", "intra_counts", "mass", "q",
          "adj", "excl", "n_excl", "mol_id", "lam")


def test_exchange_step_equals_reference(case):
    r_out, p_out = case["r_out"], case["p_out"]
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    for t in ("bonds", "angles", "dihedrals"):
        ref = bridge.tree_to_numpy(getattr(r_out, t))
        got = bridge.tree_to_numpy(getattr(p_out, t))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg="%s.%s" % (t, k))
    np.testing.assert_allclose(p_out.ev_log_dist.numpy(),
                               np.asarray(r_out.ev_log_dist), rtol=0,
                               atol=1e-6)
    events = int(p_out.reaction_counts.sum())
    if case["name"] == "60_blocked":
        # the MLs are in state 0, outside the window (5, 6)
        assert events == 0
    else:
        assert events > 0


def test_exchange_fires_and_transfers(case):
    """The reference test's own checks, on the port's step: no bond, FA
    and DA one each an event, the A sides' bonded MLs now PL, the states
    bumped; where the window blocks the channel, nothing changes."""
    start, out, systop = case["start"], case["p_out"], case["systop"]
    events = int(out.reaction_counts.sum())
    if case["name"] == "60_blocked":
        assert events == 0
        assert torch.equal(out.type_id, start.type_id)
        assert torch.equal(out.chem_state, start.chem_state)
        return
    assert int(out.bonds.valid.sum()) == int(start.bonds.valid.sum())
    tsym = systop.atomsym_atomtype
    tid, act = out.type_id.numpy(), out.active.numpy()

    def count(sym, t=tid):
        return int(((t == tsym[sym]) & act).sum())

    assert count("FA") == events and count("DA") == events
    assert 0 < count("PL") <= events
    chem = out.chem_state.numpy()
    assert chem[(tid == tsym["FA"]) & act].min() >= 2
    # the transfer: every new PL is an ML bonded to a new FA
    new_pl = np.where((tid == tsym["PL"]) & (start.type_id.numpy()
                                             == tsym["ML"]))[0]
    fa = set(np.where(tid == tsym["FA"])[0].tolist())
    adj = out.adj.numpy()
    assert len(new_pl) == count("PL")
    assert all(fa & set(adj[p].tolist()) for p in new_pl)


def test_parse_exchange_equation():
    eq = "C(0,1):E(0,1) + W(0,1) -> A(1):Z(1) + E(1)"
    got = reaction_parser.parse_exchange_equation(eq)
    assert got[1] == reaction_parser.REACTION_EXCHANGE
    assert got == rrp.parse_exchange_equation(eq)
    rl = got[0]
    assert (rl["type_1"]["name"], rl["type_1"]["new_type"]) == ("C", "A")
    assert rl["type_1"]["min"] == 0 and rl["type_1"]["max"] == 1
    assert (rl["type_2"]["name"], rl["type_2"]["new_type"],
            rl["type_2"]["delta"]) == ("E", "E", 1)
    assert (rl["type_3"]["name"], rl["type_3"]["new_type"],
            rl["type_3"]["delta"]) == ("W", "Z", 1)


def test_reference_exchange_equation():
    """The melt's equation parses to the reference's dict, and the
    compiled channel is an exchange (a C side type)."""
    eq = "MA(1,2):ML(0,9) + MA(1,2) -> FA(1):DA(1) + PL(1)"
    assert reaction_parser.parse_exchange_equation(eq) == \
        rrp.parse_exchange_equation(eq)
    pb, _, _ = pts.build_exchange_melt(n_mols=40, device="cpu")
    ch = pb.reactions.channels
    assert (ch["r_cnb_type"] >= 0).all() and not ch["r_is_diss"].any()


def test_malformed_exchange_not_misparsed_as_dissociation():
    bad = "A(1,1):B(1,1) + C(1,1) -> A1(0) + B1(0)"
    for mod in (reaction_parser, rrp):
        with pytest.raises(ValueError):
            mod.process_reaction([("reaction", bad), ("rate", "1.0"),
                                  ("cutoff", "1.0")])
