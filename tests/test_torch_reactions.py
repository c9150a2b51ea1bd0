"""The reactive layer: port vs reference from one shared state.

Reaction acceptance uses the integer hash ``pair_uniform``; the port runs
its uint32 arithmetic in int64 with ``& 0xFFFFFFFF`` and must be
bit-equal.  From one shared state (the 70-trimer melt, warmed, with
initiators switched on) ``reaction_step`` must then give identical event
lists and identical topology: every integer table exactly, and the
per-particle floats that events rewrite (mass, charge) bit for bit.
The event distances are f32 square roots of the same sums: ``1e-6``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu.engine import topo as rtopo
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import reactions as prx
from chemlab_tpu_torch.engine import topo as ptopo


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def melt():
    built, systop, _ = rts.build_melt(n_mols=70, reactive=True,
                                      use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=50, chunk=50)
    step = jax.jit(lambda s: rrx.reaction_step(built.spec, built.cfg, s, 0))
    return built, systop, st, step


def test_pair_uniform_bit_equal():
    rng = np.random.RandomState(0)
    n = 100_000
    seed, step, lo, hi, salt = (rng.randint(0, 2**32, n, dtype=np.uint64)
                                for _ in range(5))
    ref = rrx.pair_uniform(jnp.asarray(seed.astype(np.uint32)),
                           jnp.asarray(step.astype(np.uint32)),
                           jnp.asarray(lo.astype(np.uint32)),
                           jnp.asarray(hi.astype(np.uint32)),
                           jnp.asarray(salt.astype(np.uint32)))
    got = prx.pair_uniform(*(torch.from_numpy(x.astype(np.int64))
                             for x in (seed, step, lo, hi, salt)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))
    # negative int32 ids wrap like jnp.asarray(x, uint32)
    neg = np.array([-1, -2, -2**31], np.int32)
    r_neg = rrx.pair_uniform(0, 7, jnp.asarray(neg), jnp.asarray(neg), 3)
    p_neg = prx.pair_uniform(0, 7, torch.from_numpy(neg),
                             torch.from_numpy(neg), 3)
    np.testing.assert_array_equal(p_neg.numpy(), np.asarray(r_neg))


def _shared_state(melt, n_init: int, rate_scale: float, step: int):
    built, systop, st, _ = melt
    st = rts.activate_initiators(built, systop, st, n=n_init)
    st = dataclasses.replace(
        st, step=jnp.asarray(step, jnp.int32),
        reaction_rates=st.reaction_rates * rate_scale)
    return st


TABLES = ("bonds", "angles", "dihedrals")
FIELDS = ("ev_log_a", "ev_log_b", "ev_log_r", "ev_log_step", "excl",
          "n_excl", "adj", "type_id", "chem_state", "mol_id", "mass", "q",
          "reaction_counts", "intra_counts")


@pytest.mark.parametrize("n_init,rate_scale,step", [
    (10, 1.0, 200), (40, 10.0, 400), (60, 3.0, 600)],
    ids=["default", "boosted", "crowded"])
def test_reaction_step_identical(melt, n_init, rate_scale, step):
    built, _, _, rstep = melt
    rst = _shared_state(melt, n_init, rate_scale, step)
    cfg, spec, pst = bridge.from_trees(built.cfg, built.spec, rst, "cpu")
    r_out = rstep(rst)
    p_out = prx.reaction_step(spec, cfg, pst, 0)
    n_ev = int((np.asarray(r_out.ev_log_a) >= 0).sum())
    assert n_ev > 0
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
    # every event made a bond (all melt channels are bond-forming)
    assert int(p_out.bonds.count) - int(pst.bonds.count) == n_ev


def test_compact_match_identical(melt):
    """The candidate tile and the match, before any event is applied."""
    built, _, _, _ = melt
    rst = _shared_state(melt, 40, 10.0, 400)
    rcfg, rspec = built.cfg, built.spec
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, rst, "cpu")
    r_s1 = rrx.side1_mask(rspec, rcfg, rst)
    p_s1 = prx.side1_mask(spec, cfg, pst)
    np.testing.assert_array_equal(p_s1.numpy(), np.asarray(r_s1))
    rowsel = np.argsort(~np.asarray(r_s1), kind="stable")[:rcfg.rx_rows_cap]
    rowsel = rowsel.astype(np.int32)
    r_c = jax.jit(lambda s, rs: rrx.compact_candidates_from_cells(
        rspec, rcfg, s, rs))(rst, jnp.asarray(rowsel))
    p_c = prx.compact_candidates_from_cells(spec, cfg, pst,
                                            torch.from_numpy(rowsel))
    for name, r, g in zip(("cand", "excl_hit", "overflow"), r_c, p_c):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    row_ok = np.asarray(r_s1)[rowsel]
    r_m = jax.jit(lambda s, *a: rrx.match_reactions_compact(
        rspec, rcfg, s, jnp.uint32(0), *a))(
            rst, jnp.asarray(rowsel), jnp.asarray(row_ok), r_c[0], r_c[1])
    p_m = prx.match_reactions_compact(spec, cfg, pst, 0,
                                      torch.from_numpy(rowsel),
                                      torch.from_numpy(row_ok), p_c[0],
                                      p_c[1])
    for name, r, g in zip(("ev_valid", "ev_a", "ev_b", "ev_r"), r_m, p_m):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert bool(np.asarray(r_m[0]).any())


def _random_adj(n=24, deg=4, seed=3):
    rng = np.random.RandomState(seed)
    adj = np.full((n, deg), -1, np.int32)
    for i in range(n):
        k = rng.randint(0, deg + 1)
        adj[i, :k] = rng.choice(np.delete(np.arange(n), i), k, replace=False)
    return adj


def test_enumerations_match_vmapped_reference():
    adj = _random_adj()
    a = np.array([0, 3, 7, 11, 19], np.int32)
    b = np.array([5, 9, 2, 12, 4], np.int32)
    for r_fn, p_fn in ((rtopo.enumerate_new_angles, ptopo.enumerate_new_angles),
                       (rtopo.enumerate_new_dihedrals,
                        ptopo.enumerate_new_dihedrals)):
        r_idx, r_v = jax.vmap(r_fn, in_axes=(None, 0, 0))(
            jnp.asarray(adj), jnp.asarray(a), jnp.asarray(b))
        p_idx, p_v = p_fn(torch.from_numpy(adj), torch.from_numpy(a),
                          torch.from_numpy(b))
        np.testing.assert_array_equal(p_v.numpy(), np.asarray(r_v))
        np.testing.assert_array_equal(
            np.where(p_v.numpy()[..., None], p_idx.numpy(), 0),
            np.where(np.asarray(r_v)[..., None], np.asarray(r_idx), 0))


@pytest.mark.parametrize("cap", [16, 6], ids=["fits", "overflows"])
def test_appends_drop_like_the_reference(cap):
    """``mode="drop"`` scatters: rows past the capacity vanish and set the
    overflow flag, on both sides alike."""
    rng = np.random.RandomState(4)
    m = 10
    pairs = rng.randint(0, 50, (m, 2)).astype(np.int32)
    valid = rng.uniform(size=m) < 0.7
    excl = np.full((cap, 2), -1, np.int32)
    excl[:2] = [[1, 2], [3, 4]]
    r = rtopo.excl_append(jnp.asarray(excl), jnp.asarray(2, jnp.int32),
                          jnp.asarray(pairs), jnp.asarray(valid))
    p = ptopo.excl_append(torch.from_numpy(excl), torch.tensor(2,
                                                               dtype=torch.int32),
                          torch.from_numpy(pairs), torch.from_numpy(valid))
    for rv, pv in zip(r, p):
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
    assert bool(p[2]) == (cap == 6)

    from chemlab_tpu.engine.state import TermTable as RTable

    from chemlab_tpu_torch.engine.state import TermTable as PTable
    tab = PTable.create_numpy(cap, 2, [(0, 1), (1, 2)], [1, 1],
                              [[1.0, 2.0], [3.0, 4.0]])
    funcs = rng.randint(1, 3, m).astype(np.int32)
    pars = rng.uniform(size=(m, 6)).astype(np.float32)
    lam = rng.uniform(size=m).astype(np.float32)
    r_t, r_o = rtopo.table_append(
        RTable(**{k: jnp.asarray(v) for k, v in tab.items()}),
        jnp.asarray(pairs), jnp.asarray(funcs), jnp.asarray(pars),
        jnp.asarray(valid), lam=jnp.asarray(lam))
    p_t, p_o = ptopo.table_append(
        PTable(**{k: torch.from_numpy(np.array(v)) for k, v in tab.items()}),
        torch.from_numpy(pairs), torch.from_numpy(funcs),
        torch.from_numpy(pars), torch.from_numpy(valid),
        lam=torch.from_numpy(lam))
    ref, got = bridge.tree_to_numpy(r_t), bridge.tree_to_numpy(p_t)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert bool(p_o) == bool(r_o)


def test_adjacency_and_molecule_merge_match():
    adj = _random_adj(seed=5)
    mol = np.arange(24, dtype=np.int32) // 3
    for i, j, en in ((0, 1, True), (2, 23, True), (4, 6, False), (-1, 3, True)):
        r_adj, r_ov = rtopo.adj_add_edge(jnp.asarray(adj), jnp.int32(i),
                                         jnp.int32(j), en)
        p_adj, p_ov = ptopo.adj_add_edge(torch.from_numpy(adj),
                                         torch.tensor(i), torch.tensor(j), en)
        np.testing.assert_array_equal(p_adj.numpy(), np.asarray(r_adj))
        assert bool(p_ov) == bool(r_ov)
        r_mol = rtopo.merge_molecules(jnp.asarray(mol), jnp.int32(i),
                                      jnp.int32(j), en)
        p_mol = ptopo.merge_molecules(torch.from_numpy(mol), torch.tensor(i),
                                      torch.tensor(j), en)
        np.testing.assert_array_equal(p_mol.numpy(), np.asarray(r_mol))
        adj, mol = np.array(r_adj), np.array(r_mol)
