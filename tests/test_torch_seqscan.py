"""The sequential event scan and FixDistances against the reference.

With RemoveNeighboursBonds or FixDistances (ReleaseMolecule,
JoinMolecule) events apply one at a time (``_apply_events_sequential``).
On the reference tests' systems (``test_remove_bonds_overflow.py``'s
RB_CFG at 40 trimers, ``test_multi_release_join.py``'s
RELEASE_PLUS_JOIN_CFG and TWO_RELEASE_CFG at 80) the port must give the
reference's tables, constraint rows, types and lambdas exactly:

- RemoveNeighboursBonds within ``MAX_RM`` (4 hits) and beyond it (10
  hits, the sticky overflow flag);
- a reaction step whose events release dummies and capture partners;
- the loop over the fired rows only equals the loop over all
  ``max_events`` rows (invalid rows write nothing);
- ``_fix_distances``: releases on a host type change (types, masses,
  lambdas exact) and the projection (positions within
  ``2e-5 (1 + max|ref|)``, velocities exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import integrate, runner, topo
from chemlab_tpu_torch.engine import reactions as prx
from chemlab_tpu_torch.engine.state import N_BOND_PARAMS
from test_multi_release_join import RELEASE_PLUS_JOIN_CFG, TWO_RELEASE_CFG
from test_remove_bonds_overflow import RB_CFG
from test_torch_bonded_tab import reference_trees
from test_torch_dissociation import assert_same_state, ref_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_build(text, n_mols, density, seed, **opts):
    return pts._build_trimer_melt(text, n_mols, density, 1.0, seed, "cpu",
                                  opts)


ref_apply = jax.jit(rrx.apply_reaction_events, static_argnums=(1,))


# ---- RemoveNeighboursBonds ------------------------------------------------


@pytest.fixture(scope="module")
def rb_melt():
    pb, _, _ = _port_build(RB_CFG, 40, 0.4, 5, max_events=8)
    return pb, runner.initial_forces(pb.spec, pb.cfg, pb.state)


def _with_hubs(st, n_hubs: int):
    """Particle 0 (MA) also bonded to the ML hub of ``n_hubs`` foreign
    trimers (``test_remove_bonds_overflow.py``'s construction): the event
    0 + 3 then finds 2 * n_hubs (MA, ML) bonds one hop from its anchor."""
    hubs = [3 * (k + 1) + 1 for k in range(n_hubs)]
    idx = torch.tensor([[0, h] for h in hubs], dtype=torch.int32)
    bonds, ov = topo.table_append(
        st.bonds, idx, torch.ones(n_hubs, dtype=torch.int32),
        torch.zeros((n_hubs, N_BOND_PARAMS)), torch.ones(n_hubs,
                                                         dtype=torch.bool))
    assert not bool(ov)
    adj = st.adj
    for h in hubs:
        adj, ov = topo.adj_add_edge(adj, torch.tensor(0, dtype=torch.int32),
                                    torch.tensor(h, dtype=torch.int32))
        assert not bool(ov)
    return dataclasses.replace(st, bonds=bonds, adj=adj)


@pytest.mark.parametrize("n_hubs", [2, 5], ids=["within", "beyond"])
def test_remove_neighbour_bonds_equal(rb_melt, n_hubs):
    pb, st0 = rb_melt
    cfg, spec = pb.cfg, pb.spec
    st = _with_hubs(st0, n_hubs)
    m = cfg.max_events
    ev_valid = torch.zeros(m, dtype=torch.bool)
    ev_valid[0] = True
    ev_a = torch.full((m,), -1, dtype=torch.int32)
    ev_b = torch.full((m,), -1, dtype=torch.int32)
    ev_a[0], ev_b[0] = 0, 3
    ev_r = torch.zeros(m, dtype=torch.int32)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    r_st, r_ov = ref_apply(rspec, rcfg, rst, *(jnp.asarray(t.numpy()) for t in
                                               (ev_valid, ev_a, ev_b, ev_r)))
    p_st, p_ov = prx.apply_reaction_events(spec, cfg, st, ev_valid, ev_a,
                                           ev_b, ev_r)
    assert bool(p_ov) == bool(r_ov) == (2 * n_hubs > prx.MAX_RM)
    assert_same_state(r_st, p_st)
    removed = int(st.bonds.valid.sum()) + 1 - int(p_st.bonds.valid.sum())
    assert removed == 2 * n_hubs


def test_remove_neighbour_bonds_leaves_molecule_ids(rb_melt):
    """A fault of the reference, kept by the port: RemoveNeighboursBonds
    (like a FreezeRegion removal) splits molecules without relabelling
    them, since ``relabel_components`` runs only after a dissociation.
    Both packages keep the stale ids (``test_remove_neighbour_bonds_equal``
    holds ``mol_id`` equal); here the ends of the removed bonds share an id
    but lie in different components."""
    pb, st0 = rb_melt
    cfg, spec = pb.cfg, pb.spec
    st = _with_hubs(st0, 2)
    m = cfg.max_events
    ev_valid = torch.arange(m) == 0
    ev_a = torch.where(ev_valid, 0, -1).to(torch.int32)
    ev_b = torch.where(ev_valid, 3, -1).to(torch.int32)
    out, _ = prx.apply_reaction_events(spec, cfg, st, ev_valid, ev_a, ev_b,
                                       torch.zeros(m, dtype=torch.int32))
    gone = st.bonds.valid & ~out.bonds.valid
    label = topo.relabel_components(out.adj, out.active)
    split = [(i, j) for i, j in st.bonds.idx[gone].tolist()
             if label[i] != label[j]]
    assert split and all(out.mol_id[i] == out.mol_id[j] for i, j in split)


# ---- release and join -----------------------------------------------------


@pytest.fixture(scope="module")
def join_melt():
    pb, psys, _ = _port_build(RELEASE_PLUS_JOIN_CFG, 80, 0.3, 3,
                              max_events=16)
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    st = pts.warmup(pb, st, steps=20)
    st = pts.activate_initiators(pb, psys, st, n=16)
    return pb, dataclasses.replace(st, step=torch.full_like(st.step, 20))


def test_release_and_join_events_equal(join_melt):
    pb, st = join_melt
    cfg, spec = pb.cfg, pb.spec
    assert cfg.has_fixd and cfg.n_fd == 2 and not cfg.n_rb
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    r_out = ref_step(rspec, rcfg, rst, 0)
    p_out = prx.reaction_step(spec, cfg, st, 0)
    assert_same_state(r_out, p_out)
    def live(s):
        return {(h, d) for h, d in zip(s.fixd_host.tolist(),
                                       s.fixd_dummy.tolist()) if h >= 0}

    n_ev = int((p_out.ev_log_a >= 0).sum())
    # every event captured its partner (into the first free slot, which
    # may be the one its own release just freed); a host with a dummy
    # released it
    released = live(st) - live(p_out)
    captured = live(p_out) - live(st)
    assert n_ev > 0 and 0 < len(released) <= n_ev and len(captured) == n_ev
    assert {h for h, _ in released} <= set(p_out.ev_log_a.tolist())


def test_fired_rows_equal_all_rows(join_melt):
    """The scan over the fired rows only (one read) against
    ``_apply_event`` looped over all ``max_events`` rows, on the events of
    a reaction step."""
    pb, st = join_melt
    cfg, spec = pb.cfg, pb.spec
    out = prx.reaction_step(spec, cfg, st, 0)
    ev = (out.ev_log_a >= 0, out.ev_log_a, out.ev_log_b, out.ev_log_r)
    assert 0 < int(ev[0].sum()) < cfg.max_events
    fired, f_ov = prx._apply_events_sequential(spec, cfg, st, *ev)
    every, e_ov = st, torch.zeros((), dtype=torch.bool)
    for k in range(cfg.max_events):
        every, ov = prx._apply_event(spec, cfg, every, *(e[k] for e in ev))
        e_ov = e_ov | ov
    assert bool(f_ov) == bool(e_ov)
    for f in dataclasses.fields(fired):
        a, b = getattr(fired, f.name), getattr(every, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    for t in ("bonds", "angles", "dihedrals"):
        for f in dataclasses.fields(getattr(fired, t)):
            assert torch.equal(getattr(getattr(fired, t), f.name),
                               getattr(getattr(every, t), f.name))


# ---- two release blocks and FixDistances ----------------------------------


@pytest.fixture(scope="module")
def two_release():
    """The port's TWO_RELEASE_CFG melt (the build is held to the
    reference's in ``test_torch_ext_builds.py``)."""
    pb, psys, _ = _port_build(TWO_RELEASE_CFG, 80, 0.3, 3, max_events=16)
    return pb, psys


def test_fix_distances_equal(two_release):
    """Displaced dummies, and the ML hosts of the type-released block
    turned PA: the released dummies take the target type at the release
    lambda, the others snap back to ``eq`` from their hosts."""
    pb, psys = two_release
    cfg, spec, st = pb.cfg, pb.spec, pb.state
    rng = np.random.RandomState(4)
    pos = st.pos + torch.from_numpy(
        rng.uniform(-0.3, 0.3, st.pos.shape).astype(np.float32)) \
        * st.active[:, None]
    pos = pos - st.box * torch.floor(pos / st.box)
    tsym = psys.atomsym_atomtype
    tid = st.type_id.clone()
    ml = torch.nonzero(tid == tsym["ML"]).flatten()[::3]
    tid[ml] = tsym["PA"]
    vel = torch.from_numpy(rng.normal(size=st.vel.shape).astype(np.float32))
    st = dataclasses.replace(st, pos=pos, type_id=tid, vel=vel)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    r_out = jax.jit(rint._fix_distances, static_argnums=(1,))(rspec, rcfg,
                                                               rst)
    p_out = integrate._fix_distances(spec, cfg, st)
    for name in ("type_id", "mass", "lam", "fixd_host", "fixd_dummy", "vel"):
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    ref = np.asarray(r_out.pos)
    np.testing.assert_allclose(p_out.pos.numpy(), ref, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(ref).max()))
    released = int((st.fixd_host >= 0).sum()) - int(
        (p_out.fixd_host >= 0).sum())
    assert released == ml.numel()
