"""The port on several ranks (``slab_devices > 1``) against one rank:
bond breaking, the reaction extensions, capacity changes and the Verlet
row path.

Every system is built once here on the CPU at ``slab_devices=3`` (the
70-trimer melts: a 3x3x3 grid, one x-layer a slab), warmed, and sent to
3 gloo ranks of ``parallel.launch`` in one ``run_jobs`` call (fresh
interpreters that import no jax, one intra-op thread each, a file store in
a temporary directory); the same runs on one rank come from this process,
from the same state and generator seed.

  - the break melt (dissociation with its lambda fade, the ATRP forward
    reaction with ChangeNeighboursProperty and RemoveNeighboursBonds,
    restricted chain growth) over three reaction intervals;
  - the release melt (ReleaseMolecule, JoinMolecule, ATRPActivator,
    ChangeParticleType, a removing FreezeRegion) across an interval;
  - the reactive LJ melt with the neighbour caps regrown after its first
    block and shrunk after its second;
  - the row melt (every nonbonded variant and Coulomb on the persistent
    rows): forces, energies and the row-path virial, and a block;
  - the replica check against a one-ulp or one-count change in a field
    it gained here.

Both melts run with their reaction interval set to 10 (the reference's
``test_sharded_extended.py`` uses 10), so that short blocks cross
intervals.  Tolerances: on the K1f paths every leaf of the final state,
floats included, equals the one-rank run's bit for bit (each particle's
force is nonzero on one rank only and K1f's rows are K1's rows).  On the
row path each rank sums its own block of rows, and a row's sum does not
depend on the other rows: the forces are held bit for bit; the energies
are sums of 3 partial sums, held to 1e-6 relative (``test_halo.py``'s
bound for the slab path's energy), and the pressure to 1e-5 relative
(its bound for the slab path's pressure).
"""

import dataclasses

import numpy as np
import pytest
import torch

from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, cell_pair_halo, integrate, runner
from chemlab_tpu_torch.parallel import SlabMesh, jobs, launch

D = 3
N_MOLS = 70
SEED = 1234
INTERVAL = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _start(built, systop, st, n_init, rate_scale=1.0):
    """Warmed, ``n_init`` initiators on, the bond-forming channels' rates
    scaled by ``rate_scale`` (the dissociation's kept)."""
    st = runner.initial_forces(built.spec, built.cfg, st)
    st = pts.warmup(built, st, steps=30)
    st = pts.activate_initiators(built, systop, st, n=n_init)
    return dataclasses.replace(st, reaction_rates=torch.where(
        built.spec.r_is_diss, st.reaction_rates,
        st.reaction_rates * rate_scale))


def _fast(cfg):
    return dataclasses.replace(cfg, reaction_interval=INTERVAL)


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """name -> (cfg, spec, start state, run_blocks kwargs)."""
    out = {}
    b, sy, _ = pts.build_break_melt(
        n_mols=N_MOLS, diss_rate=2.0, max_events=16, slab_devices=D,
        table_dir=str(tmp_path_factory.mktemp("break")), device="cpu")
    out["break"] = (_fast(b.cfg), b.spec, _start(b, sy, b.state, 16, 10.0),
                    dict(n_blocks=1, block_steps=35))
    b, sy, _ = pts.build_release_melt(
        n_mols=N_MOLS, freeze_width=0.5, freeze_prob=0.05, max_events=16,
        slab_devices=D, device="cpu")
    out["release"] = (_fast(b.cfg), b.spec,
                      _start(b, sy, b.state, 16, 10.0),
                      dict(n_blocks=1, block_steps=25))
    b, sy, _ = pts.build_melt(n_mols=N_MOLS, reactive=True, max_events=16,
                              slab_devices=D, device="cpu")
    out["caps"] = (b.cfg, b.spec, _start(b, sy, b.state, 6),
                   dict(n_blocks=3, block_steps=8,
                        cap_changes=((0, "grow"), (1, "shrink"))))
    b, sy, _ = pts.build_row_melt(
        n_mols=N_MOLS, slab_devices=D,
        table_dir=_row_tables(tmp_path_factory), device="cpu")
    out["rows"] = (b.cfg, b.spec, _start(b, sy, b.state, 10),
                   dict(n_blocks=1, block_steps=30))
    return out


def _row_tables(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rows"))
    pts.write_row_tables(d)
    return d


def _one_rank(cfg, spec, st, **kw):
    """``jobs.run_blocks``' loop on one rank, in this process."""
    cfg, st, _ = jobs.blocks(spec, cfg, st, gen=runner.make_generator(
        SEED, "cpu"), **kw)
    return cfg, st


@pytest.fixture(scope="module")
def ranks(systems, tmp_path_factory):
    """Every job on the 3 ranks in one ``run_jobs`` call: the blocks of
    each system, the row melt's forces, then the replica check with one
    rank's ``lam`` (a float) and ``nbr.birth`` (an int) nudged."""
    jobs = []
    for name, (cfg, spec, st, kw) in systems.items():
        jobs.append(("run_blocks", dict(
            system=bridge.to_numpy(cfg, spec, st), seed=SEED, **kw)))
    rows = systems["rows"]
    row_sys = bridge.to_numpy(*rows[:3])
    jobs.append(("forces", dict(system=row_sys)))
    for field in ("lam", "nbr.birth"):
        jobs.append(("check_replicas", dict(system=row_sys, perturb_rank=1,
                                            field=field, catch=True)))
    res = launch.run_jobs(jobs, D, tmp_path_factory.mktemp("store"),
                          backend="gloo", device="cpu", timeout=300)
    out = dict(zip(systems, res))
    out["row_forces"], out["lam"], out["birth"] = res[len(systems):]
    return out


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + k + ".")
        else:
            yield path + k, v


def _assert_state_equal(ref_state, got_tree, name):
    ref = dict(_leaves(bridge.tree_to_numpy(ref_state)))
    got = dict(_leaves(got_tree))
    assert sorted(ref) == sorted(got)
    for p, r in ref.items():
        g = got[p]
        if r is None or g is None:
            assert r is None and g is None, (name, p)
            continue
        assert g.dtype == r.dtype and g.shape == r.shape, (name, p)
        assert g.tobytes() == r.tobytes(), (name, p)


@pytest.mark.parametrize("name", ["break", "release", "caps"])
def test_ranks_equal_one_rank_bit_for_bit(systems, ranks, name):
    """Every leaf of every rank's final state, the K1f path all the way:
    integers exactly, positions and the other floats bit for bit."""
    cfg, spec, st, kw = systems[name]
    cfg1, one = _one_rank(cfg, spec, st, **kw)
    for r in ranks[name]:
        _assert_state_equal(one, r["state"], name)
        assert r["caps"] == {f: getattr(cfg1, f)
                             for f in build.NEIGHBOR_CAP_FIELDS}
    # the slab path (K1f's plain version here: no kernel runs on the CPU)
    assert cell_pair_halo.supports(dataclasses.replace(cfg1, mesh=SlabMesh(
        rank=0, world_size=D, device="cpu")))
    if name == "caps":
        assert r["caps"]["max_neighbors"] != cfg.max_neighbors


def test_break_melt_mechanisms_fired(systems, ranks):
    """Over the three intervals: forward events, restricted growth and
    dissociations (each channel's count), lambda fading on the broken
    ends, and more bonds gone than the dissociations broke (the cuts)."""
    cfg, spec, st, _ = systems["break"]
    s = ranks["break"][0]["state"]
    counts = s["reaction_counts"]
    assert (counts > 0).all(), counts
    assert ((s["lam"] < 1.0) & s["active"]).any()
    n_bonds = int((s["bonds"]["idx"][:, 0] >= 0).sum())
    diss = spec.r_is_diss.numpy()
    assert n_bonds < int(st.bonds.valid.sum()) + int(counts[~diss].sum()) \
        - int(counts[diss].sum()), "no bond was cut"


def test_release_melt_mechanisms_fired(systems, ranks):
    """Across the interval: events, each releasing its host's dummy (the
    dummy takes the target type RA) and joining the captured ML in the
    same constraint row, ATRP flips, ChangeParticleType flips and
    FreezeRegion removals."""
    cfg, spec, st, _ = systems["release"]
    s = ranks["release"][0]["state"]
    assert int(s["reaction_counts"].sum()) > 0
    assert (s["fixd_dummy"] != st.fixd_dummy.numpy()).sum() > 0
    ra = 5      # RA, the release's target type
    assert (s["type_id"] == ra).sum() > (st.type_id.numpy() == ra).sum()
    assert int(s["atrp_stats"].sum()) > 0
    assert int(s["freeze_count"]) > int(st.freeze_count)
    assert (s["active"] != st.active.numpy()).any()
    changed = s["type_id"] != st.type_id.numpy()
    assert changed.sum() > int(s["reaction_counts"].sum())


def test_caps_stay_legal_for_k1f(systems, ranks):
    """The regrown and shrunk caps keep K1's grid (cap a multiple of 8)
    and the x-layers the 3 ranks cut."""
    cfg = systems["caps"][0]
    for r in ranks["caps"]:
        caps = r["caps"]
        assert caps["cell_cap"] % 8 == 0
        moved = dataclasses.replace(cfg, **caps, mesh=SlabMesh(
            rank=0, world_size=D, device="cpu"))
        assert cell_pair_halo.supports(moved)


def test_row_block_of_every_rank_covers_the_rows():
    for n, d in ((256, 3), (10, 4), (7, 7)):
        blocks = [integrate.pair_forces.row_block(n, d, r) for r in range(d)]
        assert blocks[0][0] == 0 and blocks[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        assert max(h - l for l, h in blocks) - min(h - l
                                                   for l, h in blocks) <= 1


def test_row_path_forces_energies_and_virial(systems, ranks):
    """The row melt on 3 ranks, each its block of rows: forces bit for
    bit, energies to 1e-6 relative, the virial pressure to 1e-5."""
    cfg, spec, st, _ = systems["rows"]
    assert not cfg.use_pallas
    f, e, _ = integrate.compute_forces(spec, cfg, st)
    p = float(integrate.virial_pressure(spec, cfg, st))
    res = ranks["row_forces"]
    for r in res:
        print("rows on %d ranks: max|dF| %.3e, P %.9g (one rank %.9g), "
              "energies %s (one rank %s)" % (
                  D, np.abs(r["force"] - f.numpy()).max(), float(r["P"]), p,
                  {k: float(v) for k, v in r["energies"].items()},
                  {k: float(v) for k, v in e.items()}))
        assert r["force"].tobytes() == f.numpy().tobytes()
        for k in ("lj", "lj-tab", "coulomb"):
            assert float(r["energies"][k]) == pytest.approx(
                float(e[k]), rel=1e-6), k
            assert r["energies"][k].tobytes() == \
                res[0]["energies"][k].tobytes()
        assert float(r["P"]) == pytest.approx(p, rel=1e-5, abs=1e-6)
        assert r["P"].tobytes() == res[0]["P"].tobytes()
        assert sum(r["launches"].values()) == 0


def test_row_path_block(systems, ranks):
    """A reactive block on the rows (rebuilds and func-14 births
    replicated): the replicas agree at its end (``run_block``'s check),
    the integer state equals one rank's, and so do the positions, bit for
    bit (the forces are)."""
    cfg, spec, st, kw = systems["rows"]
    _, one = _one_rank(cfg, spec, st, **kw)
    for r in ranks["rows"]:
        s = r["state"]
        for k in ("type_id", "chem_state", "active", "reaction_counts"):
            assert np.array_equal(s[k], getattr(one, k).numpy()), k
        assert np.array_equal(s["bonds"]["idx"], one.bonds.idx.numpy())
        assert np.array_equal(s["nbr"]["idx"], one.nbr.idx.numpy())
        assert np.array_equal(s["nbr"]["birth"], one.nbr.birth.numpy())
        assert s["pos"].tobytes() == one.pos.numpy().tobytes()
    assert int(one.nbr.n_rebuilds) > int(st.nbr.n_rebuilds)


@pytest.mark.parametrize("field", ["lam", "birth"])
def test_replica_check_names_a_widened_field(ranks, field):
    name = {"lam": "lam", "birth": "nbr.birth"}[field]
    for r in ranks[field]:
        assert r["error"] is not None and \
            "first in %s " % name in r["error"], r["error"]


def test_set_last_keeps_the_last_write_of_a_repeated_row():
    """``topo.set_last`` (the batched neighbour transfer's write, where two
    events' level sets may share a particle) equals a sequential scatter:
    the last write of a repeated row wins, the sentinel row is dropped,
    values broadcast, and 2-D rows are written whole."""
    from chemlab_tpu_torch.engine import topo

    rng = np.random.RandomState(3)
    arr = torch.from_numpy(rng.randn(9).astype(np.float32))
    dest = torch.from_numpy(rng.randint(0, 10, (4, 6)))     # 9 = dropped
    vals = torch.from_numpy(rng.randn(4, 6).astype(np.float32))
    want = arr.clone()
    for d, v in zip(dest.reshape(-1).tolist(), vals.reshape(-1).tolist()):
        if d < 9:
            want[d] = v
    assert torch.equal(topo.set_last(arr, dest, vals), want)
    assert torch.equal(topo.set_last(arr, dest, 7.0),
                       torch.where(torch.isin(torch.arange(9), dest), 7.0,
                                   arr))
    rows = torch.zeros((5, 3))
    got = topo.set_last(rows, torch.tensor([1, 4, 1, 5]),
                        torch.arange(12.0).reshape(4, 3))
    assert torch.equal(got[1], torch.tensor([6.0, 7.0, 8.0]))
    assert torch.equal(got[4], torch.tensor([3.0, 4.0, 5.0]))
    assert got[[0, 2, 3]].abs().sum() == 0
