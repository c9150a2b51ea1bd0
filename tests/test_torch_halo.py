"""The slab decomposition (K1f through ``engine.cell_pair_halo``) against
the reference's halo path and against the port's own one-rank path.

Reference side: ``chemlab_tpu.engine.pallas_halo`` on the 4-device virtual
CPU mesh of ``conftest.py``, its kernel in interpret mode, on the fixture
of ``tests/test_halo.py`` (200 trimers, density 0.27, 4 x-layers).  Port
side: D = 2 and D = 4 ranks of a gloo process group on the CPU, started by
``parallel.launch`` (fresh interpreters that import no jax, one intra-op
thread each, a file store in a temporary directory), each holding the
whole state and running the plain K1f on its slab.

Tolerances.  Against the port's one-rank path the D-rank forces and a
reactive block are exact: each particle's force is nonzero on one rank
only and K1f's rows are K1's rows; the pair energy and the pressure, sums
of D partial sums, are held to the reference's own bounds for its slab
path against its one-device path (``test_halo.py``: 1e-6 and 1e-5
relative).  Against the reference's slab path the energy and pressure
keep those bounds too, but the forces take the port's bound against the
reference, ``2e-5 * (1 + max|F_all|)`` (``test_torch_step.py``): the two
kernels sum each slot's terms in another order, and the excluded pairs'
large terms sit in the all-pairs sum before the correction cancels them,
so the rounding scales with the all-pairs forces, not with the net force.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import neighbor as rnb
from chemlab_tpu.engine import pallas_halo, runner as rrun
from chemlab_tpu.parallel import make_mesh as r_make_mesh
from chemlab_tpu.parallel import meshed_cfg as r_meshed_cfg
from chemlab_tpu.parallel import shard_state as r_shard_state
from chemlab_tpu.parallel import shard_system as r_shard_system
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import (cell_pair, cell_pair_halo, integrate,
                                      neighbor, runner)
from chemlab_tpu_torch.parallel import SlabMesh, launch, meshed_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread here as in the ranks: the tensors are small and
    pytest-xdist workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def melt():
    built, _, _ = rts.build_melt(n_mols=200, density=0.27, reactive=False,
                                 seed=9, use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=50)
    return built, st


@pytest.fixture(scope="module")
def reference_halo(melt):
    """The reference's halo compute_forces and virial_pressure on the
    4-device mesh."""
    built, st = melt
    mesh = r_make_mesh(4)
    cfg = r_meshed_cfg(built.cfg, mesh)
    assert pallas_halo.supports(cfg)
    spec, _ = r_shard_system(built, mesh)
    st_s = r_shard_state(mesh, st)
    f, e, _ = jax.jit(lambda s: rint.compute_forces(spec, cfg, s))(st_s)
    p = jax.jit(lambda s: rint.virial_pressure(spec, cfg, s))(st_s)
    return np.asarray(f), float(e["lj"]), float(p)


@pytest.fixture(scope="module")
def port_one_rank(melt):
    built, st = melt
    cfg, spec, state = bridge.from_trees(built.cfg, built.spec, st, "cpu")
    f, e, _ = integrate.compute_forces(spec, cfg, state)
    p = integrate.virial_pressure(spec, cfg, state)
    return (cfg, spec, state), f.numpy(), float(e["lj"]), float(p)


def _force_tol(cfg, spec, st):
    f_all = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
    return 2e-5 * (1.0 + f_all.abs().max().item())


@pytest.fixture(scope="module")
def ranks(melt, tmp_path_factory):
    """compute_forces and virial_pressure on D = 2 and D = 4 gloo ranks,
    then the modules each rank imported."""
    built, st = melt
    system = bridge.to_numpy(*bridge.from_trees(built.cfg, built.spec, st,
                                                "cpu"))
    out = {}
    for d in (2, 4):
        forces, mods = launch.run_jobs(
            [("forces", dict(system=system)), ("imported_modules", {})], d,
            tmp_path_factory.mktemp("store%d" % d), backend="gloo",
            device="cpu", timeout=300)
        out[d] = forces, mods
    return out


@pytest.mark.parametrize("d", [2, 4])
def test_slab_forces_match_reference_and_one_rank(ranks, reference_halo,
                                                  port_one_rank, d):
    f_ref = reference_halo[0]
    system, f_one = port_one_rank[:2]
    tol = _force_tol(*system)
    for r in ranks[d][0]:
        print("D = %d: max|F - F_reference halo| %.3e (tol %.3e)"
              % (d, np.abs(r["force"] - f_ref).max(), tol))
        np.testing.assert_allclose(r["force"], f_ref, rtol=0, atol=tol)
        assert np.array_equal(r["force"], f_one)
        assert r["force"].tobytes() == ranks[d][0][0]["force"].tobytes()


@pytest.mark.parametrize("d", [2, 4])
def test_slab_energy_and_pressure_match_reference(ranks, reference_halo,
                                                  port_one_rank, d):
    _, e_ref, p_ref = reference_halo
    _, _, e_one, p_one = port_one_rank
    res = ranks[d][0]
    for r in res:
        print("D = %d: e_lj %.9g (reference halo %.9g, one rank %.9g), P "
              "%.9g (%.9g, %.9g)" % (d, float(r["e_lj"]), e_ref, e_one,
                                     float(r["P"]), p_ref, p_one))
        assert float(r["e_lj"]) == pytest.approx(e_ref, rel=1e-6)
        assert float(r["e_lj"]) == pytest.approx(e_one, rel=1e-6)
        assert float(r["P"]) == pytest.approx(p_ref, rel=1e-5, abs=1e-6)
        assert float(r["P"]) == pytest.approx(p_one, rel=1e-5, abs=1e-6)
        # every rank returns the same bits
        for k in ("e_lj", "e_tab", "P"):
            assert r[k].tobytes() == res[0][k].tobytes(), k


@pytest.mark.parametrize("d", [2, 4])
def test_ranks_import_no_jax(ranks, d):
    assert [m["modules"] for m in ranks[d][1]] == [[]] * d


def test_reactive_block_on_four_ranks_matches_one_rank(tmp_path):
    """A reactive run_block across a reaction interval (started as in
    ``test_halo.py``'s reactive test) on 4 ranks: positions, bond table,
    reaction counts and n_excl equal the one-rank run's exactly, the
    replica check passes at the block's end, and events fired."""
    built, systop, _ = pts.build_melt(n_mols=200, density=0.27,
                                      reactive=True, seed=9, max_events=16,
                                      device="cpu")
    spec, cfg = built.spec, built.cfg
    assert cfg.cell_dims[0] % 4 == 0
    st = runner.initial_forces(spec, cfg, built.state)
    st = pts.warmup(built, st, steps=50)
    st = pts.activate_initiators(built, systop, st, n=6)
    st = dataclasses.replace(st, step=torch.tensor(
        cfg.reaction_interval - 2, dtype=torch.int32))
    a = runner.run_block(spec, cfg, st, 5,
                         gen=runner.make_generator(11, "cpu"))
    (res,) = launch.run_jobs(
        [("run_blocks", dict(system=bridge.to_numpy(cfg, spec, st),
                             n_blocks=1, block_steps=5, seed=11))], 4,
        tmp_path, backend="gloo", device="cpu", timeout=300)
    assert int(a.reaction_counts.sum()) > 0, \
        "the fixture must fire a reaction for the test to bite"
    for b in res:
        assert np.array_equal(a.pos.numpy(), b["pos"])
        assert np.array_equal(a.bonds.idx.numpy(), b["bonds_idx"])
        assert np.array_equal(a.reaction_counts.numpy(),
                              b["reaction_counts"])
        assert int(a.n_excl) == int(b["n_excl"])


def test_replica_check_raises_on_one_ulp(melt, tmp_path):
    built, st = melt
    system = bridge.to_numpy(*bridge.from_trees(built.cfg, built.spec, st,
                                                "cpu"))
    def check(**kw):
        return launch.run_jobs([("check_replicas", dict(system=system,
                                                        **kw))],
                               2, tmp_path, backend="gloo", device="cpu",
                               timeout=300)[0]

    assert check() == [{}, {}]
    with pytest.raises(RuntimeError, match="replicas .* differ, first in "
                                           "pos "):
        check(perturb_rank=1)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + k + ".")
        else:
            yield path + k, v


def test_slab_build_is_leaf_for_leaf_equal():
    """``slab_devices=4`` rounds the x-layer count down as the reference
    does (``test_halo.py``'s 320-trimer build).  Bit equality of every leaf
    but the build-time K-nearest rows, compared row by row as sets (see
    ``test_torch_bridge.py``: a tie of a trimer's two ends can order
    differently there)."""
    rb, _, _ = rts.build_melt(n_mols=320, density=0.27, reactive=False,
                              use_pallas=True, slab_devices=4)
    pb, _, _ = pts.build_melt(n_mols=320, density=0.27, reactive=False,
                              slab_devices=4, device="cpu")
    # 5 layers a side without the rounding
    assert pb.cfg.cell_dims == (4, 5, 5)
    assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(pb.cfg)
    for part in ("spec", "state"):
        ref = dict(_leaves(bridge.tree_to_numpy(getattr(rb, part))))
        got = dict(_leaves(bridge.tree_to_numpy(getattr(pb, part))))
        ref.pop("key", None)
        assert sorted(ref) == sorted(got)
        rows = []
        for tree in (ref, got):
            idx, mask = tree.pop("nbr.idx", None), tree.pop("nbr.excl_mask",
                                                             None)
            rows.append(None if idx is None else [
                sorted(zip(i.tolist(), m.tolist()))
                for i, m in zip(idx, mask)])
        assert rows[0] == rows[1]
        for p, r in ref.items():
            g = got[p]
            if r is None or g is None:
                assert r is None and g is None, p
                continue
            assert g.dtype == r.dtype and g.shape == r.shape, p
            assert g.tobytes() == r.tobytes(), p


def test_supports_and_the_grids_the_slab_path_refuses(port_one_rank):
    (cfg, spec, st), _, _, _ = port_one_rank
    assert cfg.cell_dims == (4, 4, 4) and cfg.cell_cap % 8 == 0

    def on(world, dims=cfg.cell_dims, cap=cfg.cell_cap):
        return dataclasses.replace(
            cfg, cell_dims=dims, cell_cap=cap,
            mesh=SlabMesh(rank=0, world_size=world, device="cpu"))

    assert not cell_pair_halo.supports(cfg)           # no mesh
    assert not cell_pair_halo.supports(on(1))          # one rank
    assert not cell_pair_halo.supports(on(3))          # 3 does not cut 4
    assert cell_pair_halo.supports(on(2)) and cell_pair_halo.supports(on(4))
    assert not cell_pair_halo.supports(on(2, dims=(2, 4, 4)))
    assert meshed_cfg(cfg, on(2).mesh).mesh.world_size == 2
    # the slab path raises on a grid K1 cannot take
    for dims, cap in (((4, 4, 4), 36), ((4, 2, 4), 32), ((4, 4, 2), 32)):
        buckets, _, _, slot_of = neighbor.build_cell_buckets(
            st.pos, st.box, st.active, dims, cap)
        with pytest.raises(ValueError, match="needs a K1 grid"):
            cell_pair_halo.cell_pair_forces_halo(
                st.pos, st.type_id, st.active, st.box, buckets, slot_of,
                dims, spec, cfg.n_types, on(2).mesh)


def test_reference_halo_double_counts_a_two_layer_grid(melt,
                                                        port_one_rank):
    """The reference's slab path on 2 x-layers and 2 devices: each slab's
    two halo layers are one and the same layer, and the 27-cell stencil
    counts its pairs twice; ``pallas_halo.supports`` does not refuse such
    a grid.  Held to a float64 direct sum over all pairs, the reference is
    off by far more than rounding, while the port's one-rank path on the
    same grid (K2, the deduplicated stencil) agrees; the port's
    ``supports`` refuses the grid (ROADMAP, Queue 3)."""
    built, st = melt
    (cfg, spec, pst), _, _, _ = port_one_rank
    dims, cap = (2, 4, 4), 48
    b, _, ovf, _ = rnb.build_cell_buckets(st.pos, st.box, st.active, dims,
                                          cap)
    assert not bool(ovf)
    f_ref, e_ref, _, _ = jax.jit(
        lambda pos: pallas_halo.cell_pair_forces_halo(
            pos, st.type_id, st.active, st.box, b, dims, built.spec,
            built.cfg.n_types, cap, r_make_mesh(2), interpret=True,
            uniform_lj=built.cfg.uniform_lj, all_lj=built.cfg.all_lj))(st.pos)
    # float64 direct sum of the uniform LJ pair force, soft core included
    pos = np.asarray(st.pos, np.float64)
    box = np.asarray(st.box, np.float64)
    act = np.asarray(st.active)
    sig, eps, cut2, shift = (float(np.asarray(a)[0]) for a in (
        built.spec.pair_sig, built.spec.pair_eps, built.spec.pair_cutoff2,
        built.spec.pair_shift))
    d = pos[:, None, :] - pos[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d * d).sum(-1)
    m = act[:, None] & act[None, :] & (r2 > 1e-12) & (r2 < cut2)
    r2c = np.maximum(np.where(m, r2, 1.0), 0.5625 * sig * sig)
    s6 = (sig * sig / r2c) ** 3
    f = np.where(m, 48.0 * eps * (s6 * s6 - 0.5 * s6) / r2c, 0.0)
    f_direct = (f[:, :, None] * d).sum(1)
    e_direct = 0.5 * np.where(m, 4.0 * eps * (s6 * s6 - s6) - shift,
                              0.0).sum()
    tol = 2e-5 * (1.0 + np.abs(f_direct).max())
    err_ref = np.abs(np.asarray(f_ref) - f_direct).max()
    buckets, _, _, slot_of = neighbor.build_cell_buckets(
        pst.pos, pst.box, pst.active, dims, cap)
    f_port, e_port, _, _ = cell_pair.cell_pair_forces(
        pst.pos, pst.type_id, pst.active, pst.box, buckets, slot_of, dims,
        spec, cfg.n_types, uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)
    print("2 x-layers, 2 slabs: max|F - direct| reference %.4g, port %.4g "
          "(tol %.3g); E_lj reference %.6f, port %.6f, direct %.6f"
          % (err_ref, np.abs(f_port.numpy() - f_direct).max(), tol,
             float(e_ref), float(e_port), e_direct))
    assert err_ref > 100 * tol
    assert abs(float(e_ref) - e_direct) > 1e-3 * abs(e_direct)
    np.testing.assert_allclose(f_port.numpy(), f_direct, rtol=0, atol=tol)
    assert float(e_port) == pytest.approx(e_direct, rel=1e-5)
    cfg2 = dataclasses.replace(cfg, cell_dims=dims, cell_cap=cap, mesh=(
        SlabMesh(rank=0, world_size=2, device="cpu")))
    assert not cell_pair_halo.supports(cfg2)
