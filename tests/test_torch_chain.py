"""The step-growth chain melt against the reference: the build leaf for
leaf, the forces and the pressure, a checkpoint with dihedrals, and the
lambda ramp of reaction-created dihedrals.

Both packages build the same text (``testsystems.chain_topology_text``:
40 E-B-B-E tetramers, func-8 bonds and angles, Ryckaert-Bellemans
dihedrals with 1-4 pairs, the E + E -> F:F link) from the same
coordinates and tables; the reference through its own ``topfile``,
``topology`` and ``build``.  Every leaf must be bit-equal, except the
build-time K-nearest rows, compared row by row as sets (the reference's
XLA CPU build contracts ``d2 += d * d`` into a fused multiply-add;
``test_torch_bridge.py`` says more).  The warmed state (the port's
descent, then the same arrays in both packages) gives forces within
``2e-5 * (1 + max|F|)``, energies within ``2e-5 * (1 + |E|)`` per term,
and the virial within ``2e-5 * (1 + |W_pair| + |W_bonded|)``.  Reaction
steps, checkpoints and the ramp are compared bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import checkpoint as rckpt
from chemlab_tpu import reaction_parser as rrp
from chemlab_tpu import topfile as rtopfile
from chemlab_tpu.engine import build as rbuild
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu.topology import compile_system_topology
from chemlab_tpu_torch import bridge, checkpoint
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import bonded_forces, integrate, observables
from chemlab_tpu_torch.engine import reactions as prx
from chemlab_tpu_torch.engine import runner
from test_torch_bonded_tab import reference_trees
from test_torch_bridge import _assert_bit_equal, _sorted_rows

N_MOLS = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _builds(table_dir, **opts):
    pb, _, _ = pts.build_chain_melt(n_mols=N_MOLS, device="cpu",
                                    table_dir=table_dir, **opts)
    systop = compile_system_topology(rtopfile.parse_lines(
        pts.chain_topology_text(N_MOLS).splitlines(), "<chain>"))
    rb = rbuild.build_system(
        systop, pts.chain_coordinates(N_MOLS, 0.27, seed=42),
        rbuild.SimOptions(**pts.chain_options(table_dir=table_dir,
                                              use_pallas=True, **opts)),
        reaction_config=rrp.parse_config_lines(
            pts.CHAIN_CFG_TEXT.splitlines()))
    return rb, pb


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("chain_tables"))
    pts.write_chain_tables(d)
    return d


@pytest.fixture(scope="module")
def builds(tables):
    return _builds(tables, t_hybrid_dihedral=4)


@pytest.fixture(scope="module")
def warm(builds):
    """The port's warmed state with reactions on and boosted rates (every
    link within the cutoff is accepted), at a reaction step."""
    _, pb = builds
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    st = pts.warmup(pb, st, steps=20)
    return dataclasses.replace(
        st, step=torch.full_like(st.step, 200),
        reactions_on=torch.ones((), dtype=torch.bool),
        reaction_rates=st.reaction_rates * 2.5)


@pytest.mark.parametrize("part", ["config", "spec", "state"])
def test_chain_build_is_leaf_for_leaf_equal(builds, part):
    rb, pb = builds
    cfg = pb.cfg
    assert not cfg.rx_compact and cfg.lazy_rows
    assert cfg.dihedral_funcs == (1, 3, 8, 12) and cfg.pair14_cap == 128
    assert cfg.bond_funcs == (1, 8) and cfg.angle_funcs == (1, 8)
    assert pb.term_names == rb.term_names
    if part == "config":
        assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(cfg)
        return
    ref = bridge.tree_to_numpy(getattr(rb, part))
    got = bridge.tree_to_numpy(getattr(pb, part))
    # the bridge carries every new leaf of the reference's build across
    moved = bridge.from_trees(rb.cfg, rb.spec, rb.state, "cpu")
    _assert_bit_equal(ref, bridge.tree_to_numpy(
        moved[1 if part == "spec" else 2]))
    if part == "state":
        rows = []
        for tree in (ref, got):
            nbr = dict(tree["nbr"])
            rows.append(_sorted_rows(nbr.pop("idx"), nbr.pop("excl_mask")))
            tree["nbr"] = nbr
        assert rows[0] == rows[1]
        assert int(got["dihedrals"]["count"]) == N_MOLS
        assert int(got["pairs14"]["count"]) == N_MOLS
    _assert_bit_equal(ref, got)


def test_chain_forces_and_pressure_match(builds, warm):
    rb, pb = builds
    cfg, spec = pb.cfg, pb.spec
    rcfg, rspec, rst = reference_trees(cfg, spec, warm)
    (f_r, e_r, _), p_r = jax.jit(lambda s: (
        rint.compute_forces(rspec, rcfg, s),
        rint.virial_pressure(rspec, rcfg, s)))(rst)
    f_p, e_p, _ = integrate.compute_forces(spec, cfg, warm)
    assert sorted(e_r) == sorted(e_p)
    for k in e_r:
        r, g = float(e_r[k]), float(e_p[k])
        assert abs(g - r) <= 2e-5 * (1.0 + abs(r)), (k, g, r)
    f_r = np.asarray(f_r)
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_r).max()))
    # the observable pass (the CLI's energy rows) reports every term
    m = runner.measure(spec, cfg, warm)
    for k in pb.term_names + ["lj14", "coulomb14"]:
        assert float(m[k]) == float(e_p[k]), k
    p_p = float(integrate.virial_pressure(spec, cfg, warm))
    w_bond = -float(bonded_forces.bonded_strain_derivative(
        spec, cfg, warm.pos, warm.box, warm.type_id, warm.q, warm.bonds,
        warm.angles, warm.dihedrals, warm.pairs14,
        dense=integrate._dense_of(cfg, warm)))
    vol = float(np.prod(np.asarray(rst.box, np.float64)))
    ekin = float(observables.kinetic_energy(warm.mass, warm.vel,
                                            warm.active))
    w_ref = 3.0 * vol * float(p_r) - 2.0 * ekin
    w_port = 3.0 * vol * p_p - 2.0 * ekin
    w_pair = w_port - w_bond
    assert w_bond != 0.0
    assert abs(w_port - w_ref) <= 2e-5 * (1.0 + abs(w_pair) + abs(w_bond)), \
        (w_port, w_ref, w_pair, w_bond)


def test_created_dihedral_lambda_ramp(builds, warm):
    """Reaction-created dihedrals start at lambda 0 under
    ``t_hybrid_dihedral`` and ramp by 1/4 a step to 1, bit for bit with
    the reference; the static ones stay at 1."""
    rb, pb = builds
    cfg, spec = pb.cfg, pb.spec
    rcfg, rspec, rst = reference_trees(cfg, spec, warm)
    p = prx.reaction_step(spec, cfg, warm, 0)
    r = jax.jit(lambda s: rrx.reaction_step(rspec, rcfg, s, 0))(rst)
    n0 = int(warm.dihedrals.count)
    new = slice(n0, int(p.dihedrals.count))
    assert new.stop > n0
    lam = p.dihedrals.lam
    assert (lam[new] == 0.0).all() and (lam[:n0] == 1.0).all()
    ramp_r = jax.jit(lambda s: rrun._hybrid_lambda_ramp(rspec, s, rcfg))
    for k in range(5):
        p = runner._hybrid_lambda_ramp(spec, p, cfg)
        r = ramp_r(r)
        np.testing.assert_array_equal(p.dihedrals.lam.numpy(),
                                      np.asarray(r.dihedrals.lam))
        assert float(p.dihedrals.lam[new].min()) == min(0.25 * (k + 1), 1.0)
    assert (p.dihedrals.lam[:n0] == 1.0).all()


def test_chain_checkpoint_round_trip(builds, warm, tmp_path):
    """A state with reaction-created dihedrals, saved by the port: the port
    restores every leaf into a fresh build, the reference restores the
    same dihedral and 1-4 tables."""
    rb, pb = builds
    st = runner._fire_reactions(pb.spec, pb.cfg, warm, 0)
    assert int(st.dihedrals.count) > N_MOLS
    path = str(tmp_path / "chain.npz")
    checkpoint.save_state(path, st, cfg=pb.cfg, rng_seed=42)
    got, cfg2 = checkpoint.load_state(path, pb.state, cfg=pb.cfg,
                                      spec=pb.spec)
    assert cfg2 == pb.cfg
    _assert_bit_equal(bridge.tree_to_numpy(st), bridge.tree_to_numpy(got))
    ref, _ = rckpt.load_state(path, rb.state, cfg=rb.cfg, spec=rb.spec)
    for t in ("dihedrals", "pairs14"):
        _assert_bit_equal(bridge.tree_to_numpy(getattr(ref, t)),
                          bridge.tree_to_numpy(getattr(st, t)))
