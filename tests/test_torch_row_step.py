"""Steps, the virial and reactions on the row path against the reference.

On the row melt (``testsystems.build_row_melt`` at 70 trimers: funcs 8,
13-17, LJ and Coulomb between charges on the persistent rows):

- twenty NVE ``md_step`` steps at a skin small enough that the rows are
  rebuilt (func-14 births carried across) hold positions to 1e-4;
- the row-path ``virial_pressure`` (W = -dU/ds by autograd) holds W to
  ``2e-5 (1 + |W|)``, also with capped pairs exactly at and inside their
  cap radius; a few Berendsen (``br``) NPT steps hold positions and
  the box to 1e-4;
- ``reaction_step`` on the persistent rows, compact (the row melt) and
  full-row (the chain melt built with ``use_pallas=False``), gives the
  reference's event lists, refreshed exclusion mask, types and charges
  exactly;
- ``runner.measure``'s ``pair_scale`` (func-14 pairs in the rows) equals
  the reference's.

The reference runs compiled (op by op its autograd passes take tens of
seconds).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import integrate, runner
from chemlab_tpu_torch.engine import reactions as prx
from test_torch_bonded_tab import chain_melt, reference_trees

N_ROW = 70

_ref_md_step = jax.jit(rint.md_step, static_argnums=(1,))
_ref_virial = jax.jit(rint.virial_pressure, static_argnums=(1,))
_ref_reaction = jax.jit(rrx.reaction_step, static_argnums=(1,))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def row(tmp_path_factory):
    """The NVE row melt after a short descent, 10 initiators active."""
    d = str(tmp_path_factory.mktemp("rowstep"))
    pts.write_row_tables(d)
    pb, systop, _ = pts.build_row_melt(n_mols=N_ROW, device="cpu",
                                       table_dir=d, thermostat="no")
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    st = pts.warmup(pb, st, steps=30)
    return pb, pts.activate_initiators(pb, systop, st, n=10), d


def _w(spec, cfg, st, p):
    """The virial W from a pressure P = (2 Ekin + W) / 3V."""
    ekin = float(0.5 * torch.sum(torch.where(
        st.active, st.mass * torch.sum(st.vel * st.vel, -1), 0.0)))
    return float(p) * 3.0 * float(torch.prod(st.box)) - 2.0 * ekin


def _assert_virial_matches(cfg, spec, st):
    p = integrate.virial_pressure(spec, cfg, st)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    p_ref = _ref_virial(rspec, rcfg, rst)
    w, w_ref = _w(spec, cfg, st, p), _w(spec, cfg, st, p_ref)
    assert np.isfinite(w) and np.isfinite(w_ref)
    assert abs(w - w_ref) <= 2e-5 * (1.0 + abs(w_ref)), (w, w_ref)
    return w


def test_twenty_nve_steps_match_reference(row):
    pb, st, _ = row
    cfg = pb.cfg
    assert cfg.thermostat == "no" and not cfg.lazy_rows and cfg.has_pps
    # a skin of 0.05 rebuilds the rows every few steps
    spec = dataclasses.replace(pb.spec, skin=torch.tensor(0.05))
    st = dataclasses.replace(st, reactions_on=torch.zeros((), dtype=bool),
                             step=torch.tensor(30, dtype=torch.int32))
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    for _ in range(20):
        st = integrate.md_step(spec, cfg, st)
        rst = _ref_md_step(rspec, rcfg, rst)
    assert int(st.nbr.n_rebuilds) == int(rst.nbr.n_rebuilds) > 3
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st.vel.numpy(), np.asarray(rst.vel), rtol=0,
                               atol=1e-3)
    birth = {(i, j): b for i, (row_j, row_b) in enumerate(zip(
        st.nbr.idx.tolist(), st.nbr.birth.tolist()))
        for j, b in zip(row_j, row_b) if j != i and i < cfg.n_particles}
    ref = {(i, j): b for i, (row_j, row_b) in enumerate(zip(
        np.asarray(rst.nbr.idx).tolist(), np.asarray(rst.nbr.birth).tolist()))
        for j, b in zip(row_j, row_b) if j != i and i < cfg.n_particles}
    assert birth == ref and max(birth.values()) > 30


def pin_pairs(spec, cfg, st, pairs):
    """``st`` with each (a, b, type a, type b, offset, (y, z)) pair's
    types set and its particles at x = 0 and x = offset, the rows
    rebuilt.  An offset that is a float32 value makes the pair's r equal
    it exactly (sqrt of a rounded square returns the value)."""
    pos, tid = st.pos.clone(), st.type_id.clone()
    for a, b, ta, tb, off, (y, z) in pairs:
        tid[a], tid[b] = ta, tb
        pos[a] = torch.tensor((0.0, y, z))
        pos[b] = torch.tensor((off, y, z))
    st = dataclasses.replace(st, pos=pos, type_id=tid)
    return integrate.maybe_rebuild_neighbors(spec, cfg, st, force=True)


@pytest.mark.parametrize("where", ["warm", "at_the_caps"])
def test_row_virial_matches_reference(row, where):
    """At the warm state, and with capped pairs placed exactly at their cap
    radius (PL-PL func 16 and ML-PL func 13, caprad 0.8) and inside it:
    autograd through ``maximum(r, caprad)`` at the tie splits the gradient
    as ``jnp.maximum``'s does, and nothing turns NaN."""
    pb, st, _ = row
    if where == "at_the_caps":
        sym = pb.systop.atomsym_atomtype
        pl, ml = sym["PL"], sym["ML"]
        cap = float(np.float32(pts.ROW_CAPRAD))
        st = pin_pairs(pb.spec, pb.cfg, st, [
            (1, 4, pl, pl, cap, (2.0, 2.0)), (61, 64, ml, pl, cap, (6.0, 6.0)),
            (121, 124, pl, pl, 0.5, (10.0, 10.0))])
        d = st.pos[4] - st.pos[1]
        assert float(torch.sqrt(torch.sum(d * d))) == cap
    assert _assert_virial_matches(pb.cfg, pb.spec, st) != 0.0


def test_a_few_berendsen_steps_match_reference(row):
    pb, st, d = row
    bb, _, _ = pts.build_row_melt(n_mols=N_ROW, device="cpu", table_dir=d,
                                  thermostat="no", barostat="br",
                                  pressure=0.15, barostat_tau=2.0)
    cfg, spec = bb.cfg, bb.spec
    assert cfg.barostat == "br" and not cfg.use_pallas
    st = dataclasses.replace(
        bb.state, pos=st.pos, vel=st.vel,
        reactions_on=torch.zeros((), dtype=bool))
    st = integrate.maybe_rebuild_neighbors(spec, cfg, st, force=True)
    st = runner.initial_forces(spec, cfg, st)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    for _ in range(3):
        st = integrate.md_step(spec, cfg, st)
        rst = _ref_md_step(rspec, rcfg, rst)
    assert not torch.equal(st.box, bb.state.box)
    np.testing.assert_allclose(st.box.numpy(), np.asarray(rst.box), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-4)


def _reaction_both(cfg, spec, st):
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    return (_ref_reaction(rspec, rcfg, rst, 0),
            prx.reaction_step(spec, cfg, st, 0))


@pytest.fixture(scope="module")
def chain_rows(tmp_path_factory):
    built, _ = chain_melt(tmp_path_factory.mktemp("chain_rows"),
                          use_pallas=False)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, pts.warmup(built, st, steps=10)


@pytest.mark.parametrize("kind", ["compact", "full"])
def test_reaction_step_on_rows_matches_reference(kind, row, chain_rows):
    if kind == "compact":
        pb, st, _ = row
        scale = 5.0
    else:
        pb, st = chain_rows
        scale = 2.5
    cfg, spec = pb.cfg, pb.spec
    assert not cfg.lazy_rows and cfg.rx_compact == (kind == "compact")
    st = dataclasses.replace(
        st, step=torch.full_like(st.step, 200),
        reactions_on=torch.ones((), dtype=torch.bool),
        reaction_rates=st.reaction_rates * scale)
    r_out, p_out = _reaction_both(cfg, spec, st)
    n_ev = int((p_out.ev_log_a >= 0).sum())
    assert n_ev > 0
    for name in ("ev_log_a", "ev_log_b", "ev_log_r", "type_id",
                 "chem_state", "q", "n_excl", "excl"):
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    for name in ("idx", "excl_mask", "overflow"):
        np.testing.assert_array_equal(
            getattr(p_out.nbr, name).numpy(),
            np.asarray(getattr(r_out.nbr, name)), err_msg=name)
    ref = bridge.tree_to_numpy(r_out.bonds)
    got = bridge.tree_to_numpy(p_out.bonds)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the refreshed mask now excludes every new bond's pair in both rows
    assert int(p_out.nbr.excl_mask.sum()) > int(st.nbr.excl_mask.sum())
    if kind == "compact":
        # an event gives each product its type's charge
        changed = p_out.type_id != st.type_id
        assert bool(changed.any())
        assert torch.equal(p_out.q[changed],
                           spec.type_q[p_out.type_id[changed].long()])


def test_measure_pair_scale_matches_reference(row):
    pb, st, _ = row
    cfg, spec = pb.cfg, pb.spec
    got = runner.measure(spec, cfg, st)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    ref = rrun.measure(rspec, rcfg, rst)
    assert int(got["pair_scale"]) == int(ref["pair_scale"]) > 0
    for k in ("lj", "lj-tab", "coulomb"):
        r = float(ref[k])
        assert abs(float(got[k]) - r) <= 2e-5 * (1.0 + abs(r)), k


def test_row_virial_ignores_the_pps_ramp_as_the_reference_does(row):
    """The reference's row-path virial evaluates the pairs without its
    config, so the func-14 ramp that scales the forces does not scale W:
    W is the same at any age of the pairs (ROADMAP Queue 3).  The port
    keeps it (``test_row_virial_matches_reference``)."""
    pb, st, _ = row
    cfg, spec = pb.cfg, pb.spec
    young = dataclasses.replace(st, step=torch.tensor(2, dtype=torch.int32))
    old = dataclasses.replace(st, step=torch.tensor(10 ** 6,
                                                    dtype=torch.int32))
    f_young, _, _ = integrate.compute_forces(spec, cfg, young)
    f_old, _, _ = integrate.compute_forces(spec, cfg, old)
    assert not torch.equal(f_young, f_old)
    assert torch.equal(integrate.virial_pressure(spec, cfg, young),
                       integrate.virial_pressure(spec, cfg, old))
