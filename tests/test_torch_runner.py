"""Run blocks: 40 NVE steps with a reaction step every 10, port vs
reference, and the ``measure`` / ``measure_cheap`` dicts.

Both sides start from one state (the 70-trimer melt, warmed, 20 initiators
on, reaction rates raised so that every reaction step fires).  NVE keeps
the reference's threefry noise out of the comparison.  The reference runs
the whole block as one jitted ``fori_loop`` with ``lax.cond`` gates; the
port loops on the host.  Tolerances:
  - positions ``1e-5``, velocities ``2e-4`` absolute: f32 force rounding
    (``2e-5`` of the pre-correction pair sum per step) integrated over 40
    steps of dt 0.0025;
  - integers (events, topology tables, images, buckets) exactly, since the
    reaction decisions see positions equal to far below any margin;
  - measured energies and temperature ``1e-4`` relative (sums over the
    slightly different positions), counters exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import runner as prun

N_STEPS = 40
INTERVAL = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blocks():
    built, systop, _ = rts.build_melt(n_mols=70, reactive=True,
                                      use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=50, chunk=50)
    st = rts.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    rcfg = dataclasses.replace(built.cfg, thermostat="no",
                               reaction_interval=INTERVAL)
    rspec = built.spec
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, st, "cpu")
    r_out = rrun.run_block(rspec, rcfg, st, N_STEPS)
    p_out = prun.run_block(spec, cfg, pst, N_STEPS)
    return (rcfg, rspec, r_out), (cfg, spec, p_out), st


def test_run_block_matches(blocks):
    (_, _, r), (_, _, p), st0 = blocks
    assert int(p.step) == int(r.step) == N_STEPS
    assert int(np.asarray(r.reaction_counts).sum()) > \
        int(np.asarray(st0.reaction_counts).sum())
    np.testing.assert_allclose(p.pos.numpy(), np.asarray(r.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(p.vel.numpy(), np.asarray(r.vel), rtol=0,
                               atol=2e-4)
    for name in ("image", "type_id", "chem_state", "mol_id", "adj", "excl",
                 "n_excl", "reaction_counts", "intra_counts", "ev_log_a",
                 "ev_log_b", "ev_log_r", "ev_log_step", "excl_masks",
                 "excl_irr"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(r, name)),
                                      err_msg=name)
    for t in ("bonds", "angles", "bonds_dense", "bonds_irr", "angles_dense",
              "angles_irr"):
        ref = bridge.tree_to_numpy(getattr(r, t))
        got = bridge.tree_to_numpy(getattr(p, t))
        for k in ref:
            if got[k].dtype.kind == "f":
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6,
                                           err_msg="%s.%s" % (t, k))
            else:
                np.testing.assert_array_equal(got[k], ref[k],
                                              err_msg="%s.%s" % (t, k))
    for name in ("buckets", "slot_of", "n_rebuilds", "overflow"):
        np.testing.assert_array_equal(getattr(p.nbr, name).numpy(),
                                      np.asarray(getattr(r.nbr, name)),
                                      err_msg=name)
    assert not bool(p.nbr.overflow)


@pytest.mark.parametrize("which", ["measure", "measure_cheap"])
def test_measure_dicts_match(blocks, which):
    (rcfg, rspec, r), (cfg, spec, p), _ = blocks
    m_r = jax.jit(lambda s: getattr(rrun, which)(rspec, rcfg, s))(r)
    m_p = getattr(prun, which)(spec, cfg, p)
    assert sorted(m_p) == sorted(m_r)
    for k, v in m_r.items():
        v = np.asarray(v)
        g = m_p[k].numpy()
        assert g.shape == v.shape, k
        if v.dtype.kind == "f":
            np.testing.assert_allclose(g, v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)


def test_step_with_extensions_reads_the_gate(blocks):
    """Without a host gate, the step reads ``reactions_on`` and the step
    count from the state: at a multiple of the interval it fires."""
    _, (cfg, spec, p), _ = blocks
    before = int(p.reaction_counts.sum())
    out = prun.step_with_extensions(
        spec, cfg, dataclasses.replace(p, step=p.step + INTERVAL - 1))
    assert int(out.step) % INTERVAL == 0
    assert int(out.ev_log_step) == int(out.step)
    assert int(out.reaction_counts.sum()) >= before
    off = prun.step_with_extensions(
        spec, cfg, dataclasses.replace(
            p, step=p.step + INTERVAL - 1,
            reactions_on=torch.zeros_like(p.reactions_on)))
    assert int(off.ev_log_step) == int(p.ev_log_step)
