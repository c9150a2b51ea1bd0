"""One force evaluation and 20 Langevin steps: port vs reference.

The reference runs its colt2 Pallas kernel in interpret mode on the CPU
(``integrate.py:77``); the port runs the kernel's plain torch version.  The
Langevin noise cannot be reproduced by torch, so the test draws the
reference's own noise from the same key split ``md_step`` makes and hands
it to the port's ``md_step``.

Tolerances:
  - forces: ``2e-5 * (1 + max|F_all|)`` with ``F_all`` the all-pairs sum
    before the excluded-pair correction: the excluded pairs' clamped terms
    sit in both f32 sums before they cancel, so the rounding scales with
    them, not with the net force;
  - energies: ``1e-5`` relative (f32 sums in another order);
  - after 20 steps: positions ``1e-5``, velocities ``2e-4`` absolute (the
    per-step force rounding above, integrated over 20 steps of dt 0.0025;
    measured 1e-6 and 1e-5, and the run is far too short for chaos to
    amplify them), forces as above.  Integers (images, buckets, rebuild
    count) must be equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import cell_pair
from chemlab_tpu_torch.engine import integrate as pint

N_STEPS = 20


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
    built, _, _ = rts.build_melt(n_mols=70, reactive=True, use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=50, chunk=50)
    return built.cfg, built.spec, st


def _force_tol(cfg, spec, st):
    f_all = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
    return 2e-5 * (1.0 + f_all.abs().max().item())


def test_compute_forces_matches(melt):
    rcfg, rspec, rst = melt
    cfg, spec, st = bridge.from_trees(rcfg, rspec, rst, "cpu")
    f_r, e_r, _ = jax.jit(lambda s: rint.compute_forces(rspec, rcfg, s))(rst)
    f_p, e_p, _ = pint.compute_forces(spec, cfg, st)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_r), rtol=0,
                               atol=_force_tol(cfg, spec, st))
    assert sorted(e_p) == sorted(e_r)
    for k in e_r:
        assert abs(float(e_p[k]) - float(e_r[k])) \
            <= 1e-5 * (1.0 + abs(float(e_r[k]))), k
    # per-step pass: no pair energy, same forces
    f_0, _, _ = pint.compute_forces(spec, cfg, st, want_energy=False)
    torch.testing.assert_close(f_0, f_p, rtol=0, atol=0)


def test_md_step_langevin_20_steps(melt):
    rcfg, rspec, rst = melt
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, rst, "cpu")
    step = jax.jit(lambda s: rint.md_step(rspec, rcfg, s))
    for _ in range(N_STEPS):
        _, sub = jax.random.split(rst.key)
        noise = jax.random.normal(sub, rst.vel.shape, rst.vel.dtype)
        rst = step(rst)
        pst = pint.md_step(spec, cfg, pst,
                           noise=torch.from_numpy(np.array(noise)))
    assert int(pst.step) == int(rst.step) == N_STEPS
    np.testing.assert_allclose(pst.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pst.vel.numpy(), np.asarray(rst.vel), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(pst.force.numpy(), np.asarray(rst.force),
                               rtol=0, atol=_force_tol(cfg, spec, pst))
    for name in ("image",):
        np.testing.assert_array_equal(getattr(pst, name).numpy(),
                                      np.asarray(getattr(rst, name)))
    for name in ("buckets", "slot_of", "n_rebuilds", "overflow"):
        np.testing.assert_array_equal(getattr(pst.nbr, name).numpy(),
                                      np.asarray(getattr(rst.nbr, name)),
                                      err_msg=name)
    assert int(pst.nbr.n_rebuilds) > 1


def test_langevin_needs_noise_or_generator(melt):
    rcfg, rspec, rst = melt
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, rst, "cpu")
    with pytest.raises(ValueError, match="Generator"):
        pint.md_step(spec, cfg, pst)
    gen = torch.Generator().manual_seed(5)
    a = pint.md_step(spec, cfg, pst, gen=gen)
    b = pint.md_step(spec, cfg, pst, gen=torch.Generator().manual_seed(5))
    torch.testing.assert_close(a.vel, b.vel, rtol=0, atol=0)
    nve = dataclasses.replace(cfg, thermostat="no")
    c = pint.md_step(spec, nve, pst)
    assert not torch.equal(a.vel, c.vel)
