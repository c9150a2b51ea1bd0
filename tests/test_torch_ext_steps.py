"""The periodic extensions and the rescaling thermostats against the
reference, on the release melt (``testsystems.build_release_melt``:
ReleaseMolecule dummies, JoinMolecule, an ATRPActivator, ChangeParticleType
and a removing FreezeRegion) at 80 trimers, density 0.3.

Torch cannot reproduce threefry, so every draw is the reference's,
recomputed from its ``jax.random.split`` chain and injected: the ATRP
ranks and uniforms, ChangeParticleType's and FreezeRegion's uniforms, the
CSVR normal and the Langevin noise.  Under them ``atrp_step`` (both
``select_from_all`` modes), ``change_particle_type_step`` and
``freeze_region_step`` (prob, num, pct, and the removal with its topology
scrub) give the reference's types, states, pools, counters and tables
exactly; the rescaling thermostats' scale holds to ``1e-6`` relative; and
twenty Langevin ``step_with_extensions`` steps hold positions to ``1e-5``
and velocities to ``2e-4``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import cell_pair, integrate, runner
from chemlab_tpu_torch.engine import reactions as prx
from test_torch_bonded_tab import reference_trees
from test_torch_dissociation import assert_same_state, run_steps_both

N_MOLS, DENSITY, SEED = 80, 0.3, 3
FREEZE = dict(freeze_width=1.5, freeze_prob=0.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def release_builds():
    """The port's release melt (the build is held to the reference's in
    ``test_torch_ext_builds.py``)."""
    pb, psys, _ = pts.build_release_melt(n_mols=N_MOLS, density=DENSITY,
                                         seed=SEED, device="cpu",
                                         max_events=16, **FREEZE)
    return pb, psys


@pytest.fixture(scope="module")
def warm(release_builds):
    pb, psys = release_builds
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    st = pts.warmup(pb, st, steps=20)
    return pts.activate_initiators(pb, psys, st, n=16)


def _centres(spec, cfg, st):
    c = torch.zeros_like(st.active)
    for e in range(cfg.n_atrp):
        c |= (st.type_id == spec.atrp_type[e]) \
            & (st.chem_state == spec.atrp_state[e])
    return int((c & st.active).sum())


@pytest.mark.parametrize("select_from_all", [False, True])
def test_atrp_step_equal(release_builds, warm, select_from_all):
    """200 samples over the 16 FA centres (or over every particle): the
    flips, the shifted pools and the counters equal the reference's."""
    pb, _ = release_builds
    spec = pb.spec
    cfg = dataclasses.replace(pb.cfg, atrp_select_from_all=select_from_all,
                              atrp_num=200 if not select_from_all else 600)
    rcfg, rspec, rst = reference_trees(cfg, spec, warm, 11)
    _, k1, k2 = jax.random.split(rst.key, 3)
    hi = cfg.n_particles if select_from_all else _centres(spec, cfg, warm)
    draws = (np.asarray(jax.random.randint(k1, (cfg.atrp_num,), 0, hi)),
             np.asarray(jax.random.uniform(k2, (cfg.atrp_num,))))
    r_out = jax.jit(rrx.atrp_step, static_argnums=(1,))(rspec, rcfg, rst)
    p_out = prx.atrp_step(spec, cfg, warm, draws=draws)
    assert_same_state(r_out, p_out)
    for name in ("atrp_ratios", "mass", "q"):
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    # every centre starts in state 3, so these are activations
    assert int(p_out.atrp_stats[0]) > 0


def test_change_particle_type_equal(release_builds, warm):
    pb, _ = release_builds
    cfg, spec = pb.cfg, pb.spec
    rcfg, rspec, rst = reference_trees(cfg, spec, warm, 12)
    _, sub = jax.random.split(rst.key)
    u = np.asarray(jax.random.uniform(sub, (warm.pos.shape[0],)))
    r_out = jax.jit(rrx.change_particle_type_step, static_argnums=(1,))(
        rspec, rcfg, rst)
    p_out = prx.change_particle_type_step(spec, cfg, warm, u=u)
    assert_same_state(r_out, p_out)
    for name in ("mass", "q"):
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)))
    assert int((p_out.type_id != warm.type_id).sum()) == cfg.cpt_num


@pytest.mark.parametrize("mode", ["prob", "num", "pct", "remove"])
def test_freeze_region_step_equal(release_builds, warm, mode):
    """Each mode on the 1.5-wide x faces: frozen particles take the final
    type with zero velocity and force; with removal the particles leave
    and every table, the adjacency, the exclusions and the dense operands
    are scrubbed of them."""
    pb, _ = release_builds
    cfg, spec = pb.cfg, pb.spec
    if mode == "remove":
        assert bool(spec.fr_remove)
    else:
        spec = dataclasses.replace(spec, fr_remove=torch.tensor(False),
                                   fr_p_num=torch.tensor(3,
                                                         dtype=torch.int32),
                                   fr_p_pct=torch.tensor(0.3))
        cfg = dataclasses.replace(cfg, freeze_mode=mode)
    rcfg, rspec, rst = reference_trees(cfg, spec, warm, 13)
    _, sub = jax.random.split(rst.key)
    u = np.asarray(jax.random.uniform(sub, (warm.pos.shape[0],)))
    r_out = jax.jit(rrx.freeze_region_step, static_argnums=(1,))(
        rspec, rcfg, rst)
    p_out = prx.freeze_region_step(spec, cfg, warm, u=u)
    assert_same_state(r_out, p_out)
    np.testing.assert_array_equal(p_out.force.numpy(),
                                  np.asarray(r_out.force))
    hit = int(p_out.freeze_count)
    assert hit > 0
    if mode == "num":
        assert hit == 3
    if mode == "remove":
        dead = torch.nonzero(warm.active & ~p_out.active).flatten()
        assert dead.numel() == hit
        for t in ("bonds", "angles", "bonds_irr", "angles_irr"):
            assert not torch.isin(getattr(p_out, t).idx, dead).any(), t
        assert not torch.isin(p_out.adj, dead).any()
        assert not torch.isin(p_out.excl, dead).any()


@pytest.mark.parametrize("thermostat", ["vr", "br", "iso"])
def test_rescale_thermostat_scale(release_builds, warm, thermostat):
    pb, _ = release_builds
    spec = pb.spec
    cfg = dataclasses.replace(pb.cfg, thermostat=thermostat, iso_coupling=3)
    rng = np.random.RandomState(5)
    st = dataclasses.replace(warm, vel=warm.vel * 1.3, step=torch.full_like(
        warm.step, 9))
    rcfg, rspec, rst = reference_trees(cfg, spec, st, 14)
    key = jax.random.PRNGKey(int(rng.randint(1 << 30)))
    r = jax.random.normal(key, ())
    r_out = jax.jit(rint._rescale_thermostat, static_argnums=(1,))(
        rspec, rcfg, rst, key)
    p_out = integrate._rescale_thermostat(spec, cfg, st,
                                          torch.tensor(np.asarray(r)))
    sel = (st.active & spec.thermal_type_mask[st.type_id.long()]).numpy()
    v0 = st.vel.numpy()[sel]
    s_ref = np.asarray(r_out.vel)[sel] / v0
    s_got = p_out.vel.numpy()[sel] / v0
    ref = float(np.median(s_ref))
    assert ref != 1.0
    np.testing.assert_allclose(s_got, ref, rtol=1e-6)
    np.testing.assert_allclose(s_ref, ref, rtol=1e-6)
    assert np.array_equal(p_out.vel.numpy()[~sel], st.vel.numpy()[~sel])


def test_twenty_langevin_steps_equal(release_builds, warm):
    """Steps 1-20 from warm: the Langevin noise, two ATRP steps, two
    ChangeParticleType steps and twenty FreezeRegion steps, FixDistances
    and the dynamic resolution every step, all under the reference's
    draws.  The ATRP centres stay the same particles over the run (flips
    go between the two centre states), so their count, which the
    reference's rank draw reads, is the warm state's."""
    pb, _ = release_builds
    cfg, spec = pb.cfg, pb.spec
    n_c = _centres(spec, cfg, warm)
    r_out, p_out = run_steps_both(cfg, spec, warm, 20, atrp_count=n_c)
    assert _centres(spec, cfg, p_out) == n_c
    assert int(p_out.atrp_stats.sum()) > 0
    assert int((p_out.type_id != warm.type_id).sum()) > 0
    assert_same_state(r_out, p_out, floats=(), pos_tol=1e-5)
    np.testing.assert_allclose(p_out.lam.numpy(), np.asarray(r_out.lam),
                               rtol=0, atol=1e-6)


def test_k1_forces_do_not_read_lambda(release_builds, warm):
    """Particle lambda scales pair forces only for nonbonded funcs 11 and
    15, which run on the row path: on K1 it is only the dynamic
    resolution's clock, and the forces are the same bits for any lambda."""
    pb, _ = release_builds
    cfg, spec = pb.cfg, pb.spec
    assert cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims)
    f1, e1, _ = integrate.compute_forces(spec, cfg, warm)
    lam = torch.from_numpy(np.random.RandomState(2).uniform(
        size=warm.lam.shape).astype(np.float32))
    f2, e2, _ = integrate.compute_forces(spec, cfg, dataclasses.replace(
        warm, lam=lam))
    assert torch.equal(f1, f2)
    assert all(torch.equal(e1[k], e2[k]) for k in e1)
