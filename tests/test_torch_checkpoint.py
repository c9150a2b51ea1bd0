"""Checkpoints: the reference's ``.npz`` format read and written by the
port, both ways, and a port resume that continues bit for bit.

The reference's MDState has one leaf more than the port's, its first: the
threefry ``key``.  The port writes ``PRNGKey(rng_seed)`` there and skips
it on reading; its own noise stream (the ``torch.Generator``) is stored
under ``__torch_rng__`` and restored by ``load_state``.  States: the
reference's build of the 70-trimer reactive melt with 20 initiators on,
and the port's build of it, warmed by the port, with the same initiators;
the port continues it under Langevin noise from a generator, so that a
resume that lost the generator's state would differ.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import checkpoint as rckpt
from chemlab_tpu import testsystems as rts
from chemlab_tpu_torch import bridge, checkpoint
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, runner

SEED = 42


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reactive(pkg, built, systop, st):
    st = pkg.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    return dataclasses.replace(built.cfg, reaction_interval=10), st


@pytest.fixture(scope="module")
def melt():
    rb, systop, _ = rts.build_melt(n_mols=70, reactive=True,
                                   use_pallas=True)
    rcfg, rst = _reactive(rts, rb, systop, rb.state)
    pb, psys, _ = pts.build_melt(n_mols=70, reactive=True, device="cpu")
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    cfg, st = _reactive(pts, pb, psys, pts.warmup(pb, st, steps=50))
    return (rb, rcfg, rst), (cfg, pb.spec, st)


def _fresh_port(cfg, **kw):
    built, _, _ = pts.build_melt(n_mols=70, reactive=True, device="cpu",
                                 **kw)
    return dataclasses.replace(built.cfg, reaction_interval=10), \
        built.spec, built.state


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + k + ".")
        else:
            yield path + k, v


def _assert_same(ref, got, skip=("key",)):
    r = {p: v for p, v in _leaves(bridge.tree_to_numpy(ref))
         if p not in skip}
    g = dict(_leaves(bridge.tree_to_numpy(got)))
    assert sorted(r) == sorted(g)
    for p, v in r.items():
        if v is None:
            assert g[p] is None, p
            continue
        assert g[p].dtype == v.dtype, p
        np.testing.assert_array_equal(g[p], v, err_msg=p)


def test_reference_checkpoint_loads_into_the_port(melt, tmp_path):
    (rb, rcfg, rst), (cfg, _, _) = melt
    path = str(tmp_path / "ref.npz")
    rckpt.save_state(path, rst, cfg=rcfg)
    pcfg, pspec, template = _fresh_port(cfg)
    st, cfg2 = checkpoint.load_state(path, template, cfg=pcfg, spec=pspec)
    assert cfg2 == pcfg
    _assert_same(rst, st)


def test_port_checkpoint_loads_into_the_reference(melt, tmp_path):
    (rb, rcfg, _), (cfg, spec, st) = melt
    st = runner.run_block(spec, cfg, st, 20,
                          gen=runner.make_generator(1, "cpu"))
    assert int(st.reaction_counts.sum()) > 0
    path = str(tmp_path / "port.npz")
    checkpoint.save_state(path, st, cfg=cfg, rng_seed=SEED)
    rst, rcfg2 = rckpt.load_state(path, rb.state, cfg=rcfg, spec=rb.spec)
    assert rcfg2 == rcfg
    np.testing.assert_array_equal(np.asarray(rst.key),
                                  np.asarray(jax.random.PRNGKey(SEED)))
    _assert_same(rst, st)


def _continue(spec, cfg, st, gen, steps=20):
    return runner.run_block(spec, cfg, st, steps, gen=gen)


def _assert_bits(a, b):
    for name in ("pos", "vel", "force", "image", "type_id", "excl",
                 "reaction_counts"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.bonds.idx, b.bonds.idx)
    assert int(a.step) == int(b.step)


def test_port_roundtrip_continues_bit_exact(melt, tmp_path):
    _, (cfg, spec, st) = melt
    gen = runner.make_generator(3, "cpu")
    st = _continue(spec, cfg, st, gen, 10)
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, st, cfg=cfg, gen=gen, rng_seed=SEED)
    pcfg, pspec, template = _fresh_port(cfg)
    gen2 = runner.make_generator(99, "cpu")
    st2, cfg2 = checkpoint.load_state(path, template, cfg=pcfg, spec=pspec,
                                      gen=gen2)
    assert cfg2 == cfg
    a = _continue(spec, cfg, st, gen)     # crosses two reaction steps
    b = _continue(spec, cfg2, st2, gen2)
    assert int(a.reaction_counts.sum()) > int(st.reaction_counts.sum())
    _assert_bits(a, b)


@pytest.mark.parametrize("grow", ["neighbor", "term"])
def test_port_checkpoint_restores_after_cap_regrowth(melt, tmp_path, grow):
    """Written after a regrowth, a checkpoint restores into a fresh build
    (the build's smaller caps) and continues bit for bit."""
    _, (cfg, spec, st) = melt
    gen = runner.make_generator(4, "cpu")
    st = _continue(spec, cfg, st, gen, 10)
    if grow == "neighbor":
        cfg_big, st_big = build.grow_neighbor_caps(cfg, spec, st)
    else:
        cfg_big, st_big = build.grow_term_caps(cfg, st)
    path = str(tmp_path / "state_big.npz")
    checkpoint.save_state(path, st_big, cfg=cfg_big, gen=gen)
    pcfg, pspec, template = _fresh_port(cfg)
    gen2 = runner.make_generator(0, "cpu")
    st2, cfg2 = checkpoint.load_state(path, template, cfg=pcfg, spec=pspec,
                                      gen=gen2)
    assert cfg2 == cfg_big
    assert st2.excl.shape == st_big.excl.shape
    _assert_bits(_continue(spec, cfg_big, st_big, gen),
                 _continue(pspec, cfg2, st2, gen2))


def test_checkpoint_portable_across_bonded_dense_flag(melt, tmp_path):
    """The derived operands are stripped on save and re-derived on load: a
    dense-on checkpoint restores into a dense-off build and back."""
    _, (cfg, spec, st) = melt
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, st, cfg=cfg)
    off_cfg, off_spec, off_t = _fresh_port(cfg, bonded_dense=False)
    st_off, _ = checkpoint.load_state(path, off_t, cfg=off_cfg,
                                      spec=off_spec)
    assert st_off.bonds_dense is None
    assert torch.equal(st_off.bonds.idx, st.bonds.idx)
    assert torch.equal(st_off.pos, st.pos)
    on_cfg, on_spec, on_t = _fresh_port(cfg)
    st_on, _ = checkpoint.load_state(path, on_t, cfg=on_cfg, spec=on_spec)
    assert torch.equal(st_on.bonds_dense.idx, st.bonds_dense.idx)
    assert torch.equal(st_on.excl_masks, st.excl_masks)


def test_leaf_count_mismatch_raises(melt, tmp_path):
    _, (cfg, spec, st) = melt
    path = str(tmp_path / "bad.npz")
    np.savez(path, __n__=np.asarray(3), leaf_0=np.zeros(2, np.uint32))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(path, st, cfg=cfg, spec=spec)


def test_release_melt_roundtrip_continues_bit_exact(tmp_path):
    """The release melt (dummies appended after the real particles, live
    FixDistances rows, ATRP pools, a FreezeRegion) round-trips: restored
    into a fresh build with its generator, 30 more steps (the ATRP,
    ChangeParticleType and FreezeRegion steps drawing from the generator)
    give the same bits as the run that wrote it."""
    def fresh():
        built, psys, _ = pts.build_release_melt(
            n_mols=40, density=0.3, seed=3, device="cpu", freeze_width=1.0,
            freeze_prob=0.05)
        return built, psys

    pb, psys = fresh()
    cfg, spec = pb.cfg, pb.spec
    st = pts.activate_initiators(pb, psys, runner.initial_forces(
        spec, cfg, pb.state), n=8)
    gen = runner.make_generator(5, "cpu")
    st = _continue(spec, cfg, st, gen, 10)
    assert cfg.n_particles > 3 * 40 and int((st.fixd_host >= 0).sum()) > 0
    assert int(st.atrp_stats.sum()) > 0
    path = str(tmp_path / "release.npz")
    checkpoint.save_state(path, st, cfg=cfg, gen=gen, rng_seed=SEED)
    template = fresh()[0]
    gen2 = runner.make_generator(0, "cpu")
    st2, cfg2 = checkpoint.load_state(path, template.state, cfg=template.cfg,
                                      spec=template.spec, gen=gen2)
    assert cfg2 == cfg
    a = _continue(spec, cfg, st, gen, 30)
    b = _continue(template.spec, cfg2, st2, gen2, 30)
    _assert_bits(a, b)
    for name in ("fixd_host", "fixd_dummy", "lam", "atrp_ratios",
                 "atrp_stats", "freeze_count", "active", "chem_state"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(a.atrp_stats.sum()) > int(st.atrp_stats.sum())
