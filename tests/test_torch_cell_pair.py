"""K1 (cell-tile LJ) and the excluded-pair correction: port vs reference.

The reference runs its Pallas colt2 kernel in interpret mode on the CPU;
the port runs the kernel's plain torch version (what the K1 wrapper uses
for CPU tensors).  Both sum the same per-pair f32 terms in different
orders, so forces agree to f32 rounding of a sum: the tolerance is
``2e-5 * (1 + max|F|)`` (f32 eps ~1.2e-7 times a few hundred terms per
particle, with margin).  Energies and virials are sums over ~10^5 pairs
in another order: ``1e-5`` relative (the f32 reordering error of such a
sum is ~1e-7 relative).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import excl_dense as r_excl_dense
from chemlab_tpu.engine import pallas_pair, runner
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import cell_pair, excl_dense, neighbor
from chemlab_tpu_torch.engine.spec import PAIR_LJ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(rcfg, rspec, rstate):
    return bridge.from_trees(rcfg, rspec, rstate, "cpu")


@pytest.fixture(scope="module")
def melt():
    built, _, _ = rts.build_melt(n_mols=70, reactive=True, use_pallas=True)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=50, chunk=50)
    return built.cfg, built.spec, st


def _mixed_spec(cfg, spec_np, islj_gate: bool):
    """Per-type-pair sigma/epsilon (symmetric), optionally one non-LJ type
    pair, so the general lookup path is exercised."""
    T = cfg.n_types
    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (T, T)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (T, T)).astype(np.float32)
    out = dict(spec_np)
    out["pair_sig"] = ((s + s.T) / 2).reshape(-1)
    out["pair_eps"] = ((e + e.T) / 2).reshape(-1)
    kind = np.full((T, T), PAIR_LJ, np.int32)
    if islj_gate:
        kind[0, 1] = kind[1, 0] = 0       # MA-ML pairs: no LJ
    out["pair_kind"] = kind.reshape(-1)
    return out


MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
CH3 = [(True, False), (False, False), (False, True)]    # (energy, virial)


@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
@pytest.mark.parametrize("want_energy,want_virial", CH3,
                         ids=["energy", "none", "virial"])
def test_k1_plain_matches_colt2_interpret(melt, uniform, all_lj,
                                          want_energy, want_virial):
    rcfg, rspec, rst = melt
    cfg, spec, st = _port(rcfg, rspec, rst)
    if not uniform:
        spec_np = _mixed_spec(rcfg, bridge.tree_to_numpy(rspec), not all_lj)
        rspec = dataclasses.replace(
            rspec, **{k: jnp.asarray(spec_np[k])
                      for k in ("pair_sig", "pair_eps", "pair_kind")})
        spec = dataclasses.replace(
            spec, **{k: torch.from_numpy(spec_np[k])
                     for k in ("pair_sig", "pair_eps", "pair_kind")})
    f_r, e_r, _, w_r = pallas_pair.cell_pair_forces_colt(
        rst.pos, rst.type_id, rst.active, rst.box, rst.nbr.buckets,
        rcfg.cell_dims, rspec, rcfg.n_types, rcfg.cell_cap, interpret=True,
        uniform_lj=uniform, slot_of=rst.nbr.slot_of, want_virial=want_virial,
        want_energy=want_energy, all_lj=all_lj)
    f_p, e_p, _, w_p = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types, uniform_lj=uniform,
        all_lj=all_lj, want_energy=want_energy, want_virial=want_virial)
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all()
    tol = 2e-5 * (1.0 + np.abs(f_r).max())
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0, atol=tol)
    s3_r, s3_p = (float(w_r), float(w_p)) if want_virial else \
        (float(e_r), float(e_p))
    if want_energy or want_virial:
        assert s3_r != 0.0
        assert abs(s3_p - s3_r) <= 1e-5 * (1.0 + abs(s3_r)), (s3_p, s3_r)
    else:
        assert s3_p == 0.0 and s3_r == 0.0


def test_flat_and_dense_corrections_match_reference(melt):
    rcfg, rspec, rst = melt
    cfg, spec, st = _port(rcfg, rspec, rst)
    ref_flat = pallas_pair.excluded_pair_correction(
        rspec, rcfg.n_types, rst.pos, rst.box, rst.type_id, rst.excl,
        active=rst.active, has_tab=False)
    ref_dense = r_excl_dense.correction(
        rspec, rcfg, rst.pos, rst.box, rst.type_id, rst.excl_masks,
        rst.excl_irr, active=rst.active, has_tab=False)
    flat = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, st.pos, st.box, st.type_id, st.excl,
        active=st.active)
    dense = excl_dense.correction(spec, cfg, st.pos, st.box, st.type_id,
                                  st.excl_masks, st.excl_irr,
                                  active=st.active)
    for ref, got in ((ref_flat, flat), (ref_dense, dense)):
        f_r = np.asarray(ref[0])
        tol = 1e-5 * (1.0 + np.abs(f_r).max())
        np.testing.assert_allclose(got[0].numpy(), f_r, rtol=0, atol=tol)
        for k in (1, 3):     # e_lj, virial
            assert abs(float(got[k]) - float(ref[k])) \
                <= 1e-5 * (1.0 + abs(float(ref[k])))
    # the two legs of the port agree with each other too
    np.testing.assert_allclose(dense[0].numpy(), flat[0].numpy(), rtol=0,
                               atol=1e-5 * (1.0 + flat[0].abs().max().item()))


def _lj_np(r2, sig, eps, shift):
    """float64 soft-cored LJ (F/r, E) for the direct-sum check."""
    r2c = np.maximum(r2, 0.5625 * sig * sig)
    s6 = (sig * sig / r2c) ** 3
    return 48.0 * eps * (s6 * s6 - 0.5 * s6) / r2c, \
        4.0 * eps * (s6 * s6 - s6) - shift


def test_cancellation_of_excluded_pair_at_short_range(melt):
    """An excluded (bonded) pair pushed to r = 0.05 sigma: all-pairs minus
    correction stays finite, equals the reference's, and equals a float64
    direct sum over the non-excluded pairs."""
    rcfg, rspec, rst = melt
    cfg, spec, st = _port(rcfg, rspec, rst)
    excl = st.excl.numpy()
    i, j = (int(x) for x in excl[0])
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, st.box, st.active, cfg.cell_dims, cfg.cell_cap)
    assert not bool(ovf)
    f_all, e_all, _, _ = cell_pair.cell_pair_forces(
        pos, st.type_id, st.active, st.box, buckets, slot_of, cfg.cell_dims,
        spec, cfg.n_types, uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)
    f_ex, e_ex, _, _ = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, st.box, st.type_id, st.excl, active=st.active)
    f_port = (f_all - f_ex).numpy()
    assert np.isfinite(f_port).all()

    rpos = jnp.asarray(pos.numpy())
    rbk = jnp.asarray(buckets.numpy())
    rslot = jnp.asarray(slot_of.numpy())
    rf_all, re_all, _, _ = pallas_pair.cell_pair_forces_colt(
        rpos, rst.type_id, rst.active, rst.box, rbk, rcfg.cell_dims, rspec,
        rcfg.n_types, rcfg.cell_cap, interpret=True, uniform_lj=True,
        slot_of=rslot, all_lj=True)
    rf_ex, re_ex, _, _ = pallas_pair.excluded_pair_correction(
        rspec, rcfg.n_types, rpos, rst.box, rst.type_id, rst.excl,
        active=rst.active, has_tab=False)
    f_ref = np.asarray(rf_all - rf_ex)
    # the clamped excluded-pair term (~2.4e3 eps/sigma x 0.05 sigma) sits in
    # both f32 sums before it cancels, so rounding noise scales with it
    big = max(np.abs(f_ref).max(), f_ex.abs().max().item())
    np.testing.assert_allclose(f_port, f_ref, rtol=0, atol=2e-5 * (1.0 + big))

    # float64 direct sum over non-excluded pairs for the two endpoints
    p = pos.numpy().astype(np.float64)
    box = st.box.numpy().astype(np.float64)
    act = st.active.numpy()
    ex = {(min(a, b), max(a, b)) for a, b in excl if a >= 0}
    sig = float(spec.pair_sig[0]); eps = float(spec.pair_eps[0])
    cut2 = float(spec.pair_cutoff2[0]); shift = float(spec.pair_shift[0])
    for a in (i, j):
        d = p[a] - p
        d -= box * np.round(d / box)
        r2 = (d * d).sum(-1)
        keep = act & (np.arange(len(p)) != a) & (r2 < cut2)
        keep &= np.array([(min(a, b), max(a, b)) not in ex
                          for b in range(len(p))])
        fr, _ = _lj_np(r2[keep], sig, eps, shift)
        f_direct = (fr[:, None] * d[keep]).sum(0)
        assert np.abs(f_port[a] - f_direct).max() \
            <= 1e-3 * (1.0 + np.abs(f_direct).max()), (a, f_port[a], f_direct)


@pytest.mark.parametrize("irr_cap", [128, 4], ids=["fits", "overflows"])
def test_excl_dense_derive_matches_reference(melt, irr_cap):
    """Offset detection and the mask-plane / irregular split, integer for
    integer, with reaction-like irregular pairs appended to the chain list;
    an irregular capacity of 4 overflows and must say so on both sides."""
    rcfg, rspec, rst = melt
    excl = np.array(rst.excl)
    n_excl = int(rst.n_excl)
    excl[n_excl:n_excl + 6] = [[0, 9], [4, 30], [31, 12], [40, 41], [7, 3],
                               [50, 53]]
    offs = r_excl_dense.detect_offsets(excl)
    assert excl_dense.detect_offsets(excl) == offs == rcfg.excl_offsets
    n = rst.pos.shape[0]
    ref = r_excl_dense.derive(jnp.asarray(excl), n, offs, irr_cap)
    got = excl_dense.derive(torch.from_numpy(excl), n, offs, irr_cap)
    for name, r, g in zip(("masks", "irr", "overflow"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert bool(got[2]) == (irr_cap == 4)
