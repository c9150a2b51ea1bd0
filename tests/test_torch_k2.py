"""K2 (the per-cell LJ pair kernel for grids colt2 cannot take): port vs
reference.

The reference runs its Pallas ``_kernel`` in interpret mode on the CPU
(``pallas_pair.cell_pair_forces`` routes there when ``cap % 8 != 0`` or a
grid axis has fewer than 3 cells); the port runs the kernel's plain torch
version (what the K2 wrapper uses for CPU tensors).  Two grids:

  - the 70-trimer melt at ``cell_cap=36``: 3x3x3 cells, the full S = 27
    stencil, a cap that is not a multiple of 8;
  - the 40-trimer melt at density 0.3 (the reference's NPT test system):
    2x2x2 cells, where the offsets -1 and +1 name the same cell, so the
    deduplicated stencil has S = 8.

Tolerances: forces ``2e-5 * (1 + max|F_ref|)`` (per-slot f32 sums of a few
hundred terms in another order); energies and virials ``1e-5`` relative
(sums over ~10^4-10^5 pairs in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import pallas_pair
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import cell_pair
from chemlab_tpu_torch.engine import integrate as pint
from chemlab_tpu_torch.engine import neighbor
from chemlab_tpu_torch.engine.spec import PAIR_LJ


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_kernel_choice(monkeypatch):
    """The reference picks its kernel by grid unless a tuning variable
    overrides it; these tests need its default choice."""
    monkeypatch.delenv("CHEMLAB_KERNEL", raising=False)
    monkeypatch.delenv("CHEMLAB_PACKET", raising=False)


def _reference_melt(grid: str):
    if grid == "cap36":
        built, _, _ = rts.build_melt(n_mols=70, reactive=True,
                                     use_pallas=True, cell_cap=36)
    else:
        built, _, _ = rts.build_melt(n_mols=40, density=0.3, reactive=False,
                                     seed=3, use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=30, chunk=30)
    return built.cfg, built.spec, st


@pytest.fixture(scope="module")
def melts():
    out = {g: _reference_melt(g) for g in ("cap36", "grid222")}
    assert out["cap36"][0].cell_dims == (3, 3, 3)
    assert out["cap36"][0].cell_cap == 36
    assert out["grid222"][0].cell_dims == (2, 2, 2)
    return out


def _mixed_spec(cfg, spec_np):
    """Per-type-pair sigma/epsilon (symmetric) and one non-LJ type pair,
    so the lookup mode and its is-LJ gate are exercised."""
    T = cfg.n_types
    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (T, T)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (T, T)).astype(np.float32)
    out = dict(spec_np)
    out["pair_sig"] = ((s + s.T) / 2).reshape(-1)
    out["pair_eps"] = ((e + e.T) / 2).reshape(-1)
    kind = np.full((T, T), PAIR_LJ, np.int32)
    kind[0, 1] = kind[1, 0] = 0       # MA-ML pairs: no LJ
    out["pair_kind"] = kind.reshape(-1)
    return out


@pytest.mark.parametrize("dims", [(3, 3, 3), (2, 2, 2), (1, 2, 3),
                                  (2, 4, 5)])
def test_stencil_table_matches_reference(dims):
    got = cell_pair.stencil_table(dims)
    ref = pallas_pair.stencil_table(dims)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    # every cell's neighbours are distinct cells: no pair counted twice
    assert all(len(set(row)) == len(row) for row in got.tolist())
    assert got.shape[1] == min(3, dims[0]) * min(3, dims[1]) \
        * min(3, dims[2])


@pytest.mark.parametrize("grid", ["cap36", "grid222"])
@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "lookup"])
@pytest.mark.parametrize("want_virial", [False, True],
                         ids=["energy", "virial"])
def test_k2_plain_matches_reference(melts, grid, uniform, want_virial):
    rcfg, rspec, rst = melts[grid]
    assert not cell_pair.colt_legal(rcfg.cell_cap, rcfg.cell_dims)
    cfg, spec, st = bridge.from_trees(rcfg, rspec, rst, "cpu")
    if not uniform:
        spec_np = _mixed_spec(rcfg, bridge.tree_to_numpy(rspec))
        keys = ("pair_sig", "pair_eps", "pair_kind")
        rspec = dataclasses.replace(
            rspec, **{k: jnp.asarray(spec_np[k]) for k in keys})
        spec = dataclasses.replace(
            spec, **{k: torch.from_numpy(spec_np[k]) for k in keys})
    f_r, e_r, _, w_r = pallas_pair.cell_pair_forces(
        rst.pos, rst.type_id, rst.active, rst.box, rst.nbr.buckets,
        rcfg.cell_dims, rspec, rcfg.n_types, rcfg.cell_cap, interpret=True,
        uniform_lj=uniform, slot_of=rst.nbr.slot_of, want_virial=want_virial)
    n0 = cell_pair.K2.launches
    f_p, e_p, _, w_p = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types, uniform_lj=uniform,
        all_lj=False, want_virial=want_virial)
    assert cell_pair.K2.launches == n0      # the plain version on the CPU
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all() and np.abs(f_r).max() > 0
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_r).max()))
    s3_r, s3_p = (w_r, w_p) if want_virial else (e_r, e_p)
    assert float(s3_r) != 0.0
    assert abs(float(s3_p) - float(s3_r)) <= 1e-5 * (1.0 + abs(float(s3_r)))


def test_k2_plain_on_the_small_grid_equals_a_direct_sum(melts):
    """On the 2x2x2 grid the plain K2 equals a float64 all-pairs sum over
    minimum images: the deduplicated stencil counts each pair once."""
    rcfg, rspec, rst = melts["grid222"]
    cfg, spec, st = bridge.from_trees(rcfg, rspec, rst, "cpu")
    f_p, e_p, _, _ = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types, uniform_lj=True)
    act = st.active.numpy()
    p = st.pos.numpy()[act].astype(np.float64)
    box = st.box.numpy().astype(np.float64)
    sig, eps = float(spec.pair_sig[0]), float(spec.pair_eps[0])
    cut2, shift = float(spec.pair_cutoff2[0]), float(spec.pair_shift[0])
    d = p[:, None, :] - p[None, :, :]
    d -= box * np.round(d / box)
    r2 = (d * d).sum(-1)
    keep = (r2 < cut2) & ~np.eye(len(p), dtype=bool)
    r2c = np.maximum(np.where(keep, r2, 1.0), 0.5625 * sig * sig)
    s6 = (sig * sig / r2c) ** 3
    f = np.where(keep, 48.0 * eps * (s6 * s6 - 0.5 * s6) / r2c, 0.0)
    e = np.where(keep, 4.0 * eps * (s6 * s6 - s6) - shift, 0.0)
    f_direct = (f[..., None] * d).sum(1)
    np.testing.assert_allclose(f_p.numpy()[act], f_direct, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_direct).max()))
    assert abs(float(e_p) - 0.5 * e.sum()) <= 1e-5 * (1.0 + abs(e.sum()))


@pytest.mark.parametrize("grid", ["cap36", "grid222"])
def test_cancellation_of_excluded_pair_on_the_k2_path(melts, grid):
    """An excluded (bonded) pair pushed to r = 0.05 sigma: K2's all-pairs
    sum minus the correction stays finite and equals the reference's."""
    rcfg, rspec, rst = melts[grid]
    cfg, spec, st = bridge.from_trees(rcfg, rspec, rst, "cpu")
    i, j = (int(x) for x in st.excl[0])
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, st.box, st.active, cfg.cell_dims, cfg.cell_cap)
    assert not bool(ovf)
    f_all = cell_pair.cell_pair_forces(
        pos, st.type_id, st.active, st.box, buckets, slot_of, cfg.cell_dims,
        spec, cfg.n_types, uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, st.box, st.type_id, st.excl,
        active=st.active)[0]
    f_port = (f_all - f_ex).numpy()
    assert np.isfinite(f_port).all()

    rpos = jnp.asarray(pos.numpy())
    rf_all = pallas_pair.cell_pair_forces(
        rpos, rst.type_id, rst.active, rst.box, jnp.asarray(buckets.numpy()),
        rcfg.cell_dims, rspec, rcfg.n_types, rcfg.cell_cap, interpret=True,
        uniform_lj=True, slot_of=jnp.asarray(slot_of.numpy()))[0]
    rf_ex = pallas_pair.excluded_pair_correction(
        rspec, rcfg.n_types, rpos, rst.box, rst.type_id, rst.excl,
        active=rst.active, has_tab=False)[0]
    f_ref = np.asarray(rf_all - rf_ex)
    big = max(np.abs(f_ref).max(), f_ex.abs().max().item())
    assert big > 100.0
    np.testing.assert_allclose(f_port, f_ref, rtol=0, atol=2e-5 * (1.0 + big))


@pytest.mark.parametrize("grid", ["cap36", "grid222"])
def test_compute_forces_on_the_k2_path_matches(melts, grid):
    rcfg, rspec, rst = melts[grid]
    cfg, spec, st = bridge.from_trees(rcfg, rspec, rst, "cpu")
    f_r, e_r, _ = jax.jit(lambda s: rint.compute_forces(rspec, rcfg, s))(rst)
    f_p, e_p, _ = pint.compute_forces(spec, cfg, st)
    f_all = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_r), rtol=0,
                               atol=2e-5 * (1.0 + f_all.abs().max().item()))
    assert sorted(e_p) == sorted(e_r)
    for k in e_r:
        assert abs(float(e_p[k]) - float(e_r[k])) \
            <= 1e-5 * (1.0 + abs(float(e_r[k]))), k
    # the per-step pass (no pair-energy channel) gives the same forces
    f_0, _, _ = pint.compute_forces(spec, cfg, st, want_energy=False)
    torch.testing.assert_close(f_0, f_p, rtol=0, atol=0)


def test_dispatch_follows_the_reference_rule():
    """K1 when cap % 8 == 0 and every axis has at least 3 cells, else K2
    (``pallas_pair.py:844-847``); no other input decides."""
    assert cell_pair.colt_legal(32, (11, 11, 11))
    assert cell_pair.colt_legal(24, (3, 3, 3))
    assert not cell_pair.colt_legal(36, (11, 11, 11))
    assert not cell_pair.colt_legal(40, (2, 2, 2))
    assert not cell_pair.colt_legal(32, (3, 2, 3))
