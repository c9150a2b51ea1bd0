"""K1f, the pair kernel in ``x_halo`` mode, on one x-slab: the port's plain
version against the reference's colt2 kernel in interpret mode, and the
slabs of D ranks laid side by side against the full-grid K1.

A haloed slab is what ``cell_pair_halo`` gives a rank: the w + 2 x-layers
(r*w - 1) mod nx ... ((r+1)*w) mod nx of the bucket table, the reference's
``pallas_halo`` operand after its two ppermutes.  Both kernels return the
raw (w * ny * nz * cap, 4) slot rows of the w inner layers.  Tolerance
against the reference: ``2e-5 * (1 + max|ref|)``, as for K1 (per-slot sums
of a few hundred f32 terms taken in another order).  The port's slabs and
its full grid run one op sequence in one order, so they agree bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import observables as robs
from chemlab_tpu.engine import pallas_pair
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import cell_pair, cell_pair_halo, observables
from chemlab_tpu_torch.engine.spec import PAIR_LJ

MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
CH3 = [(True, False), (False, False), (False, True)]    # (energy, virial)
CHANNEL = {(True, False): cell_pair.CH3_ENERGY,
           (False, False): cell_pair.CH3_NONE,
           (False, True): cell_pair.CH3_VIRIAL}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _slab(cfg, state, n_ranks: int, rank: int):
    """The port's haloed slab operand of ``rank`` and its dims."""
    nx, ny, nz = cfg.cell_dims
    ids = cell_pair_halo.slab_cells(tuple(cfg.cell_dims), n_ranks, rank,
                                    state.pos.device)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(state.pos, state.type_id, state.active),
        state.nbr.buckets[ids], ids.numel())
    return cells, counts, (nx // n_ranks + 2, ny, nz), ids


def _reference_slab(buckets, ids):
    return jnp.asarray(np.asarray(buckets)[ids.numpy()])


def _close(got, ref):
    ref = np.asarray(ref)
    tol = 2e-5 * (1.0 + np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def lj():
    """The reference's slab fixture (200 trimers, 4 x-layers), unwarmed:
    both sides see the same operand."""
    built, _, _ = rts.build_melt(n_mols=200, density=0.27, reactive=False,
                                 seed=9, use_pallas=True)
    return built


def _mixed(rspec, spec, n_types, islj_gate):
    """Per-type-pair sigma/epsilon, optionally one non-LJ type pair, on
    both sides."""
    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (n_types, n_types)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (n_types, n_types)).astype(np.float32)
    kind = np.full((n_types, n_types), PAIR_LJ, np.int32)
    if islj_gate:
        kind[0, 1] = kind[1, 0] = 0
    cols = {"pair_sig": ((s + s.T) / 2).reshape(-1),
            "pair_eps": ((e + e.T) / 2).reshape(-1),
            "pair_kind": kind.reshape(-1)}
    return (dataclasses.replace(rspec, **{k: jnp.asarray(v)
                                          for k, v in cols.items()}),
            dataclasses.replace(spec, **{k: torch.from_numpy(v)
                                         for k, v in cols.items()}))


@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
@pytest.mark.parametrize("want_energy,want_virial", CH3,
                         ids=["energy", "none", "virial"])
def test_k1f_plain_matches_colt2_x_halo_interpret(lj, uniform, all_lj,
                                                  want_energy, want_virial):
    """Rank 0 of 4 (w = 1; its left halo layer wraps to the last one)."""
    rb = lj
    cfg, spec, st = bridge.from_trees(rb.cfg, rb.spec, rb.state, "cpu")
    rspec = rb.spec
    if not uniform:
        rspec, spec = _mixed(rspec, spec, cfg.n_types, not all_lj)
    cells, counts, sdims, ids = _slab(cfg, st, 4, 0)
    assert sdims == (3, 4, 4)
    rst = rb.state
    ref = jax.jit(lambda pos: pallas_pair.cell_pair_forces_colt(
        pos, rst.type_id, rst.active, rst.box,
        _reference_slab(rst.nbr.buckets, ids), sdims, rspec, rb.cfg.n_types,
        rb.cfg.cell_cap, interpret=True, uniform_lj=uniform,
        want_virial=want_virial, want_energy=want_energy, all_lj=all_lj,
        lj_on=True, x_halo=True))(rst.pos)
    got = cell_pair.colt_cells(cells, counts, st.box,
                               cell_pair.pair_params(spec, cfg.n_types),
                               sdims, uniform, all_lj,
                               CHANNEL[(want_energy, want_virial)],
                               x_halo=True).reshape(-1, 4).numpy()
    assert got.shape == np.asarray(ref).shape == (16 * cfg.cell_cap, 4)
    assert np.isfinite(got).all()
    _close(got[:, :3], np.asarray(ref)[:, :3])
    _close(got[:, 3], np.asarray(ref)[:, 3])
    assert (np.abs(got[:, 3]).max() > 0) == (want_energy or want_virial)


@pytest.fixture(scope="module")
def tab_melts():
    """The reference's tabulated melt (K1c/K1e) and blended melt (K1d) at
    70 trimers (3 x-layers), unwarmed."""
    tab, _, _ = rts.build_tabulated_melt(n_mols=70, reactive=False,
                                         use_pallas=True)
    mixed, _, _ = rts.build_mixed_tab_melt(n_mols=70, use_pallas=True)
    return tab, mixed


@pytest.mark.parametrize("mode", ["K1c", "K1d", "K1e"])
@pytest.mark.parametrize("want_energy,want_virial", CH3,
                         ids=["energy", "none", "virial"])
def test_k1f_cheb_plain_matches_colt2_x_halo_interpret(tab_melts, mode,
                                                       want_energy,
                                                       want_virial):
    """Rank 0 of 3 (w = 1) in each Chebyshev mode."""
    rb = tab_melts[1] if mode == "K1d" else tab_melts[0]
    rcfg = rb.cfg
    if mode == "K1e":
        rcfg = dataclasses.replace(rcfg, cheb_ntab=0)
    assert rcfg.tab_cheb and rcfg.cheb_mix == (mode == "K1d")
    cfg, spec, st = bridge.from_trees(rcfg, rb.spec, rb.state, "cpu")
    rst = rb.state
    obs_r = robs.conversions(rb.spec, rst.type_id, rst.chem_state,
                             rst.active)
    obs_p = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    cells, counts, sdims, ids = _slab(cfg, st, 3, 0)
    ref = jax.jit(lambda pos: pallas_pair.cell_pair_forces_colt(
        pos, rst.type_id, rst.active, rst.box,
        _reference_slab(rst.nbr.buckets, ids), sdims, rb.spec, rcfg.n_types,
        rcfg.cell_cap, interpret=True, want_virial=want_virial,
        want_energy=want_energy, cheb_kw=rcfg.cheb_kw, cheb_ko=rcfg.cheb_ko,
        lj_on=False, cheb_ntab=rcfg.cheb_ntab, cheb_mix=rcfg.cheb_mix,
        obs_x=obs_r, x_halo=True))(rst.pos)
    ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko,
                                  cfg.cheb_ntab, cfg.cheb_mix, obs_p)
    got = cell_pair.cheb_cells(cells, counts, st.box, *ops, sdims,
                               cfg.cheb_kw, cfg.cheb_ko,
                               CHANNEL[(want_energy, want_virial)],
                               cfg.cheb_ntab, x_halo=True)
    got = got.reshape(-1, 4).numpy()
    assert got.shape == np.asarray(ref).shape == (9 * cfg.cell_cap, 4)
    assert np.isfinite(got).all()
    _close(got[:, :3], np.asarray(ref)[:, :3])
    _close(got[:, 3], np.asarray(ref)[:, 3])


@pytest.fixture(scope="module")
def port_melts():
    """The port's LJ, tabulated and blended melts at 200 trimers (4 x 4 x 4
    cells), unwarmed."""
    kw = dict(n_mols=200, density=0.27, reactive=False, device="cpu")
    lj_b, _, _ = pts.build_melt(seed=9, **kw)
    tab_b, _, _ = pts.build_tabulated_melt(**kw)
    mixed_b, _, _ = pts.build_mixed_tab_melt(**kw)
    return {"K1": lj_b, "K1c": tab_b, "K1d": mixed_b, "K1e": tab_b}


@pytest.mark.parametrize("mode", ["K1", "K1c", "K1d", "K1e"])
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_k1f_slabs_side_by_side_equal_k1_bitwise(port_melts, mode,
                                                 n_ranks):
    """The D slabs' rows, rank after rank, are the full grid's rows, in
    every ch3 channel (LJ: K1; Chebyshev: K1c, K1d, K1e)."""
    built = port_melts[mode]
    cfg, spec, st = built.cfg, built.spec, built.state
    if mode == "K1e":
        cfg = dataclasses.replace(cfg, cheb_ntab=0)
    assert cfg.cell_dims == (4, 4, 4)
    assert cfg.tab_cheb == (mode != "K1") and cfg.cheb_mix == (mode == "K1d")
    obs_x = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    n_cells = int(np.prod(cfg.cell_dims))
    full_cells, full_counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        n_cells)
    for ch3 in CHANNEL.values():
        def rows(cells, counts, dims, x_halo):
            return cell_pair.pair_rows(
                cells, counts, st.box, dims, spec, cfg.n_types,
                cfg.uniform_lj, cfg.all_lj, ch3 == cell_pair.CH3_ENERGY,
                ch3 == cell_pair.CH3_VIRIAL,
                cfg.cheb_kw if cfg.tab_cheb else 0, cfg.cheb_ko,
                cfg.cheb_ntab, cfg.cheb_mix, obs_x, x_halo=x_halo)

        full = rows(full_cells, full_counts, cfg.cell_dims, False)
        slabs = torch.cat([rows(*_slab(cfg, st, n_ranks, r)[:3], True)
                           for r in range(n_ranks)])
        assert full.abs().max() > 0
        assert torch.equal(slabs, full), (mode, ch3)


def test_slab_layers_wrap_around_the_grid():
    assert cell_pair_halo.slab_layers(4, 4, 0) == [3, 0, 1]
    assert cell_pair_halo.slab_layers(4, 4, 3) == [2, 3, 0]
    assert cell_pair_halo.slab_layers(8, 2, 1) == [3, 4, 5, 6, 7, 0]
    assert cell_pair_halo.slab_layers(3, 3, 2) == [1, 2, 0]
