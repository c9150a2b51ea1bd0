"""K3c's and K1''s CUDA source, run on the CPU:
``chemlab_tpu_torch/csrc/cell_pair_ladder.cu`` (and the headers it
includes) and K1's ``cell_pair.cu`` are compiled with the host's g++
against the stand-in for the CUDA runtime of ``test_torch_cheb_emulation``
(one fiber per CUDA thread, blocks one after another, IEEE single
precision without contraction; the bulk copies of ``cell_pair_bulk.cuh``
done at once, an mbarrier's waits yielding until its phase completes), and
the entry points are called through ctypes on CPU tensors.

The whole-column K3c (``ladder_colz``) must equal its first design
(``ladder_colz_cellwise``) bit for bit: both channels, [fx, fy, fz, e/2,
w/2, 0, 0, 0] a slot, in both parameter modes, under the default plan, plans
whose lists fill and take several rounds, and one warp to the most that fit
a block; on the 3^3 melt at cap 24, on grids with axes of 2 and 1 (fewer
than 9 distinct columns, fewer than 3 distinct cells a column), on cells
filled past one packet and on a grid whose every pair crosses the z wrap.
The column-segment K1' (``ladder_colt1``, K1's body with colt1's per-column
sums) must equal its first design (``ladder_colt1_cellwise``) bit for bit
in ch3 modes 1 and 2, uniform and mixed parameters, at segments of 1, 3
and nz, on the 3^3 melt, odd grids and a grid with whole empty columns,
and agree with K1 to the tolerance of ``chip_smoke.py``'s ladder check.
The card tests (``test_torch_cuda.py``) hold the compiled kernels.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_ladder.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
# the melts' warmups on one torch thread (an autouse fixture)
from test_torch_cheb_emulation import (_one_torch_thread,  # noqa: F401
                                       compile_for_host)
from test_torch_resident_emulation import (RAGGED_PARAMS, _mixed_params,
                                           _random_cells)

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, runner
from chemlab_tpu_torch.engine import cell_pair_variants as variants

# K3c's plans besides the default: one warp with lists of one pass, then
# batches of 1 to 32 slots over 2 to 8 warps with lists of one and two
# passes (emptied within a row)
COLZ_PLANS = [dict(rows=1, threads=32, depth=1),
              dict(rows=3, threads=96, depth=1),
              dict(rows=32, threads=256, depth=2),
              dict(rows=2, threads=64, depth=2)]
# K1''s: segments of 1, 3 and (given per grid) nz; lists of one and two
# passes, batches of 1 to 32 rows
COLT1_PLANS = [dict(seg=1, rows=3, threads=64, depth=1),
               dict(seg=3, rows=1, threads=32, depth=1),
               dict(seg=3, rows=32, threads=96, depth=2)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    ladder = compile_for_host(cell_pair.K3C.source,
                              tmp_path_factory.mktemp("colz_emu"))
    k1 = compile_for_host(cell_pair.K1.source,
                          tmp_path_factory.mktemp("colz_emu_k1"))
    for so, kernel in ((ladder, cell_pair.K3C), (ladder, cell_pair.K1P),
                       (ladder, cell_pair.K3C_CELLWISE),
                       (ladder, cell_pair.K1P_CELLWISE), (k1, cell_pair.K1)):
        fn = getattr(so, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return ladder, k1


def _run(so, symbol, cells, counts, box, params, dims, uniform,
         ch3=cell_pair.CH3_ENERGY, plan=None):
    """One emulated launch of ladder entry point ``symbol`` on CPU tensors
    (with ``plan`` after the operands when given); every row written (the
    output starts as NaN)."""
    C, cap, _ = cells.shape
    n_out = 4 if "colt1" in symbol else 8
    out = torch.full((C, cap, n_out), float("nan"))
    table = torch.from_numpy(variants.ladder_table(dims).copy())
    args = (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            params.data_ptr(), table.data_ptr(), out.data_ptr(), *dims, cap,
            params.shape[1], *variants.table_sizes(dims), int(uniform), ch3)
    plan = () if plan is None else tuple(plan)
    assert getattr(so, symbol)(*args, *plan, None) == 0
    return out


def _colz_same_bits(emu, cells, counts, box, params, dims, plans=COLZ_PLANS,
                    default=True):
    """In both parameter modes: K3c's first design against plain, then the
    new K3c under the default plan (when ``default``) and each of
    ``plans`` against the first design."""
    ladder, _ = emu
    cap = cells.shape[1]
    for uniform in (True, False):
        old = _run(ladder, cell_pair.K3C_CELLWISE.symbol, cells, counts, box,
                   params, dims, uniform)
        ref = variants.colz_rows_ref(cells, counts, box, params, dims,
                                     uniform)
        torch.testing.assert_close(
            old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
        for kw in ([{}] if default else []) + list(plans):
            plan = variants.colz_launch_plan(cap, dims, **kw)
            new = _run(ladder, cell_pair.K3C.symbol, cells, counts, box,
                       params, dims, uniform, plan=plan)
            assert torch.equal(new, old), (uniform, plan)


def _colt1_same_bits(emu, cells, counts, box, params, dims,
                     plans=COLT1_PLANS):
    """In ch3 modes 1 and 2 and both parameter modes: K1''s first design
    against plain and against K1 (to ``chip_smoke.py``'s ladder tolerance),
    then the new K1' under the default plan, each of ``plans`` and a
    segment of nz against the first design, bit for bit."""
    ladder, k1 = emu
    cap, n_types = cells.shape[1], params.shape[1]
    for uniform in (True, False):
        for ch3 in (cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL):
            old = _run(ladder, cell_pair.K1P_CELLWISE.symbol, cells, counts,
                       box, params, dims, uniform, ch3)
            ref = variants.colt1_rows_ref(cells, counts, box, params, dims,
                                          uniform, ch3)
            torch.testing.assert_close(
                old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
            for kw in [{}, dict(seg=dims[2])] + list(plans):
                plan = variants.colt1_launch_plan(dims, cap, n_types, **kw)
                new = _run(ladder, cell_pair.K1P.symbol, cells, counts, box,
                           params, dims, uniform, ch3, plan)
                assert torch.equal(new, old), (uniform, ch3, plan)
            # K1 on the same operands (the is-LJ gate unless uniform, as K1'
            # takes it): the same pairs, K2's running sums
            ref_k1 = cell_pair._out_rows(cells, dims, False).fill_(
                float("nan"))
            args = cell_pair._colt_pointers(cells, counts, box, params,
                                            ref_k1, dims, uniform, False,
                                            ch3, False)
            plan = cell_pair.colt_launch_plan(dims, cap, n_types)
            assert k1.cell_pair_colt(*args, *cell_pair.colt_plan_args(plan),
                                     None) == 0
            torch.testing.assert_close(
                new, ref_k1, rtol=0,
                atol=2e-5 * (1 + ref_k1.abs().max().item()))


@pytest.fixture(scope="module")
def melt():
    """The 70-trimer melt (3^3 cells, cap 24) warmed on the CPU."""
    built, _, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                         thermostat="no", device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, testsystems.warmup(built, st, steps=50)


def _melt_operands(melt, params):
    built, st = melt
    cfg = built.cfg
    assert tuple(cfg.cell_dims) == (3, 3, 3) and cfg.cell_cap == 24
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    p = (cell_pair.pair_params(built.spec, cfg.n_types) if params == "melt"
         else _mixed_params(built.spec, cfg.n_types))
    return cells, counts, st.box, p, tuple(cfg.cell_dims)


@pytest.mark.parametrize("params", ["melt", "mixed"])
def test_emulated_colz_equals_baseline_on_the_melt(emu, melt, params):
    """The 70-trimer melt (3^3 cells, cap 24), the melt's parameters and
    per-pair ones: the same bits as the first design, every plan."""
    _colz_same_bits(emu, *_melt_operands(melt, params))


@pytest.mark.parametrize("dims,cap", [((3, 2, 4), 16), ((4, 3, 1), 8),
                                      ((2, 2, 2), 24), ((5, 4, 3), 32)])
def test_emulated_colz_on_small_axes(emu, dims, cap):
    """Random occupancy (inactive rows inside the counts, empty cells) on
    grids with axes of 2 and 1 (U = 6, 3, 4 and 9 columns; a column of 1
    or 2 distinct cells) at caps 8 to 32: the same bits as the first
    design."""
    cells, counts, box = _random_cells(dims, cap, cap)
    _colz_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                    plans=COLZ_PLANS[:2], default=max(dims) <= 3)


def test_emulated_colz_fills_past_a_packet(emu):
    """A 3 x 3 x 4 grid at cap 24 whose cells hold 9 to 24 particles: every
    cell past its first 8-row packet, so the live items run over several
    batches of each cell and a warp's run crosses cells."""
    dims, cap = (3, 3, 4), 24
    cells, counts, box = _random_cells(dims, cap, 11, edge=1.6)
    rng = np.random.RandomState(12)
    fill = torch.from_numpy(rng.randint(9, cap + 1, 36).astype(np.int32))
    cells[torch.arange(cap)[None, :] >= fill[:, None]] = 0.0
    _colz_same_bits(emu, cells, fill, box, RAGGED_PARAMS, dims,
                    plans=[dict(rows=3, threads=96, depth=1),
                           dict(rows=1, threads=32, depth=2)],
                    default=False)


def test_emulated_colz_windows_that_wrap(emu):
    """Particles only in the cells z = 0 and z = nz - 1 of a 3 x 3 x 5 grid:
    every pair is read through a window that wraps in z inside the staged
    columns; the same bits as the first design."""
    dims, cap = (3, 3, 5), 16
    cells, counts, box = _random_cells(dims, cap, 21)
    z = torch.arange(cells.shape[0]) % dims[2]
    inner = (z > 0) & (z < dims[2] - 1)
    cells[inner] = 0.0
    counts[inner] = 0
    assert int(counts.sum()) > 0
    _colz_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                    plans=COLZ_PLANS[:2], default=False)


def test_emulated_colz_warps_up_to_a_full_block(emu):
    """One warp and the most warps a block takes (``COLZ_THREADS``), with
    more warps than live batches: the same bits as the first design."""
    dims, cap = (2, 2, 2), 8
    cells, counts, box = _random_cells(dims, cap, 5)
    _colz_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                    plans=[dict(rows=1, threads=32, depth=1),
                           dict(rows=1, threads=variants.COLZ_THREADS)],
                    default=False)


@pytest.mark.parametrize("params", ["melt", "mixed"])
def test_emulated_colt1_equals_baseline_on_the_melt(emu, melt, params):
    """The 70-trimer melt (3^3 cells, cap 24), the melt's parameters and
    per-pair ones, ch3 modes 1 and 2: the same bits as the first design at
    every segment, within f32 rounding of K1."""
    _colt1_same_bits(emu, *_melt_operands(melt, params))


@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((4, 3, 3), 16),
                                      ((3, 3, 6), 8)])
def test_emulated_colt1_on_odd_grids(emu, dims, cap):
    """Random occupancy on odd grids of at least 3 cells an axis: the same
    bits as the first design at segments of 1 (the default on so small a
    grid), 3 and nz."""
    cells, counts, box = _random_cells(dims, cap, cap + 3)
    _colt1_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                     plans=COLT1_PLANS[1:2])


def test_emulated_colt1_with_whole_empty_columns(emu):
    """A 4 x 3 x 4 grid whose xy columns with cx + cy odd are empty: rows
    whose in-cut pairs skip whole columns, where the first design adds an
    empty partial (+0.0) and the new kernel folds nothing; the same bits."""
    dims, cap = (4, 3, 4), 16
    cells, counts, box = _random_cells(dims, cap, 31)
    col = torch.arange(cells.shape[0]) // dims[2]
    empty = ((col // dims[1]) + (col % dims[1])) % 2 == 1
    cells[empty] = 0.0
    counts[empty] = 0
    assert int(counts.sum()) > 0
    _colt1_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                     plans=COLT1_PLANS[:1])


def test_emulated_launchers_refuse_a_bad_plan(emu):
    """K3c's and K1''s launchers check the plan against their own layout:
    bytes that differ (K1' without its column bytes), a batch wider than a
    warp, part of a warp, or (K1') more threads than its launch bounds or a
    grid with an axis under 3 give cudaErrorInvalidValue, and nothing
    runs."""
    ladder, _ = emu
    dims, cap = (3, 3, 4), 16
    cells, counts, box = _random_cells(dims, cap, 3)
    table = torch.from_numpy(variants.ladder_table(dims).copy())
    out = torch.full((cells.shape[0], cap, 8), 7.0)

    def args(dims_):
        return (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
                RAGGED_PARAMS.data_ptr(), table.data_ptr(), out.data_ptr(),
                *dims_, cap, 2, *variants.table_sizes(dims), 1, 1)

    plan = variants.colz_launch_plan(cap, dims)
    for bad in (plan._replace(smem=plan.smem + 20), plan._replace(rows=33),
                plan._replace(threads=80)):
        assert ladder.ladder_colz(*args(dims), *bad, None) == 1
    p1 = variants.colt1_launch_plan(dims, cap, 2)
    k1_bytes = cell_pair.colt_smem(cap, 2, p1.seg, p1.threads, p1.depth)
    wide = p1._replace(threads=512, smem=variants.colt1_smem(
        cap, 2, p1.seg, 512, p1.depth))
    for bad in (p1._replace(smem=k1_bytes), p1._replace(rows=33),
                p1._replace(threads=80), wide):
        assert ladder.ladder_colt1(*args(dims), *bad, None) == 1
    assert ladder.ladder_colt1(*args((3, 2, 6)), *p1, None) == 1
    assert bool((out == 7.0).all())
