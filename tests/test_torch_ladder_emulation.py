"""K3a's and K3d's CUDA source, run on the CPU:
``chemlab_tpu_torch/csrc/cell_pair_ladder.cu`` (and the headers it
includes) and K2's ``cell_pair_cell.cu`` are compiled with the host's g++
against the stand-in for the CUDA runtime of ``test_torch_cheb_emulation``
(one fiber per CUDA thread, blocks one after another, IEEE single
precision without contraction; the bulk copies of
``cell_pair_bulk.cuh`` done at once, an mbarrier's waits yielding until
its phase completes), and the entry points are called through ctypes on
CPU tensors.

The warp-per-packet K3a (``ladder_packet``) must equal its first design
(``ladder_packet_cellwise``) bit for bit, and the column-window K3d
(``ladder_column``) must equal its first design
(``ladder_column_cellwise``) bit for bit: both channels, [fx, fy, fz, e/2,
w/2, 0, 0, 0] a slot, in both parameter modes, under the default plan and
plans whose lists fill and take several rounds; the first designs must
equal the cellwise K2's energy rows and virial channel bit for bit.  On
the 3^3 melt at cap 24 (and cap 36 for K3d), on ragged grids (K3a at caps
that are multiples of 8, with cells filled past one packet; K3d on grids
with axes of 2 and 1), and on a grid whose every pair crosses the z wrap.
The card tests (``test_torch_cuda.py``) hold the compiled kernels.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_ladder.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_cheb_emulation import compile_for_host
from test_torch_resident_emulation import (RAGGED_PARAMS, _k2, _mixed_params,
                                           _random_cells)

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, runner
from chemlab_tpu_torch.engine import cell_pair_variants as variants

# K3a's plans: the default, then lists of one and two passes of 32
# candidates (emptied within a packet), 1 to 4 warps a block
PACKET_PLANS = [dict(), dict(threads=32, depth=1), dict(threads=96, depth=2),
                dict(threads=128, depth=1)]
# K3d's plans: the default, then lists of one and two passes, batches of 1
# to 32 slots, 1 to 8 warps a block
COLUMN_PLANS = [dict(), dict(rows=1, threads=32, depth=1),
                dict(rows=3, threads=96, depth=1),
                dict(rows=8, threads=64, depth=2),
                dict(rows=32, threads=256, depth=2)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    ladder = compile_for_host(cell_pair.K3A.source,
                              tmp_path_factory.mktemp("ladder_emu"))
    k2 = compile_for_host(cell_pair.K2.source,
                          tmp_path_factory.mktemp("ladder_emu_k2"))
    for so, kernel in ((ladder, cell_pair.K3A), (ladder, cell_pair.K3D),
                       (ladder, cell_pair.K3A_CELLWISE),
                       (ladder, cell_pair.K3D_CELLWISE),
                       (k2, cell_pair.K2_CELLWISE)):
        fn = getattr(so, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return ladder, k2


def _run(so, symbol, cells, counts, box, params, dims, uniform, plan=None):
    """One emulated launch of entry point ``symbol`` on CPU tensors (with
    ``plan`` after the operands when given); every row written (the output
    starts as NaN)."""
    nx, ny, nz = dims
    C, cap, _ = cells.shape
    out = torch.full((C, cap, 8), float("nan"))
    table = torch.from_numpy(variants.ladder_table(dims).copy())
    n_stencil, n_cols = variants.table_sizes(dims)
    args = (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            params.data_ptr(), table.data_ptr(), out.data_ptr(), nx, ny, nz,
            cap, params.shape[1], n_stencil, n_cols, int(uniform),
            cell_pair.CH3_ENERGY)
    plan = () if plan is None else tuple(plan)
    assert getattr(so, symbol)(*args, *plan, None) == 0
    return out


def _first_design(emu, kind, cells, counts, box, params, dims, uniform):
    """The first design of ``kind`` ("packet" or "column"), held against
    plain (to f32 rounding) and against the cellwise K2's energy rows and
    virial channel (bit for bit)."""
    ladder, k2 = emu
    symbol = {"packet": cell_pair.K3A_CELLWISE,
              "column": cell_pair.K3D_CELLWISE}[kind].symbol
    old = _run(ladder, symbol, cells, counts, box, params, dims, uniform)
    ref = variants.ladder_rows_ref(cells, counts, box, params, dims, uniform)
    torch.testing.assert_close(
        old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
    k2_e = _k2(k2, cells, counts, box, params, dims, uniform,
               cell_pair.CH3_ENERGY)
    k2_w = _k2(k2, cells, counts, box, params, dims, uniform,
               cell_pair.CH3_VIRIAL)
    assert torch.equal(old[..., :4], k2_e), (kind, uniform)
    assert torch.equal(old[..., 4], k2_w[..., 3]), (kind, uniform)
    assert not old[..., 5:].any()
    return old


def _packet_same_bits(emu, cells, counts, box, params, dims,
                      plans=PACKET_PLANS):
    """In both parameter modes: the new K3a under each of ``plans`` against
    its first design, which equals K2."""
    ladder, _ = emu
    for uniform in (True, False):
        old = _first_design(emu, "packet", cells, counts, box, params, dims,
                            uniform)
        for kw in plans:
            plan = variants.packet_launch_plan(cells.shape[1], **kw)
            new = _run(ladder, cell_pair.K3A.symbol, cells, counts, box,
                       params, dims, uniform, plan)
            assert torch.equal(new, old), (uniform, plan)


def _column_same_bits(emu, cells, counts, box, params, dims,
                      plans=COLUMN_PLANS):
    """In both parameter modes: the new K3d under each of ``plans`` against
    its first design, which equals K2."""
    ladder, _ = emu
    for uniform in (True, False):
        old = _first_design(emu, "column", cells, counts, box, params, dims,
                            uniform)
        for kw in plans:
            plan = variants.column_launch_plan(cells.shape[1], dims, **kw)
            new = _run(ladder, cell_pair.K3D.symbol, cells, counts, box,
                       params, dims, uniform, plan)
            assert torch.equal(new, old), (uniform, plan)


@pytest.fixture(scope="module")
def melts():
    """The 70-trimer melt (3^3 cells) warmed on the CPU, built at cap 24
    and at cap 36."""
    out = {}
    for cap in (24, 36):
        built, _, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                             thermostat="no", cell_cap=cap,
                                             device="cpu")
        st = runner.initial_forces(built.spec, built.cfg, built.state)
        out[cap] = (built, testsystems.warmup(built, st, steps=50))
    return out


def _melt_operands(melts, cap, params):
    built, st = melts[cap]
    cfg = built.cfg
    assert tuple(cfg.cell_dims) == (3, 3, 3) and cfg.cell_cap == cap
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    p = (cell_pair.pair_params(built.spec, cfg.n_types) if params == "melt"
         else _mixed_params(built.spec, cfg.n_types))
    return cells, counts, st.box, p, tuple(cfg.cell_dims)


@pytest.mark.parametrize("params", ["melt", "mixed"])
def test_emulated_packet_equals_baseline_on_the_melt(emu, melts, params):
    """The 70-trimer melt (3^3 cells, cap 24), the melt's parameters and
    per-pair ones: the same bits as the first design and as K2, every
    plan."""
    _packet_same_bits(emu, *_melt_operands(melts, 24, params))


@pytest.mark.parametrize("dims,cap", [((2, 3, 4), 16), ((3, 4, 2), 24),
                                      ((2, 2, 2), 16)])
def test_emulated_packet_on_ragged_grids(emu, dims, cap):
    """Random occupancy (cells filled past one and two packets, and empty
    ones) on grids with an axis of 2 (S = 18 and 8) at caps that are
    multiples of 8: the same bits as the first design and as K2."""
    cells, counts, box = _random_cells(dims, cap, cap + 1)
    assert int(counts.max()) > 8
    _packet_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                      plans=PACKET_PLANS[:3])


def test_emulated_packet_fills_every_packet(emu):
    """A 3^3 grid at cap 24 whose cells hold 9 to 24 particles: up to three
    live packets a cell, more than a block's warps under one warp, so
    warps loop over packets."""
    dims, cap = (3, 3, 3), 24
    cells, counts, box = _random_cells(dims, cap, 11, edge=1.6)
    rng = np.random.RandomState(12)
    fill = torch.from_numpy(rng.randint(9, cap + 1, 27).astype(np.int32))
    cells[torch.arange(cap)[None, :] >= fill[:, None]] = 0.0
    _packet_same_bits(emu, cells, fill, box, RAGGED_PARAMS, dims,
                      plans=[dict(threads=32, depth=1),
                             dict(threads=64, depth=2)])


@pytest.mark.parametrize("cap,params", [(24, "melt"), (24, "mixed"),
                                        (36, "melt")])
def test_emulated_column_equals_baseline_on_the_melt(emu, melts, cap, params):
    """The 70-trimer melt (3^3 cells) at cap 24 and at cap 36 (K3d's path:
    a cap that is no multiple of 8), the melt's parameters and per-pair
    ones: the same bits as the first design and as K2, every plan."""
    _column_same_bits(emu, *_melt_operands(melts, cap, params))


@pytest.mark.parametrize("dims,cap", [((2, 2, 2), 13), ((3, 2, 4), 20),
                                      ((4, 3, 1), 9)])
def test_emulated_column_on_small_axes(emu, dims, cap):
    """Random occupancy on grids with axes of 2 and 1 (S = 8, 18 and 9: a
    column's window holds 2 cells, or 1), at caps that are no multiple of
    8: the same bits as the first design and as K2."""
    cells, counts, box = _random_cells(dims, cap, cap)
    _column_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                      plans=COLUMN_PLANS[:3])


def test_emulated_column_windows_that_wrap(emu):
    """Particles only in the cells z = 0 and z = nz - 1 of a 3 x 3 x 5 grid:
    every pair is taken through a window that wraps in z (two bulk copies
    a column); the same bits as the first design and as K2."""
    dims, cap = (3, 3, 5), 12
    cells, counts, box = _random_cells(dims, cap, 21)
    z = torch.arange(cells.shape[0]) % dims[2]
    inner = (z > 0) & (z < dims[2] - 1)
    cells[inner] = 0.0
    counts[inner] = 0
    assert int(counts.sum()) > 0
    _column_same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                      plans=COLUMN_PLANS[:2])


def test_emulated_launchers_refuse_a_bad_plan(emu):
    """K3a's and K3d's launchers check the plan against their own layout:
    bytes that differ, a batch wider than a warp, part of a warp, or (K3a)
    a cap that is no multiple of 8 give cudaErrorInvalidValue, and nothing
    runs."""
    ladder, _ = emu
    dims, cap = (2, 3, 4), 16
    cells, counts, box = _random_cells(dims, cap, 3)
    table = torch.from_numpy(variants.ladder_table(dims).copy())
    out = torch.full((cells.shape[0], cap, 8), 7.0)

    def args(cap_):
        return (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
                RAGGED_PARAMS.data_ptr(), table.data_ptr(), out.data_ptr(),
                *dims, cap_, 2, *variants.table_sizes(dims), 1, 1)

    pk = variants.packet_launch_plan(cap)
    for bad in (pk._replace(smem=pk.smem + 20), pk._replace(threads=48)):
        assert ladder.ladder_packet(*args(cap), *bad, None) == 1
    assert ladder.ladder_packet(*args(12), *pk, None) == 1
    col = variants.column_launch_plan(cap, dims)
    for bad in (col._replace(smem=col.smem + 20), col._replace(rows=33),
                col._replace(threads=80)):
        assert ladder.ladder_column(*args(cap), *bad, None) == 1
    assert bool((out == 7.0).all())
