"""K2's CUDA source, run on the CPU:
``chemlab_tpu_torch/csrc/cell_pair_cell.cu``
and the header it includes (``cell_pair_packed.cuh``, which holds K1's
column-segment body) are compiled with the host's g++ against the stand-in
for the CUDA runtime of ``test_torch_cheb_emulation`` (one fiber per CUDA
thread, blocks one after another, IEEE single precision without
contraction), and the entry points are called through ctypes on CPU
tensors.  The column-segment K2 (``cell_pair_cell``, K1's kernel over the
stencil mask of ``cell_pair.stencil_mask``) must equal the cellwise K2
(``cell_pair_cell_cellwise``) bit for bit in every parameter mode and
channel: on the 3^3 melt at cap 24 and at cap 36, on the 2x2x2 melt, on
ragged grids with an axis of 1 and of 2, and under plans whose lists fill
and take several rounds; the cellwise K2 must agree with plain K2 to f32
rounding.  The card tests (``test_torch_cuda.py``) hold the compiled
kernel.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_k2.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_cheb_emulation import compile_for_host

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, neighbor, runner

MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
CH3 = (cell_pair.CH3_NONE, cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)
# launch plans: the default, then lists of one and two passes of 32
# candidates (emptied within a row), batches of 1 to 32 rows, segments
# longer than nz, one warp a block
PLANS = [dict(), dict(seg=2, rows=3, threads=64, depth=1),
         dict(seg=5, rows=32, threads=96, depth=2),
         dict(seg=1, rows=1, threads=32, depth=1)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    so = compile_for_host(cell_pair.K2.source,
                          tmp_path_factory.mktemp("k2_emu"))
    for kernel in (cell_pair.K2, cell_pair.K2_CELLWISE):
        fn = getattr(so, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return so


def _run(so, cells, counts, box, params, dims, uniform, all_lj, ch3,
         plan=None):
    """One emulated launch on CPU tensors: the cellwise K2, or the
    column-segment K2 with ``plan``; every row written (the output starts
    as NaN)."""
    out = torch.full_like(cells, float("nan"))
    nx, ny, nz = dims
    cap, n_types = cells.shape[1], params.shape[1]
    if plan is None:
        offsets = torch.from_numpy(neighbor.neighbor_cell_offsets(dims))
        rc = so.cell_pair_cell_cellwise(
            cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            params.data_ptr(), offsets.data_ptr(), out.data_ptr(), nx, ny,
            nz, cap, n_types, offsets.shape[0], int(uniform), int(all_lj),
            ch3, None)
    else:
        args = cell_pair._colt_pointers(cells, counts, box, params, out,
                                        dims, uniform, all_lj, ch3, False)
        rc = so.cell_pair_cell(*args[:-1], cell_pair.stencil_mask(dims),
                               *cell_pair.colt_plan_args(plan), None)
    assert rc == 0
    return out


def _same_bits(so, cells, counts, box, params, dims, modes=MODES,
               channels=CH3, plans=PLANS):
    """The cellwise K2 against plain, then the column-segment K2 under each
    of ``plans`` against the cellwise K2."""
    for uniform, all_lj in modes:
        for ch3 in channels:
            old = _run(so, cells, counts, box, params, dims, uniform, all_lj,
                       ch3)
            ref = cell_pair.cell_pair_forces_cell_ref(
                cells, counts, box, params, dims, uniform, all_lj, ch3)
            torch.testing.assert_close(
                old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
            for kw in plans:
                plan = cell_pair.k2_launch_plan(dims, cells.shape[1],
                                                params.shape[1], **kw)
                new = _run(so, cells, counts, box, params, dims, uniform,
                           all_lj, ch3, plan)
                assert torch.equal(new, old), (uniform, all_lj, ch3, plan)


def _mixed_params(spec, n_types):
    """Per-type-pair sigma, epsilon and cutoff (seeded), one non-LJ pair:
    the inputs of the general lookup modes and of the per-type cull."""
    rng = np.random.RandomState(5)
    p = cell_pair.pair_params(spec, n_types).numpy().copy()
    for k, (lo, hi) in ((0, (0.9, 1.1)), (1, (0.7, 1.3)), (2, (4.0, 6.25))):
        a = rng.uniform(lo, hi, (n_types, n_types)).astype(np.float32)
        p[k] = (a + a.T) / 2
    p[4, 0, 1] = p[4, 1, 0] = 0.0
    return torch.from_numpy(p)


def _warm(**kw):
    built, _, _ = testsystems.build_melt(thermostat="no", device="cpu", **kw)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, testsystems.warmup(built, st, steps=50)


@pytest.fixture(scope="module")
def melts():
    """The 70-trimer melt (3^3 cells, cap 24) and the 40-trimer melt at
    density 0.3 (2x2x2, S = 8)."""
    return {"melt": _warm(n_mols=70, reactive=True),
            "grid222": _warm(n_mols=40, density=0.3, seed=3,
                             reactive=False)}


@pytest.mark.parametrize("grid,cap", [("melt", 24), ("melt", 36),
                                      ("grid222", None)])
def test_emulated_k2_equals_cellwise(emu, melts, grid, cap):
    """The melts' own operands (the 3^3 melt also bucketed at cap 36, K2's
    cap on the 10k melt): the same bits in every mode and channel, the
    uniform modes with the melt's parameters, the lookups with per-pair
    ones."""
    built, st = melts[grid]
    cfg = built.cfg
    cap = cap or cfg.cell_cap
    buckets = neighbor.build_cell_buckets(st.pos, st.box, st.active,
                                          cfg.cell_dims, cap)[0]
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), buckets,
        int(np.prod(cfg.cell_dims)))
    if grid == "grid222":
        assert cfg.cell_dims == (2, 2, 2)
    plans = PLANS if grid == "grid222" else PLANS[:2]
    _same_bits(emu, cells, counts, st.box,
               cell_pair.pair_params(built.spec, cfg.n_types), cfg.cell_dims,
               modes=MODES[:1], plans=plans)
    _same_bits(emu, cells, counts, st.box,
               _mixed_params(built.spec, cfg.n_types), cfg.cell_dims,
               modes=MODES[1:], plans=plans[:2])


def _random_cells(dims, cap, seed, edge=1.1):
    """Random occupancy with inactive rows inside the counts (type 0) and
    two types: (cells, counts, box)."""
    rng = np.random.RandomState(seed)
    n_cells = int(np.prod(dims))
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, cap + 1, n_cells).astype(np.int32)
    for c in range(n_cells):
        at = np.array([c // (dims[1] * dims[2]), (c // dims[2]) % dims[1],
                       c % dims[2]])
        k = counts[c]
        cells[c, :k, :3] = at * edge + rng.uniform(0, edge, (k, 3))
        cells[c, :k, 3] = rng.randint(0, 3, k)
    box = torch.tensor(dims, dtype=torch.float32) * edge
    return torch.from_numpy(cells), torch.from_numpy(counts), box


# two types: per-pair sigma, epsilon and cutoff (type 1's rows cut at 1.0,
# type 2's at 1.1), one non-LJ pair
RAGGED_PARAMS = torch.tensor(
    [[[0.35, 0.3], [0.3, 0.4]], [[1.0, 0.8], [0.8, 1.2]],
     [[1.0, 0.9], [0.9, 1.21]], [[0.01, 0.02], [0.02, 0.03]],
     [[1.0, 0.0], [0.0, 1.0]]], dtype=torch.float32)


@pytest.mark.parametrize("dims,cap", [((3, 2, 4), 13), ((4, 3, 1), 20),
                                      ((2, 1, 2), 9), ((1, 3, 2), 36)])
def test_emulated_k2_on_ragged_grids(emu, dims, cap):
    """Random occupancy on grids with an axis of 1 or 2 cells (S from 4 to
    18) and caps that are no multiple of 8: the same bits in every mode
    (each in one channel, the three channels in turn), under the default
    plan and one warp a block with lists of one pass."""
    cells, counts, box = _random_cells(dims, cap, cap)
    assert bin(cell_pair.stencil_mask(dims)).count("1") == len(
        neighbor.neighbor_cell_offsets(dims))
    plans = [dict(), dict(seg=1, rows=5, threads=32, depth=1)]
    for k, mode in enumerate(MODES):
        _same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
                   modes=[mode], channels=CH3[k:k + 1], plans=plans)


def test_emulated_k2_box_change_under_one_plan(emu, melts):
    """The 2x2x2 melt's box shrinks between two calls under one cached plan
    (as under the barostat of the NPT runs): the cull reads the new box on
    the device, and K2 still equals its cellwise kernel on the new box."""
    built, st = melts["grid222"]
    cfg = built.cfg
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    plan = cell_pair.k2_launch_plan(cfg.cell_dims, cfg.cell_cap, cfg.n_types)
    for scale in (1.0, 0.97):
        cells, counts = cell_pair.colt_operands(
            cell_pair.pack_rows(st.pos * scale, st.type_id, st.active),
            st.nbr.buckets, int(np.prod(cfg.cell_dims)))
        assert cell_pair.k2_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                        cfg.n_types) is plan
        old = _run(emu, cells, counts, st.box * scale, params, cfg.cell_dims,
                   True, True, cell_pair.CH3_VIRIAL)
        new = _run(emu, cells, counts, st.box * scale, params, cfg.cell_dims,
                   True, True, cell_pair.CH3_VIRIAL, plan)
        assert torch.equal(new, old), scale


def test_emulated_k2_launcher_refuses_a_bad_plan_or_mask(emu):
    """The launcher checks the plan against its own layout and the mask
    against the 27 lanes: bytes that differ, a batch wider than a warp or
    a bit above 26 give cudaErrorInvalidValue, and nothing runs."""
    dims, cap = (3, 2, 4), 13
    cells, counts, box = _random_cells(dims, cap, 1)
    out = torch.full_like(cells, 7.0)
    args = cell_pair._colt_pointers(cells, counts, box, RAGGED_PARAMS, out,
                                    dims, True, True, 0, False)[:-1]
    plan = cell_pair.k2_launch_plan(dims, cap, 2)
    mask = cell_pair.stencil_mask(dims)
    for m, p in ((mask, plan._replace(smem=plan.smem + 16)),
                 (mask, plan._replace(rows=33)), (mask | 1 << 27, plan)):
        assert emu.cell_pair_cell(*args, m, *cell_pair.colt_plan_args(p),
                                  None) == 1
    assert bool((out == 7.0).all())
