"""K3b's CUDA source, run on the CPU:
``chemlab_tpu_torch/csrc/cell_pair_ladder.cu``
(and the header it includes, ``cell_pair_packed.cuh``) and K2's
``cell_pair_cell.cu`` are compiled with the host's g++ against the stand-in
for the CUDA runtime of ``test_torch_cheb_emulation`` (one fiber per CUDA
thread, blocks one after another, IEEE single precision without
contraction), and the entry points are called through ctypes on CPU
tensors.  The warp-per-row K3b (``ladder_resident``) must equal its first
design (``ladder_resident_packet``, the baseline) bit for bit, both its
channels, [fx, fy, fz, e/2, w/2, 0, 0, 0] a slot, and those must equal the
cellwise K2's energy rows and virial channel bit for bit; the baseline
must agree with the plain version to f32 rounding.  On the 3^3 melt at cap
24, on ragged grids with an axis of 2 at caps that are a multiple of 8,
under the default plan and plans whose lists fill and take several
rounds.  The card tests (``test_torch_cuda.py``) hold
the compiled kernel.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_ladder.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_cheb_emulation import compile_for_host

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, neighbor, runner
from chemlab_tpu_torch.engine import cell_pair_variants as variants

# K3b's plans: the default, then lists of one and two passes of 32
# candidates (emptied within a row), batches of 1 to 32 slots, blocks of 4
# to 8 warps
PLANS = [dict(), dict(rows=8), dict(rows=1, depth=1),
         dict(rows=3, threads=160, depth=1),
         dict(rows=32, threads=256, depth=2)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    ladder = compile_for_host(cell_pair.K3B.source,
                              tmp_path_factory.mktemp("resident_emu"))
    k2 = compile_for_host(cell_pair.K2.source,
                          tmp_path_factory.mktemp("resident_emu_k2"))
    for so, kernel in ((ladder, cell_pair.K3B), (ladder,
                                                 cell_pair.K3B_CELLWISE),
                       (k2, cell_pair.K2_CELLWISE)):
        fn = getattr(so, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return ladder, k2


def _k3b(so, cells, counts, box, params, dims, uniform, plan=None):
    """One emulated K3b launch on CPU tensors: the baseline, or the
    warp-per-row kernel with ``plan``; every row written (the output
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
    if plan is None:
        rc = so.ladder_resident_packet(*args, None)
    else:
        rc = so.ladder_resident(*args, *plan, None)
    assert rc == 0
    return out


def _k2(so, cells, counts, box, params, dims, uniform, ch3):
    """The emulated cellwise K2 (the is-LJ gate unless ``uniform``, as the
    ladder takes it)."""
    out = torch.full_like(cells, float("nan"))
    offsets = torch.from_numpy(neighbor.neighbor_cell_offsets(dims))
    rc = so.cell_pair_cell_cellwise(
        cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
        params.data_ptr(), offsets.data_ptr(), out.data_ptr(), *dims,
        cells.shape[1], params.shape[1], offsets.shape[0], int(uniform), 0,
        ch3, None)
    assert rc == 0
    return out


def _same_bits(emu, cells, counts, box, params, dims, plans=PLANS):
    """In both parameter modes: the baseline against plain and against the
    cellwise K2 (both channels), then the warp-per-row kernel under each
    of ``plans`` against the baseline."""
    ladder, k2 = emu
    for uniform in (True, False):
        old = _k3b(ladder, cells, counts, box, params, dims, uniform)
        ref = variants.ladder_rows_ref(cells, counts, box, params, dims,
                                       uniform)
        torch.testing.assert_close(
            old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
        k2_e = _k2(k2, cells, counts, box, params, dims, uniform,
                   cell_pair.CH3_ENERGY)
        k2_w = _k2(k2, cells, counts, box, params, dims, uniform,
                   cell_pair.CH3_VIRIAL)
        assert torch.equal(old[..., :4], k2_e), uniform
        assert torch.equal(old[..., 4], k2_w[..., 3]), uniform
        assert not old[..., 5:].any()
        for kw in plans:
            plan = variants.resident_launch_plan(cells.shape[1], **kw)
            new = _k3b(ladder, cells, counts, box, params, dims, uniform,
                       plan)
            assert torch.equal(new, old), (uniform, plan)


def _mixed_params(spec, n_types):
    """Per-type-pair sigma, epsilon and cutoff (seeded), one non-LJ pair:
    the inputs of the lookup mode."""
    rng = np.random.RandomState(5)
    p = cell_pair.pair_params(spec, n_types).numpy().copy()
    for k, (lo, hi) in ((0, (0.9, 1.1)), (1, (0.7, 1.3)), (2, (4.0, 6.25))):
        a = rng.uniform(lo, hi, (n_types, n_types)).astype(np.float32)
        p[k] = (a + a.T) / 2
    p[4, 0, 1] = p[4, 1, 0] = 0.0
    return torch.from_numpy(p)


@pytest.fixture(scope="module")
def melt():
    built, _, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                         thermostat="no", device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, testsystems.warmup(built, st, steps=50)


@pytest.mark.parametrize("params", ["melt", "mixed"])
def test_emulated_resident_equals_baseline(emu, melt, params):
    """The 70-trimer melt (3^3 cells, cap 24), the melt's parameters and
    per-pair ones: the same bits as the baseline and as K2, every plan."""
    built, st = melt
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    p = (cell_pair.pair_params(built.spec, cfg.n_types) if params == "melt"
         else _mixed_params(built.spec, cfg.n_types))
    _same_bits(emu, cells, counts, st.box, p, cfg.cell_dims)


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


# two types: per-pair sigma, epsilon and cutoff, one non-LJ pair
RAGGED_PARAMS = torch.tensor(
    [[[0.35, 0.3], [0.3, 0.4]], [[1.0, 0.8], [0.8, 1.2]],
     [[1.0, 0.9], [0.9, 1.21]], [[0.01, 0.02], [0.02, 0.03]],
     [[1.0, 0.0], [0.0, 1.0]]], dtype=torch.float32)


@pytest.mark.parametrize("dims,cap", [((2, 3, 4), 16), ((3, 4, 2), 40),
                                      ((2, 2, 2), 8)])
def test_emulated_resident_on_ragged_grids(emu, dims, cap):
    """Random occupancy on grids with an axis of 2 (S = 18 and 8) at caps
    that are multiples of 8 (cap 40: two batches of 32 slots and more):
    the same bits as the baseline and as K2."""
    cells, counts, box = _random_cells(dims, cap, cap)
    _same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims,
               plans=PLANS[:3])


def test_emulated_resident_launcher_refuses_a_bad_plan(emu):
    """The launcher checks the plan against its own layout: list bytes that
    differ, a batch wider than a warp or a block of fewer than 4 warps give
    cudaErrorInvalidValue, and nothing runs."""
    ladder, _ = emu
    dims, cap = (2, 3, 4), 16
    cells, counts, box = _random_cells(dims, cap, 3)
    table = torch.from_numpy(variants.ladder_table(dims).copy())
    out = torch.full((cells.shape[0], cap, 8), 7.0)
    args = (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            RAGGED_PARAMS.data_ptr(), table.data_ptr(), out.data_ptr(),
            *dims, cap, 2, *variants.table_sizes(dims), 1, 1)
    plan = variants.resident_launch_plan(cap)
    for bad in (plan._replace(smem=plan.smem + 20), plan._replace(rows=33),
                plan._replace(threads=96, smem=variants.resident_smem(
                    96, plan.depth))):
        assert ladder.ladder_resident(*args, *bad, None) == 1
    assert bool((out == 7.0).all())
