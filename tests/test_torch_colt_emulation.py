"""K1's CUDA source, run on the CPU: ``chemlab_tpu_torch/csrc/cell_pair.cu``
and the header it includes (``cell_pair_packed.cuh``) are compiled with the
host's g++ against the stand-in for the CUDA runtime of
``test_torch_cheb_emulation`` (one fiber per CUDA thread, blocks one after
another, IEEE single precision without contraction), and the
entry points are called through ctypes on CPU tensors.  The column-segment
kernel (``cell_pair_colt``, K1/K1b/K1f) must equal the cellwise kernel
(``cell_pair_colt_cellwise``) bit for bit in every parameter mode and
channel, on full grids and on ``x_halo`` slabs, under the default plan
and under plans whose lists fill and take several rounds; the cellwise
kernel must agree with the plain
torch version to f32 rounding.  The card tests (``test_torch_cuda.py``)
hold the compiled kernel.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_cell_pair.py`` and ``test_torch_k1f.py``.
"""

import ctypes

import numpy as np
import pytest
import torch
from test_torch_cheb_emulation import compile_for_host

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, cell_pair_halo, runner

MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
CH3 = (cell_pair.CH3_NONE, cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)
# launch plans: the default, then lists of one and two passes of 32
# candidates (emptied within a row), batches of 1 to 32 rows, segments
# longer than nz, one warp a block
PLANS = [dict(), dict(seg=2, rows=3, threads=64, depth=1),
         dict(seg=5, rows=32, threads=96, depth=2),
         dict(seg=3, rows=1, threads=32)]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    so = compile_for_host(cell_pair.K1.source,
                          tmp_path_factory.mktemp("colt_emu"))
    for kernel in (cell_pair.K1, cell_pair.K1_CELLWISE):
        fn = getattr(so, kernel.symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
    return so


def _run(so, cells, counts, box, params, dims, uniform, all_lj, ch3, x_halo,
         plan=None):
    """One emulated launch on CPU tensors: the cellwise kernel, or the
    column-segment kernel with ``plan``; every row written (the output
    starts as NaN)."""
    out = cell_pair._out_rows(cells, dims, x_halo).fill_(float("nan"))
    args = cell_pair._colt_pointers(cells, counts, box, params, out, dims,
                                    uniform, all_lj, ch3, x_halo)
    if plan is None:
        rc = so.cell_pair_colt_cellwise(*args, None)
    else:
        rc = so.cell_pair_colt(*args, *cell_pair.colt_plan_args(plan), None)
    assert rc == 0
    return out


def _same_bits(so, cells, counts, box, params, dims, x_halo=False,
               modes=MODES, channels=CH3, plans=PLANS):
    """The cellwise kernel against plain, then the column-segment kernel
    under each of ``plans`` against the cellwise kernel."""
    for uniform, all_lj in modes:
        for ch3 in channels:
            old = _run(so, cells, counts, box, params, dims, uniform, all_lj,
                       ch3, x_halo)
            ref = cell_pair.cell_pair_forces_colt_ref(
                cells, counts, box, params, dims, uniform, all_lj, ch3,
                x_halo)
            torch.testing.assert_close(
                old, ref, rtol=0, atol=2e-5 * (1 + ref.abs().max().item()))
            for kw in plans:
                plan = cell_pair.colt_launch_plan(
                    dims, cells.shape[1], params.shape[1], x_halo, **kw)
                new = _run(so, cells, counts, box, params, dims, uniform,
                           all_lj, ch3, x_halo, plan)
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


@pytest.fixture(scope="module")
def melt():
    built, _, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                         thermostat="no", device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, testsystems.warmup(built, st, steps=50)


@pytest.mark.parametrize("x_halo", [False, True], ids=["full", "slab"])
def test_emulated_kernel_equals_cellwise(emu, melt, x_halo):
    """The 70-trimer melt (3^3 cells, cap 24), the full grid or the middle
    slab of 3: the same bits in every mode and channel, the uniform modes
    with the melt's parameters, the lookups with per-pair ones."""
    built, st = melt
    cfg = built.cfg
    packed = cell_pair.pack_rows(st.pos, st.type_id, st.active)
    if x_halo:
        nx, ny, nz = cfg.cell_dims
        ids = cell_pair_halo.slab_cells(tuple(cfg.cell_dims), 3, 1, "cpu")
        cells, counts = cell_pair.colt_operands(packed, st.nbr.buckets[ids],
                                                ids.numel())
        dims = (nx // 3 + 2, ny, nz)
    else:
        cells, counts = cell_pair.colt_operands(
            packed, st.nbr.buckets, int(np.prod(cfg.cell_dims)))
        dims = cfg.cell_dims
    # the full grid under the default plan and one whose lists fill, the
    # slab under every plan
    plans = PLANS if x_halo else PLANS[:2]
    _same_bits(emu, cells, counts, st.box,
               cell_pair.pair_params(built.spec, cfg.n_types), dims, x_halo,
               modes=MODES[:1], plans=plans)
    _same_bits(emu, cells, counts, st.box,
               _mixed_params(built.spec, cfg.n_types), dims, x_halo,
               modes=MODES[1:], plans=plans)


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


@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((5, 3, 7), 24)])
def test_emulated_kernel_on_ragged_cells(emu, dims, cap):
    """Random occupancy, the full grid and a slab of its first three
    layers: the same bits in every mode (each in one channel, the three
    channels in turn), with one warp a block, its list of one pass or of
    the default depth."""
    cells, counts, box = _random_cells(dims, cap, cap)
    plans = [dict(threads=32), dict(threads=32, depth=1)]
    for x_halo in (False, True):
        for k, mode in enumerate(MODES):
            _same_bits(emu, cells, counts, box, RAGGED_PARAMS, dims, x_halo,
                       modes=[mode], channels=CH3[k:k + 1], plans=plans)


def test_emulated_box_change_under_one_plan(emu, melt):
    """The box shrinks between two calls under one cached plan (as under a
    barostat): the cull reads the new box on the device, and the kernel
    still equals the cellwise kernel on the new box."""
    built, st = melt
    cfg = built.cfg
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    plan = cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types)
    for scale in (1.0, 0.97):
        box = st.box * scale
        pos = st.pos * scale
        cells, counts = cell_pair.colt_operands(
            cell_pair.pack_rows(pos, st.type_id, st.active), st.nbr.buckets,
            int(np.prod(cfg.cell_dims)))
        assert cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                          cfg.n_types) is plan
        old = _run(emu, cells, counts, box, params, cfg.cell_dims, True,
                   True, cell_pair.CH3_VIRIAL, False)
        new = _run(emu, cells, counts, box, params, cfg.cell_dims, True,
                   True, cell_pair.CH3_VIRIAL, False, plan)
        assert torch.equal(new, old), scale


def test_emulated_launcher_refuses_a_plan_of_other_bytes(emu, melt):
    """The launcher checks the plan against its own layout: bytes that
    differ, a batch wider than a warp, a block of part of a warp or no
    list give cudaErrorInvalidValue, and nothing runs."""
    built, st = melt
    cfg = built.cfg
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    out = cell_pair._out_rows(cells, cfg.cell_dims, False).fill_(7.0)
    args = cell_pair._colt_pointers(cells, counts, st.box, params, out,
                                    cfg.cell_dims, True, True, 0, False)
    plan = cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types)
    smem = cell_pair.colt_smem
    odd = plan._replace(threads=48, smem=smem(
        cfg.cell_cap, cfg.n_types, plan.seg, 48, plan.depth))
    no_list = plan._replace(depth=0, smem=smem(
        cfg.cell_cap, cfg.n_types, plan.seg, plan.threads, 0))
    bad = [cell_pair.colt_plan_args(p) for p in (
        plan._replace(smem=plan.smem + 16), plan._replace(rows=33), odd,
        no_list)]
    for a in bad:
        assert emu.cell_pair_colt(*args, *a, None) == 1, a
    assert bool((out == 7.0).all())


def test_emulated_kernel_gives_the_same_bits_twice(emu, melt):
    built, st = melt
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    plan = cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types)
    a, b = (_run(emu, cells, counts, st.box, params, cfg.cell_dims, True,
                 True, cell_pair.CH3_ENERGY, False, plan) for _ in range(2))
    assert torch.equal(a, b)
