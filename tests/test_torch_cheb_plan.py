"""The launch plan of the column-segment Chebyshev kernel (K1c, K1d, K1e
and their K1f modes), on the CPU: ``cell_pair.cheb_launch_plan`` at the
10k grid (11^3, cap 32), the 100k grid (24^3, cap 40), the blended pack
and a 2-layer slab.  The plan comes from the shapes alone, its bytes are
those of the kernel's shared-memory layout, the 10k grid gets at least two
blocks per SM of the card, and a plan above 227 KiB raises."""

import inspect

import pytest

from chemlab_tpu_torch.engine import cell_pair

T = 7            # the melt's types
KW, KO = 8, 0    # the tabulated melt's fit

# (id, dims, cap, coefficient rows, blend, x_halo)
GRIDS = [("10k", (11, 11, 11), 32, 1, False, False),
         ("100k", (24, 24, 24), 40, 1, False, False),
         ("blend", (11, 11, 11), 32, 3, True, False),
         ("slab2", (4, 11, 11), 40, 1, False, True)]


def _layout_bytes(cap, n_rows, mix, seg, threads, depth):
    """The kernel's stage, written out: 9 z-columns of seg + 2 cells, cap
    float4 rows a cell and one row of padding a column; depth float4 list
    entries per thread; the pack (2 kw + 2 ko + 6 floats a row); cut2 and
    tmap (and tmap_b and xmat with the blend); the 9 (seg + 3) column
    prefixes; per staged cell (9 (seg + 2)) its count, row offset and
    6-float bounding box; the largest cutoff^2 per type."""
    stage = 9 * ((seg + 2) * cap + 1) * 16
    lists = threads * depth * 16
    pack = n_rows * (2 * KW + 2 * KO + 6) * 4
    maps = T * T * 4 * (4 if mix else 2)
    prefixes = 9 * (seg + 3) * 4
    staged = 9 * (seg + 2) * (4 + 4 + 6 * 4)
    return stage + lists + pack + maps + prefixes + staged + T * 4


def _blocks(dims, plan, x_halo):
    nx, ny, nz = dims
    return (nx - 2 if x_halo else nx) * ny * -(-nz // plan.seg)


@pytest.mark.parametrize("dims,cap,n_rows,mix,x_halo",
                         [g[1:] for g in GRIDS], ids=[g[0] for g in GRIDS])
def test_plan_bytes_match_the_staged_layout(dims, cap, n_rows, mix, x_halo):
    plan = cell_pair.cheb_launch_plan(dims, cap, T, n_rows, KW, KO, mix,
                                      x_halo)
    assert plan.smem == _layout_bytes(cap, n_rows, mix, plan.seg,
                                      plan.threads, plan.depth)
    assert plan.smem <= 227 * 1024
    assert 1 <= plan.rows <= 32 and plan.threads % 32 == 0
    assert plan.depth >= 1
    # the segments tile z evenly: the last is at most one cell per segment
    # shorter than the others
    nz = dims[2]
    n_seg = -(-nz // plan.seg)
    assert 1 <= plan.seg <= cell_pair.CHEB_SEG
    assert plan.seg == -(-nz // n_seg)
    assert 0 < nz - (n_seg - 1) * plan.seg <= plan.seg


@pytest.mark.parametrize("dims,cap,n_rows,mix,x_halo",
                         [g[1:] for g in GRIDS], ids=[g[0] for g in GRIDS])
def test_plan_fills_the_card(dims, cap, n_rows, mix, x_halo):
    """At least two blocks per SM of the card's 132 wherever the grid has
    them (one z cell per block otherwise), and at 10k with the longest
    segment that does."""
    plan = cell_pair.cheb_launch_plan(dims, cap, T, n_rows, KW, KO, mix,
                                      x_halo)
    blocks = _blocks(dims, plan, x_halo)
    assert blocks >= 264 or plan.seg == 1
    # the longest segment (up to CHEB_SEG) that leaves 264 blocks, evenly
    # split over nz
    nz, cols = dims[2], (dims[0] - 2 if x_halo else dims[0]) * dims[1]
    fits = [s for s in range(1, cell_pair.CHEB_SEG + 1)
            if cols * -(-nz // s) >= 264]
    longest = max(fits) if fits else 1
    assert plan.seg == -(-nz // -(-nz // longest))


def test_plan_at_the_10k_grid_is_two_blocks_per_sm():
    plan = cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 1, KW, KO, False)
    assert _blocks((11, 11, 11), plan, False) >= 2 * 132


@pytest.mark.parametrize("rows", [2300, 3000])
def test_plan_raises_above_227_kib(rows):
    """A coefficient pack that cannot fit: ValueError naming the bytes."""
    with pytest.raises(ValueError, match="227 KiB") as err:
        cell_pair.cheb_launch_plan((11, 11, 11), 32, T, rows, KW, KO, False)
    seg = cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 1, KW, KO,
                                     False).seg
    size = _layout_bytes(32, rows, False, seg, cell_pair.CHEB_THREADS,
                         cell_pair.CHEB_DEPTH)
    assert str(size) in str(err.value)


def test_plan_raises_on_a_stage_that_cannot_fit():
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.cheb_launch_plan((24, 24, 24), 1024, T, 1, KW, KO, False)
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 1, KW, KO, False,
                                   threads=1024, depth=16)


def test_plan_never_depends_on_the_counts():
    """The plan takes shapes and flags only: no operand tensor, so the host
    never reads the device's counts to launch."""
    params = list(inspect.signature(cell_pair.cheb_launch_plan).parameters)
    assert params[:8] == ["dims", "cap", "n_types", "n_rows", "kw", "ko",
                          "mix", "x_halo"]
    assert not any("count" in p or "cells" in p for p in params)
    a = cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 1, KW, KO, False)
    b = cell_pair.cheb_launch_plan([11, 11, 11], 32, T, 1, KW, KO, False)
    assert a == b


@pytest.mark.parametrize("override", [dict(rows=0), dict(rows=33),
                                      dict(threads=100), dict(threads=2048),
                                      dict(depth=0), dict(seg=0),
                                      dict(rows=8, threads=0),
                                      dict(threads=16)])
def test_plan_refuses_layouts_the_kernel_cannot_take(override):
    with pytest.raises((ValueError, ZeroDivisionError)):
        cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 1, KW, KO, False,
                                   **override)


def test_plan_overrides_keep_the_layout_bytes():
    for seg, rows, threads, depth in ((1, 1, 32, 1), (2, 32, 64, 4),
                                      (6, 9, 256, 5), (11, 3, 128, 32)):
        plan = cell_pair.cheb_launch_plan((11, 11, 11), 32, T, 3, KW, KO,
                                          True, seg=seg, rows=rows,
                                          threads=threads, depth=depth)
        assert tuple(plan)[:4] == (seg, rows, threads, depth)
        assert plan.smem == _layout_bytes(32, 3, True, seg, threads, depth)


def test_the_cellwise_kernel_stays_off_the_step():
    """The cellwise handles are no TPU kernel's counterpart: outside
    BY_NAME, never chosen by ``cheb_kernel_for``, named only by cell_pair
    (which defines them) and the kernel matrix (the A/B), and their entry
    points are in the Chebyshev source beside the new ones."""
    from pathlib import Path

    olds = (cell_pair.K1C_CELLWISE, cell_pair.K1D_CELLWISE)
    assert not any(k is o for k in cell_pair.KERNELS for o in olds)
    assert len(cell_pair.BY_NAME) == 14
    for tmap_b in (None, object()):
        for ntab in (0, 1):
            for x_halo in (False, True):
                if tmap_b is not None and ntab == 0:
                    continue
                k = cell_pair.cheb_kernel_for(tmap_b, ntab, x_halo)
                assert k in cell_pair.KERNELS
                assert k.symbol in ("cell_pair_cheb", "cell_pair_cheb_mix")
    src = cell_pair.K1C.source.read_text()
    for k in olds:
        assert 'extern "C" int %s(' % k.symbol in src
        assert k.source == cell_pair.K1C.source
    # the new device function's name neither holds nor is held by the old
    # one's (the profiler's timer matches names by substring)
    assert "cheb_packed_kernel" in src and "cheb_cellwise_kernel" in src
    pkg = Path(cell_pair.__file__).resolve().parent.parent
    users = sorted(p.relative_to(pkg).as_posix()
                   for p in pkg.rglob("*.py") if "cellwise" in p.read_text())
    assert users == ["engine/cell_pair.py", "kernel_matrix.py"]
    text = Path(cell_pair.__file__).read_text()
    body = text[text.index("def cell_pair_forces("):]
    assert "cellwise" not in body


def test_cellwise_wrapper_refuses_cpu_tensors():
    import torch

    cells = torch.zeros((27, 8, 4))
    counts = torch.zeros(27, dtype=torch.int32)
    box = torch.full((3,), 3.0)
    cut2 = torch.ones((1, 1))
    tmap = torch.ones((1, 1), dtype=torch.int32)
    coef = torch.zeros((1, 2 * 2 + 6))
    n0 = cell_pair.K1C_CELLWISE.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_cheb_cellwise(
            cells, counts, box, cut2, tmap, None, None, coef, (3, 3, 3), 2,
            0, 0)
    assert cell_pair.K1C_CELLWISE.launches == n0
