"""K2's host side, on the CPU: the stencil mask (``cell_pair.stencil_mask``)
and the launch plan (``cell_pair.k2_launch_plan``).  The mask keeps, in the
column-segment kernel's lane order, exactly the offsets that
``neighbor_cell_offsets`` keeps, in its order, on every grid of 1 to 4
cells an axis.  The plan comes from the shapes alone (never the counts or
the box), its bytes are those of K1's shared-memory layout, it fills the
card where the grid can, and a plan above 227 KiB raises naming K2.  The
cellwise K2, kept as the baseline, stays off the step."""

import inspect
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from chemlab_tpu_torch.engine import cell_pair, neighbor

T = 7            # the melt's types

# (id, dims, cap): the 10k melt at cap 36, the 2x2x2 melt, the film of
# 32 x 32 x 2 cells, grids with an axis of 1
GRIDS = [("10k-cap36", (11, 11, 11), 36), ("grid222", (2, 2, 2), 24),
         ("film", (32, 32, 2), 36), ("slab1", (4, 3, 1), 20),
         ("line", (1, 1, 7), 13)]
IDS = [g[0] for g in GRIDS]


def _lane_offset(o):
    return o // 9 - 1, o // 3 % 3 - 1, o % 3 - 1


@pytest.mark.parametrize("dims", list(itertools.product((1, 2, 3, 4),
                                                        repeat=3)),
                         ids=lambda d: "x".join(map(str, d)))
def test_mask_keeps_the_deduplicated_stencil_in_order(dims):
    mask = cell_pair.stencil_mask(dims)
    assert 0 < mask < 1 << 27
    kept = [tuple(d % n for d, n in zip(_lane_offset(o), dims))
            for o in range(27) if mask >> o & 1]
    assert kept == [tuple(r) for r in
                    neighbor.neighbor_cell_offsets(dims).tolist()]
    # a full grid keeps all 27 (on an axis of 1 the first residue is the
    # offset -1, which names the cell itself)
    assert (mask == (1 << 27) - 1) == (min(dims) >= 3)


def test_mask_is_an_int_made_once_per_grid():
    """The mask goes to the kernel as an int argument: no tensor, nothing
    copied to the device on a call."""
    assert type(cell_pair.stencil_mask((2, 2, 2))) is int
    assert cell_pair.stencil_mask([2, 2, 2]) == cell_pair.stencil_mask(
        (2, 2, 2))
    n0 = cell_pair._mask.cache_info().misses
    cell_pair.stencil_mask((2, 3, 2))
    cell_pair.stencil_mask(np.array([2, 3, 2]))
    assert cell_pair._mask.cache_info().misses <= n0 + 1


@pytest.mark.parametrize("dims,cap", [g[1:] for g in GRIDS], ids=IDS)
def test_k2_plan_bytes_and_blocks(dims, cap):
    """K1's layout at K1's choices (the fastest on K2's main-path grid);
    the segment the longest of at most COLT_SEG cells that leaves 264
    blocks (or one cell a block), evenly split over nz."""
    plan = cell_pair.k2_launch_plan(dims, cap, T)
    assert (plan.rows, plan.threads, plan.depth) == (
        cell_pair.COLT_ROWS, cell_pair.COLT_THREADS, cell_pair.COLT_DEPTH)
    assert plan.smem == cell_pair.colt_smem(cap, T, plan.seg, plan.threads,
                                            plan.depth)
    assert plan.smem <= 227 * 1024
    nx, ny, nz = dims
    assert plan.seg == cell_pair.plan_segment(dims, False,
                                              cell_pair.COLT_SEG)
    assert 1 <= plan.seg <= min(cell_pair.COLT_SEG, nz)
    blocks = nx * ny * -(-nz // plan.seg)
    assert blocks >= cell_pair.MIN_BLOCKS or plan.seg == 1


def test_k2_plan_raises_above_227_kib_naming_k2():
    with pytest.raises(ValueError, match="K2: shared-memory stage of") \
            as err:
        cell_pair.k2_launch_plan((3, 3, 3), 600, T)
    assert "227 KiB" in str(err.value)
    assert str(cell_pair.colt_smem(600, T, 1, cell_pair.COLT_THREADS,
                                   cell_pair.COLT_DEPTH)) in str(err.value)
    with pytest.raises(ValueError, match="K2: no plan"):
        cell_pair.k2_launch_plan((2, 2, 2), 24, T, rows=33)


def test_k2_plan_never_depends_on_the_counts_or_the_box():
    params = list(inspect.signature(cell_pair.k2_launch_plan).parameters)
    assert params[:3] == ["dims", "cap", "n_types"]
    assert not any(w in p for p in params
                   for w in ("count", "cells", "box", "pos"))
    a = cell_pair.k2_launch_plan((2, 2, 2), 24, T)
    b = cell_pair.k2_launch_plan([2, 2, 2], 24, T)
    assert a is b


def test_the_cellwise_k2_stays_off_the_step():
    """K2's cellwise handle is no TPU kernel's counterpart: outside BY_NAME
    and KERNELS, its entry point in cell_pair_cell.cu beside the new one,
    the two device functions' names apart from each other and from K1's
    (the profiler's timer matches names by substring), and no step
    function reaches it."""
    old = cell_pair.K2_CELLWISE
    assert not any(k is old for k in cell_pair.KERNELS)
    assert cell_pair.BY_NAME["K2"] is cell_pair.K2
    assert old.source == cell_pair.K2.source
    src = cell_pair.K2.source.read_text()
    for symbol in ("cell_pair_cell", "cell_pair_cell_cellwise"):
        assert 'extern "C" int %s(' % symbol in src
    names = ("cell_packed_kernel", "cell_cellwise_kernel",
             "colt_packed_kernel", "colt_cellwise_kernel",
             "cheb_packed_kernel", "cheb_cellwise_kernel")
    for a, b in itertools.permutations(names, 2):
        assert a not in b
    for name in names[:2]:
        assert "__global__ void %s(" % name in src
    text = Path(cell_pair.__file__).read_text()
    for step_fn in ("def cell_pair_forces(", "def pair_rows(",
                    "def cell_cells("):
        body = text[text.index(step_fn):]
        body = body[:body.index("\ndef ", 1)]
        assert "cellwise" not in body and "CELLWISE" not in body


def test_cellwise_k2_wrapper_refuses_cpu_tensors():
    cells = torch.zeros((8, 8, 4))
    counts = torch.zeros(8, dtype=torch.int32)
    box = torch.full((3,), 3.0)
    params = torch.ones((5, 1, 1))
    n0 = cell_pair.K2_CELLWISE.launches
    for fn in (cell_pair.cell_pair_forces_cell_cellwise,
               cell_pair.cell_pair_forces_cell_kernel):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(cells, counts, box, params, (2, 2, 2), True, True,
               cell_pair.CH3_NONE)
    assert cell_pair.K2_CELLWISE.launches == n0
