"""The launch plan of the LJ column-segment kernel (K1, K1b and K1f), on
the CPU: ``cell_pair.colt_launch_plan`` at the 10k grid (11^3, cap 32),
the NPT melt's grid (10^3, cap 40), the slabs of 2 and 4 ranks (7 and 4
x-layers of 11 x 11, cap 40) and the 100k grid (24^3, cap 40).  The plan
comes from the shapes alone (never the counts or the box), its bytes are
those of the kernel's shared-memory layout, it fills the card, and a plan above 227 KiB raises.  The cellwise LJ kernel, kept as
the baseline, stays off the step."""

import inspect
from pathlib import Path

import pytest
import torch

from chemlab_tpu_torch.engine import cell_pair

T = 7            # the melt's types

# (id, dims, cap, x_halo)
GRIDS = [("10k", (11, 11, 11), 32, False),
         ("npt", (10, 10, 10), 40, False),
         ("slab2", (7, 11, 11), 40, True),
         ("slab4", (4, 11, 11), 40, True),
         ("100k", (24, 24, 24), 40, False)]
IDS = [g[0] for g in GRIDS]


def _layout_bytes(cap, seg, threads, depth):
    """The kernel's stage, written out: 9 z-columns of seg + 2 cells, cap
    float4 rows a cell and one row of padding a column; depth float4 list
    entries per thread; the (5, T, T)
    parameters; the 9 (seg + 3) column prefixes; per staged cell (9 (seg +
    2)) its count, row offset and 6-float bounding box; the largest
    cutoff^2 per type."""
    stage = 9 * ((seg + 2) * cap + 1) * 16
    lists = threads * depth * 16
    params = 5 * T * T * 4
    prefixes = 9 * (seg + 3) * 4
    staged = 9 * (seg + 2) * (4 + 4 + 6 * 4)
    return stage + lists + params + prefixes + staged + T * 4


def _blocks(dims, plan, x_halo):
    nx, ny, nz = dims
    return (nx - 2 if x_halo else nx) * ny * -(-nz // plan.seg)


@pytest.mark.parametrize("depth", [None, 1], ids=["default", "depth1"])
@pytest.mark.parametrize("dims,cap,x_halo", [g[1:] for g in GRIDS], ids=IDS)
def test_plan_bytes_match_the_staged_layout(dims, cap, x_halo, depth):
    """The default plan, and one whose lists hold one pass a warp."""
    plan = cell_pair.colt_launch_plan(dims, cap, T, x_halo, depth=depth)
    assert plan.depth == (depth or cell_pair.COLT_DEPTH)
    assert plan.smem == _layout_bytes(cap, plan.seg, plan.threads,
                                      plan.depth)
    assert plan.smem == cell_pair.colt_smem(cap, T, plan.seg, plan.threads,
                                            plan.depth)
    assert plan.smem <= 227 * 1024
    assert 1 <= plan.rows <= 32 and plan.threads % 32 == 0
    assert plan.depth >= 1
    # the segments tile z evenly: the last is at most one cell per segment
    # shorter than the others
    nz = dims[2]
    n_seg = -(-nz // plan.seg)
    assert 1 <= plan.seg <= cell_pair.COLT_SEG
    assert plan.seg == -(-nz // n_seg)
    assert 0 < nz - (n_seg - 1) * plan.seg <= plan.seg


@pytest.mark.parametrize("dims,cap,x_halo", [g[1:] for g in GRIDS], ids=IDS)
def test_plan_fills_the_card(dims, cap, x_halo):
    """At least two blocks per SM of the card's 132 wherever the grid has
    them (one z cell per block otherwise), with the longest segment (up to
    COLT_SEG) that does, evenly split over nz: the rule of the Chebyshev
    plan."""
    plan = cell_pair.colt_launch_plan(dims, cap, T, x_halo)
    assert _blocks(dims, plan, x_halo) >= cell_pair.MIN_BLOCKS == 264 \
        or plan.seg == 1
    nz, cols = dims[2], (dims[0] - 2 if x_halo else dims[0]) * dims[1]
    fits = [s for s in range(1, cell_pair.COLT_SEG + 1)
            if cols * -(-nz // s) >= 264]
    longest = max(fits) if fits else 1
    assert plan.seg == -(-nz // -(-nz // longest))


def test_plan_defaults_are_the_measured_choices():
    plan = cell_pair.colt_launch_plan((11, 11, 11), 32, T)
    assert (plan.rows, plan.threads, plan.depth) == (
        cell_pair.COLT_ROWS, cell_pair.COLT_THREADS, cell_pair.COLT_DEPTH)


@pytest.mark.parametrize("override,size", [
    (dict(seg=2, threads=1024, depth=16), _layout_bytes(32, 2, 1024, 16)),
    (dict(seg=11, threads=1024, depth=11), _layout_bytes(32, 11, 1024, 11))])
def test_plan_raises_above_227_kib(override, size):
    """A stage or lists that cannot fit: ValueError naming the bytes."""
    assert size > 227 * 1024
    with pytest.raises(ValueError, match="227 KiB") as err:
        cell_pair.colt_launch_plan((11, 11, 11), 32, T, **override)
    assert str(size) in str(err.value)


def test_plan_raises_on_a_cap_that_cannot_fit():
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.colt_launch_plan((24, 24, 24), 1024, T)


def test_plan_never_depends_on_the_counts_or_the_box():
    """The plan takes shapes and flags only: no operand tensor, so the host
    never reads the device's counts or box to launch, and one cached plan
    serves every step of a moving box."""
    params = list(inspect.signature(cell_pair.colt_launch_plan).parameters)
    assert params[:4] == ["dims", "cap", "n_types", "x_halo"]
    assert not any(w in p for p in params
                   for w in ("count", "cells", "box", "pos"))
    a = cell_pair.colt_launch_plan((10, 10, 10), 40, T)
    b = cell_pair.colt_launch_plan([10, 10, 10], 40, T)
    assert a is b


@pytest.mark.parametrize("override", [dict(rows=0), dict(rows=33),
                                      dict(threads=100), dict(threads=2048),
                                      dict(threads=1056),
                                      dict(threads=16),
                                      dict(depth=0), dict(depth=-1),
                                      dict(seg=0), dict(rows=8, threads=0)])
def test_plan_refuses_layouts_the_kernel_cannot_take(override):
    with pytest.raises((ValueError, ZeroDivisionError)):
        cell_pair.colt_launch_plan((11, 11, 11), 32, T, **override)


def test_plan_overrides_keep_the_layout_bytes():
    for seg, rows, threads, depth in (
            (1, 1, 32, 1), (2, 32, 64, 4), (6, 9, 256, 5), (11, 3, 128, 2),
            (3, 8, 256, None)):
        plan = cell_pair.colt_launch_plan((11, 11, 11), 32, T, seg=seg,
                                          rows=rows, threads=threads,
                                          depth=depth)
        assert tuple(plan)[:3] == (seg, rows, threads)
        assert plan.depth == (depth or cell_pair.COLT_DEPTH)
        assert plan.smem == _layout_bytes(32, seg, threads, plan.depth)


def test_the_cellwise_lj_kernel_stays_off_the_step():
    """The LJ cellwise handle is no TPU kernel's counterpart: outside
    BY_NAME and KERNELS, its entry point in cell_pair.cu beside the new one,
    named only by cell_pair (which defines it) and the kernel matrix (the
    A/B), and no step function reaches it."""
    old = cell_pair.K1_CELLWISE
    assert not any(k is old for k in cell_pair.KERNELS)
    assert len(cell_pair.BY_NAME) == 14
    for k in (cell_pair.K1, cell_pair.K1B, cell_pair.K1F):
        assert k.symbol == "cell_pair_colt" and k in cell_pair.KERNELS
    src = cell_pair.K1.source.read_text()
    assert old.source == cell_pair.K1.source
    for symbol in ("cell_pair_colt", "cell_pair_colt_cellwise"):
        assert 'extern "C" int %s(' % symbol in src
    # the device functions' names: neither holds the other, nor any other
    # kernel's (the profiler's timer matches names by substring)
    new_name, old_name = "colt_packed_kernel", "colt_cellwise_kernel"
    assert new_name not in old_name and old_name not in new_name
    assert "__global__ void %s(" % old_name in src
    assert "__global__ void %s(" % new_name in src
    csrc = Path(cell_pair.K1.source).parent
    for other in csrc.glob("*.cu"):
        if other.name != "cell_pair.cu":
            text = other.read_text()
            assert new_name not in text and old_name not in text
    pkg = Path(cell_pair.__file__).resolve().parent.parent
    users = sorted(p.relative_to(pkg).as_posix() for p in pkg.rglob("*.py")
                   if "K1_CELLWISE" in p.read_text()
                   or "colt_cellwise" in p.read_text())
    assert users == ["engine/cell_pair.py", "kernel_matrix.py"]
    text = Path(cell_pair.__file__).read_text()
    for step_fn in ("def cell_pair_forces(", "def pair_rows(",
                    "def colt_cells("):
        body = text[text.index(step_fn):]
        body = body[:body.index("\ndef ", 1)]
        assert "cellwise" not in body and "CELLWISE" not in body


def test_cellwise_lj_wrapper_refuses_cpu_tensors():
    cells = torch.zeros((27, 8, 4))
    counts = torch.zeros(27, dtype=torch.int32)
    box = torch.full((3,), 3.0)
    params = torch.ones((5, 1, 1))
    n0 = cell_pair.K1_CELLWISE.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_colt_cellwise(
            cells, counts, box, params, (3, 3, 3), True, True,
            cell_pair.CH3_NONE)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_colt_kernel(
            cells, counts, box, params, (3, 3, 3), True, True,
            cell_pair.CH3_NONE)
    assert cell_pair.K1_CELLWISE.launches == n0


def test_library_path_hashes_the_included_header(tmp_path, monkeypatch):
    """An edited header rebuilds the sources that include it: the library's
    name hashes cell_pair.cu and cell_pair_packed.cuh."""
    from chemlab_tpu_torch.engine import _kernels

    for path in _kernels.source_files(cell_pair.K1.source):
        (tmp_path / path.name).write_text(path.read_text())
    monkeypatch.setattr(_kernels, "CSRC_DIR", tmp_path)
    kernel = _kernels.CudaKernel("cell_pair.cu", "cell_pair_colt", [])
    assert [p.name for p in _kernels.source_files(kernel.source)] == [
        "cell_pair.cu", "cell_pair_packed.cuh"]
    before = kernel.library_path()
    header = tmp_path / "cell_pair_packed.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert kernel.library_path() != before
