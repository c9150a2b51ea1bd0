"""K3a's, K3c's, K3d's and K1''s launch plans, on the CPU:
``cell_pair_variants.packet_launch_plan`` comes from the cap alone,
``colz_launch_plan`` and ``column_launch_plan`` from the cap and the grid,
``colt1_launch_plan`` from the grid, the cap and the types (never the
counts or the box); their bytes are those of the kernels' stages, lists and
tables, a layout the kernel cannot take raises naming it, and a plan above
227 KiB raises naming it with its size.  The 100k melt's grid (24^3 at cap
40, and 48 after a capacity regrowth) stays within the opt-in.  The first
designs stay off the step."""

import inspect
import re
from pathlib import Path

import pytest

from chemlab_tpu_torch.engine import cell_pair
from chemlab_tpu_torch.engine import cell_pair_variants as variants

GRIDS = [(11, 11, 11), (32, 32, 2), (2, 2, 2), (4, 3, 1), (24, 24, 24)]


@pytest.mark.parametrize("cap", [8, 24, 32, 40, 48])
def test_packet_plan_defaults_and_bytes(cap):
    plan = variants.packet_launch_plan(cap)
    assert (plan.threads, plan.depth) == (variants.PACKET_THREADS,
                                          variants.PACKET_DEPTH)
    # a stage of 27 cells of cap rows (16 bytes each), then depth list
    # entries a thread, a float4 and a float each
    assert plan.smem == 16 * 27 * cap + plan.threads * plan.depth * (16 + 4)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("cap", [9, 32, 36, 40, 48])
def test_column_plan_defaults_and_bytes(cap, dims):
    plan = variants.column_launch_plan(cap, dims)
    n_stencil = variants.table_sizes(dims)[0]
    assert plan.rows == min(variants.COLUMN_ROWS, cap)
    assert (plan.threads, plan.depth) == (variants.COLUMN_THREADS,
                                          variants.COLUMN_DEPTH)
    # a stage of the S stencil cells (the columns' windows) of cap rows,
    # the lists, and an int a stage row (each candidate's row)
    assert plan.smem == (20 * n_stencil * cap
                         + plan.threads * plan.depth * (16 + 4))
    assert 1 <= plan.rows <= 32 and plan.threads % 32 == 0


@pytest.mark.parametrize("dims", GRIDS)
@pytest.mark.parametrize("cap", [8, 32, 40, 48])
def test_colz_plan_defaults_and_bytes(cap, dims):
    plan = variants.colz_launch_plan(cap, dims)
    n_stencil, n_cols = variants.table_sizes(dims)
    nz = dims[2]
    assert plan.rows == min(variants.COLZ_ROWS, cap)
    assert plan.depth == variants.COLZ_DEPTH
    # a stage of the U whole neighbour columns (nz cap rows of 16 bytes),
    # the lists, the U nz counts and a 16-bit table of S cap rows a warp
    assert plan.smem == (16 * n_cols * nz * cap
                         + plan.threads * plan.depth * (16 + 4)
                         + 4 * n_cols * nz
                         + 2 * (plan.threads // 32) * n_stencil * cap)
    # the most warps up to COLZ_THREADS whose bytes fit a block
    assert plan.threads % 32 == 0 and plan.threads <= variants.COLZ_THREADS
    assert plan.smem <= variants.SMEM_LIMIT
    if plan.threads < variants.COLZ_THREADS:
        assert variants.colz_smem(cap, dims, plan.threads + 32,
                                  plan.depth) > variants.SMEM_LIMIT
    # the stage's rows fit the 16-bit tables, its bytes one mbarrier phase
    assert n_cols * nz * cap < 2 ** 16
    assert 16 * n_cols * nz * cap < 2 ** 20 - 1


def test_colz_plan_at_10k_is_the_measured_one():
    """At 10k (11^3, cap 32) the stage of 9 whole columns is 50 688 bytes
    and the measured plan fits whole."""
    plan = variants.colz_launch_plan(32, (11, 11, 11))
    assert (plan.rows, plan.threads, plan.depth) == (
        variants.COLZ_ROWS, variants.COLZ_THREADS, variants.COLZ_DEPTH)
    assert 16 * 9 * 11 * 32 == 50688


@pytest.mark.parametrize("dims", [(11, 11, 11), (24, 24, 24), (5, 4, 3)])
@pytest.mark.parametrize("cap", [8, 32, 48])
def test_colt1_plan_defaults_and_bytes(cap, dims):
    T = 7
    plan = variants.colt1_launch_plan(dims, cap, T)
    assert plan.seg == cell_pair.plan_segment(dims, False, variants.COLT1_SEG)
    assert (plan.rows, plan.threads, plan.depth) == (
        variants.COLT1_ROWS, variants.COLT1_THREADS, variants.COLT1_DEPTH)
    # K1's layout and a byte a list entry (its column)
    assert plan.smem == cell_pair.colt_smem(cap, T, plan.seg, plan.threads,
                                            plan.depth) \
        + plan.threads * plan.depth
    assert isinstance(plan, cell_pair.PackedPlan)


def test_colt1_plan_takes_one_block_per_xy_column():
    """A segment of nz is the reference's one program per xy column: at
    the 100k grid at cap 48 with 256 threads and depth 4 it needs ~205 KB,
    within the opt-in."""
    plan = variants.colt1_launch_plan((24, 24, 24), 48, 7, seg=24,
                                      threads=256, depth=4)
    assert 200 * 1000 < plan.smem <= variants.SMEM_LIMIT


@pytest.mark.parametrize("override", [dict(threads=16), dict(threads=100),
                                      dict(threads=2048), dict(depth=0)])
def test_packet_plan_refuses_layouts_the_kernel_cannot_take(override):
    with pytest.raises(ValueError, match="K3a: no plan"):
        variants.packet_launch_plan(32, **override)


@pytest.mark.parametrize("cap", [4, 12, 36])
def test_packet_plan_needs_whole_packets(cap):
    with pytest.raises(ValueError, match="K3a: no plan with cap %d" % cap):
        variants.packet_launch_plan(cap)


@pytest.mark.parametrize("override", [dict(rows=0), dict(rows=33),
                                      dict(threads=16), dict(threads=100),
                                      dict(threads=2048), dict(depth=0)])
def test_column_plan_refuses_layouts_the_kernel_cannot_take(override):
    with pytest.raises(ValueError, match="K3d: no plan"):
        variants.column_launch_plan(36, (11, 11, 11), **override)


@pytest.mark.parametrize("override", [dict(rows=0), dict(rows=33),
                                      dict(threads=16), dict(threads=100),
                                      dict(threads=1024), dict(depth=0)])
def test_colz_plan_refuses_layouts_the_kernel_cannot_take(override):
    """Among them more threads than ``COLZ_THREADS``: at K3c's registers a
    thread, 32 warps do not fit an SM."""
    with pytest.raises(ValueError, match="K3c: no plan"):
        variants.colz_launch_plan(32, (11, 11, 11), **override)


@pytest.mark.parametrize("override", [dict(seg=0), dict(rows=0),
                                      dict(rows=33), dict(threads=16),
                                      dict(threads=100), dict(threads=512),
                                      dict(depth=0)])
def test_colt1_plan_refuses_layouts_the_kernel_cannot_take(override):
    """Among them more threads than ``COLT1_THREADS``, the kernel's launch
    bounds."""
    with pytest.raises(ValueError, match="K1': no plan"):
        variants.colt1_launch_plan((11, 11, 11), 32, 7, **override)


def test_plans_raise_above_227_kib_naming_the_kernel():
    size = variants.packet_smem(48, 1024, 12)
    assert size > 227 * 1024
    with pytest.raises(ValueError, match="K3a: shared memory") as err:
        variants.packet_launch_plan(48, threads=1024, depth=12)
    assert str(size) in str(err.value) and "227 KiB" in str(err.value)
    dims = (24, 24, 24)
    size = variants.column_smem(48, dims, 1024, 12)
    assert size > 227 * 1024
    with pytest.raises(ValueError, match="K3d: shared memory") as err:
        variants.column_launch_plan(48, dims, threads=1024, depth=12)
    assert str(size) in str(err.value) and "227 KiB" in str(err.value)
    # K3c: a stage of whole columns too large for any warp count, and too
    # many warps beside a stage that fits
    for cap, kw in ((104, {}), (48, dict(threads=896))):
        size = variants.colz_smem(cap, dims, kw.get("threads", 32),
                                  variants.COLZ_DEPTH)
        assert size > 227 * 1024
        with pytest.raises(ValueError, match="K3c: shared memory") as err:
            variants.colz_launch_plan(cap, dims, **kw)
        assert str(size) in str(err.value) and "227 KiB" in str(err.value)
    size = variants.colt1_smem(56, 7, 24, variants.COLT1_THREADS,
                               variants.COLT1_DEPTH)
    assert size > 227 * 1024
    with pytest.raises(ValueError, match="K1': shared-memory stage") as err:
        variants.colt1_launch_plan(dims, 56, 7, seg=24)
    assert str(size) in str(err.value) and "227 KiB" in str(err.value)


@pytest.mark.parametrize("cap", [40, 48])
def test_plans_at_the_100k_grid_fit_the_opt_in(cap):
    """24^3 cells at cap 40, and 48 after a regrowth: both default plans
    fit the 227 KiB a block may opt in to."""
    dims = (24, 24, 24)
    for plan in (variants.packet_launch_plan(cap),
                 variants.colz_launch_plan(cap, dims),
                 variants.column_launch_plan(cap, dims),
                 variants.colt1_launch_plan(dims, cap, 7),
                 variants.colt1_launch_plan(dims, cap, 7, seg=24)):
        assert plan.smem <= variants.SMEM_LIMIT == 227 * 1024
    # K3c's stage of 9 whole columns: 138 240 bytes at cap 40, 165 888 at
    # 48, which leaves room for fewer warps than at 10k
    colz = variants.colz_launch_plan(cap, dims)
    assert 16 * 9 * 24 * cap == {40: 138240, 48: 165888}[cap]
    assert 32 <= colz.threads < variants.COLZ_THREADS


def test_plans_never_depend_on_the_counts_or_the_box():
    for fn, first in ((variants.packet_launch_plan, ["cap"]),
                      (variants.colz_launch_plan, ["cap", "dims"]),
                      (variants.column_launch_plan, ["cap", "dims"]),
                      (variants.colt1_launch_plan,
                       ["dims", "cap", "n_types"])):
        params = list(inspect.signature(fn).parameters)
        assert params[:len(first)] == first
        assert not any(w in p for p in params
                       for w in ("count", "cells", "box", "pos"))
    assert variants.packet_launch_plan(32) is variants.packet_launch_plan(32)
    assert variants.column_launch_plan(36, (11, 11, 11)) is \
        variants.column_launch_plan(36, [11, 11, 11])
    assert variants.colz_launch_plan(32, (11, 11, 11)) is \
        variants.colz_launch_plan(32, [11, 11, 11])
    assert variants.colt1_launch_plan((11, 11, 11), 32, 7) is \
        variants.colt1_launch_plan([11, 11, 11], 32, 7)


def test_the_first_designs_stay_off_the_step():
    """The baseline handles are outside BY_NAME and KERNELS, beside the new
    entry points in the ladder's source, the device functions' names apart
    (the profiler's timer matches by substring), and only each baseline's
    own wrapper names it."""
    from chemlab_tpu_torch import kernel_matrix as km

    src = cell_pair.K3A.source.read_text()
    text = Path(variants.__file__).read_text()
    for kind, new, old, wrapper, names in (
            ("packet", cell_pair.K3A, cell_pair.K3A_CELLWISE,
             "packet_baseline_kernel", (km.K3A_NEW, km.K3A_OLD)),
            ("colz", cell_pair.K3C, cell_pair.K3C_CELLWISE,
             "colz_baseline_kernel", (km.K3C_NEW, km.K3C_OLD)),
            ("column", cell_pair.K3D, cell_pair.K3D_CELLWISE,
             "column_baseline_kernel", (km.K3D_NEW, km.K3D_OLD)),
            ("colt1", cell_pair.K1P, cell_pair.K1P_CELLWISE,
             "colt1_baseline_kernel", (km.K1P_NEW, km.K1P_OLD))):
        assert not any(k is old for k in cell_pair.KERNELS)
        assert variants.KERNEL_OF[kind] is new
        assert old.source == new.source
        for symbol in (new.symbol, old.symbol):
            assert 'extern "C" int %s(' % symbol in src
        for name in names:
            assert re.search(r"__global__ void (__launch_bounds__\([\d, ]+\) )?"
                             r"%s\(" % name, src), name
        handle = [n for n in dir(cell_pair) if getattr(cell_pair, n) is old]
        users = [block.split("(", 1)[0]
                 for block in text.split("\ndef ")[1:]
                 if handle[0] in block]
        assert users == [wrapper]
    names = list(km.LADDER_KERNEL_NAMES.values()) + [
        km.K3A_OLD, km.K3B_OLD, km.K3C_OLD, km.K3D_OLD, km.K1P_OLD,
        "colt_packed_kernel", "cell_packed_kernel"]
    for a in names:
        assert sum(a in b for b in names) == 1, a
    assert km.LADDER_KERNEL_NAMES["colz"] == km.K3C_NEW
    assert km.LADDER_KERNEL_NAMES["colt1"] == km.K1P_NEW
    for step_fn in ("def cell_pair_forces_packets(",
                    "def cell_pair_forces_columns(", "def _both_channels(",
                    "def cell_pair_forces_colt1(", "def ladder_cells("):
        body = text[text.index(step_fn):]
        body = body.split("\ndef ", 1)[0]
        assert "cellwise" not in body and "CELLWISE" not in body
        assert "baseline" not in body
