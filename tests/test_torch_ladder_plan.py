"""K3a's and K3d's launch plans, on the CPU:
``cell_pair_variants.packet_launch_plan`` comes from the cap alone and
``column_launch_plan`` from the cap and the grid (never the counts or the
box); their bytes are those of the kernels' stages and lists, a layout the
kernel cannot take raises naming it, and a plan above 227 KiB raises naming
it with its size.  The 100k melt's grid (24^3 at cap 40, and 48 after a
capacity regrowth) stays within the opt-in.  The first designs stay off
the step."""

import inspect
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


@pytest.mark.parametrize("cap", [40, 48])
def test_plans_at_the_100k_grid_fit_the_opt_in(cap):
    """24^3 cells at cap 40, and 48 after a regrowth: both default plans
    fit the 227 KiB a block may opt in to."""
    dims = (24, 24, 24)
    for plan in (variants.packet_launch_plan(cap),
                 variants.column_launch_plan(cap, dims)):
        assert plan.smem <= variants.SMEM_LIMIT == 227 * 1024


def test_plans_never_depend_on_the_counts_or_the_box():
    for fn, first in ((variants.packet_launch_plan, ["cap"]),
                      (variants.column_launch_plan, ["cap", "dims"])):
        params = list(inspect.signature(fn).parameters)
        assert params[:len(first)] == first
        assert not any(w in p for p in params
                       for w in ("count", "cells", "box", "pos"))
    assert variants.packet_launch_plan(32) is variants.packet_launch_plan(32)
    assert variants.column_launch_plan(36, (11, 11, 11)) is \
        variants.column_launch_plan(36, [11, 11, 11])


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
            ("column", cell_pair.K3D, cell_pair.K3D_CELLWISE,
             "column_baseline_kernel", (km.K3D_NEW, km.K3D_OLD))):
        assert not any(k is old for k in cell_pair.KERNELS)
        assert variants.KERNEL_OF[kind] is new
        assert old.source == new.source
        for symbol in (new.symbol, old.symbol):
            assert 'extern "C" int %s(' % symbol in src
        for name in names:
            assert "__global__ void %s(" % name in src
        handle = [n for n in dir(cell_pair) if getattr(cell_pair, n) is old]
        users = [block.split("(", 1)[0]
                 for block in text.split("\ndef ")[1:]
                 if handle[0] in block]
        assert users == [wrapper]
    names = list(km.LADDER_KERNEL_NAMES.values()) + [
        km.K3A_OLD, km.K3B_OLD, km.K3D_OLD]
    for a in names:
        assert sum(a in b for b in names) == 1, a
    for step_fn in ("def cell_pair_forces_packets(",
                    "def cell_pair_forces_columns(", "def _both_channels(",
                    "def ladder_cells("):
        body = text[text.index(step_fn):]
        body = body[:body.index("\ndef ", 1)]
        assert "cellwise" not in body and "CELLWISE" not in body
