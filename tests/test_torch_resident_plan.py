"""K3b's launch plan, on the CPU: ``cell_pair_variants.resident_launch_plan``
comes from the cap alone (never the counts or the box), its bytes are
those of the kernel's lists, its blocks hold at least 4 warps, and a plan
above 227 KiB raises naming K3b.  The baseline K3b stays off the step."""

import inspect
from pathlib import Path

import pytest

from chemlab_tpu_torch.engine import cell_pair
from chemlab_tpu_torch.engine import cell_pair_variants as variants


@pytest.mark.parametrize("cap", [8, 24, 32, 40, 64])
def test_resident_plan_defaults_and_bytes(cap):
    plan = variants.resident_launch_plan(cap)
    assert plan.rows == min(variants.RESIDENT_ROWS, cap)
    assert (plan.threads, plan.depth) == (variants.RESIDENT_THREADS,
                                          variants.RESIDENT_DEPTH)
    # depth entries a thread, a float4 and a float each
    assert plan.smem == plan.threads * plan.depth * (16 + 4)
    assert plan.threads % 32 == 0 and plan.threads >= 4 * 32
    assert 1 <= plan.rows <= 32


@pytest.mark.parametrize("override", [dict(rows=0), dict(rows=33),
                                      dict(threads=96), dict(threads=100),
                                      dict(threads=2048), dict(depth=0)])
def test_resident_plan_refuses_layouts_the_kernel_cannot_take(override):
    with pytest.raises(ValueError, match="K3b: no plan"):
        variants.resident_launch_plan(32, **override)


def test_resident_plan_raises_above_227_kib_naming_k3b():
    size = variants.resident_smem(1024, 12)
    assert size > 227 * 1024
    with pytest.raises(ValueError, match="K3b: lists of") as err:
        variants.resident_launch_plan(32, threads=1024, depth=12)
    assert str(size) in str(err.value) and "227 KiB" in str(err.value)


def test_resident_plan_never_depends_on_the_counts_or_the_box():
    params = list(inspect.signature(variants.resident_launch_plan)
                  .parameters)
    assert params[0] == "cap"
    assert not any(w in p for p in params
                   for w in ("count", "cells", "box", "pos", "dims"))
    assert variants.resident_launch_plan(32) is \
        variants.resident_launch_plan(32)


def test_the_baseline_k3b_stays_off_the_step():
    """The baseline handle is outside BY_NAME and KERNELS, beside the new
    entry point in the ladder's source, the two device functions' names
    apart (the profiler's timer matches by substring), and only the
    baseline's own wrapper names it."""
    old = cell_pair.K3B_CELLWISE
    assert not any(k is old for k in cell_pair.KERNELS)
    assert cell_pair.BY_NAME["K3b"] is cell_pair.K3B
    assert variants.KERNEL_OF["resident"] is cell_pair.K3B
    src = cell_pair.K3B.source.read_text()
    assert old.source == cell_pair.K3B.source
    for symbol in ("ladder_resident", "ladder_resident_packet"):
        assert 'extern "C" int %s(' % symbol in src
    new_name, old_name = "ladder_resident_kernel", \
        "ladder_resident_packet_kernel"
    assert new_name not in old_name and old_name not in new_name
    assert "__global__ void %s(" % old_name in src
    assert "__global__ void %s(" % new_name in src
    text = Path(variants.__file__).read_text()
    users = [block.split("(", 1)[0] for block in text.split("\ndef ")[1:]
             if "K3B_CELLWISE" in block]
    assert users == ["resident_packet_kernel"]
    for step_fn in ("def cell_pair_forces_resident(", "def _both_channels(",
                    "def ladder_cells("):
        body = text[text.index(step_fn):]
        body = body[:body.index("\ndef ", 1)]
        assert "packet_kernel" not in body and "CELLWISE" not in body
