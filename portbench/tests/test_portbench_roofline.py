"""The yardstick's counts on cases counted by hand."""

import pytest
import torch

from portbench import roofline


def test_two_particles_one_pair():
    box = torch.tensor([10.0, 10.0, 10.0])
    pos = torch.tensor([[1.0, 1.0, 1.0], [2.0, 1.0, 1.0]])
    assert roofline.count_pairs(pos, box, 2.5) == 1
    # across the periodic boundary: 0.5 + 0.9 apart
    pos = torch.tensor([[0.5, 5.0, 5.0], [9.1, 5.0, 5.0]])
    assert roofline.count_pairs(pos, box, 2.5) == 1
    assert roofline.count_pairs(pos, box, 1.0) == 0


def test_lattice_3x3x3():
    # 27 sites, spacing 1, periodic box 3: each site has 6 neighbours at
    # 1, 12 at sqrt(2) and 8 at sqrt(3)
    g = torch.arange(3, dtype=torch.float64)
    pos = torch.cartesian_prod(g, g, g) + 0.5
    box = torch.tensor([3.0, 3.0, 3.0], dtype=torch.float64)
    assert roofline.count_pairs(pos, box, 1.1) == 27 * 6 // 2
    assert roofline.count_pairs(pos, box, 1.5) == 27 * 18 // 2
    assert roofline.count_pairs(pos, box, 1.8) == 27 * 26 // 2
    # on a grid of 3 cells a side (the cell path), tiled to 9^3
    g9 = torch.arange(9, dtype=torch.float64)
    pos9 = torch.cartesian_prod(g9, g9, g9) + 0.5
    box9 = torch.tensor([9.0, 9.0, 9.0], dtype=torch.float64)
    assert roofline.count_pairs(pos9, box9, 1.1) == 729 * 6 // 2
    assert roofline.count_pairs(pos9, box9, 1.8) == 729 * 26 // 2


def test_flops_and_bytes():
    assert roofline.pair_flops("lj", 1) == 41
    assert roofline.pair_flops("table", 2) == 72
    assert roofline.pair_bytes(2, 1) == 64
    assert roofline.pair_bytes(2, 0, table_points=10) == 96
    t, by = roofline.least_seconds(67e12, 1.0)
    assert (t, by) == (pytest.approx(1.0), "operations")
    t, by = roofline.least_seconds(0.0, 3.35e12)
    assert (t, by) == (pytest.approx(1.0), "bytes")
