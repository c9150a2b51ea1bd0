"""The yardstick's counts: the H100's published peaks, and the operations
and bytes the step's work needs whatever implements it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W
limit: 67 TFLOP/s in float32 outside the tensor cores (the unit every
force here is computed in) and 3.35 TB/s of HBM.

Operations per unordered pair inside the cutoff (float32; each pair's
work done once, its force added to both ends):

- geometry, 17: the displacement (3 subtractions), the minimum image (3
  of multiply by the inverse box, round, multiply-subtract: 9), r^2 (3
  multiplications, 2 additions: 5);
- LJ, 24: soft core (1 max), 1/r^2 (1), s2 (1), s6 (2), 48 eps
  (s6^2 - s6/2) / r^2 (5), f * d (3), the two ends' accumulation (6),
  the cutoff test (1), and the pair's type lookup (4: the count the
  kernels' plain versions are written to, ``chip_smoke.OPS_LJ``);
- a func-8 table, 19: r (1 square root), the bin (r - r0) / dr (2), its
  floor and fraction (2), the linear blend of F (3), F / r (1), f * d
  (3), accumulation (6), the cutoff test (1).  The program fits the
  tables with Chebyshev series; what it evaluates for a pair is its own
  choice, and the roofline counts what the table needs.

Bytes of the pair sum: each particle's position and type read once (16
bytes) and its force written once (12), each excluded pair read once (8)
for the correction, and each table's force column once (4 a point).
"""

from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

OPS_GEOMETRY = 17
OPS_PAIR = {"lj": 24, "table": 19}


def pair_flops(kind: str, pairs: int) -> float:
    """Operations of one pair sum over ``pairs`` unordered pairs inside
    the cutoff."""
    return float(pairs) * (OPS_GEOMETRY + OPS_PAIR[kind])


def pair_bytes(n: int, n_excl: int, table_points: int = 0) -> float:
    """Bytes of one pair sum with its excluded-pair correction."""
    return 28.0 * n + 8.0 * n_excl + 4.0 * table_points


def least_seconds(flops: float, n_bytes: float):
    """(seconds, "operations" or "bytes"): the larger of the two bounds."""
    t_ops, t_bytes = flops / F32_FLOPS, n_bytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def count_pairs(pos, box, rc: float) -> int:
    """Unordered pairs inside the cutoff ``rc``, from the positions."""
    from .reference.forces import count_pairs as _count

    return _count(pos, box, rc)
