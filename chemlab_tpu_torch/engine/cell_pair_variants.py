"""The pair-kernel ladder: K1' (colt1) and K3a-K3d, selectable by name.

Port of ``chemlab_tpu/engine/pallas_pair_variants.py`` (and of
``pallas_pair.cell_pair_forces_colt(impl="colt")``): one wrapper per TPU
wrapper, each with the same contract as ``cell_pair.cell_pair_forces``,
the unexcluded all-pairs LJ sum on the cell grid.

  - ``cell_pair_forces_packets`` (K3a, ``_packet_kernel``): a program per
    (cell, 8-row packet), packets past the cell's fill skipped; on the card
    a block per cell stages its candidates once and a warp takes each live
    packet, with the plan of ``packet_launch_plan``; its first design (a
    block per cell and packet, ``packet_baseline_kernel``, handle
    ``cell_pair.K3A_CELLWISE``) stays as the baseline it is held to bit
    for bit, which no step runs;
  - ``cell_pair_forces_resident`` (K3b, ``_resident_kernel``): nothing
    staged; on the card a warp per row reads every candidate from global
    memory (L2), with the plan of ``resident_launch_plan``; its first
    design (8-thread packets, ``resident_packet_kernel``, handle
    ``cell_pair.K3B_CELLWISE``) stays as the baseline it is held to bit for
    bit, which no step runs;
  - ``cell_pair_forces_columns`` (``z_unroll`` and ``cap % 8 == 0``: K3c,
    ``_colz_kernel``, one program per xy column over its nz cells; on the
    card the block stages its U neighbour columns whole with bulk copies
    and a warp takes each batch of rows, with the plan of
    ``colz_launch_plan``; else K3d, ``_column_kernel``, one program per
    cell read from its columns; on the card the block stages its
    neighbour columns' windows with bulk copies and a warp takes each
    batch of rows, with the plan of ``column_launch_plan``); their first
    designs, a thread per slot (``colz_baseline_kernel``,
    ``column_baseline_kernel``, handles ``cell_pair.K3C_CELLWISE``,
    ``K3D_CELLWISE``), stay as the baselines they are held to bit for bit,
    which no step runs;
  - ``cell_pair_forces_colt1`` (K1', ``_colt_kernel``): one program per xy
    column over its 9 haloed z-columns with per-column partial sums; on
    the card K1's column-segment body with colt1's per-column sums, with
    the plan of ``colt1_launch_plan``; its first design, a thread per slot
    (``colt1_baseline_kernel``, handle ``cell_pair.K1P_CELLWISE``), stays
    as the baseline it is held to bit for bit, which no step runs.

K3a-K3d return (force, e, 0, w) in one pass and ignore the energy/virial
choice, as the reference's variants do; K1' returns colt2's tuple, its
spare channel the energy or, under ``want_virial``, the virial.  The
kernels are hand-written CUDA in ``csrc/cell_pair_ladder.cu``, each with
its launch count in ``cell_pair.BY_NAME`` (K1p, K3a, K3b, K3c, K3d); a CPU
tensor takes the plain torch version, a CUDA tensor the kernel or raises.

Plain versions: K3a, K3b and K3d compute plain K2's pairs in both channels
(``ladder_rows_ref``), so their forces equal plain K2's bit for bit; plain
K3c reads each cell's stencil through the xy columns (``column_stencil``)
and zeroes the rows of dead packets; plain K1' keeps colt1's per-column
grouping (``colt1_rows_ref``).

The epilogue is the port's ``slot_of`` gather, not the reference's
scatter-add into zeros (``mode="drop"``): each valid slot holds one
distinct particle, so the scatter only permutes rows and the gather is
exact (a ``-0.0`` row stays ``-0.0`` where the scatter onto ``+0.0`` gives
``+0.0``: compare forces with ``==``, not by their bytes).

Packet gating reads the port's counts, the bucket occupancy, where the
reference counts ``sum(slot_valid)``, which also asks that the particle be
active.  The two agree because ``neighbor.build_cell_buckets`` bins
inactive particles into the junk row: a real cell holds only active
particles, filled from rank 0.  (A particle deactivated between two
refreshes would break the gating in the reference too.)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import cell_pair
from .neighbor import neighbor_cell_offsets

SMEM_LIMIT = 227 * 1024      # the most dynamic shared memory a block takes


class ResidentPlan(NamedTuple):
    """K3b's launch plan: slots per warp batch, threads per block (at least
    4 warps), list entries per thread (a warp's list holds 32 times as
    many, 20 bytes each) and the shared-memory bytes of the lists."""
    rows: int
    threads: int
    depth: int
    smem: int


class PacketPlan(NamedTuple):
    """K3a's launch plan: threads per block (W warps, each taking the
    cell's live 8-row packets w, w + W, ...), list entries per thread and
    the shared-memory bytes (the stage of 27 cells and the lists)."""
    threads: int
    depth: int
    smem: int


class ColzPlan(NamedTuple):
    """K3c's launch plan: slots per warp batch, threads per block (W
    warps, each a run of the column's batches), list entries per thread
    and the shared-memory bytes (the stage of the U whole neighbour
    columns, the lists, the counts and each warp's table of stage
    rows)."""
    rows: int
    threads: int
    depth: int
    smem: int


class ColumnPlan(NamedTuple):
    """K3d's launch plan: slots per warp batch, threads per block, list
    entries per thread and the shared-memory bytes (the stage of the S
    cells of the neighbour columns' windows, the lists and the table of
    each candidate's stage row)."""
    rows: int
    threads: int
    depth: int
    smem: int


# K3b's choices, measured on an H100 (PERF.md: ``python -m
# chemlab_tpu_torch.kernel_matrix --k2``'s sweep and rules in turns at 10k)
RESIDENT_ROWS = 2
RESIDENT_THREADS = 128
RESIDENT_DEPTH = 4
# K3a's and K3d's, measured on an H100 (PERF.md: ``python -m
# chemlab_tpu_torch.kernel_matrix --ladder``'s sweeps and rules in turns,
# K3a at 10k, K3d at 10k and cap 36 and on the film)
PACKET_THREADS = 128
PACKET_DEPTH = 4
COLUMN_ROWS = 1
COLUMN_THREADS = 256
COLUMN_DEPTH = 4
# K3c's and K1''s, measured on an H100 (PERF.md: ``kernel_matrix
# --ladder``'s sweeps and rules in turns at 10k, cap 32).  Each one's
# threads are also the most its block takes.  K3c: at its 71 registers a
# thread, 28 warps fill an SM's 64 Ki registers (a build held to 64
# registers for 32 warps spilled and was slower); the plan takes fewer
# where the stage leaves no room for their lists and tables.  K1': the
# kernel's launch bounds (256 threads, 4 blocks an SM) hold it to 64
# registers, and K1's rule was the fastest under them.
COLZ_ROWS = 1
COLZ_THREADS = 896
COLZ_DEPTH = 4
COLT1_SEG = 3
COLT1_ROWS = 2
COLT1_THREADS = 256
COLT1_DEPTH = 4


def resident_smem(threads: int, depth: int) -> int:
    """Shared-memory bytes of K3b's lists: ``depth`` entries a thread, a
    float4 (the force terms and the energy) and a float (the virial term)
    each."""
    return 20 * threads * depth


def packet_smem(cap: int, threads: int, depth: int) -> int:
    """Shared-memory bytes of K3a: a stage of 27 cells of ``cap`` rows (16
    bytes each; the occupied rows packed at its front) and the lists."""
    return 16 * 27 * cap + resident_smem(threads, depth)


def column_smem(cap: int, dims, threads: int, depth: int) -> int:
    """Shared-memory bytes of K3d: a stage of the S cells of the stencil
    (the neighbour columns' windows) at ``cap`` rows each, the lists, and
    the stage row of each candidate (an int per stage row)."""
    return 20 * table_sizes(dims)[0] * cap + resident_smem(threads, depth)


def colz_smem(cap: int, dims, threads: int, depth: int) -> int:
    """Shared-memory bytes of K3c: a stage of the U whole neighbour
    columns (nz * cap rows of 16 bytes each), the lists, the U * nz counts
    and a table of S * cap 16-bit stage rows a warp."""
    n_stencil, n_cols = table_sizes(dims)
    nz = int(dims[2])
    return (16 * n_cols * nz * cap + resident_smem(threads, depth)
            + 4 * n_cols * nz + 2 * (threads // 32) * n_stencil * cap)


def colt1_smem(cap: int, n_types: int, seg: int, threads: int,
               depth: int) -> int:
    """Shared-memory bytes of K1': K1's layout (``cell_pair.colt_smem``)
    and a byte a list entry, its column."""
    return cell_pair.colt_smem(cap, n_types, seg, threads, depth) \
        + threads * depth


def resident_launch_plan(cap: int, *, rows=None, threads=None,
                         depth=None) -> ResidentPlan:
    """The launch plan of ``ladder_resident`` (K3b) at cell cap ``cap``:
    from the shapes alone, never the counts or the box; ``rows``,
    ``threads`` and ``depth`` override the measured choices (the kernel
    matrix's sweep).  Raises ``ValueError`` naming K3b on a layout the
    kernel cannot take, and above 227 KiB of shared memory with the
    size."""
    return _resident_plan(int(cap), rows, threads, depth)


@functools.lru_cache(maxsize=None)
def _resident_plan(cap, rows, threads, depth):
    rows = min(RESIDENT_ROWS, cap) if rows is None else rows
    threads = RESIDENT_THREADS if threads is None else threads
    depth = RESIDENT_DEPTH if depth is None else depth
    if not (1 <= rows <= 32 and 128 <= threads <= 1024 and threads % 32 == 0
            and depth >= 1):
        raise ValueError("K3b: no plan with rows %d, threads %d, depth %d"
                         % (rows, threads, depth))
    smem = resident_smem(threads, depth)
    if smem > SMEM_LIMIT:
        raise ValueError("K3b: lists of %d bytes exceed 227 KiB" % smem)
    return ResidentPlan(rows, threads, depth, smem)


def _warps_ok(threads, depth):
    return 32 <= threads <= 1024 and threads % 32 == 0 and depth >= 1


def packet_launch_plan(cap: int, *, threads=None,
                       depth=None) -> PacketPlan:
    """The launch plan of ``ladder_packet`` (K3a) at cell cap ``cap``: from
    the shapes alone, never the counts or the box; ``threads`` and
    ``depth`` override the measured choices (the kernel matrix's sweep).
    Raises ``ValueError`` naming K3a on a layout the kernel cannot take (a
    cap that is not a multiple of 8, blocks of part of a warp), and above
    227 KiB of shared memory with the size."""
    return _packet_plan(int(cap), threads, depth)


@functools.lru_cache(maxsize=None)
def _packet_plan(cap, threads, depth):
    threads = PACKET_THREADS if threads is None else threads
    depth = PACKET_DEPTH if depth is None else depth
    if cap < 8 or cap % 8 or not _warps_ok(threads, depth):
        raise ValueError("K3a: no plan with cap %d, threads %d, depth %d"
                         % (cap, threads, depth))
    smem = packet_smem(cap, threads, depth)
    if smem > SMEM_LIMIT:
        raise ValueError("K3a: shared memory of %d bytes exceeds 227 KiB"
                         % smem)
    return PacketPlan(threads, depth, smem)


def column_launch_plan(cap: int, dims, *, rows=None, threads=None,
                       depth=None) -> ColumnPlan:
    """The launch plan of ``ladder_column`` (K3d) at cell cap ``cap`` on the
    grid ``dims``: from the shapes alone, never the counts or the box;
    ``rows``, ``threads`` and ``depth`` override the measured choices (the
    kernel matrix's sweep).  Raises ``ValueError`` naming K3d on a layout
    the kernel cannot take, and above 227 KiB of shared memory with the
    size."""
    return _column_plan(int(cap), tuple(int(d) for d in dims), rows,
                        threads, depth)


@functools.lru_cache(maxsize=None)
def _column_plan(cap, dims, rows, threads, depth):
    rows = min(COLUMN_ROWS, cap) if rows is None else rows
    threads = COLUMN_THREADS if threads is None else threads
    depth = COLUMN_DEPTH if depth is None else depth
    if not (1 <= cap and 1 <= rows <= 32 and _warps_ok(threads, depth)):
        raise ValueError("K3d: no plan with cap %d, rows %d, threads %d, "
                         "depth %d" % (cap, rows, threads, depth))
    smem = column_smem(cap, dims, threads, depth)
    if smem > SMEM_LIMIT:
        raise ValueError("K3d: shared memory of %d bytes exceeds 227 KiB"
                         % smem)
    return ColumnPlan(rows, threads, depth, smem)


def colz_launch_plan(cap: int, dims, *, rows=None, threads=None,
                     depth=None) -> ColzPlan:
    """The launch plan of ``ladder_colz`` (K3c) at cell cap ``cap`` on the
    grid ``dims``: from the shapes alone, never the counts or the box.  The
    stage of whole columns grows with nz * cap, so the default threads are
    the most up to ``COLZ_THREADS`` whose bytes fit a block; ``rows``,
    ``threads`` and ``depth`` override the measured choices (the kernel
    matrix's sweep).  Raises ``ValueError`` naming K3c on a layout the
    kernel cannot take (more than ``COLZ_THREADS`` threads among them), and
    above 227 KiB of shared memory with the size."""
    return _colz_plan(int(cap), tuple(int(d) for d in dims), rows, threads,
                      depth)


@functools.lru_cache(maxsize=None)
def _colz_plan(cap, dims, rows, threads, depth):
    rows = min(COLZ_ROWS, cap) if rows is None else rows
    depth = COLZ_DEPTH if depth is None else depth
    if threads is None:
        threads = next((th for th in range(COLZ_THREADS, 32, -32)
                        if colz_smem(cap, dims, th, depth) <= SMEM_LIMIT),
                       32)
    if not (1 <= cap and 1 <= rows <= 32 and _warps_ok(threads, depth)
            and threads <= COLZ_THREADS):
        raise ValueError("K3c: no plan with cap %d, rows %d, threads %d, "
                         "depth %d" % (cap, rows, threads, depth))
    smem = colz_smem(cap, dims, threads, depth)
    if smem > SMEM_LIMIT:
        raise ValueError("K3c: shared memory of %d bytes exceeds 227 KiB"
                         % smem)
    return ColzPlan(rows, threads, depth, smem)


def colt1_launch_plan(dims, cap: int, n_types: int, *, seg=None, rows=None,
                      threads=None, depth=None) -> cell_pair.PackedPlan:
    """The launch plan of ``ladder_colt1`` (K1') on the grid ``dims``: K1's
    fields (``cell_pair.colt_launch_plan``'s segment rule with at most
    ``COLT1_SEG`` cells; the grouping by xy column does not depend on the
    segment, so every segment gives the same bits) and K1''s bytes
    (``colt1_smem``), from the shapes alone; ``seg``, ``rows``,
    ``threads`` and ``depth`` override the measured choices (the kernel
    matrix's sweep).  Raises ``ValueError`` naming K1' on a layout the
    kernel cannot take (more than ``COLT1_THREADS`` threads among them),
    and above 227 KiB of shared memory with the size."""
    return _colt1_plan(tuple(int(d) for d in dims), int(cap), int(n_types),
                       seg, rows, threads, depth)


@functools.lru_cache(maxsize=None)
def _colt1_plan(dims, cap, n_types, seg, rows, threads, depth):
    if threads is not None and threads > COLT1_THREADS:
        raise ValueError("K1': no plan with threads %d (at most %d)"
                         % (threads, COLT1_THREADS))
    return cell_pair._packed_plan(
        "K1'", dims, False, seg, rows, threads, depth,
        (COLT1_SEG, COLT1_ROWS, COLT1_THREADS, COLT1_DEPTH),
        lambda sg, th, dp: colt1_smem(cap, n_types, sg, th, dp))


@functools.lru_cache(maxsize=None)
def _table(dims):
    offs = neighbor_cell_offsets(dims)
    xy = []
    for dx, dy, _ in offs.tolist():
        if (dx, dy) not in xy:
            xy.append((dx, dy))
    col_idx = [xy.index((dx, dy)) for dx, dy, _ in offs.tolist()]
    tab = np.concatenate([np.asarray(xy, np.int32).reshape(-1),
                          np.asarray(col_idx, np.int32),
                          offs[:, 2]]).astype(np.int32)
    tab.flags.writeable = False
    return tab, len(offs), len(xy)


def ladder_table(dims) -> np.ndarray:
    """int32 (2U + 2S,): the U distinct (dx, dy) xy columns of the
    deduplicated stencil (residues mod dims, in first-appearance order),
    then each stencil entry's column index, then its dz residue (the
    reference's ``xy_list``, ``col_idx`` and ``dzs``; stencil order as
    ``neighbor_cell_offsets``).  Made once per grid (read-only): the
    wrappers' host time sits between the launches."""
    return _table(tuple(int(d) for d in dims))[0]


def table_sizes(dims):
    """(S, U) of ``ladder_table``: stencil entries and distinct xy
    columns."""
    return _table(tuple(int(d) for d in dims))[1:]


@functools.lru_cache(maxsize=None)
def _ladder_table_on(dims, device):
    """``ladder_table`` on ``device``, made once per grid (a copy from the
    host on every call would synchronise the stream)."""
    return torch.tensor(ladder_table(dims), device=device)


def column_stencil(dims) -> np.ndarray:
    """(C, S) neighbour cell ids read through the xy columns, as K3c reads
    them: cell (column c, z) takes, for each stencil entry s, cell
    (z + dz_s) mod nz of its neighbour column ``col_idx[s]``."""
    nx, ny, nz = (int(d) for d in dims)
    tab = ladder_table(dims)
    n_stencil, n_cols = table_sizes(dims)
    xy = tab[:2 * n_cols].reshape(n_cols, 2)
    col_idx = tab[2 * n_cols:2 * n_cols + n_stencil]
    dz = tab[2 * n_cols + n_stencil:]
    col = np.arange(nx * ny)
    cx, cy = col // ny, col % ny
    ncol = ((cx[:, None] + xy[None, :, 0]) % nx) * ny \
        + (cy[:, None] + xy[None, :, 1]) % ny                     # (XY, U)
    z = np.arange(nz)
    out = ncol[:, None, col_idx] * nz \
        + (z[None, :, None] + dz[None, None, :]) % nz            # (XY, nz, S)
    return out.reshape(nx * ny * nz, n_stencil).astype(np.int32)


def packet_live(counts, cap: int):
    """(C, cap) bool: the slot's 8-row packet starts inside the cell's
    fill."""
    start = (torch.arange(cap, device=counts.device) // 8) * 8
    return start[None, :] < counts[:, None]


def ladder_rows_ref(cells, counts, box, params, dims, uniform_lj: bool,
                    nbr=None):
    """Plain K3a/K3b/K3d: plain K2's pairs (the is-LJ gate unless
    ``uniform_lj``) in both channels, (C, cap, 8) rows
    [fx, fy, fz, e/2, w/2, 0, 0, 0]; ``counts`` is unused (empty slots are
    zero rows).  ``nbr`` as in ``cell_pair.stencil_pairs``."""
    dr, f, e, r2s = cell_pair.lj_pair_terms(cells, box, params, dims,
                                            uniform_lj, False, True, nbr=nbr)
    cols = [torch.sum(f * d, dim=2) for d in dr]
    cols += [0.5 * torch.sum(e, dim=2), 0.5 * torch.sum(f * r2s, dim=2)]
    zero = torch.zeros_like(cols[0])
    return torch.stack(cols + [zero] * 3, dim=-1)


def colz_rows_ref(cells, counts, box, params, dims, uniform_lj: bool):
    """Plain K3c: each cell's stencil read through its xy columns
    (``column_stencil``, the same candidates in K2's order), the rows of
    dead packets zero."""
    nbr = torch.from_numpy(column_stencil(dims))
    rows = ladder_rows_ref(cells, counts, box, params, dims, uniform_lj, nbr)
    return torch.where(packet_live(counts, cells.shape[1])[..., None], rows,
                       0.0)


def colt1_rows_ref(cells, counts, box, params, dims, uniform_lj: bool,
                   ch3_mode: int):
    """Plain K1': colt1's grouping on a full grid, (C, cap, 4) rows
    [fx, fy, fz, ch3]: per xy column (27 stencil cells = 9 columns of 3 in
    K1's order) a partial sum, the 9 added in turn; ch3 the sum of each
    column's half energy (mode 1) or half virial (mode 2)."""
    C, cap = cells.shape[:2]
    dr, f, e, r2s = cell_pair.lj_pair_terms(
        cells, box, params, dims, uniform_lj, False,
        ch3_mode == cell_pair.CH3_ENERGY)

    def by_column(t, half=False):
        part = t.reshape(C, cap, 9, -1).sum(dim=3)
        if half:
            part = 0.5 * part
        acc = part[..., 0]
        for k in range(1, 9):
            acc = acc + part[..., k]
        return acc

    cols = [by_column(f * d) for d in dr]
    cols.append(by_column(e if ch3_mode == cell_pair.CH3_ENERGY
                          else f * r2s, half=True))
    out = torch.stack(cols, dim=-1)
    return torch.where(packet_live(counts, cap)[..., None], out, 0.0)


def _smem(kind: str, cap: int, dims, n_types: int) -> int:
    """The dynamic shared memory (bytes) of a launch that takes no plan, as
    the entry points of ``cell_pair_ladder.cu`` size it: the first designs
    of K3a, K3c, K3d and K1'."""
    nz = int(dims[2])
    n_stencil, n_cols = table_sizes(dims)
    par = 20 * n_types * n_types
    if kind in ("packet", "column"):
        return 16 * n_stencil * cap + par + 4 * n_stencil
    if kind == "colz":
        return 16 * n_cols * nz * cap + par + 4 * n_cols * (nz + 1)
    if kind == "colt1":
        return 16 * 9 * (nz + 2) * cap + par + 4 * 9 * (nz + 3)
    return 0


KERNEL_OF = {"packet": cell_pair.K3A, "resident": cell_pair.K3B,
             "colz": cell_pair.K3C, "column": cell_pair.K3D,
             "colt1": cell_pair.K1P}


def ladder_kernel(kind: str, cells, counts, box, params, dims,
                  uniform_lj: bool, ch3_mode: int = cell_pair.CH3_ENERGY,
                  plan=None):
    """Launch the CUDA kernel of ``kind`` ("packet" K3a, "resident" K3b,
    "colz" K3c, "column" K3d, "colt1" K1') with ``plan``, its
    ``*_launch_plan``'s by default, on the current stream (CUDA tensors
    only); returns (C, cap, 8) rows, (C, cap, 4) for K1'."""
    return _launch(KERNEL_OF[kind], kind, cells, counts, box, params, dims,
                   uniform_lj, ch3_mode, plan)


def packet_baseline_kernel(cells, counts, box, params, dims,
                           uniform_lj: bool,
                           ch3_mode: int = cell_pair.CH3_ENERGY):
    """Launch K3a's first design (``K3A_CELLWISE``: a block per cell and
    8-row packet) on the same operands as ``ladder_kernel("packet",
    ...)``: the baseline of the A/B, which no step reaches."""
    return _launch(cell_pair.K3A_CELLWISE, "packet", cells, counts, box,
                   params, dims, uniform_lj, ch3_mode, None)


def resident_packet_kernel(cells, counts, box, params, dims,
                           uniform_lj: bool,
                           ch3_mode: int = cell_pair.CH3_ENERGY):
    """Launch K3b's first design (``K3B_CELLWISE``: 8-thread packets) on
    the same operands as ``ladder_kernel("resident", ...)``: the baseline
    of the A/B, which no step reaches."""
    return _launch(cell_pair.K3B_CELLWISE, "resident", cells, counts, box,
                   params, dims, uniform_lj, ch3_mode, None)


def colz_baseline_kernel(cells, counts, box, params, dims,
                         uniform_lj: bool,
                         ch3_mode: int = cell_pair.CH3_ENERGY):
    """Launch K3c's first design (``K3C_CELLWISE``: a thread per slot of a
    block per xy column) on the same operands as ``ladder_kernel("colz",
    ...)``: the baseline of the A/B, which no step reaches."""
    return _launch(cell_pair.K3C_CELLWISE, "colz", cells, counts, box,
                   params, dims, uniform_lj, ch3_mode, None)


def colt1_baseline_kernel(cells, counts, box, params, dims,
                          uniform_lj: bool,
                          ch3_mode: int = cell_pair.CH3_ENERGY):
    """Launch K1''s first design (``K1P_CELLWISE``: a thread per slot over
    the 9 haloed columns) on the same operands as
    ``ladder_kernel("colt1", ...)``: the baseline of the A/B, which no
    step reaches."""
    return _launch(cell_pair.K1P_CELLWISE, "colt1", cells, counts, box,
                   params, dims, uniform_lj, ch3_mode, None)


def column_baseline_kernel(cells, counts, box, params, dims,
                           uniform_lj: bool,
                           ch3_mode: int = cell_pair.CH3_ENERGY):
    """Launch K3d's first design (``K3D_CELLWISE``: a thread per slot) on
    the same operands as ``ladder_kernel("column", ...)``: the baseline of
    the A/B, which no step reaches."""
    return _launch(cell_pair.K3D_CELLWISE, "column", cells, counts, box,
                   params, dims, uniform_lj, ch3_mode, None)


# the kernels that take a launch plan, and the plan each takes by default,
# from (cap, dims, n_types)
_PLANNED = {
    id(cell_pair.K3A): lambda cap, dims, n_types: packet_launch_plan(cap),
    id(cell_pair.K3B): lambda cap, dims, n_types: resident_launch_plan(cap),
    id(cell_pair.K3C): lambda cap, dims, n_types: colz_launch_plan(cap, dims),
    id(cell_pair.K3D): lambda cap, dims, n_types: column_launch_plan(
        cap, dims),
    id(cell_pair.K1P): lambda cap, dims, n_types: colt1_launch_plan(
        dims, cap, n_types)}


def _launch(kernel, kind: str, cells, counts, box, params, dims,
            uniform_lj: bool, ch3_mode: int, plan):
    """Check the operands of ``kind`` and launch ``kernel`` on them (with
    its launch plan, ``plan`` or its default, when it takes one)."""
    nx, ny, nz = (int(d) for d in dims)
    C, cap, _ = cells.shape
    if C != nx * ny * nz:
        raise ValueError("%s: dims %s for %d cells" % (kind, dims, C))
    if cells.device.type != "cuda":
        raise ValueError("the ladder's CUDA kernels take CUDA tensors, not "
                         "%s" % cells.device)
    if kind != "column" and cap % 8:
        raise ValueError("%s needs cell_cap %% 8 == 0, not %d" % (kind, cap))
    if kind == "colt1" and not cell_pair.colt_legal(cap, dims):
        raise ValueError("colt1 needs a full 27-cell stencil: dims %s"
                         % (dims,))
    if not 0 < cap <= 1024:
        raise ValueError("%s: cell_cap %d does not fit one block"
                         % (kind, cap))
    cell_pair._check(cells, "cells", torch.float32, (C, cap, 4))
    if cells.data_ptr() % 16:
        raise ValueError("cells must be 16-byte aligned (float4 rows)")
    dev = cells.device
    n_types = params.shape[1]
    planned = _PLANNED.get(id(kernel))
    if planned is not None and plan is None:
        plan = planned(cap, (nx, ny, nz), n_types)
    smem = plan.smem if planned is not None else _smem(kind, cap, dims,
                                                        n_types)
    if smem > SMEM_LIMIT:
        raise ValueError("%s: shared-memory stage of %d bytes exceeds "
                         "227 KiB" % (kind, smem))
    for t, name in ((counts, "counts"), (box, "box"), (params, "params")):
        if t.device != dev:
            raise ValueError("%s is on %s, cells on %s" % (name, t.device,
                                                          dev))
    cell_pair._check(counts, "counts", torch.int32, (C,))
    cell_pair._check(box, "box", torch.float32, (3,))
    cell_pair._check(params, "params", torch.float32, (5, n_types, n_types))
    table = _ladder_table_on((nx, ny, nz), dev)
    n_stencil, n_cols = table_sizes((nx, ny, nz))
    out = torch.empty((C, cap, 4 if kind == "colt1" else 8),
                      dtype=cells.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    extra = tuple(plan) if planned is not None else ()
    kernel.launch(cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
                  params.data_ptr(), table.data_ptr(), out.data_ptr(), nx, ny,
                  nz, cap, n_types, n_stencil, n_cols, int(uniform_lj),
                  int(ch3_mode), *extra, stream)
    return out


def ladder_ref(kind: str, cells, counts, box, params, dims,
               uniform_lj: bool, ch3_mode: int = cell_pair.CH3_ENERGY):
    """The plain torch version of ``kind``'s kernel."""
    if kind == "colt1":
        return colt1_rows_ref(cells, counts, box, params, dims, uniform_lj,
                              ch3_mode)
    if kind == "colz":
        return colz_rows_ref(cells, counts, box, params, dims, uniform_lj)
    return ladder_rows_ref(cells, counts, box, params, dims, uniform_lj)


def ladder_cells(kind: str, cells, counts, box, params, dims,
                 uniform_lj: bool, ch3_mode: int = cell_pair.CH3_ENERGY):
    """The wrapper of ``kind``'s kernel: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if cells.device.type == "cuda":
        return ladder_kernel(kind, cells, counts, box, params, dims,
                             uniform_lj, ch3_mode)
    if cells.device.type == "cpu":
        return ladder_ref(kind, cells, counts, box, params, dims, uniform_lj,
                          ch3_mode)
    raise ValueError("the ladder has no version for device %s"
                     % cells.device)


def _operands(pos, type_id, active, box, buckets, dims, spec, n_types: int):
    """(cells, counts, box, params) of a ladder call; counts are the
    bucket occupancy (see the module's note on packet gating)."""
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, type_id, active), buckets,
        int(np.prod(dims)))
    return cells, counts, box.contiguous(), cell_pair.pair_params(spec,
                                                                  n_types)


def _gather(rows, slot_of):
    """Each particle's force row through ``slot_of`` (zero off the grid)."""
    in_grid = slot_of < rows.shape[0]
    got = rows[torch.where(in_grid, slot_of, 0).long()]
    return torch.where(in_grid[:, None], got[:, :3], 0.0)


def _both_channels(kind, pos, type_id, active, box, buckets, slot_of, dims,
                   spec, n_types, uniform_lj):
    """(force, e, 0, w) through the two-channel kernel ``kind``."""
    ops = _operands(pos, type_id, active, box, buckets, dims, spec, n_types)
    flat = ladder_cells(kind, *ops, dims, uniform_lj).reshape(-1, 8)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return (_gather(flat, slot_of), torch.sum(flat[:, 3]), zero,
            torch.sum(flat[:, 4]))


def cell_pair_forces_packets(pos, type_id, active, box, buckets, slot_of,
                             dims, spec, n_types: int,
                             uniform_lj: bool = False):
    """K3a, the packet-grid kernel (reference:
    ``pallas_pair_variants.cell_pair_forces_packets``); ``cap % 8 == 0``.
    Returns (force, e, 0, w)."""
    return _both_channels("packet", pos, type_id, active, box, buckets,
                          slot_of, dims, spec, n_types, uniform_lj)


def cell_pair_forces_resident(pos, type_id, active, box, buckets, slot_of,
                              dims, spec, n_types: int,
                              uniform_lj: bool = False):
    """K3b, the packet kernel with nothing staged (reference:
    ``cell_pair_forces_resident``); ``cap % 8 == 0``.  Returns
    (force, e, 0, w)."""
    return _both_channels("resident", pos, type_id, active, box, buckets,
                          slot_of, dims, spec, n_types, uniform_lj)


def cell_pair_forces_columns(pos, type_id, active, box, buckets, slot_of,
                             dims, spec, n_types: int,
                             uniform_lj: bool = False, z_unroll: bool = True):
    """The column kernels (reference: ``cell_pair_forces_columns``): K3c
    when ``z_unroll`` and ``cap % 8 == 0``, else K3d (any cap, any grid).
    Returns (force, e, 0, w)."""
    kind = "colz" if z_unroll and buckets.shape[1] % 8 == 0 else "column"
    return _both_channels(kind, pos, type_id, active, box, buckets, slot_of,
                          dims, spec, n_types, uniform_lj)


def cell_pair_forces_colt1(pos, type_id, active, box, buckets, slot_of, dims,
                           spec, n_types: int, uniform_lj: bool = False,
                           want_virial: bool = False):
    """K1', colt1 (reference: ``cell_pair_forces_colt(impl="colt")``) on a
    grid colt2 takes.  Returns colt2's (force, e, 0, 0), or (force, 0, 0,
    w) under ``want_virial``: the spare channel is never empty."""
    ops = _operands(pos, type_id, active, box, buckets, dims, spec, n_types)
    mode = cell_pair.CH3_VIRIAL if want_virial else cell_pair.CH3_ENERGY
    flat = ladder_cells("colt1", *ops, dims, uniform_lj, mode).reshape(-1, 4)
    return cell_pair.pair_result(_gather(flat, slot_of),
                                 torch.sum(flat[:, 3]), want_virial, 0)
