"""Cell-tile pair forces (K1 and its Chebyshev modes K1c/K1d/K1e, the
per-cell K2) and the excluded-pair correction.

Port of ``chemlab_tpu/engine/pallas_pair.py``: ``cell_pair_forces`` (the
dispatcher), ``cell_pair_forces_colt`` (the wrapper of the TPU kernel
``_colt2_kernel``, in its LJ modes and its Chebyshev-tabulated modes), the
per-cell kernel ``_kernel`` (K2) with ``stencil_table``, ``_pair_eval`` and
``excluded_pair_correction``.  K1 takes the grids colt2 takes (``cap % 8 ==
0`` and at least 3 cells per axis); K2 takes every other LJ grid, against
the deduplicated stencil of ``neighbor.neighbor_cell_offsets``.

The pair sum runs over every pair on the cell grid, excluded pairs
included; the correction subtracts the exclusion list afterwards.  That
cancels only if both sides run the same f32 op sequence per pair: minimum
image ``d - box * round(d * (1/box))`` (round half to even), ``r2`` summed
x, y, z in that order, the self-pair drop at ``r2 > 1e-12`` (kernel) or the
``1e-12`` floor (correction), and LJ with the 0.75-sigma soft-core clamp.

On the card, K1 (and its virial channel K1b and slab mode K1f) runs the
column-segment kernel of ``csrc/cell_pair.cu`` with the launch plan of
``colt_launch_plan`` (from the shapes alone, never the counts or the
box); the source's first, cellwise kernel stays beside it as the baseline
it is held to bit for bit (``cell_pair_forces_colt_cellwise``, handle
``K1_CELLWISE``), which no step runs.  K2 launches the same column-segment
body (``csrc/cell_pair_cell.cu``, from ``csrc/cell_pair_packed.cuh``) over
``stencil_mask(dims)``, which keeps the lanes of the deduplicated stencil,
with the plan of ``k2_launch_plan``; its first, cellwise kernel stays as
its baseline (``cell_pair_forces_cell_cellwise``, handle ``K2_CELLWISE``),
which no step runs.

The tabulated modes evaluate a Chebyshev fit per pair
(``tab_cheb.eval_planes``) from a coefficient row chosen by a (T, T) map:
K1c takes the deduplicated table-scalar rows (``cheb_sc``, map
``cheb_tab_slot``), K1d blends two rows ``x*g_a + (1-x)*g_b`` (func 10/12),
K1e takes the per-table rows through the table id (``cheb_ntab == 0``).
A tabulated system is pure-tabulated (``build.supports_cheb``), so the
spare channel carries the tabulated energy ``e_tab``.  On the card these
modes run the column-segment kernel of ``csrc/cell_pair_cheb.cu`` with the
launch plan of ``cheb_launch_plan`` (from the shapes alone); the source's
first, cellwise kernel stays beside it as the baseline it is held to bit
for bit (``cell_pair_forces_cheb_cellwise``), which no step runs.

K1f is K1 (and K1c/K1d/K1e) in the reference's ``x_halo`` mode
(``pallas_pair.py:682-699, 755-756``), which ``cell_pair_halo`` runs on
one x-slab per rank: the operand is a slab of w + 2 x-layers (the w inner
layers and one halo layer on each side), the sum runs over the inner
cells only, the x neighbour is indexed without a wrap, and the raw
(w * ny * nz, cap, 4) slot rows come back.  Its launches have their own
counts, ``K1F`` (LJ) and ``K1F_CHEB`` / ``K1F_CHEB_MIX`` (Chebyshev).

``cell_pair_forces(kernel=...)`` picks the LJ kernel by name as the
reference's CHEMLAB_KERNEL does (``PAIR_KERNELS``; "auto" is the rule
above); the ladder's kernels (K1' and K3a-K3d, one launch count each in
``BY_NAME``) live in ``cell_pair_variants``.

``colt_cells``, ``cheb_cells`` and ``cell_cells`` are the kernels'
wrappers.  A CPU tensor takes the plain torch version; a CUDA tensor
launches the hand-written kernel in ``csrc/cell_pair.cu``,
``csrc/cell_pair_cheb.cu`` or ``csrc/cell_pair_cell.cu`` (built at first
use) or raises.  The operand packing and the ``slot_of`` epilogue
stay here as torch indexing, as they stay outside the kernel in the
reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from . import _kernels, tab_cheb
from .neighbor import neighbor_cell_offsets
from .spec import MIX_OBS, PAIR_LJ, PAIR_TAB

# ch3 channel of the kernel's [fx, fy, fz, ch3] rows
CH3_NONE, CH3_ENERGY, CH3_VIRIAL = 0, 1, 2

# K1, its virial channel K1b and its slab mode K1f share an entry point,
# each with its own launch count (the pressure pass of an NPT step launches
# K1b, a rank of the slab decomposition K1f); the entry point takes the
# launch plan (``colt_launch_plan``) after the operands
_COLT_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
K1 = _kernels.CudaKernel("cell_pair.cu", "cell_pair_colt", _COLT_ARGS)
K1B = _kernels.CudaKernel("cell_pair.cu", "cell_pair_colt", _COLT_ARGS)
K1F = _kernels.CudaKernel("cell_pair.cu", "cell_pair_colt", _COLT_ARGS)
# the LJ cellwise kernel, K1's first design (one block per cell, 27
# stages), kept as the baseline the column-segment kernel is held and
# timed against: outside BY_NAME, and no step reaches it
K1_CELLWISE = _kernels.CudaKernel(
    "cell_pair.cu", "cell_pair_colt_cellwise",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])

# the Chebyshev modes, one source: K1c and K1e share the unblended entry
# point (they differ only in the map and the pack), each with its own count;
# the entry points take the launch plan (``cheb_launch_plan``) after the
# operands
_CHEB_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
K1C = _kernels.CudaKernel("cell_pair_cheb.cu", "cell_pair_cheb", _CHEB_ARGS)
K1D = _kernels.CudaKernel("cell_pair_cheb.cu", "cell_pair_cheb_mix",
                          _CHEB_ARGS)
K1E = _kernels.CudaKernel("cell_pair_cheb.cu", "cell_pair_cheb", _CHEB_ARGS)
# K1f in the Chebyshev modes: K1c/K1e's entry point and K1d's
K1F_CHEB = _kernels.CudaKernel("cell_pair_cheb.cu", "cell_pair_cheb",
                               _CHEB_ARGS)
K1F_CHEB_MIX = _kernels.CudaKernel("cell_pair_cheb.cu", "cell_pair_cheb_mix",
                                   _CHEB_ARGS)
# the cellwise kernel, the first design of the Chebyshev modes (one block
# per cell, 27 stages), kept as the baseline the column-segment kernel is
# held and timed against: outside BY_NAME, and no step reaches it
_CELLWISE_ARGS = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 \
    + [ctypes.c_void_p]
K1C_CELLWISE = _kernels.CudaKernel("cell_pair_cheb.cu",
                                   "cell_pair_cheb_cellwise", _CELLWISE_ARGS)
K1D_CELLWISE = _kernels.CudaKernel("cell_pair_cheb.cu",
                                   "cell_pair_cheb_mix_cellwise",
                                   _CELLWISE_ARGS)
# K2: the column-segment kernel of K1 over the stencil mask
# (``stencil_mask``), with the launch plan (``k2_launch_plan``) after the
# operands; its signature is K1's with the mask where K1 takes x_halo
K2 = _kernels.CudaKernel("cell_pair_cell.cu", "cell_pair_cell", _COLT_ARGS)
# K2's first design (one block per cell, the S cells staged at once), kept
# as the baseline the column-segment kernel is held and timed against:
# outside BY_NAME, and no step reaches it
K2_CELLWISE = _kernels.CudaKernel(
    "cell_pair_cell.cu", "cell_pair_cell_cellwise",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
# the ladder (``cell_pair_variants``): five entry points of one source,
# each its own launch count, with one signature followed by the kernel's
# launch plan (``cell_pair_variants.packet_launch_plan``,
# ``resident_launch_plan``, ``colz_launch_plan``, ``column_launch_plan``,
# ``colt1_launch_plan``)
_LADDER_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def _ladder_plan_args(n_plan: int) -> list:
    return _LADDER_ARGS[:-1] + [ctypes.c_int] * n_plan + [ctypes.c_void_p]


_LADDER_PLAN_ARGS = _ladder_plan_args(4)
K1P = _kernels.CudaKernel("cell_pair_ladder.cu", "ladder_colt1",
                          _ladder_plan_args(5))
K3A = _kernels.CudaKernel("cell_pair_ladder.cu", "ladder_packet",
                          _ladder_plan_args(3))
K3B = _kernels.CudaKernel("cell_pair_ladder.cu", "ladder_resident",
                          _LADDER_PLAN_ARGS)
K3C = _kernels.CudaKernel("cell_pair_ladder.cu", "ladder_colz",
                          _LADDER_PLAN_ARGS)
K3D = _kernels.CudaKernel("cell_pair_ladder.cu", "ladder_column",
                          _LADDER_PLAN_ARGS)
# the first designs of K3a (a block per cell and 8-row packet), K3b
# (8-thread packets), K3c (a thread per slot of a block per xy column), K3d
# (a thread per slot) and K1' (a thread per slot over 9 haloed columns),
# kept as the baselines the redesigned kernels are held and timed against:
# outside BY_NAME, and no step reaches them
K3A_CELLWISE = _kernels.CudaKernel("cell_pair_ladder.cu",
                                   "ladder_packet_cellwise", _LADDER_ARGS)
K3B_CELLWISE = _kernels.CudaKernel("cell_pair_ladder.cu",
                                   "ladder_resident_packet", _LADDER_ARGS)
K3C_CELLWISE = _kernels.CudaKernel("cell_pair_ladder.cu",
                                   "ladder_colz_cellwise", _LADDER_ARGS)
K3D_CELLWISE = _kernels.CudaKernel("cell_pair_ladder.cu",
                                   "ladder_column_cellwise", _LADDER_ARGS)
K1P_CELLWISE = _kernels.CudaKernel("cell_pair_ladder.cu",
                                   "ladder_colt1_cellwise", _LADDER_ARGS)
BY_NAME = {"K1": K1, "K1b": K1B, "K1c": K1C, "K1d": K1D, "K1e": K1E,
           "K2": K2, "K1f": K1F, "K1f-cheb": K1F_CHEB,
           "K1f-cheb-mix": K1F_CHEB_MIX, "K1p": K1P, "K3a": K3A, "K3b": K3B,
           "K3c": K3C, "K3d": K3D}
KERNELS = tuple(BY_NAME.values())


def pack_rows(pos, type_id, active=None):
    """Packed (N, 4) [x, y, z, type+1|0] rows (0 = inactive)."""
    tv = type_id + 1
    if active is not None:
        tv = torch.where(active, tv, 0)
    return torch.cat([pos, tv.to(pos.dtype)[:, None]], dim=-1)


def pair_params(spec, n_types: int):
    """(5, T, T) float32 per-type-pair [sigma, eps, cutoff^2, shift, is_lj]."""
    is_lj = (spec.pair_kind == PAIR_LJ).to(torch.float32)
    return torch.stack([spec.pair_sig, spec.pair_eps, spec.pair_cutoff2,
                        spec.pair_shift, is_lj]).reshape(
                            5, n_types, n_types).contiguous()


def colt_operands(packed, buckets, n_cells: int):
    """Cell-dense (C, cap, 4) rows through ``buckets`` (holes are zero rows,
    hence invalid) and the (C,) int32 per-cell occupancy; buckets fill from
    rank 0, so a cell's rows [0, count) are exactly its particles."""
    b = buckets[:n_cells]
    rows = torch.clamp(b, min=0).long()
    cells = torch.where((b >= 0)[..., None], packed[rows], 0.0)
    counts = (b >= 0).sum(dim=1, dtype=torch.int32)
    return cells.contiguous(), counts


def stencil_table(dims, x_halo: bool = False) -> np.ndarray:
    """(C, S) neighbour cell ids over the deduplicated stencil, S <= 27
    (reference: ``pallas_pair.stencil_table``); on a full grid the 27
    offsets come in the kernels' loop order dx, dy, dz in (-1, 0, 1).
    With ``x_halo`` (K1f), ``dims`` is a slab of nx = w + 2 layers: the rows
    are its w * ny * nz inner cells and x is offset without a wrap."""
    offs = neighbor_cell_offsets(dims)
    nx, ny, nz = (int(d) for d in dims)
    if x_halo:
        ids = np.arange((nx - 2) * ny * nz) + ny * nz
    else:
        ids = np.arange(nx * ny * nz)
    cx, cy, cz = ids // (ny * nz), (ids // nz) % ny, ids % nz
    out = np.empty((len(ids), len(offs)), np.int32)
    for s, (dx, dy, dz) in enumerate(offs):
        # the offsets are residues mod dims: nx - 1 stands for -1
        x = cx + (dx + 1) % nx - 1 if x_halo else (cx + dx) % nx
        out[:, s] = (x * ny + (cy + dy) % ny) * nz + (cz + dz) % nz
    return out


def stencil_pairs(cells, box, dims, x_halo: bool = False, nbr=None):
    """Every slot of each cell against every slot of its S neighbour cells
    (the deduplicated stencil), in the kernels' op order: (minimum-image d
    per axis, r2 summed x, y, z, the valid-pair mask, the (C', cap, 4) rows
    of the summed cells (all C, or the inner cells of an ``x_halo`` slab),
    the (C', S*cap, 4) neighbour rows).  ``nbr`` is the (C', S) neighbour
    table when the caller derives it its own way (``stencil_table``'s by
    default)."""
    if nbr is None:
        nbr = torch.from_numpy(stencil_table(dims, x_halo))
    nbr = nbr.to(cells.device).long()
    n_out = nbr.shape[0]
    first = int(dims[1]) * int(dims[2]) if x_halo else 0
    xi = cells[first:first + n_out]
    xj = cells[nbr].reshape(n_out, -1, 4)
    ibox = 1.0 / box
    dr = []
    r2 = None
    for ax in range(3):
        d = xi[:, :, None, ax] - xj[:, None, :, ax]
        d = d - box[ax] * torch.round(d * ibox[ax])
        dr.append(d)
        r2 = d * d if r2 is None else r2 + d * d
    valid = ((xi[:, :, 3] > 0.5)[:, :, None]
             & (xj[:, :, 3] > 0.5)[:, None, :] & (r2 > 1e-12))
    return dr, r2, valid, xi, xj


def type_pairs(cells, xj, n_types: int):
    """(C, cap, S*cap) type-pair index ti * T + tj of ``stencil_pairs``."""
    ti = torch.clamp(cells[:, :, 3].long() - 1, min=0)
    tj = torch.clamp(xj[:, :, 3].long() - 1, min=0)
    return ti[:, :, None] * n_types + tj[:, None, :]


def lj_pair_terms(cells, box, params, dims, uniform_lj: bool, all_lj: bool,
                  want_e: bool, x_halo: bool = False, nbr=None):
    """The LJ terms of every pair of ``stencil_pairs`` in the kernels' op
    sequence: (d per axis, the force scalar f, the pair energy or None, the
    clamped r2s), each (C', cap, S*cap), zero outside the cutoff."""
    dr, r2, valid, xi, xj = stencil_pairs(cells, box, dims, x_halo, nbr)
    r2s = torch.where(valid, r2, 1.0)
    if uniform_lj:
        sig, eps, cut2, shift = (params[k, 0, 0] for k in range(4))
        in_cut = valid & (r2s < cut2)
    else:
        pid = type_pairs(xi, xj, params.shape[1])
        flat = params.reshape(5, -1)
        sig, eps, cut2, shift = (flat[k][pid] for k in range(4))
        in_cut = valid & (r2s < cut2)
        if not all_lj:
            in_cut &= flat[4][pid] > 0.5
    r2c = torch.maximum(r2s, 0.5625 * (sig * sig))
    inv_r2c = 1.0 / r2c
    s2 = (sig * sig) * inv_r2c
    s6 = s2 * s2 * s2
    f = torch.where(in_cut, 48.0 * eps * (s6 * s6 - 0.5 * s6) * inv_r2c, 0.0)
    e = (torch.where(in_cut, 4.0 * eps * (s6 * s6 - s6) - shift, 0.0)
         if want_e else None)
    return dr, f, e, r2s


def cell_pair_forces_cell_ref(cells, counts, box, params, dims,
                              uniform_lj: bool, all_lj: bool, ch3_mode: int,
                              x_halo: bool = False):
    """Plain torch K2: every slot i of a cell against every slot of its S
    deduplicated neighbour cells, vectorised over (C, cap, S*cap), in
    stencil order then slot order.  Returns the kernel's (C, cap, 4)
    [fx, fy, fz, ch3] rows; ``counts`` is unused here (empty slots are zero
    rows, which the validity test drops).  With ``x_halo`` (plain K1f) the
    cells are a slab of ``dims`` = (w + 2, ny, nz) and the rows are those
    of its w * ny * nz inner cells."""
    dr, f, e, r2s = lj_pair_terms(cells, box, params, dims, uniform_lj,
                                  all_lj, ch3_mode == CH3_ENERGY, x_halo)
    fxyz = [torch.sum(f * d, dim=2) for d in dr]
    if ch3_mode == CH3_ENERGY:
        ch3 = 0.5 * torch.sum(e, dim=2)
    elif ch3_mode == CH3_VIRIAL:
        ch3 = 0.5 * torch.sum(f * r2s, dim=2)
    else:
        ch3 = torch.zeros_like(fxyz[0])
    return torch.stack(fxyz + [ch3], dim=-1)


# Plain K1 is plain K2: on a full grid the deduplicated stencil is the 27
# offsets in K1's loop order.
cell_pair_forces_colt_ref = cell_pair_forces_cell_ref


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError("%s: dtype %s, expected %s" % (name, t.dtype, dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s: shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def _check_grid(cells, dims):
    """The kernels' common launch conditions on the (C, cap, 4) cell rows
    (a full grid, or a K1f slab of nx = w + 2 layers); returns the grid
    (nx, ny, nz)."""
    nx, ny, nz = (int(d) for d in dims)
    C, cap, _ = cells.shape
    if C != nx * ny * nz or min(nx, ny, nz) < 3:
        raise ValueError("K1 needs a full 27-cell stencil: dims %s for %d "
                         "cells" % (dims, C))
    if cells.device.type != "cuda":
        raise ValueError("K1's CUDA kernel takes CUDA tensors, not %s"
                         % cells.device)
    if cap > 1024:
        raise ValueError("K1: cell_cap %d exceeds one block" % cap)
    _check(cells, "cells", torch.float32, (C, cap, 4))
    if cells.data_ptr() % 16:
        raise ValueError("cells must be 16-byte aligned (float4 rows)")
    return nx, ny, nz


def _out_rows(cells, dims, x_halo: bool):
    """The kernels' (C', cap, 4) output: every cell, or the inner cells of
    a K1f slab."""
    nx, ny, nz = (int(d) for d in dims)
    n_out = (nx - 2 if x_halo else nx) * ny * nz
    return torch.empty((n_out,) + tuple(cells.shape[1:]), dtype=cells.dtype,
                       device=cells.device)


def _colt_checks(cells, counts, box, params, dims):
    """The LJ kernels' launch conditions."""
    _check_grid(cells, dims)
    C = cells.shape[0]
    n_types = params.shape[1]
    dev = cells.device
    for t, name in ((counts, "counts"), (box, "box"), (params, "params")):
        if t.device != dev:
            raise ValueError("%s is on %s, cells on %s" % (name, t.device,
                                                          dev))
    _check(counts, "counts", torch.int32, (C,))
    _check(box, "box", torch.float32, (3,))
    _check(params, "params", torch.float32, (5, n_types, n_types))


def _colt_pointers(cells, counts, box, params, out, dims, uniform_lj: bool,
                   all_lj: bool, ch3_mode: int, x_halo: bool):
    """The LJ entry points' common arguments, operands to ``x_halo``."""
    nx, ny, nz = (int(d) for d in dims)
    return (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            params.data_ptr(), out.data_ptr(), nx, ny, nz, cells.shape[1],
            params.shape[1], int(uniform_lj), int(all_lj), int(ch3_mode),
            int(x_halo))


def colt_plan_args(plan):
    """The plan's arguments of ``cell_pair_colt``, after the operands."""
    return plan.seg, plan.rows, plan.threads, plan.depth, plan.smem


def cell_pair_forces_colt_kernel(cells, counts, box, params, dims,
                                 uniform_lj: bool, all_lj: bool,
                                 ch3_mode: int, x_halo: bool = False,
                                 plan=None):
    """Launch the CUDA K1 (K1b in the virial channel, K1f with ``x_halo``)
    on the current stream (CUDA tensors only): the column-segment kernel
    with ``plan`` (``colt_launch_plan``'s for these shapes by default)."""
    _colt_checks(cells, counts, box, params, dims)
    if plan is None:
        plan = colt_launch_plan(dims, cells.shape[1], params.shape[1],
                                x_halo)
    out = _out_rows(cells, dims, x_halo)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    kernel = K1F if x_halo else K1B if ch3_mode == CH3_VIRIAL else K1
    kernel.launch(*_colt_pointers(cells, counts, box, params, out, dims,
                                  uniform_lj, all_lj, ch3_mode, x_halo),
                  *colt_plan_args(plan), stream)
    return out


def cell_pair_forces_colt_cellwise(cells, counts, box, params, dims,
                                   uniform_lj: bool, all_lj: bool,
                                   ch3_mode: int, x_halo: bool = False):
    """Launch the LJ cellwise kernel (``K1_CELLWISE``) on the same operands
    as ``cell_pair_forces_colt_kernel``: the baseline of the A/B, which no
    step reaches."""
    _colt_checks(cells, counts, box, params, dims)
    cap, n_types = cells.shape[1], params.shape[1]
    if cap * 16 + 5 * n_types * n_types * 4 > 48 * 1024:
        raise ValueError("K1 cellwise: shared-memory stage exceeds 48 KiB")
    out = _out_rows(cells, dims, x_halo)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    K1_CELLWISE.launch(*_colt_pointers(cells, counts, box, params, out, dims,
                                       uniform_lj, all_lj, ch3_mode, x_halo),
                       stream)
    return out


def colt_cells(cells, counts, box, params, dims, uniform_lj: bool,
               all_lj: bool, ch3_mode: int, x_halo: bool = False):
    """K1 (K1f with ``x_halo``) wrapper: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    if cells.device.type == "cuda":
        return cell_pair_forces_colt_kernel(cells, counts, box, params, dims,
                                            uniform_lj, all_lj, ch3_mode,
                                            x_halo)
    if cells.device.type == "cpu":
        return cell_pair_forces_colt_ref(cells, counts, box, params, dims,
                                         uniform_lj, all_lj, ch3_mode, x_halo)
    raise ValueError("K1 has no version for device %s" % cells.device)


@functools.lru_cache(maxsize=None)
def _stencil_offsets(dims, device):
    """The cellwise K2's (S, 3) int32 offset table on ``device``, made once
    per grid: a copy from the host on every call would synchronise the
    stream."""
    return torch.from_numpy(neighbor_cell_offsets(dims)).to(device)


@functools.lru_cache(maxsize=None)
def _mask(dims) -> int:
    kept, seen = 0, set()
    for o in range(27):
        key = tuple((d - 1) % n for d, n in zip((o // 9, o // 3 % 3, o % 3),
                                                dims))
        if key not in seen:
            seen.add(key)
            kept |= 1 << o
    return kept


def stencil_mask(dims) -> int:
    """K2's 27-bit stencil mask on ``dims``: bit o (offset dx, dy, dz =
    o // 9 - 1, o // 3 % 3 - 1, o % 3 - 1, the column-segment kernel's lane
    order) is set when the offset's residue mod dims appears for the first
    time in that order: the offsets ``neighbor_cell_offsets`` keeps, in its
    order.  All 27 bits on a full grid.  Made once per grid, on the host
    (an int, no device copy)."""
    return _mask(tuple(int(d) for d in dims))


def _cell_checks(cells, counts, box, params, dims):
    """K2's launch conditions: any grid, any cap up to 1024 (its plan
    raises where the stage cannot fit)."""
    nx, ny, nz = (int(d) for d in dims)
    C, cap, _ = cells.shape
    if C != nx * ny * nz:
        raise ValueError("K2: dims %s for %d cells" % (dims, C))
    if cells.device.type != "cuda":
        raise ValueError("K2's CUDA kernel takes CUDA tensors, not %s"
                         % cells.device)
    if not 0 < cap <= 1024:
        raise ValueError("K2: cell_cap %d does not fit one block" % cap)
    _check(cells, "cells", torch.float32, (C, cap, 4))
    if cells.data_ptr() % 16:
        raise ValueError("cells must be 16-byte aligned (float4 rows)")
    dev = cells.device
    n_types = params.shape[1]
    for t, name in ((counts, "counts"), (box, "box"), (params, "params")):
        if t.device != dev:
            raise ValueError("%s is on %s, cells on %s" % (name, t.device,
                                                          dev))
    _check(counts, "counts", torch.int32, (C,))
    _check(box, "box", torch.float32, (3,))
    _check(params, "params", torch.float32, (5, n_types, n_types))


def cell_pair_forces_cell_kernel(cells, counts, box, params, dims,
                                 uniform_lj: bool, all_lj: bool,
                                 ch3_mode: int, plan=None):
    """Launch the CUDA K2 on the current stream (CUDA tensors only): K1's
    column-segment kernel over ``stencil_mask(dims)``, any grid, any cap,
    with ``plan`` (``k2_launch_plan``'s for these shapes by default)."""
    _cell_checks(cells, counts, box, params, dims)
    if plan is None:
        plan = k2_launch_plan(dims, cells.shape[1], params.shape[1])
    out = torch.empty_like(cells)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    K2.launch(*_colt_pointers(cells, counts, box, params, out, dims,
                              uniform_lj, all_lj, ch3_mode, False)[:-1],
              stencil_mask(dims), *colt_plan_args(plan), stream)
    return out


def cell_pair_forces_cell_cellwise(cells, counts, box, params, dims,
                                   uniform_lj: bool, all_lj: bool,
                                   ch3_mode: int):
    """Launch K2's cellwise kernel (``K2_CELLWISE``) on the same operands as
    ``cell_pair_forces_cell_kernel``: the baseline of the A/B, which no
    step reaches."""
    _cell_checks(cells, counts, box, params, dims)
    nx, ny, nz = (int(d) for d in dims)
    cap, n_types = cells.shape[1], params.shape[1]
    offsets = _stencil_offsets((nx, ny, nz), cells.device)
    n_stencil = offsets.shape[0]
    # dynamic stage (rows, parameters, occupancies) + the static cell ids
    smem = 16 * n_stencil * cap + 4 * (5 * n_types * n_types + n_stencil) \
        + 4 * 27
    if smem > SMEM_MAX:
        raise ValueError("K2 cellwise: shared-memory stage of %d bytes "
                         "exceeds 227 KiB" % smem)
    out = torch.empty_like(cells)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    K2_CELLWISE.launch(cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
                       params.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                       nx, ny, nz, cap, n_types, n_stencil, int(uniform_lj),
                       int(all_lj), int(ch3_mode), stream)
    return out


def cell_cells(cells, counts, box, params, dims, uniform_lj: bool,
               all_lj: bool, ch3_mode: int):
    """K2 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if cells.device.type == "cuda":
        return cell_pair_forces_cell_kernel(cells, counts, box, params, dims,
                                            uniform_lj, all_lj, ch3_mode)
    if cells.device.type == "cpu":
        return cell_pair_forces_cell_ref(cells, counts, box, params, dims,
                                         uniform_lj, all_lj, ch3_mode)
    raise ValueError("K2 has no version for device %s" % cells.device)


def colt_legal(cap: int, dims) -> bool:
    """The reference's rule for colt2 (K1) over the per-cell K2
    (``pallas_pair.py:844-847``): cap a multiple of 8, a full 27-cell
    stencil."""
    return cap % 8 == 0 and min(int(d) for d in dims) >= 3


def mix_weights(spec, obs_x):
    """(T*T,) float32 blend weight of table a per type pair: the
    conversion observable for func 10, the static factor for func 12, and
    1 on every pair without a second table (so the blend is exact there)."""
    x = torch.where(spec.pair_mix_mode == MIX_OBS,
                    obs_x[spec.pair_obs.long()], spec.pair_mix_x)
    return torch.where(spec.cheb_tab_slot_b > 0.5, x,
                       torch.ones_like(x)).to(torch.float32)


def cheb_operands(spec, n_types: int, ko: int, ntab: int, mix: bool,
                  obs_x=None):
    """The Chebyshev modes' operands: (cut2 (T, T) f32, tmap (T, T) int32
    row index + 1 into ``coef`` (0: no table), tmap_b and xmat (T, T) for
    the blend or None, coef (rows, 2kw + 2ko + 6) f32).  Table-scalar mode
    (``ntab > 0``) maps through the deduplicated slots to ``cheb_sc``;
    coefficient-plane mode maps the table id to the per-table fit rows."""
    tt = (n_types, n_types)
    cut2 = spec.pair_cutoff2.to(torch.float32).reshape(tt).contiguous()
    tmap_b = xmat = None
    if ntab:
        tmap = spec.cheb_tab_slot.to(torch.int32).reshape(tt).contiguous()
        coef = spec.cheb_sc.to(torch.float32).contiguous()
        if mix:
            tmap_b = spec.cheb_tab_slot_b.to(torch.int32).reshape(
                tt).contiguous()
            xmat = mix_weights(spec, obs_x).reshape(tt).contiguous()
    else:
        if mix:
            raise ValueError("the two-table blend needs table-scalar mode")
        tmap = (torch.clamp(spec.pair_tab_a, min=0) + 1).to(
            torch.int32).reshape(tt).contiguous()
        coef = tab_cheb.table_rows(spec, ko)
    return cut2, tmap, tmap_b, xmat, coef


def _cheb_rows_eval(coef, tmap_flat, pid, r2s, kw, ko, want_e):
    """(G, E) of the row ``tmap[pid] - 1`` of ``coef`` (zero where the map
    is 0)."""
    m = tmap_flat[pid].long()
    c = tab_cheb.split_rows(coef[torch.clamp(m - 1, min=0)], kw, ko)
    g, e = tab_cheb.eval_planes(r2s, c["wall_g"], c["wall_e"], c["well_g"],
                                c["well_e"], c["ay"], c["by"], c["ax"],
                                c["bx"], c["rs2"], c["rcap2"], kw, ko,
                                want_e=want_e)
    return torch.where(m > 0, g, 0.0), torch.where(m > 0, e, 0.0)


def cell_pair_forces_cheb_ref(cells, counts, box, cut2, tmap, tmap_b, xmat,
                              coef, dims, kw: int, ko: int, ch3_mode: int,
                              x_halo: bool = False):
    """Plain torch K1c/K1d/K1e, vectorised over (C, cap, 27*cap) like the
    LJ version: per pair the minimum image and r2 of the LJ mode, the fit
    row(s) of the type pair's map, ``eval_planes``, the blend
    ``x*g_a + (1-x)*g_b`` when ``tmap_b`` is given, and the cut
    ``valid & (r2s < cut2)``.  ch3 carries half the tabulated energy
    (mode 1) or half the pair virial (mode 2).  ``x_halo`` as in the LJ
    version (plain K1f).  The series run on the pairs inside the cut only
    (elementwise, so each pair's value is the same bits as over the whole
    plane); every other pair contributes an exact zero."""
    dr, r2, valid, xi, xj = stencil_pairs(cells, box, dims, x_halo)
    r2s = torch.where(valid, r2, 1.0)
    pid = type_pairs(xi, xj, cut2.shape[0])
    in_cut = valid & (r2s < cut2.reshape(-1)[pid])
    want_e = ch3_mode == CH3_ENERGY
    pid_in, r2_in = pid[in_cut], r2s[in_cut]
    g_in, e_in = _cheb_rows_eval(coef, tmap.reshape(-1), pid_in, r2_in, kw,
                                 ko, want_e)
    if tmap_b is not None:
        g_b, e_b = _cheb_rows_eval(coef, tmap_b.reshape(-1), pid_in, r2_in,
                                   kw, ko, want_e)
        x = xmat.reshape(-1)[pid_in]
        g_in = x * g_in + (1.0 - x) * g_b
        e_in = x * e_in + (1.0 - x) * e_b
    f = torch.zeros_like(r2s)
    f[in_cut] = g_in
    fxyz = [torch.sum(f * d, dim=2) for d in dr]
    if ch3_mode == CH3_ENERGY:
        e = torch.zeros_like(r2s)
        e[in_cut] = e_in
        ch3 = 0.5 * torch.sum(e, dim=2)
    elif ch3_mode == CH3_VIRIAL:
        ch3 = 0.5 * torch.sum(f * r2s, dim=2)
    else:
        ch3 = torch.zeros_like(fxyz[0])
    return torch.stack(fxyz + [ch3], dim=-1)


def cheb_kernel_for(tmap_b, ntab: int, x_halo: bool = False):
    """The kernel handle (entry point and launch count) of a Chebyshev
    mode."""
    if x_halo:
        return K1F_CHEB_MIX if tmap_b is not None else K1F_CHEB
    return K1D if tmap_b is not None else (K1C if ntab else K1E)


class PackedPlan(NamedTuple):
    """A column-segment kernel's launch plan: z cells per block (L), rows
    per warp batch, threads per block, list entries per thread (a warp's
    list holds 32 times as many) and the shared-memory bytes of that
    layout."""
    seg: int
    rows: int
    threads: int
    depth: int
    smem: int


# The plans' choices, measured on an H100 (PERF.md): at least MIN_BLOCKS,
# two blocks per SM of the card's 132, wherever the grid has them (the
# segment shrinks to reach them), and a block's shared memory below
# SMEM_MAX, the card's 227 KiB.  The Chebyshev kernel (the sweep of
# ``python -m chemlab_tpu_torch.kernel_matrix --tab``): segments of at most
# CHEB_SEG cells, batches of CHEB_ROWS rows a warp, CHEB_THREADS threads a
# block, lists of CHEB_DEPTH entries a thread.
MIN_BLOCKS = 2 * 132
SMEM_MAX = 227 * 1024
CHEB_SEG = 2
CHEB_ROWS = 4
CHEB_THREADS = 128
CHEB_DEPTH = 8
# The LJ kernel (the sweep of ``kernel_matrix --lj``, then these rules in
# turns; PERF.md): segments of at most COLT_SEG cells, batches of COLT_ROWS
# rows a warp, COLT_THREADS threads a block, lists of COLT_DEPTH entries a
# thread were the fastest on the 10k and NPT melts (the main paths), within
# 7 % of the fastest on the tiled 22^3 grids and the slabs.
COLT_SEG = 3
COLT_ROWS = 2
COLT_THREADS = 256
COLT_DEPTH = 4


def _stage_bytes(cap: int, seg: int, threads: int, depth: int,
                 words: int) -> int:
    """Shared-memory bytes of a column-segment kernel with ``words`` 4-byte
    words of its own: the stage of 9 z-columns of seg + 2 cells (hz cap + 1
    rows of 16 B a column), ``depth`` 16-byte list entries per thread, each
    column's row prefix (hz + 1) and each staged cell's count, row offset
    and bounding box (6 floats)."""
    hz = seg + 2
    return (16 * (9 * (hz * cap + 1) + threads * depth)
            + 4 * (words + 9 * (hz + 1) + 9 * hz * (1 + 1 + 6)))


def cheb_smem(cap: int, n_types: int, n_rows: int, kw: int, ko: int,
              mix: bool, seg: int, threads: int, depth: int) -> int:
    """Shared-memory bytes of the Chebyshev column-segment kernel: the
    stage and lists (``_stage_bytes``), the coefficient pack, the (T, T)
    cutoffs and maps (two more with the blend), and the largest cutoff^2
    per type."""
    return _stage_bytes(cap, seg, threads, depth,
                        n_rows * (2 * kw + 2 * ko + 6)
                        + n_types * n_types * (4 if mix else 2) + n_types)


def colt_smem(cap: int, n_types: int, seg: int, threads: int,
              depth: int) -> int:
    """Shared-memory bytes of the LJ column-segment kernel: the stage and
    lists (``_stage_bytes``), the (5, T, T) parameter table and the largest cutoff^2 per type."""
    return _stage_bytes(cap, seg, threads, depth,
                        5 * n_types * n_types + n_types)


def plan_segment(dims, x_halo: bool, seg_max: int) -> int:
    """The plans' segment: the longest of at most ``seg_max`` cells that
    leaves ``MIN_BLOCKS`` blocks (or one cell a block), split evenly over
    nz."""
    nx, ny, nz = (int(d) for d in dims)
    n_cols = (nx - 2 if x_halo else nx) * ny
    seg = next(s for s in range(min(seg_max, nz), 0, -1)
               if n_cols * -(-nz // s) >= MIN_BLOCKS or s == 1)
    return -(-nz // -(-nz // seg))


def _packed_plan(label: str, dims, x_halo: bool, seg, rows, threads, depth,
                 defaults, smem_fn) -> PackedPlan:
    """A column-segment kernel's plan on ``dims``: the segment by
    ``plan_segment`` with at most ``defaults[0]`` cells; rows, threads and
    depth default to ``defaults[1:]``; ``smem_fn(seg, threads, depth)``
    gives the bytes."""
    seg_max, rows_d, threads_d, depth_d = defaults
    if seg is None:
        seg = plan_segment(dims, x_halo, seg_max)
    rows = rows_d if rows is None else rows
    threads = threads_d if threads is None else threads
    depth = depth_d if depth is None else depth
    if not (1 <= seg and 1 <= rows <= 32 and 32 <= threads <= 1024
            and threads % 32 == 0 and depth >= 1):
        raise ValueError("%s: no plan with seg %d, rows %d, threads %d, "
                         "depth %d" % (label, seg, rows, threads, depth))
    smem = smem_fn(seg, threads, depth)
    if smem > SMEM_MAX:
        raise ValueError("%s: shared-memory stage of %d bytes exceeds "
                         "227 KiB" % (label, smem))
    return PackedPlan(seg, rows, threads, depth, smem)


def cheb_launch_plan(dims, cap: int, n_types: int, n_rows: int, kw: int,
                     ko: int, mix: bool, x_halo: bool = False, *,
                     seg=None, rows=None, threads=None,
                     depth=None) -> PackedPlan:
    """The launch plan of ``cell_pair_cheb`` / ``cell_pair_cheb_mix`` on a
    grid ``dims`` (a K1f slab of w + 2 layers with ``x_halo``): from the
    shapes alone, never from the counts, which the host cannot read without
    a sync.  The segment is the longest of at most ``CHEB_SEG`` cells that
    leaves ``MIN_BLOCKS`` blocks (or one cell a block), split evenly over
    nz; ``seg``, ``rows``, ``threads`` and ``depth`` override the measured
    choices (the kernel matrix's sweep).  Raises ``ValueError`` above 227
    KiB of shared memory, naming the size."""
    return _plan(tuple(int(d) for d in dims), int(cap), int(n_types),
                 int(n_rows), int(kw), int(ko), bool(mix), bool(x_halo), seg,
                 rows, threads, depth)


@functools.lru_cache(maxsize=None)
def _plan(dims, cap, n_types, n_rows, kw, ko, mix, x_halo, seg, rows,
          threads, depth):
    """``cheb_launch_plan``, made once per set of shapes: the step's wrapper
    asks for it on every call."""
    return _packed_plan(
        "K1 cheb", dims, x_halo, seg, rows, threads, depth,
        (CHEB_SEG, CHEB_ROWS, CHEB_THREADS, CHEB_DEPTH),
        lambda sg, th, dp: cheb_smem(cap, n_types, n_rows, kw, ko, mix, sg,
                                     th, dp))


def colt_launch_plan(dims, cap: int, n_types: int, x_halo: bool = False, *,
                     seg=None, rows=None, threads=None,
                     depth=None) -> PackedPlan:
    """The launch plan of ``cell_pair_colt`` (K1, K1b, K1f) on a grid
    ``dims`` (a K1f slab of w + 2 layers with ``x_halo``): from the shapes
    alone, never from the counts or the box, which the host cannot read
    without a sync (and the box moves every NPT step).  The segment rule is
    ``cheb_launch_plan``'s with at most ``COLT_SEG`` cells; ``seg``,
    ``rows``, ``threads`` and ``depth`` override the measured choices (the
    kernel matrix's sweep).  Raises ``ValueError`` above 227 KiB of shared
    memory, naming the size."""
    return _colt_plan(tuple(int(d) for d in dims), int(cap), int(n_types),
                      bool(x_halo), seg, rows, threads, depth)


@functools.lru_cache(maxsize=None)
def _colt_plan(dims, cap, n_types, x_halo, seg, rows, threads, depth):
    """``colt_launch_plan``, made once per set of shapes."""
    return _packed_plan(
        "K1", dims, x_halo, seg, rows, threads, depth,
        (COLT_SEG, COLT_ROWS, COLT_THREADS, COLT_DEPTH),
        lambda sg, th, dp: colt_smem(cap, n_types, sg, th, dp))


def k2_launch_plan(dims, cap: int, n_types: int, *, seg=None, rows=None,
                   threads=None, depth=None) -> PackedPlan:
    """The launch plan of ``cell_pair_cell`` (K2) on a grid ``dims`` of any
    shape and any cap: K1's layout (``colt_smem``) and K1's rule
    (``COLT_*``), which was also the fastest of ``kernel_matrix``'s
    ``K2_RULES`` in turns on K2's main-path grid (PERF.md), from the shapes
    alone, never the counts or the box; ``seg``, ``rows``, ``threads`` and
    ``depth`` override it (the kernel matrix's sweep).  Raises
    ``ValueError`` naming K2 above 227 KiB of shared memory, with the
    size."""
    return _k2_plan(tuple(int(d) for d in dims), int(cap), int(n_types),
                    seg, rows, threads, depth)


@functools.lru_cache(maxsize=None)
def _k2_plan(dims, cap, n_types, seg, rows, threads, depth):
    """``k2_launch_plan``, made once per set of shapes."""
    return _packed_plan(
        "K2", dims, False, seg, rows, threads, depth,
        (COLT_SEG, COLT_ROWS, COLT_THREADS, COLT_DEPTH),
        lambda sg, th, dp: colt_smem(cap, n_types, sg, th, dp))


def _cheb_checks(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, dims,
                 kw: int, ko: int):
    """The Chebyshev kernels' launch conditions."""
    _check_grid(cells, dims)
    C = cells.shape[0]
    n_types = cut2.shape[0]
    n_p = coef.shape[1]
    if n_p != 2 * kw + 2 * ko + 6 or kw < 2 or (ko and ko < 2):
        raise ValueError("K1 cheb: %d coefficients per row for kw=%d ko=%d"
                         % (n_p, kw, ko))
    if (tmap_b is None) != (xmat is None):
        raise ValueError("the blend needs both tmap_b and xmat")
    dev = cells.device
    ops = [(counts, "counts", torch.int32, (C,)),
           (box, "box", torch.float32, (3,)),
           (cut2, "cut2", torch.float32, (n_types, n_types)),
           (tmap, "tmap", torch.int32, (n_types, n_types)),
           (coef, "coef", torch.float32, None)]
    if tmap_b is not None:
        ops += [(tmap_b, "tmap_b", torch.int32, (n_types, n_types)),
                (xmat, "xmat", torch.float32, (n_types, n_types))]
    for t, name, dtype, shape in ops:
        if t.device != dev:
            raise ValueError("%s is on %s, cells on %s" % (name, t.device,
                                                          dev))
        _check(t, name, dtype, shape)


def _cheb_pointers(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, out,
                   dims, kw: int, ko: int, ch3_mode: int, x_halo: bool):
    """The entry points' common arguments, operands to ``x_halo``."""
    nx, ny, nz = (int(d) for d in dims)
    return (cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
            cut2.data_ptr(), tmap.data_ptr(),
            0 if tmap_b is None else tmap_b.data_ptr(),
            0 if xmat is None else xmat.data_ptr(), coef.data_ptr(),
            out.data_ptr(), nx, ny, nz, cells.shape[1], cut2.shape[0],
            coef.shape[0], kw, ko, int(ch3_mode), int(x_halo))


def cell_pair_forces_cheb_kernel(cells, counts, box, cut2, tmap, tmap_b,
                                 xmat, coef, dims, kw: int, ko: int,
                                 ch3_mode: int, ntab: int = 1,
                                 x_halo: bool = False, plan=None):
    """Launch the CUDA K1c (``ntab > 0``), K1d (``tmap_b`` given) or K1e
    (``ntab == 0``), or K1f in that mode with ``x_halo``, on the current
    stream (CUDA tensors only): the column-segment kernel with ``plan``
    (``cheb_launch_plan``'s for these shapes by default)."""
    _cheb_checks(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, dims,
                 kw, ko)
    if plan is None:
        plan = cheb_launch_plan(dims, cells.shape[1], cut2.shape[0],
                                coef.shape[0], kw, ko, tmap_b is not None,
                                x_halo)
    out = _out_rows(cells, dims, x_halo)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    cheb_kernel_for(tmap_b, ntab, x_halo).launch(
        *_cheb_pointers(cells, counts, box, cut2, tmap, tmap_b, xmat, coef,
                        out, dims, kw, ko, ch3_mode, x_halo),
        plan.seg, plan.rows, plan.threads, plan.depth, plan.smem, stream)
    return out


def cell_pair_forces_cheb_cellwise(cells, counts, box, cut2, tmap, tmap_b,
                                   xmat, coef, dims, kw: int, ko: int,
                                   ch3_mode: int, x_halo: bool = False):
    """Launch the cellwise kernel (``K1C_CELLWISE``, or ``K1D_CELLWISE``
    with ``tmap_b``) on the same operands as
    ``cell_pair_forces_cheb_kernel``: the baseline of the A/B, which no
    step reaches."""
    _cheb_checks(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, dims,
                 kw, ko)
    n_types = cut2.shape[0]
    smem = cells.shape[1] * 16 + 4 * (coef.numel() + n_types * n_types
                                      * (4 if tmap_b is not None else 2))
    if smem > SMEM_MAX:
        raise ValueError("K1 cheb: shared-memory stage of %d bytes exceeds "
                         "227 KiB" % smem)
    out = _out_rows(cells, dims, x_halo)
    stream = torch.cuda.current_stream(cells.device).cuda_stream
    kernel = K1C_CELLWISE if tmap_b is None else K1D_CELLWISE
    kernel.launch(*_cheb_pointers(cells, counts, box, cut2, tmap, tmap_b,
                                  xmat, coef, out, dims, kw, ko, ch3_mode,
                                  x_halo), stream)
    return out


def cheb_cells(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, dims,
               kw: int, ko: int, ch3_mode: int, ntab: int = 1,
               x_halo: bool = False):
    """K1c/K1d/K1e (K1f in those modes with ``x_halo``) wrapper: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if cells.device.type == "cuda":
        return cell_pair_forces_cheb_kernel(cells, counts, box, cut2, tmap,
                                            tmap_b, xmat, coef, dims, kw, ko,
                                            ch3_mode, ntab, x_halo)
    if cells.device.type == "cpu":
        return cell_pair_forces_cheb_ref(cells, counts, box, cut2, tmap,
                                         tmap_b, xmat, coef, dims, kw, ko,
                                         ch3_mode, x_halo)
    raise ValueError("K1 has no version for device %s" % cells.device)


# the names ``cell_pair_forces`` takes (the reference's CHEMLAB_KERNEL
# values); "colt" and "colt2" name K1, which the Chebyshev branch and the
# slab path run anyway, the others a kernel of their own
PAIR_KERNELS = ("auto", "cell", "colt", "colt1", "colt2", "packet", "column",
                "resident")
LADDER = ("cell", "colt1", "packet", "column", "resident")


def check_pair_kernel(kernel: str, cheb_kw: int = 0, slab: bool = False):
    """Raise ``ValueError`` on a name ``cell_pair_forces`` does not take,
    and on a kernel of ``LADDER`` named for a tabulated system or a slab
    mesh, which run only colt2 (where the reference ignores the name)."""
    if kernel not in PAIR_KERNELS:
        raise ValueError("unknown pair kernel %r: one of %s"
                         % (kernel, ", ".join(PAIR_KERNELS)))
    if kernel in LADDER and cheb_kw:
        raise ValueError("pair kernel %r is LJ only: a tabulated system "
                         "runs the Chebyshev modes of colt2" % kernel)
    if kernel in LADDER and slab:
        raise ValueError("pair kernel %r on a slab mesh: the slab path "
                         "runs colt2 (K1f) only" % kernel)


def cell_pair_forces(pos, type_id, active, box, buckets, slot_of, dims, spec,
                     n_types: int, uniform_lj: bool = False,
                     all_lj: bool = False, want_energy: bool = True,
                     want_virial: bool = False, cheb_kw: int = 0,
                     cheb_ko: int = 0, cheb_ntab: int = 0,
                     cheb_mix: bool = False, obs_x=None,
                     kernel: str = "auto"):
    """Unexcluded all-pairs sum on the cell grid (reference:
    ``cell_pair_forces``): LJ through K1 on a grid colt2 takes
    (``colt_legal``) and through K2 on any other, or the Chebyshev-tabulated
    pairs through K1c/K1d/K1e when ``cheb_kw > 0`` (colt2 grids only, as in
    the reference).  Returns (force (N, 3), e_lj, e_tab, w): the spare
    channel carries either the pair energy (``want_energy``; ``e_tab`` on a
    tabulated system) or the pair virial (``want_virial``), never both.

    ``kernel`` picks the LJ kernel by the reference's rule
    (``pallas_pair.py:828-874``, its CHEMLAB_KERNEL): "auto" as above,
    "cell" K2, "colt"/"colt2" K1 and "colt1" K1' where colt2 is legal,
    "packet"/"resident" K3a/K3b where ``cap % 8 == 0``, "column" K3c (K3d
    when ``cap % 8 != 0``); every illegal geometry takes K2.  K3a-K3d
    return (force, e, 0, w) in one pass whatever the energy/virial flags,
    as the reference's variants do (``cell_pair_variants``)."""
    check_pair_kernel(kernel, cheb_kw)
    n_cells = int(np.prod(dims))
    cap = buckets.shape[1]
    legal = colt_legal(cap, dims)
    if kernel not in ("auto", "colt", "colt2"):
        from . import cell_pair_variants as variants

        args = (pos, type_id, active, box, buckets, slot_of, dims, spec,
                n_types, uniform_lj)
        if kernel == "column":
            return variants.cell_pair_forces_columns(*args)
        if kernel == "colt1" and legal:
            return variants.cell_pair_forces_colt1(*args,
                                                   want_virial=want_virial)
        if cap % 8 == 0 and kernel == "packet":
            return variants.cell_pair_forces_packets(*args)
        if cap % 8 == 0 and kernel == "resident":
            return variants.cell_pair_forces_resident(*args)
        legal = False       # "cell" and every illegal geometry: K2
    if cheb_kw and not legal:
        raise ValueError("the Chebyshev tabulated path needs a colt2 grid "
                         "(cap %% 8 == 0, min(dims) >= 3): cap %d, dims %s"
                         % (cap, dims))
    cells, counts = colt_operands(pack_rows(pos, type_id, active), buckets,
                                  n_cells)
    out_flat = pair_rows(cells, counts, box, dims, spec, n_types, uniform_lj,
                         all_lj, want_energy, want_virial, cheb_kw, cheb_ko,
                         cheb_ntab, cheb_mix, obs_x, lj_kernel=legal)
    in_grid = slot_of < n_cells * cap
    rows_f = out_flat[torch.where(in_grid, slot_of, 0).long()]
    force = torch.where(in_grid[:, None], rows_f[:, :3], 0.0)
    return pair_result(force, torch.sum(out_flat[:, 3]), want_virial,
                       cheb_kw)


def pair_rows(cells, counts, box, dims, spec, n_types: int, uniform_lj: bool,
              all_lj: bool, want_energy: bool, want_virial: bool,
              cheb_kw: int, cheb_ko: int, cheb_ntab: int, cheb_mix: bool,
              obs_x, lj_kernel: bool = True, x_halo: bool = False):
    """The pair kernel's flat (rows, 4) slot output on these cell operands:
    the Chebyshev modes when ``cheb_kw > 0``, else LJ through K1
    (``lj_kernel``) or K2; ``x_halo`` runs K1f on a slab."""
    mode = (CH3_VIRIAL if want_virial
            else CH3_ENERGY if want_energy else CH3_NONE)
    if cheb_kw:
        cut2, tmap, tmap_b, xmat, coef = cheb_operands(
            spec, n_types, cheb_ko, cheb_ntab, cheb_mix, obs_x)
        out = cheb_cells(cells, counts, box.contiguous(), cut2, tmap, tmap_b,
                         xmat, coef, dims, cheb_kw, cheb_ko, mode, cheb_ntab,
                         x_halo)
    else:
        args = (cells, counts, box.contiguous(), pair_params(spec, n_types),
                dims, uniform_lj, all_lj, mode)
        out = colt_cells(*args, x_halo) if lj_kernel else cell_cells(*args)
    return out.reshape(-1, 4)


def pair_result(force, s3, want_virial: bool, cheb_kw: int):
    """``cell_pair_forces``' return tuple (force, e_lj, e_tab, w): the
    spare-channel sum ``s3`` is the virial, the tabulated or the LJ pair
    energy."""
    zero = torch.zeros((), dtype=force.dtype, device=force.device)
    if want_virial:
        return force, zero, zero, s3
    if cheb_kw:
        return force, zero, s3, zero
    return force, s3, zero, zero


def cheb_pair_operands(spec, cheb=None, cheb_mix: bool = False,
                       obs_x=None):
    """The correction's Chebyshev operands, built once per correction:
    None (``cheb`` None) or (kw, ko, the per-table fit rows, the (T*T,)
    blend weights of table a or None)."""
    if cheb is None:
        return None
    kw, ko = cheb
    x = mix_weights(spec, obs_x) if cheb_mix else None
    return kw, ko, tab_cheb.table_rows(spec, ko), x


def _pair_eval(spec, n_types: int, pi, pj, box, valid, tab=None):
    """Per-pair correction terms for packed endpoint rows of any leading
    shape.  Returns (d, f_scalar, e_lj, e_tab, r2s, valid) elementwise, in
    exactly the kernel's op sequence (the cancellation contract).  With
    ``tab`` (``cheb_pair_operands``) the pairs are evaluated by their
    Chebyshev fit (``tab_cheb.eval_pairs``), blended ``x*g_a + (1-x)*g_b``
    when the blend weights are given; a tabulated system has no LJ pair
    (``build.supports_cheb``), so the LJ terms are zero there."""
    valid = valid & (pi[..., 3] > 0.5) & (pj[..., 3] > 0.5)
    d = pi[..., :3] - pj[..., :3]
    d = d - box * torch.round(d * (1.0 / box))
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    r2s = torch.where(valid, torch.clamp(r2, min=1e-12), 1.0)
    ti = torch.clamp(pi[..., 3].long() - 1, min=0)
    tj = torch.clamp(pj[..., 3].long() - 1, min=0)
    pid = ti * n_types + tj
    in_cut = valid & (r2s < spec.pair_cutoff2[pid])
    kind = spec.pair_kind[pid]
    if tab is None:
        sig = spec.pair_sig[pid]
        eps = spec.pair_eps[pid]
        r2c = torch.maximum(r2s, 0.5625 * (sig * sig))
        inv_r2c = 1.0 / r2c
        s2 = (sig * sig) * inv_r2c
        s6 = s2 * s2 * s2
        lj_m = in_cut & (kind == PAIR_LJ)
        e_lj = torch.where(lj_m, 4.0 * eps * (s6 * s6 - s6)
                           - spec.pair_shift[pid], 0.0)
        f_lj = torch.where(lj_m, 48.0 * eps * (s6 * s6 - 0.5 * s6) * inv_r2c,
                           0.0)
        return d, f_lj, e_lj, torch.zeros_like(e_lj), r2s, valid
    kw, ko, rows, x = tab
    g, e = tab_cheb.eval_pairs(rows, torch.clamp(spec.pair_tab_a[pid], min=0),
                               r2s, kw, ko)
    if x is not None:
        g_b, e_b = tab_cheb.eval_pairs(
            rows, torch.clamp(spec.pair_tab_b[pid], min=0), r2s, kw, ko)
        x = x[pid]
        g = x * g + (1.0 - x) * g_b
        e = x * e + (1.0 - x) * e_b
    tab_m = in_cut & (kind == PAIR_TAB)
    f_tab = torch.where(tab_m, g, 0.0)
    return (d, f_tab, torch.zeros_like(f_tab), torch.where(tab_m, e, 0.0),
            r2s, valid)


def excluded_pair_correction(spec, n_types: int, pos, box, type_id, excl,
                             active=None, cheb=None, cheb_mix: bool = False,
                             obs_x=None):
    """Energy/force of the exclusion-list pairs, to subtract from the
    all-pairs sum (``cheb=(kw, ko)`` on a tabulated system, ``cheb_mix``
    and ``obs_x`` for the blend).  Returns (force (N, 3), e_lj, e_tab, w)."""
    return flat_correction(spec, n_types, pos, box, type_id, excl, active,
                           cheb_pair_operands(spec, cheb, cheb_mix, obs_x))


def flat_correction(spec, n_types: int, pos, box, type_id, excl, active,
                    tab):
    """``excluded_pair_correction`` with the Chebyshev operands already
    built (``tab`` from ``cheb_pair_operands``)."""
    i, j = excl[:, 0], excl[:, 1]
    valid = (i >= 0) & (j >= 0)
    ic = torch.clamp(i, min=0).long()
    jc = torch.clamp(j, min=0).long()
    packed = pack_rows(pos, type_id, active)
    d, f_s, e_lj, e_tab, r2s, valid = _pair_eval(
        spec, n_types, packed[ic], packed[jc], box, valid, tab)
    f_over_r = f_s[:, None] * d
    n, m = pos.shape[0], excl.shape[0]
    # One index_put_ with accumulate: it sorts the destinations (stably)
    # and sums each one's terms in a fixed order, the i ends' then the j
    # ends', so every call gives the same bits, on the card too (CUDA's
    # index_add_ adds duplicates atomically, in no fixed order, and would
    # let replicas of the state drift apart).  Each padding end gets a
    # spare row of its own: one shared sentinel row would be a run of
    # thousands of duplicates, which the card sums serially.
    spare = n + torch.arange(2 * m, device=pos.device)
    dest = torch.cat([torch.where(valid, ic, spare[:m]),
                      torch.where(valid, jc, spare[m:])])
    force = torch.zeros((n + 2 * m, 3), dtype=pos.dtype, device=pos.device)
    force.index_put_((dest,), torch.cat([f_over_r, -f_over_r]),
                     accumulate=True)
    w = torch.sum(f_s * r2s)
    return force[:n], torch.sum(e_lj), torch.sum(e_tab), w
