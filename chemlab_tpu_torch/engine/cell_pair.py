"""Cell-tile LJ pair forces (K1) and the excluded-pair correction.

Port of ``chemlab_tpu/engine/pallas_pair.py``: ``cell_pair_forces_colt``
(the wrapper of the TPU kernel ``_colt2_kernel``, LJ mode), ``_pair_eval``
and ``excluded_pair_correction``.

The pair sum runs over every pair on the cell grid, excluded pairs
included; the correction subtracts the exclusion list afterwards.  That
cancels only if both sides run the same f32 op sequence per pair: minimum
image ``d - box * round(d * (1/box))`` (round half to even), ``r2`` summed
x, y, z in that order, the self-pair drop at ``r2 > 1e-12`` (kernel) or the
``1e-12`` floor (correction), and LJ with the 0.75-sigma soft-core clamp.

``colt_cells`` is the kernel's wrapper.  A CPU tensor takes the plain
torch version ``cell_pair_forces_colt_ref``; a CUDA tensor launches the
hand-written kernel in ``csrc/cell_pair.cu`` (built at first use) or
raises.  The operand packing and the ``slot_of`` epilogue stay here as
torch indexing, as they stay outside the kernel in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from .spec import PAIR_LJ

# ch3 channel of the kernel's [fx, fy, fz, ch3] rows
CH3_NONE, CH3_ENERGY, CH3_VIRIAL = 0, 1, 2

K1 = _kernels.CudaKernel(
    "cell_pair.cu", "cell_pair_colt",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


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


def _stencil(dims, device):
    """(C, 27) neighbour cell ids, offsets ordered dx, dy, dz in (-1, 0, 1)
    (the kernel's loop order)."""
    nx, ny, nz = dims
    c = torch.arange(nx * ny * nz, device=device)
    cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
    off = torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                       device=device)
    return ((((cx[:, None] + off[:, 0]) % nx) * ny
             + (cy[:, None] + off[:, 1]) % ny) * nz
            + (cz[:, None] + off[:, 2]) % nz)


def cell_pair_forces_colt_ref(cells, counts, box, params, dims,
                              uniform_lj: bool, all_lj: bool, ch3_mode: int):
    """Plain torch K1: every slot i of a cell against every slot of its 27
    neighbour cells, vectorised over (C, cap, 27*cap).  Returns the kernel's
    (C, cap, 4) [fx, fy, fz, ch3] rows; ``counts`` is unused here (empty
    slots are zero rows, which the validity test drops)."""
    C, cap, _ = cells.shape
    xj = cells[_stencil(dims, cells.device)].reshape(C, 27 * cap, 4)
    xi = cells
    ibox = 1.0 / box
    dr = []
    r2 = None
    for ax in range(3):
        d = xi[:, :, None, ax] - xj[:, None, :, ax]
        d = d - box[ax] * torch.round(d * ibox[ax])
        dr.append(d)
        r2 = d * d if r2 is None else r2 + d * d
    valid = ((xi[:, :, 3] > 0.5)[:, :, None] & (xj[:, :, 3] > 0.5)[:, None, :]
             & (r2 > 1e-12))
    r2s = torch.where(valid, r2, 1.0)
    if uniform_lj:
        sig, eps, cut2, shift = (params[k, 0, 0] for k in range(4))
        in_cut = valid & (r2s < cut2)
    else:
        n_types = params.shape[1]
        ti = torch.clamp(xi[:, :, 3].long() - 1, min=0)
        tj = torch.clamp(xj[:, :, 3].long() - 1, min=0)
        pid = ti[:, :, None] * n_types + tj[:, None, :]
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
    fxyz = [torch.sum(f * d, dim=2) for d in dr]
    if ch3_mode == CH3_ENERGY:
        e = torch.where(in_cut, 4.0 * eps * (s6 * s6 - s6) - shift, 0.0)
        ch3 = 0.5 * torch.sum(e, dim=2)
    elif ch3_mode == CH3_VIRIAL:
        ch3 = 0.5 * torch.sum(f * r2s, dim=2)
    else:
        ch3 = torch.zeros_like(fxyz[0])
    return torch.stack(fxyz + [ch3], dim=-1)


def _check(t, name, dtype, shape=None):
    if t.dtype != dtype:
        raise TypeError("%s: dtype %s, expected %s" % (name, t.dtype, dtype))
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError("%s: shape %s, expected %s"
                         % (name, tuple(t.shape), tuple(shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)


def cell_pair_forces_colt_kernel(cells, counts, box, params, dims,
                                 uniform_lj: bool, all_lj: bool,
                                 ch3_mode: int):
    """Launch the CUDA K1 on the current stream (CUDA tensors only)."""
    nx, ny, nz = (int(d) for d in dims)
    C, cap, _ = cells.shape
    n_types = params.shape[1]
    if C != nx * ny * nz or min(nx, ny, nz) < 3:
        raise ValueError("K1 needs a full 27-cell stencil: dims %s for %d "
                         "cells" % (dims, C))
    if cells.device.type != "cuda":
        raise ValueError("K1's CUDA kernel takes CUDA tensors, not %s"
                         % cells.device)
    if cap > 1024:
        raise ValueError("K1: cell_cap %d exceeds one block" % cap)
    if cap * 16 + 5 * n_types * n_types * 4 > 48 * 1024:
        raise ValueError("K1: shared-memory stage exceeds 48 KiB")
    dev = cells.device
    for t, name in ((counts, "counts"), (box, "box"), (params, "params")):
        if t.device != dev:
            raise ValueError("%s is on %s, cells on %s" % (name, t.device,
                                                          dev))
    _check(cells, "cells", torch.float32, (C, cap, 4))
    _check(counts, "counts", torch.int32, (C,))
    _check(box, "box", torch.float32, (3,))
    _check(params, "params", torch.float32, (5, n_types, n_types))
    if cells.data_ptr() % 16:
        raise ValueError("cells must be 16-byte aligned (float4 rows)")
    out = torch.empty_like(cells)
    stream = torch.cuda.current_stream(dev).cuda_stream
    K1.launch(cells.data_ptr(), counts.data_ptr(), box.data_ptr(),
              params.data_ptr(), out.data_ptr(), nx, ny, nz, cap, n_types,
              int(uniform_lj), int(all_lj), int(ch3_mode), stream)
    return out


def colt_cells(cells, counts, box, params, dims, uniform_lj: bool,
               all_lj: bool, ch3_mode: int):
    """K1 wrapper: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    if cells.device.type == "cuda":
        return cell_pair_forces_colt_kernel(cells, counts, box, params, dims,
                                            uniform_lj, all_lj, ch3_mode)
    if cells.device.type == "cpu":
        return cell_pair_forces_colt_ref(cells, counts, box, params, dims,
                                         uniform_lj, all_lj, ch3_mode)
    raise ValueError("K1 has no version for device %s" % cells.device)


def cell_pair_forces(pos, type_id, active, box, buckets, slot_of, dims, spec,
                     n_types: int, uniform_lj: bool = False,
                     all_lj: bool = False, want_energy: bool = True,
                     want_virial: bool = False):
    """Unexcluded all-pairs LJ on the cell grid (reference:
    ``cell_pair_forces_colt``).  Returns (force (N, 3), e_lj, e_tab, w):
    the spare channel carries either the pair energy (``want_energy``) or
    the pair virial (``want_virial``), never both."""
    n_cells = int(np.prod(dims))
    cap = buckets.shape[1]
    cells, counts = colt_operands(pack_rows(pos, type_id, active), buckets,
                                  n_cells)
    mode = (CH3_VIRIAL if want_virial
            else CH3_ENERGY if want_energy else CH3_NONE)
    out = colt_cells(cells, counts, box.contiguous(),
                     pair_params(spec, n_types), dims, uniform_lj, all_lj,
                     mode)
    out_flat = out.reshape(n_cells * cap, 4)
    in_grid = slot_of < n_cells * cap
    rows_f = out_flat[torch.where(in_grid, slot_of, 0).long()]
    force = torch.where(in_grid[:, None], rows_f[:, :3], 0.0)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    s3 = torch.sum(out_flat[:, 3])
    if want_virial:
        return force, zero, zero, s3
    return force, s3, zero, zero


def _pair_eval(spec, n_types: int, pi, pj, box, valid):
    """Per-pair correction terms for packed endpoint rows of any leading
    shape.  Returns (d, f_scalar, e_lj, r2s, valid) elementwise, in exactly
    the kernel's op sequence (the cancellation contract)."""
    valid = valid & (pi[..., 3] > 0.5) & (pj[..., 3] > 0.5)
    d = pi[..., :3] - pj[..., :3]
    d = d - box * torch.round(d * (1.0 / box))
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    r2s = torch.where(valid, torch.clamp(r2, min=1e-12), 1.0)
    ti = torch.clamp(pi[..., 3].long() - 1, min=0)
    tj = torch.clamp(pj[..., 3].long() - 1, min=0)
    pid = ti * n_types + tj
    in_cut = valid & (r2s < spec.pair_cutoff2[pid])
    sig = spec.pair_sig[pid]
    eps = spec.pair_eps[pid]
    r2c = torch.maximum(r2s, 0.5625 * (sig * sig))
    inv_r2c = 1.0 / r2c
    s2 = (sig * sig) * inv_r2c
    s6 = s2 * s2 * s2
    lj_m = in_cut & (spec.pair_kind[pid] == PAIR_LJ)
    e_lj = torch.where(lj_m, 4.0 * eps * (s6 * s6 - s6) - spec.pair_shift[pid],
                       0.0)
    f_lj = torch.where(lj_m, 48.0 * eps * (s6 * s6 - 0.5 * s6) * inv_r2c, 0.0)
    return d, f_lj, e_lj, r2s, valid


def excluded_pair_correction(spec, n_types: int, pos, box, type_id, excl,
                             active=None):
    """Energy/force of the exclusion-list pairs, to subtract from the
    all-pairs sum.  Returns (force (N, 3), e_lj, e_tab, w)."""
    i, j = excl[:, 0], excl[:, 1]
    valid = (i >= 0) & (j >= 0)
    ic = torch.clamp(i, min=0).long()
    jc = torch.clamp(j, min=0).long()
    packed = pack_rows(pos, type_id, active)
    d, f_s, e_lj, r2s, valid = _pair_eval(spec, n_types, packed[ic],
                                          packed[jc], box, valid)
    f_over_r = f_s[:, None] * d
    n = pos.shape[0]
    force = torch.zeros((n + 1, 3), dtype=pos.dtype, device=pos.device)
    force.index_add_(0, torch.where(valid, ic, n), f_over_r)
    force.index_add_(0, torch.where(valid, jc, n), -f_over_r)
    w = torch.sum(f_s * r2s)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    return force[:n], torch.sum(e_lj), zero, w
