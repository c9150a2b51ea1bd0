"""Dense-static exclusion correction: chain exclusions on rolled planes.

Port of ``chemlab_tpu/engine/excl_dense.py``.  The cell-tile kernel sums
every pair, excluded ones included; the correction subtracts the
exclusion list.  Chain exclusions (b, b+d) for d in a small static offset
set become per-offset mask planes evaluated on rolled copies of the packed
particle plane; the irregular remainder (reaction-created exclusions)
rides the flat correction at a small capacity.  The per-pair math is
``cell_pair._pair_eval``, shared with the flat correction, so both legs
run the kernel's op sequence and the cancellation contract holds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import cell_pair
from .state import I32

__all__ = ["detect_offsets", "derive", "rederive", "correction"]


def detect_offsets(excl_np: np.ndarray, max_offsets: int = 4,
                   min_cover: float = 0.05) -> tuple:
    """Host-side: the offset set covering the build-time exclusion list,
    most frequent first; an offset needs ``min_cover`` of the pairs."""
    e = np.asarray(excl_np)
    valid = (e[:, 0] >= 0) & (e[:, 1] >= 0)
    if not valid.any():
        return ()
    d = np.abs(e[valid, 1] - e[valid, 0])
    offs, counts = np.unique(d, return_counts=True)
    order = np.argsort(-counts)
    picked = []
    for k in order[:max_offsets]:
        if counts[k] >= min_cover * valid.sum() and offs[k] > 0:
            picked.append(int(offs[k]))
    return tuple(sorted(picked))


def derive(excl, n: int, offsets: tuple, irr_cap: int):
    """Split the flat (E, 2) exclusion list into mask planes + remainder.

    Returns (masks (n_offsets, N) bool, irr (irr_cap, 2) int32 -1-padded,
    overflow ())."""
    dev = excl.device
    i, j = excl[:, 0], excl[:, 1]
    valid = (i >= 0) & (j >= 0)
    lo = torch.minimum(i, j)
    d = torch.abs(j - i)
    planes = []
    covered = torch.zeros_like(valid)
    for off in offsets:
        sel = valid & (d == off)
        plane = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        plane[torch.where(sel, lo, n).long()] = True
        planes.append(plane[:n])
        covered |= sel
    masks = (torch.stack(planes) if offsets
             else torch.zeros((0, n), dtype=torch.bool, device=dev))

    sel = valid & ~covered
    dest = torch.cumsum(sel.to(I32), 0) - 1
    overflow = torch.any(sel & (dest >= irr_cap))
    dest = torch.where(sel & (dest < irr_cap), dest, irr_cap).long()
    irr = torch.full((irr_cap + 1, 2), -1, dtype=I32, device=dev)
    irr[dest] = excl
    return masks, irr[:irr_cap], overflow


def rederive(cfg, state, create: bool = False):
    """Refresh the derived exclusion operands from the flat list (no-op for
    a state without them unless ``create``)."""
    if not cfg.excl_offsets or (state.excl_masks is None and not create):
        return state
    n = state.pos.shape[0]
    masks, irr, ovf = derive(state.excl, n, cfg.excl_offsets,
                             cfg.excl_irr_cap)
    nbr = dataclasses.replace(state.nbr, overflow=state.nbr.overflow | ovf)
    return dataclasses.replace(state, excl_masks=masks, excl_irr=irr,
                               nbr=nbr)


def correction(spec, cfg, pos, box, type_id, excl_masks, excl_irr,
               active=None, cheb=None, cheb_mix: bool = False, obs_x=None):
    """Excluded-pair correction via mask planes + rolled packed rows, plus
    the flat correction over the irregular remainder (``cheb``,
    ``cheb_mix`` and ``obs_x`` as in ``cell_pair.excluded_pair_correction``;
    the Chebyshev operands are built once for every leg).  Returns
    (force (N,3), e_lj, e_tab, w) like ``cell_pair.excluded_pair_correction``.
    """
    n_types = cfg.n_types
    tab = cell_pair.cheb_pair_operands(spec, cheb, cheb_mix, obs_x)
    packed = cell_pair.pack_rows(pos, type_id, active)
    force = torch.zeros_like(pos)
    zero = torch.zeros((), dtype=pos.dtype, device=pos.device)
    e_lj, e_tab, w = zero, zero, zero
    for k, off in enumerate(cfg.excl_offsets):
        pj = torch.roll(packed, -off, dims=0)
        d, f_s, el, et, r2s, valid = cell_pair._pair_eval(
            spec, n_types, packed, pj, box, excl_masks[k], tab)
        fv = torch.where(valid[:, None], f_s[:, None] * d, 0.0)
        # base endpoint gains +f, partner (base+off) gains -f: the inverse
        # roll of the same plane
        force = force + fv - torch.roll(fv, off, dims=0)
        e_lj = e_lj + torch.sum(torch.where(valid, el, 0.0))
        e_tab = e_tab + torch.sum(torch.where(valid, et, 0.0))
        w = w + torch.sum(torch.where(valid, f_s * r2s, 0.0))

    f_i, el_i, et_i, w_i = cell_pair.flat_correction(
        spec, n_types, pos, box, type_id, excl_irr, active, tab)
    return force + f_i, e_lj + el_i, e_tab + et_i, w + w_i
