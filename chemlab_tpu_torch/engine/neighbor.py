"""Cell binning and the build-time Verlet rows.

Port of ``chemlab_tpu/engine/neighbor.py``: ``build_cell_buckets`` (the
sort-based binning and its ``slot_of`` inverse), ``refresh_buckets``,
``needs_rebuild``, ``build_exclusion_rows`` and ``build_neighbor_state``
(the K-nearest rows: the row path's persistent Verlet rows, with the
func-14 birth step of each pair; the lazy-row force path reads only the
buckets).  ``choose_cell_grid`` and ``neighbor_cell_offsets`` are
numpy and are copied, because the reference module imports jax at its top.

Every sort is ``stable=True``: ``jnp.argsort`` is stable and bucket order
(hence ``buckets`` and ``slot_of``) depends on it.  ``mode="drop"``
scatters write into one extra sentinel slot that is sliced off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import I32, NeighborState


def choose_cell_grid(box: np.ndarray, rc_skin: float, margin: float = 1.02):
    """Static cell-grid dims: cell edge >= rc_skin * margin."""
    return tuple(max(1, int(np.floor(b / (rc_skin * margin)))) for b in box)


def neighbor_cell_offsets(dims):
    """Static, deduplicated 27-stencil offsets (periodic wrap on small grids
    makes offsets coincide)."""
    seen = set()
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                key = (dx % dims[0], dy % dims[1], dz % dims[2])
                if key not in seen:
                    seen.add(key)
                    out.append(key)
    return np.asarray(out, dtype=np.int32)


def _rank_in_run(sorted_keys):
    """Rank of each element within its run of equal (sorted) keys."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, dtype=torch.int64, device=sorted_keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - run_start


def build_cell_buckets(pos, box, active, dims, cell_cap: int):
    """Scatter particles into (n_cells+1, cell_cap) index buckets (-1 padded).

    Inactive particles land in the trailing junk bin; real-bin overflow sets
    the returned flag.  Also returns ``slot_of`` (N,) int32, each particle's
    flat slot ``cid * cell_cap + rank`` (``n_cells * cell_cap`` when
    inactive or dropped), the exact inverse of ``buckets``."""
    dev = pos.device
    n_cells = int(np.prod(dims))
    dims_t = torch.tensor(dims, dtype=I32, device=dev)
    frac = pos / box
    ci = torch.minimum(torch.clamp((frac * dims_t).to(I32), min=0),
                       dims_t - 1)
    cid = (ci[:, 0] * dims[1] + ci[:, 1]) * dims[2] + ci[:, 2]
    cid = torch.where(active, cid, n_cells).long()

    order = torch.argsort(cid, stable=True)
    sorted_cid = cid[order]
    rank = _rank_in_run(sorted_cid)
    overflow = torch.any((rank >= cell_cap) & (sorted_cid < n_cells))
    # flat bucket index; out-of-capacity entries go to one sentinel slot
    sentinel = (n_cells + 1) * cell_cap
    flat = torch.where(rank < cell_cap, sorted_cid * cell_cap + rank, sentinel)
    buckets = torch.full((sentinel + 1,), -1, dtype=I32, device=dev)
    buckets[flat] = order.to(I32)
    buckets = buckets[:sentinel].reshape(n_cells + 1, cell_cap)
    flat_slot = torch.where((sorted_cid < n_cells) & (rank < cell_cap),
                            sorted_cid * cell_cap + rank,
                            n_cells * cell_cap).to(I32)
    slot_of = torch.empty(pos.shape[0], dtype=I32, device=dev)
    slot_of[order] = flat_slot
    return buckets, ci, overflow, slot_of


def build_exclusion_rows(excl_pairs, n_pad: int, excl_cap: int):
    """Flat exclusion pairs -> per-particle rows (N, EXCL_CAP), -1 padded."""
    dev = excl_pairs.device
    rows = torch.cat([excl_pairs[:, 0], excl_pairs[:, 1]]).long()
    vals = torch.cat([excl_pairs[:, 1], excl_pairs[:, 0]])
    rows = torch.where(rows >= 0, rows, n_pad)            # junk row
    order = torch.argsort(rows, stable=True)
    rows_s = rows[order]
    vals_s = vals[order]
    rank = _rank_in_run(rows_s)
    overflow = torch.any((rank >= excl_cap) & (rows_s < n_pad))
    sentinel = (n_pad + 1) * excl_cap
    flat = torch.where(rank < excl_cap, rows_s * excl_cap + rank, sentinel)
    out = torch.full((sentinel + 1,), -1, dtype=I32, device=dev)
    out[flat] = vals_s.to(I32)
    return out[:n_pad * excl_cap].reshape(n_pad, excl_cap), overflow


# slot pairs of the (N, K, K_old) birth match made at once: a 64 MiB bool
# plane and a 256 MiB int32 one
BIRTH_CHUNK_SLOTS = 1 << 26


def inherit_births(nbr, prev_idx, prev_birth, now):
    """Each slot's birth step: the minimum of the previous rows' births of
    the same pair where the pair was in the previous rows, else ``now``.
    The (N, K, K_old) match is made a block of rows at a time."""
    birth = torch.empty(nbr.shape, dtype=I32, device=nbr.device)
    rows = max(1, BIRTH_CHUNK_SLOTS // max(1, nbr.shape[1]
                                            * prev_idx.shape[1]))
    big = torch.iinfo(torch.int32).max
    for lo in range(0, nbr.shape[0], rows):
        cur = nbr[lo:lo + rows]
        match = cur[:, :, None] == prev_idx[lo:lo + rows, None, :]
        had = torch.any(match, dim=-1)
        old = torch.amin(torch.where(match, prev_birth[lo:lo + rows, None, :],
                                     big), dim=-1)
        birth[lo:lo + rows] = torch.where(had, old, now)
    return birth


def build_neighbor_state(pos, box, active, excl_pairs, rc_skin, *, dims,
                         cell_cap: int, max_neighbors: int, excl_cap: int,
                         track_birth: bool = False, prev=None,
                         step=None) -> NeighborState:
    """A fresh NeighborState: buckets plus the K nearest in-range (< rc_skin)
    active candidates of each particle (unused slots point at the particle
    itself) and the per-slot exclusion mask.

    With ``track_birth`` (ParticlePairScaling, nonbonded func 14) each slot
    carries the step its pair entered the rows: a pair found in
    ``prev.idx`` keeps its earliest birth there, a new pair starts at
    ``step`` (0 when None)."""
    dev = pos.device
    n_pad = pos.shape[0]
    n_cells = int(np.prod(dims))
    buckets, ci, overflow, slot_of = build_cell_buckets(pos, box, active,
                                                        dims, cell_cap)
    offsets = torch.from_numpy(neighbor_cell_offsets(dims)).to(dev)
    dims_t = torch.tensor(dims, dtype=I32, device=dev)
    nc = torch.remainder(ci[:, None, :] + offsets[None, :, :], dims_t)
    ncid = ((nc[..., 0] * dims[1] + nc[..., 1]) * dims[2] + nc[..., 2]).long()

    # one packed [x, y, z, id+1] plane, gathered cell-block-wise
    pid1 = (torch.arange(n_pad, dtype=I32, device=dev) + 1).to(pos.dtype)
    plane4 = torch.zeros(((n_cells + 1) * cell_cap, 4), dtype=pos.dtype,
                         device=dev)
    plane4[slot_of.long()] = torch.cat([pos, pid1[:, None]], dim=-1)
    g = plane4.reshape(n_cells + 1, cell_cap * 4)[ncid].reshape(n_pad, -1)
    d2 = torch.zeros((n_pad, g.shape[1] // 4), dtype=pos.dtype, device=dev)
    for ax in range(3):
        d = g[:, ax::4] - pos[:, ax][:, None]
        d = d - box[ax] * torch.round(d / box[ax])
        d2 = d2 + d * d
    cand = g[:, 3::4].to(I32) - 1
    cand_safe = torch.clamp(cand, min=0)

    self_idx = torch.arange(n_pad, dtype=I32, device=dev)
    if isinstance(rc_skin, torch.Tensor):
        rc2 = rc_skin.to(pos.dtype) * rc_skin.to(pos.dtype)
    else:
        # a Python cutoff squares in double and rounds once to f32, as a
        # weakly typed scalar does in the reference
        rc2 = torch.tensor(float(rc_skin) ** 2, dtype=pos.dtype, device=dev)
    valid = (cand >= 0) & (cand != self_idx[:, None]) & (d2 < rc2)
    valid &= active[:, None]

    # nearest-K: a stable ascending sort equals jax.lax.top_k on -d2
    # (ties keep the lower candidate slot first)
    key = torch.where(valid, d2, torch.inf)
    sel = torch.argsort(key, dim=1, stable=True)[:, :max_neighbors]
    nbr = torch.gather(cand_safe, 1, sel)
    ok = torch.gather(valid, 1, sel)
    nbr = torch.where(ok, nbr, self_idx[:, None])
    nbr_overflow = torch.max(valid.sum(dim=1)) > max_neighbors

    excl_rows, excl_overflow = build_exclusion_rows(excl_pairs, n_pad,
                                                    excl_cap)
    excl_mask = torch.any(nbr[:, None, :] == excl_rows[:, :, None], dim=1)
    if track_birth:
        now = torch.as_tensor(0 if step is None else step, dtype=I32,
                              device=dev)
        if prev is None:
            birth = now.expand(nbr.shape).clone()
        else:
            birth = inherit_births(nbr, prev.idx, prev.birth, now)
    else:
        birth = torch.zeros((1, 1), dtype=I32, device=dev)
    return NeighborState(
        idx=nbr, excl_mask=excl_mask, ref_pos=pos, buckets=buckets,
        slot_of=slot_of, birth=birth,
        overflow=overflow | nbr_overflow | excl_overflow,
        n_rebuilds=torch.ones((), dtype=I32, device=dev))


def refresh_buckets(nbr: NeighborState, pos, box, active, *, dims,
                    cell_cap: int) -> NeighborState:
    """Re-bin particles into cell buckets without rebuilding rows; resets
    ``ref_pos`` (the Verlet guarantee of the lazy-row force path)."""
    buckets, _, overflow, slot_of = build_cell_buckets(pos, box, active,
                                                       dims, cell_cap)
    return dataclasses.replace(
        nbr, buckets=buckets, slot_of=slot_of, ref_pos=pos,
        overflow=nbr.overflow | overflow, n_rebuilds=nbr.n_rebuilds + 1)


def needs_rebuild(pos, nbr: NeighborState, box, skin):
    """Verlet criterion: any displacement since rebuild exceeds skin/2
    (a 0-d bool tensor; the caller decides where to read it)."""
    dr = pos - nbr.ref_pos
    dr = dr - box * torch.round(dr / box)
    d2 = torch.sum(dr * dr, dim=-1)
    return torch.max(d2) > (0.5 * skin) ** 2
