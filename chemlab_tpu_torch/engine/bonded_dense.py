"""Dense-static bonded operands: chain terms on rolled planes.

Port of ``chemlab_tpu/engine/bonded_dense.py``.  From the canonical
TermTables (the source of truth) it derives a DENSE table whose row b owns
the term with endpoints (b, b+1, ..., b+A-1), evaluated on ``torch.roll``
copies of the particle plane (no gather forward, no scatter in the
backward pass), plus a compacted IRREGULAR remainder for every other
term.  Derivation runs at build and at the end of every reaction
interval, the only places the term tables change.
"""

from __future__ import annotations

import dataclasses

import torch

from .state import I32, TermTable
from .topo import set_drop

__all__ = ["derive_aligned", "roll_rows", "rederive"]


def roll_rows(pos4, arity: int):
    """(N, arity, 4) endpoint rows: endpoint k is the plane rolled up by k."""
    return torch.stack([torch.roll(pos4, -k, dims=0) for k in range(arity)],
                       dim=1)


def _put(shape, fill, dtype, dest, values, dev):
    """``full(shape, fill).at[dest].set(values, mode="drop")``."""
    return set_drop(torch.full(shape, fill, dtype=dtype, device=dev), dest,
                    values)


def _scatter_columns(table: TermTable, sel, base, n: int, arity: int):
    """Dense TermTable: the selected rows' columns at slot = base."""
    dev = table.idx.device
    dest = torch.where(sel, base, n).long()
    idx = torch.full((n + 1, arity), -1, dtype=I32, device=dev)
    for k in range(arity):
        idx[dest, k] = (base + k).to(I32)
    P = table.params.shape[1]
    return TermTable(
        idx=idx[:n],
        func=_put((n,), 0, I32, dest, table.func, dev),
        params=_put((n, P), 0.0, table.params.dtype, dest, table.params, dev),
        typelookup=_put((n,), False, torch.bool, dest, table.typelookup, dev),
        lam=_put((n,), 1.0, table.lam.dtype, dest, table.lam, dev),
        group=_put((n,), -1, I32, dest, table.group, dev),
        count=torch.tensor(n, dtype=I32, device=dev))


def _compact(table: TermTable, sel, irr_cap: int):
    """Compact the selected rows into an ``irr_cap``-row TermTable."""
    dev = table.idx.device
    dest = torch.cumsum(sel.to(I32), 0) - 1
    overflow = torch.any(sel & (dest >= irr_cap))
    dest = torch.where(sel & (dest < irr_cap), dest, irr_cap).long()
    arity = table.idx.shape[1]
    P = table.params.shape[1]
    out = TermTable(
        idx=_put((irr_cap, arity), -1, I32, dest, table.idx, dev),
        func=_put((irr_cap,), 0, I32, dest, table.func, dev),
        params=_put((irr_cap, P), 0.0, table.params.dtype, dest,
                    table.params, dev),
        typelookup=_put((irr_cap,), False, torch.bool, dest,
                        table.typelookup, dev),
        lam=_put((irr_cap,), 1.0, table.lam.dtype, dest, table.lam, dev),
        group=_put((irr_cap,), -1, I32, dest, table.group, dev),
        count=torch.clamp(sel.to(I32).sum(), max=irr_cap).to(I32))
    return out, overflow


def derive_aligned(table: TermTable, n: int, irr_cap: int):
    """Split a canonical TermTable into (dense, irregular, overflow).

    Aligned rows: bonds (b, b+1) in either order, angles exactly
    (b, b+1, b+2) in stored order.  The lowest row id wins a contested base
    slot; losers stay irregular."""
    arity = table.idx.shape[1]
    dev = table.idx.device
    valid = table.idx[:, 0] >= 0
    if arity == 2:
        i, j = table.idx[:, 0], table.idx[:, 1]
        base = torch.minimum(i, j)
        aligned = valid & (torch.maximum(i, j) == base + 1)
    else:
        base = table.idx[:, 0]
        aligned = valid
        for k in range(1, arity):
            aligned = aligned & (table.idx[:, k] == base + k)
    aligned = aligned & (base >= 0) & (base + arity - 1 < n)

    rows = torch.arange(table.capacity, dtype=I32, device=dev)
    claim = torch.full((n + 1,), torch.iinfo(torch.int32).max, dtype=I32,
                       device=dev)
    claim = claim.scatter_reduce(0, torch.where(aligned, base, n).long(),
                                 rows, reduce="amin")
    claimed = aligned & (claim[torch.clamp(base, 0, n - 1).long()] == rows)

    dense = _scatter_columns(table, claimed, base, n, arity)
    irr, overflow = _compact(table, valid & ~claimed, irr_cap)
    return dense, irr, overflow


def rederive(cfg, state):
    """Refresh the dense/irregular operands from the canonical tables; an
    irregular-capacity overflow folds into the sticky flag."""
    if not cfg.bonded_dense:
        return state
    n = state.pos.shape[0]
    bdn, bir, o1 = derive_aligned(state.bonds, n, cfg.bond_irr_cap)
    adn, air, o2 = derive_aligned(state.angles, n, cfg.angle_irr_cap)
    nbr = dataclasses.replace(state.nbr,
                              overflow=state.nbr.overflow | o1 | o2)
    return dataclasses.replace(state, bonds_dense=bdn, bonds_irr=bir,
                               angles_dense=adn, angles_irr=air, nbr=nbr)
