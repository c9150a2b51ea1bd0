"""Topology-manager primitives for the batched reaction-event path.

Port of ``chemlab_tpu/engine/topo.py``: adjacency insert, molecule merge,
term-table and exclusion appends, and the enumeration of the angles and
dihedrals a new bond creates.  The enumerations take whole event vectors
(``a``, ``b`` of shape (E,)) where the reference vmaps a per-event
function; row order inside each event is the reference's.

``mode="drop"`` scatters are written into one extra sentinel row that is
sliced off.  Indices are 0-based rows; -1 is padding.
"""

from __future__ import annotations

import torch

from .state import I32, TermTable


def set_drop(arr, dest, values):
    """``arr.at[dest].set(values, mode="drop")``: ``dest == len(arr)`` writes
    into one extra row that is sliced off.  ``dest`` may have any shape;
    ``values`` broadcasts against it."""
    out = torch.cat([arr, arr[:1]])
    out[dest.long()] = torch.as_tensor(values, device=arr.device).to(arr.dtype)
    return out[:arr.shape[0]]


def adj_add_edge(adj, i, j, enable=True):
    """Insert undirected edge (i, j) (0-d tensors) into the fixed-degree
    adjacency.  Returns (adj, overflow); a no-op when disabled or i/j < 0."""
    deg_cap = adj.shape[1]
    valid = torch.as_tensor(enable, device=adj.device) & (i >= 0) & (j >= 0)

    def insert(adj, a, b):
        row = adj[a]
        free = row < 0
        slot = torch.argmax(free.to(torch.uint8))
        ok = free[slot]
        new_row = row.clone()
        new_row[torch.where(ok, slot, deg_cap - 1)] = torch.where(
            ok, b, row[deg_cap - 1])
        adj = adj.clone()
        adj[a] = torch.where(ok & valid, new_row, row)
        return adj, ~ok & valid

    a = torch.clamp(i, min=0).long()
    b = torch.clamp(j, min=0)
    adj, ov1 = insert(adj, a, b.to(I32))
    adj, ov2 = insert(adj, b.long(), a.to(I32))
    return adj, ov1 | ov2


def merge_molecules(mol_id, i, j, enable=True):
    """Union the components of i and j: relabel max(a,b) -> min(a,b)."""
    valid = torch.as_tensor(enable, device=mol_id.device) & (i >= 0) \
        & (j >= 0)
    a = mol_id[torch.clamp(i, min=0).long()]
    b = mol_id[torch.clamp(j, min=0).long()]
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    return torch.where(valid & (mol_id == hi), lo, mol_id)


def table_append(table: TermTable, cand_idx, cand_func, cand_params,
                 cand_valid, typelookup=None, lam=None, group=None):
    """Append masked candidate rows at the table's cursor.  Returns
    (table, overflow)."""
    cap = table.capacity
    m = cand_idx.shape[0]
    dev = cand_idx.device
    offs = torch.cumsum(cand_valid.to(I32), 0) - 1
    dest = table.count + offs
    overflow = torch.any(cand_valid & (dest >= cap))
    dest = torch.where(cand_valid & (dest < cap), dest, cap).long()
    tl = torch.ones(m, dtype=torch.bool, device=dev) if typelookup is None \
        else typelookup
    lam_v = torch.ones(m, dtype=table.lam.dtype, device=dev) if lam is None \
        else lam
    grp = torch.full((m,), -1, dtype=I32, device=dev) if group is None \
        else group
    new_count = torch.clamp(table.count + cand_valid.to(I32).sum(), max=cap)
    return TermTable(
        idx=set_drop(table.idx, dest, cand_idx),
        func=set_drop(table.func, dest, cand_func),
        params=set_drop(table.params, dest, cand_params),
        typelookup=set_drop(table.typelookup, dest, tl),
        lam=set_drop(table.lam, dest, lam_v),
        group=set_drop(table.group, dest, grp),
        count=new_count.to(I32)), overflow


def enumerate_new_angles(adj, a, b):
    """Triples containing the (already inserted) edges (a[e], b[e]).

    Returns (idx (E, 2*DEG, 3), valid (E, 2*DEG)): (n, a, b) for n in
    adj[a] minus b, then (a, b, m) for m in adj[b] minus a."""
    na = adj[a.long()]
    nb = adj[b.long()]
    deg = adj.shape[1]
    A = a[:, None].expand(-1, deg)
    B = b[:, None].expand(-1, deg)
    v1 = (na >= 0) & (na != B)
    v2 = (nb >= 0) & (nb != A)
    t1 = torch.stack([na, A, B], dim=-1)
    t2 = torch.stack([A, B, nb], dim=-1)
    return torch.cat([t1, t2], dim=1), torch.cat([v1, v2], dim=1)


def enumerate_new_dihedrals(adj, a, b):
    """Quadruples containing the (already inserted) edges (a[e], b[e]):
    families n-a-b-m, o-n-a-b and a-b-m-q.  Returns (idx (E, 3*DEG^2, 4),
    valid (E, 3*DEG^2))."""
    deg = adj.shape[1]
    E = a.shape[0]
    na = adj[a.long()]                       # (E, DEG)
    nb = adj[b.long()]
    A = a[:, None].expand(-1, deg * deg)
    B = b[:, None].expand(-1, deg * deg)
    va = (na >= 0) & (na != b[:, None])
    vb = (nb >= 0) & (nb != a[:, None])

    # family 1: n - a - b - m  (jnp.repeat / jnp.tile order)
    n_ = na.repeat_interleave(deg, dim=1)
    m_ = nb.repeat(1, deg)
    v1 = va.repeat_interleave(deg, dim=1) & vb.repeat(1, deg) & (n_ != m_)
    f1 = torch.stack([n_, A, B, m_], dim=-1)

    # family 2: o - n - a - b  (o in adj[n], n in adj[a] minus b)
    o_ = adj[torch.clamp(na, min=0).long()].reshape(E, -1)
    n2 = na.repeat_interleave(deg, dim=1)
    v2 = va.repeat_interleave(deg, dim=1) & (o_ >= 0) & (o_ != A) & (o_ != B)
    f2 = torch.stack([o_, n2, A, B], dim=-1)

    # family 3: a - b - m - q  (q in adj[m], m in adj[b] minus a)
    q_ = adj[torch.clamp(nb, min=0).long()].reshape(E, -1)
    m3 = nb.repeat_interleave(deg, dim=1)
    v3 = vb.repeat_interleave(deg, dim=1) & (q_ >= 0) & (q_ != B) & (q_ != A)
    f3 = torch.stack([A, B, m3, q_], dim=-1)
    return torch.cat([f1, f2, f3], dim=1), torch.cat([v1, v2, v3], dim=1)


def excl_append(excl, n_excl, pairs, valid):
    """Append masked (M, 2) pairs to the flat exclusion list.  Returns
    (excl, n_excl, overflow)."""
    cap = excl.shape[0]
    offs = torch.cumsum(valid.to(I32), 0) - 1
    dest = n_excl + offs
    overflow = torch.any(valid & (dest >= cap))
    dest = torch.where(valid & (dest < cap), dest, cap).long()
    n_new = torch.clamp(n_excl + valid.to(I32).sum(), max=cap).to(I32)
    return set_drop(excl, dest, pairs), n_new, overflow
