"""Topology-manager primitives of the reactive layer.

Port of ``chemlab_tpu/engine/topo.py``: adjacency insert and removal,
molecule merge and the connected-components relabel, term-table and
exclusion appends and removals, the bounded BFS, and the enumeration of
the angles and dihedrals a new bond creates.  The enumerations take whole event vectors
(``a``, ``b`` of shape (E,)) where the reference vmaps a per-event
function; row order inside each event is the reference's.

``mode="drop"`` scatters are written into one extra sentinel row that is
sliced off.  Indices are 0-based rows; -1 is padding.
"""

from __future__ import annotations

import dataclasses

import torch

from .state import I32, TermTable


def set_drop(arr, dest, values):
    """``arr.at[dest].set(values, mode="drop")``: ``dest == len(arr)`` writes
    into one extra row that is sliced off.  ``dest`` may have any shape;
    ``values`` broadcasts against it.  The kept rows of ``dest`` must be
    distinct: on the card an indexed assignment that repeats a row keeps
    an unspecified one of its writes (``set_last`` takes repeats)."""
    out = torch.cat([arr, arr[:1]])
    out[dest.long()] = torch.as_tensor(values, device=arr.device).to(arr.dtype)
    return out[:arr.shape[0]]


def set_last(arr, dest, values):
    """``set_drop`` where ``dest`` may repeat a row: the last write in
    ``dest``'s flat order wins, as in a sequential scatter, and the
    earlier ones go to the sentinel row, so no two writes race for a kept
    row and every device (and every replica of a mesh) keeps the same
    one."""
    n = arr.shape[0]
    d = dest.reshape(-1).long()
    vals = torch.as_tensor(values, device=arr.device).to(arr.dtype)
    vals = vals.broadcast_to(tuple(dest.shape) + tuple(arr.shape[1:]))
    order = torch.argsort(d, stable=True)
    later = torch.zeros_like(d, dtype=torch.bool)
    later[order[:-1]] = d[order[1:]] == d[order[:-1]]
    out = torch.cat([arr, arr[:1]])
    out[torch.where(later, n, d)] = vals.reshape((-1,) + tuple(arr.shape[1:]))
    return out[:n]


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


# ---------------------------------------------------------------------------
# removal primitives (bond breaking, the sequential event scan, freezing)
# ---------------------------------------------------------------------------

def adj_remove_edges(adj, edges, valid):
    """Remove the undirected edge of each row of ``edges`` (E, 2) where
    ``valid`` and both ends are >= 0, a no-op where absent: the reference's
    ``adj_remove_edge`` over the rows in order, in one scatter per side.  A
    removal only writes -1, so no row changes what another row matches, and
    rows may share endpoints or repeat."""
    n, deg = adj.shape
    valid = valid & (edges[:, 0] >= 0) & (edges[:, 1] >= 0)
    flat = torch.cat([adj.reshape(-1), adj.new_full((1,), -1)])
    slot = torch.arange(deg, device=adj.device)
    for x, y in ((edges[:, 0], edges[:, 1]), (edges[:, 1], edges[:, 0])):
        xl = torch.clamp(x, min=0).long()
        hit = (adj[xl] == y[:, None]) & valid[:, None]
        flat[torch.where(hit, xl[:, None] * deg + slot, n * deg)] = -1
    return flat[:n * deg].reshape(n, deg)


def relabel_components(adj, active):
    """Connected components by min-label propagation with pointer jumping
    (the reference's ``while_loop``): one host read of the convergence
    flag per iteration, O(log N) iterations.  Labels are particle rows,
    equal to the reference's.  ``active`` is unused, as in the
    reference."""
    n = adj.shape[0]
    label = torch.arange(n, dtype=I32, device=adj.device)
    has = adj >= 0
    nbr_idx = torch.clamp(adj, min=0).long()
    while True:
        nbr = torch.where(has, label[nbr_idx], n)
        new = torch.minimum(label, torch.amin(nbr, dim=1).to(I32))
        new = torch.minimum(new, new[new.long()])      # pointer jumping
        if not bool(torch.any(new != label)):
            return new
        label = new


def invalidate_terms_with_edges(table: TermTable, edges, edge_valid):
    """Invalidate rows whose consecutive-index pairs include any valid row
    of ``edges`` (E, 2), in either order.  Returns (table, hit)."""
    idx = table.idx
    elo = torch.minimum(edges[:, 0], edges[:, 1])[None, :]
    ehi = torch.maximum(edges[:, 0], edges[:, 1])[None, :]
    hit = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
    for k in range(idx.shape[1] - 1):
        a, b = idx[:, k], idx[:, k + 1]
        lo = torch.minimum(a, b)[:, None]
        hi = torch.maximum(a, b)[:, None]
        hit |= torch.any((lo == elo) & (hi == ehi) & edge_valid[None, :],
                         dim=1)
    hit &= table.valid
    return dataclasses.replace(
        table, idx=torch.where(hit[:, None], -1, idx)), hit


def excl_remove(excl, pairs, valid):
    """Remove exclusion pairs (unordered match); leaves -1 holes and does
    not lower the cursor."""
    lo = torch.minimum(excl[:, 0], excl[:, 1])[:, None]
    hi = torch.maximum(excl[:, 0], excl[:, 1])[:, None]
    plo = torch.minimum(pairs[:, 0], pairs[:, 1])[None, :]
    phi = torch.maximum(pairs[:, 0], pairs[:, 1])[None, :]
    hit = torch.any((lo == plo) & (hi == phi) & valid[None, :], dim=1)
    hit &= excl[:, 0] >= 0
    return torch.where(hit[:, None], -1, excl)


def bfs_distances(adj, source, max_level: int):
    """Hop distance from ``source`` (0-d) up to ``max_level``, else
    ``max_level + 1``; the bounded relaxation of the reference."""
    n = adj.shape[0]
    big = max_level + 1
    dist = torch.full((n,), big, dtype=I32, device=adj.device)
    dist[torch.clamp(source, min=0).long()] = torch.where(
        source >= 0, 0, big).to(I32)
    has = adj >= 0
    nbr_idx = torch.clamp(adj, min=0).long()
    for _ in range(max_level):
        nbr_dist = torch.where(has, dist[nbr_idx], big)
        dist = torch.minimum(dist, torch.amin(nbr_dist, dim=1) + 1).to(I32)
    return dist
