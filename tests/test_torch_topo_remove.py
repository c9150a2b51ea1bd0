"""The topology removal primitives against the reference, exactly.

``adj_remove_edges`` (against the reference's ``adj_remove_edge``, one
row and a loop of rows), ``relabel_components``,
``invalidate_terms_with_edges``, ``excl_remove`` and ``bfs_distances`` of
``chemlab_tpu_torch/engine/topo.py`` run on random adjacency tables,
term tables and exclusion lists (numpy, from a seed) beside the
reference's ``chemlab_tpu/engine/topo.py``; every output is integer and
must be equal element for element.  ``relabel_components`` runs its
convergence loop on the host, the reference as a ``while_loop``: the
labels must still be the same rows.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import state as rstate
from chemlab_tpu.engine import topo as rtopo
from chemlab_tpu_torch.engine import topo as ptopo
from chemlab_tpu_torch.engine.state import TermTable

N, DEG = 200, 6


def _random_adj(rng, n_edges: int, n: int = N, deg: int = DEG):
    """A symmetric fixed-degree adjacency with ``n_edges`` random edges
    (rows padded with -1, holes left in the middle of rows too)."""
    adj = np.full((n, deg), -1, np.int32)
    edges = set()
    while len(edges) < n_edges:
        i, j = rng.randint(0, n, 2)
        if i == j or (min(i, j), max(i, j)) in edges:
            continue
        fi = np.where(adj[i] < 0)[0]
        fj = np.where(adj[j] < 0)[0]
        if not len(fi) or not len(fj):
            continue
        adj[i, rng.choice(fi)] = j
        adj[j, rng.choice(fj)] = i
        edges.add((min(i, j), max(i, j)))
    return adj, sorted(edges)


@pytest.mark.parametrize("seed,n_edges", [(0, 60), (1, 190), (2, 400)])
def test_relabel_components_equal(seed, n_edges):
    rng = np.random.RandomState(seed)
    adj, _ = _random_adj(rng, n_edges)
    active = rng.uniform(size=N) < 0.9
    ref = np.asarray(rtopo.relabel_components(jnp.asarray(adj),
                                              jnp.asarray(active)))
    got = ptopo.relabel_components(torch.from_numpy(adj),
                                   torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, ref)
    # a partition into components: every edge's ends share a label
    i, k = np.nonzero(adj >= 0)
    assert np.all(got[i] == got[adj[i, k]])


def test_adj_edges_and_bfs_equal():
    rng = np.random.RandomState(3)
    adj, edges = _random_adj(rng, 300)
    a_r, a_p = jnp.asarray(adj), torch.from_numpy(adj)
    for level in (1, 3, 5):
        for src in (0, 17, -1):
            ref = rtopo.bfs_distances(a_r, jnp.asarray(src, jnp.int32), level)
            got = ptopo.bfs_distances(a_p, torch.tensor(src, dtype=torch.int32),
                                      level)
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pairs = [edges[0], edges[5], (3, 4), (7, 7), (-1, 2), (150, 199)]
    for i, j in pairs:
        ti, tj = torch.tensor(i, dtype=torch.int32), torch.tensor(
            j, dtype=torch.int32)
        ri, rj = jnp.asarray(i, jnp.int32), jnp.asarray(j, jnp.int32)
        for en in (True, False):
            got = ptopo.adj_remove_edges(a_p, torch.stack([ti, tj])[None],
                                         torch.tensor([en]))
            ref = rtopo.adj_remove_edge(a_r, ri, rj, jnp.asarray(en))
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the ordered loop over edge rows (rows share endpoints)
    rows = np.asarray([edges[0], edges[1], (edges[0][1], edges[0][0]),
                       edges[9], (-1, -1)], np.int32)
    valid = np.asarray([True, True, True, False, True])
    ref = a_r
    for k in range(len(rows)):
        ref = rtopo.adj_remove_edge(ref, rows[k, 0], rows[k, 1], valid[k])
    got = ptopo.adj_remove_edges(a_p, torch.from_numpy(rows),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _random_table(rng, cap, arity, n_valid, edges):
    """Rows built along ``edges`` chains (so that some hold removed edges),
    the rest random, then padding."""
    idx = np.full((cap, arity), -1, np.int32)
    for r in range(n_valid):
        if r % 2 == 0:
            a, b = edges[rng.randint(len(edges))]
            row = [a, b] + list(rng.randint(0, N, arity - 2))
            if rng.uniform() < 0.5:
                row = row[::-1]
        else:
            row = list(rng.randint(0, N, arity))
        idx[r] = row
    return idx


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_invalidate_terms_with_edges_equal(arity):
    rng = np.random.RandomState(10 + arity)
    _, edges = _random_adj(rng, 150)
    cap = 256
    idx = _random_table(rng, cap, arity, 200, edges)
    n_rm = 12
    rm = np.asarray([edges[k] for k in rng.choice(len(edges), n_rm, False)],
                    np.int32)
    rm[::3] = rm[::3, ::-1]
    valid = rng.uniform(size=n_rm) < 0.75
    params = rng.normal(size=(cap, 6)).astype(np.float32)
    common = dict(func=np.ones(cap, np.int32), params=params,
                  typelookup=np.zeros(cap, bool), lam=np.ones(cap, np.float32),
                  group=np.full(cap, -1, np.int32))
    r_tab = rstate.TermTable(idx=jnp.asarray(idx), count=jnp.asarray(
        200, jnp.int32), **{k: jnp.asarray(v) for k, v in common.items()})
    p_tab = TermTable(idx=torch.from_numpy(idx), count=torch.tensor(
        200, dtype=torch.int32),
        **{k: torch.from_numpy(v) for k, v in common.items()})
    r_out, r_hit = rtopo.invalidate_terms_with_edges(
        r_tab, jnp.asarray(rm), jnp.asarray(valid))
    p_out, p_hit = ptopo.invalidate_terms_with_edges(
        p_tab, torch.from_numpy(rm), torch.from_numpy(valid))
    np.testing.assert_array_equal(p_hit.numpy(), np.asarray(r_hit))
    np.testing.assert_array_equal(p_out.idx.numpy(), np.asarray(r_out.idx))
    assert p_hit.any() and not p_hit.all()
    for f in dataclasses.fields(p_out):
        if f.name != "idx":
            assert torch.equal(getattr(p_out, f.name), getattr(p_tab, f.name))


def test_excl_remove_equal():
    rng = np.random.RandomState(7)
    _, edges = _random_adj(rng, 400)
    excl = np.full((384, 2), -1, np.int32)
    pick = rng.choice(len(edges), 300, False)
    excl[:300] = np.asarray([edges[k] for k in pick], np.int32)
    excl[:300:4] = excl[:300:4, ::-1]
    excl[40:50] = -1        # holes of earlier removals
    pairs = np.concatenate([excl[rng.choice(300, 20, False)],
                            rng.randint(0, N, (10, 2)),
                            np.full((2, 2), -1)]).astype(np.int32)
    pairs[::2] = pairs[::2, ::-1]
    valid = rng.uniform(size=len(pairs)) < 0.8
    ref = rtopo.excl_remove(jnp.asarray(excl), jnp.asarray(pairs),
                            jnp.asarray(valid))
    got = ptopo.excl_remove(torch.from_numpy(excl), torch.from_numpy(pairs),
                            torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got[:, 0] < 0).sum() > (excl[:, 0] < 0).sum()
