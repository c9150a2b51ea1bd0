"""A plain reaction step: which pairs react, and the topology that
results.

The rules, from the configuration's ``reactions`` block: a pair (a, b),
a the type_1 side, is a candidate of a channel when the types and
chemical states match, the pair is within the channel's cutoff, is not
excluded nor bonded, and the molecule and residue rules allow it.  It is
accepted when the system's counter-based uniform for (seed, step, the
unordered pair, the channel's salt) is below rate * dt * interval.  Each
type_1 particle proposes its accepted candidate with the smallest
uniform; a target takes the smallest proposal it receives.  Each event
then bonds the pair, applies the channel's type and state changes, the
transfers to the particles one and two bonds from either end (in the
order the configuration lists them, the a ends before the b ends),
adds the angles the new bond closes where the types have an angle type,
and excludes the new bond's and angles' end pairs.

The uniform is the system's stated random stream (a 32-bit hash), so a
run's events can be checked one by one.  The geometry of the acceptance
is computed in float32, the precision the configuration states, with
the system's operation order.  NumPy, and plain PyTorch for the distance
search (on the card where the check runs there: one op at a time, so the
same float32 roundings as NumPy's).
"""

from __future__ import annotations

import numpy as np
import torch

from .system import canon_angles, unique_rows

M32 = np.uint64(0xFFFFFFFF)
BIG = np.float32(1e30)
ROWS_PER_BLOCK = 64


def _mul32(x, c: int):
    return (x * np.uint64(c)) & M32


def _mix(x):
    x = _mul32(x ^ (x >> np.uint64(16)), 0x7FEB352D)
    x = _mul32(x ^ (x >> np.uint64(15)), 0x846CA68B)
    return x ^ (x >> np.uint64(16))


def pair_uniform(seed: int, step: int, lo, hi, salt):
    """U[0, 1) keyed by (seed, step, unordered pair lo < hi, salt)."""
    u64 = np.uint64
    lo = np.asarray(lo).astype(np.uint64) & M32
    hi = np.asarray(hi).astype(np.uint64) & M32
    salt = np.asarray(salt).astype(np.uint64) & M32
    h = _mix((lo + u64(0x9E3779B9)) & M32)
    h = _mix(h ^ hi)
    h = _mix(h ^ (u64(step) & M32))
    h = _mix(h ^ salt)
    h = _mix(h ^ (u64(seed) & M32))
    return h.astype(np.float32) * np.float32(2.3283064e-10)


def pair_keys(pairs: np.ndarray, n: int) -> np.ndarray:
    p = np.sort(np.asarray(pairs, dtype=np.int64).reshape(-1, 2), axis=1)
    return p[:, 0] * n + p[:, 1]


def adjacency(bonds: np.ndarray, n: int) -> list:
    adj = [set() for _ in range(n)]
    for i, j in np.asarray(bonds, dtype=np.int64):
        adj[int(i)].add(int(j))
        adj[int(j)].add(int(i))
    return adj


def derived_exclusions(bonds, angles) -> np.ndarray:
    """The exclusions of a topology: every bond's pair and every angle's
    end pair."""
    a = np.asarray(angles, dtype=np.int64).reshape(-1, 3)
    return unique_rows(np.concatenate([
        np.sort(np.asarray(bonds, dtype=np.int64).reshape(-1, 2), axis=1),
        np.sort(a[:, [0, 2]], axis=1)]))


def _candidates(sys_, pos, box, rows, device):
    """(a, b, r2) of every pair with a in ``rows`` and b within the
    largest channel cutoff, r2 in float32 by the system's operation
    order (minimum image by rounding half to even, then x*x + y*y +
    z*z), each operation apart."""
    cut2 = torch.tensor(max(np.float32(c.cutoff2) for c in sys_.channels),
                        device=device)
    p = torch.as_tensor(pos, device=device)
    bx = torch.as_tensor(box, device=device)
    out = []
    for k in range(0, len(rows), ROWS_PER_BLOCK):
        a = torch.as_tensor(rows[k:k + ROWS_PER_BLOCK], device=device)
        d = p[a][:, None, :] - p[None, :, :]
        d = d - bx * torch.round(d / bx)
        r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        ia, jb = torch.nonzero(r2 <= cut2, as_tuple=True)
        out.append(tuple(x.cpu().numpy() for x in (a[ia], jb, r2[ia, jb])))
    if not out:
        e = np.zeros(0, dtype=np.int64)
        return e, e, np.zeros(0, dtype=np.float32)
    return tuple(np.concatenate(x) for x in zip(*out))


def match(sys_, topo, adj, pos, box, step: int, seed: int, device="cpu"):
    """The step's events, as (a, b, channel) rows in the order the system
    applies them (by their uniform); the distances on ``device``."""
    n = len(topo.type_id)
    tid, chem = topo.type_id, topo.chem
    s1 = np.zeros(n, dtype=bool)
    for c in sys_.channels:
        s1 |= (tid == c.t1) & (chem >= c.min1) & (chem < c.max1)
    rows = np.nonzero(s1)[0]
    a, b, r2 = _candidates(sys_, pos, box, rows, device)
    excl_keys = np.sort(pair_keys(derived_exclusions(topo.bonds,
                                                     topo.angles), n))
    keys = pair_keys(np.stack([a, b], axis=1), n)
    at = np.clip(np.searchsorted(excl_keys, keys), 0,
                 max(len(excl_keys) - 1, 0))
    excluded = (excl_keys[at] == keys) if len(excl_keys) else \
        np.zeros(len(keys), dtype=bool)
    bonded = np.array([int(y) in adj[int(x)] for x, y in zip(a, b)],
                      dtype=bool)
    base = (a != b) & ~excluded & ~bonded
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    best_u = np.full(len(a), BIG, dtype=np.float32)
    best_r = np.full(len(a), -1, dtype=np.int64)
    w_dt = np.float32(sys_.dt)
    for r, c in enumerate(sys_.channels):
        m = base & (tid[a] == c.t1) & (tid[b] == c.t2)
        m &= (chem[a] >= c.min1) & (chem[a] < c.max1)
        m &= (chem[b] >= c.min2) & (chem[b] < c.max2)
        m &= r2 <= np.float32(c.cutoff2)
        if not c.intramolecular:
            m &= topo.mol[a] != topo.mol[b]
        if not c.intraresidual:
            m &= topo.res[a] != topo.res[b]
        salt = 4 * r + (0 if c.t1 == c.t2 else np.where(a == lo, 0, 1))
        u = pair_uniform(seed, step, lo, hi, salt)
        w = np.float32(c.rate) * w_dt * np.float32(sys_.interval)
        acc = m & (u < w)
        take = acc & (u < best_u)
        best_u = np.where(take, u, best_u)
        best_r = np.where(take, r, best_r)
    # each type_1 particle's proposal: its accepted pair of least uniform
    prop = {}
    for k in np.nonzero(best_r >= 0)[0]:
        ak = int(a[k])
        if ak not in prop or best_u[k] < prop[ak][0]:
            prop[ak] = (best_u[k], int(b[k]), int(best_r[k]))
    win = {}
    for ak, (u, bk, _) in prop.items():
        win[bk] = min(win.get(bk, BIG), u)
    events = []
    for ak in sorted(prop):
        u, bk, r = prop[ak]
        claimed = win.get(ak, BIG)
        if u == win[bk] and (claimed > u or (claimed == u and ak < bk)):
            events.append((u, ak, bk, r))
    events.sort(key=lambda e: e[0])     # stable: ties keep row order
    return [(ak, bk, r) for _, ak, bk, r in events]


def _levels(adj, end: int, max_level: int) -> list:
    """The particles exactly 1..max_level bonds from ``end``."""
    seen = {end}
    frontier = {end}
    out = []
    for _ in range(max_level):
        nxt = set()
        for p in frontier:
            nxt |= adj[p]
        nxt -= seen
        out.append(nxt)
        seen |= nxt
        frontier = nxt
    return out


def apply(sys_, topo, events, n_active=None):
    """The topology after ``events``: (type_id, chem, mol, bonds, angles,
    excl, counts per channel)."""
    n = len(topo.type_id)
    tid = topo.type_id.copy()
    chem = topo.chem.copy()
    counts = np.zeros(len(sys_.channels), dtype=np.int64)
    for a, b, r in events:
        c = sys_.channels[r]
        chem[a] += c.delta1
        chem[b] += c.delta2
        counts[r] += 1
        if c.new1 >= 0:
            tid[a] = c.new1
        if c.new2 >= 0:
            tid[b] = c.new2
    new_bonds = np.array([sorted((a, b)) for a, b, _ in events],
                         dtype=np.int64).reshape(-1, 2)
    bonds = np.concatenate([topo.bonds, new_bonds])
    adj = adjacency(bonds, n)
    max_level = max([t.level for t in sys_.transfers], default=0)
    for side in (0, 1):
        levels = [_levels(adj, ev[side], max_level) for ev in events]
        for t in sys_.transfers:
            for e in range(len(events)):
                for p in levels[e][t.level - 1]:
                    if tid[p] == t.old:
                        tid[p] = t.new
                        chem[p] = t.state
    new_angles = []
    for a, b, _ in events:
        for x in adj[a] - {b}:
            if (tid[x], tid[a], tid[b]) in sys_.angle_types:
                new_angles.append((x, a, b))
        for y in adj[b] - {a}:
            if (tid[a], tid[b], tid[y]) in sys_.angle_types:
                new_angles.append((a, b, y))
    angles = np.concatenate([topo.angles, canon_angles(
        np.array(new_angles, dtype=np.int64).reshape(-1, 3))])
    mol = components_min(bonds, n)
    return (tid, chem, mol, bonds, angles,
            derived_exclusions(bonds, angles), counts)


def components_min(bonds, n: int) -> np.ndarray:
    """Each particle's molecule, labelled by its smallest index."""
    parent = np.arange(n)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in np.asarray(bonds, dtype=np.int64):
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    return np.array([find(x) for x in range(n)])
