"""The reactive layer: matching, event application and the periodic
extensions.

Port of ``chemlab_tpu/engine/reactions.py``.  ``reaction_step`` matches
in one of two ways, each on the lazy-row path or on the row path's
persistent Verlet rows:

- compact (``cfg.rx_compact``, the type_1 side is a minority): candidates
  for the particles that can be the type_1 side of a channel
  (``side1_mask``) on the reaction cell grid
  (``compact_candidates_from_cells``) or from their persistent rows
  (``compact_candidates_from_rows``), conflicts resolved by deterministic
  scatter-min (``match_reactions_compact``);
- full-row (the type_1 side spans the bulk, as in step-growth chemistry):
  fresh neighbour rows on the reaction grid
  (``neighbor.build_neighbor_state`` at ``cfg.rx_rc``) or the persistent
  rows, both directions of every channel tested for every slot
  (``_channel_accept``) and conflicts resolved by mutual argmin
  (``match_reactions``).

On the row path the persistent rows stay geometrically valid through a
reaction step; only their exclusion mask is refreshed, and only when an
event fired (one host read).

Both accept with the pair-symmetric integer hash (``pair_uniform``,
bit-exact with the reference) and the RestrictReaction whitelist.  The
events apply in one batch (``_apply_events_batched``,
ChangeNeighboursProperty included) or, with RemoveNeighboursBonds or
FixDistances (ReleaseMolecule, JoinMolecule), one at a time
(``_apply_events_sequential``).  Dissociation channels break bonds after
the events (``match_dissociations``, ``apply_dissociation_events``).  The
periodic extensions ``atrp_step``, ``change_particle_type_step`` and
``freeze_region_step`` take their draws as arguments or from a
``torch.Generator``.

uint32 hashing runs in int64 with ``& 0xFFFFFFFF`` and a 16-bit split
multiply (no signed overflow); every sort is ``stable=True``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import neighbor, perf, topo
from .state import I32

F32 = torch.float32
_M32 = 0xFFFFFFFF
_BIG = 1e30


# ---------------------------------------------------------------------------
# counter-based uniform hash (pair-symmetric)
# ---------------------------------------------------------------------------

def _u32(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def _mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(x):
    """splitmix-style 32-bit finalizer (the reference's ``_mix``)."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def pair_uniform(seed, step, lo, hi, salt):
    """U[0,1) keyed by (seed, step, unordered pair, salt); bit-equal to the
    reference's uint32 arithmetic."""
    dev = lo.device if isinstance(lo, torch.Tensor) else None
    h = _mix((_u32(lo, dev) + 0x9E3779B9) & _M32)
    h = _mix(h ^ _u32(hi, dev))
    h = _mix(h ^ _u32(step, dev))
    h = _mix(h ^ _u32(salt, dev))
    h = _mix(h ^ _u32(seed, dev))
    return h.to(F32) * torch.tensor(2.3283064e-10, dtype=F32, device=h.device)


def _gauss_from_uniform(u1, u2):
    """Box-Muller (single branch) for the Gaussian reaction cutoff."""
    r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-12)))
    return r * torch.cos(2.0 * torch.pi * u2)


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _norm2(d):
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


# ---------------------------------------------------------------------------
# acceptance (both paths) and full-row matching
# ---------------------------------------------------------------------------

def _accept(spec, cfg, state, seed, a, b, r2, slot_valid, r: int,
            asym_salt):
    """Acceptance of channel ``r`` with ``a`` the type_1 side and ``b`` the
    type_2 side.  The draws are keyed by the unordered pair, so both rows
    of a pair agree bit for bit; ``asym_salt`` (0 or 1 by direction) salts
    the acceptance draw of an asymmetric channel only, so a symmetric
    channel draws one number per pair.  Returns (accepted, draw)."""
    lo = torch.minimum(a, b)
    hi = torch.maximum(a, b)
    al, bl = a.long(), b.long()
    ta = state.type_id[al]
    tb = state.type_id[bl]
    sa = state.chem_state[al]
    sb = state.chem_state[bl]

    m = slot_valid
    m = m & (ta == spec.r_t1[r]) & (tb == spec.r_t2[r])
    m = m & (sa >= spec.r_min1[r]) & (sa < spec.r_max1[r])
    m = m & (sb >= spec.r_min2[r]) & (sb < spec.r_max2[r])
    m = m & state.reaction_active[r] & ~spec.r_is_diss[r]

    symmetric = spec.r_t1[r] == spec.r_t2[r]
    dir_salt = torch.where(symmetric, 0, asym_salt)
    u1 = pair_uniform(seed, state.step, lo, hi, 4 * r + 2)
    u2 = pair_uniform(seed, state.step, lo, hi, 4 * r + 3)
    gcut = spec.r_eq[r] + spec.r_sigma[r] * _gauss_from_uniform(u1, u2)
    cut2 = torch.where(spec.r_sigma[r] > 0.0,
                       torch.where(gcut > 0.0, gcut * gcut, -1.0),
                       spec.r_cutoff2[r])
    m = m & (r2 <= cut2) & (r2 >= spec.r_min_cutoff2[r])

    m = m & (spec.r_intramolecular[r] | (state.mol_id[al] != state.mol_id[bl]))
    m = m & (spec.r_intraresidual[r] | (state.res_id[al] != state.res_id[bl]))
    adj_a = state.adj[al]
    m = m & ~torch.any(adj_a == b[..., None], dim=-1)

    # RestrictReaction whitelist: binary search on lo, then a bounded scan
    # over the equal-lo run (the bound is the build's longest run)
    if spec.restrict_lo.shape[0]:
        mm = spec.restrict_lo.shape[0]
        pos_ = torch.searchsorted(spec.restrict_lo, lo.contiguous())
        listed = torch.zeros_like(m)
        for k in range(cfg.restrict_scan):
            pk = torch.clamp(pos_ + k, max=mm - 1)
            listed = listed | ((spec.restrict_lo[pk] == lo)
                               & (spec.restrict_hi[pk] == hi))
        m = m & (listed | ~spec.r_restricted[r])

    cnb = spec.r_cnb_type[r]
    nbr = torch.clamp(adj_a, min=0).long()
    nbr_t = state.type_id[nbr]
    nbr_s = state.chem_state[nbr]
    has_cnb = torch.any((adj_a >= 0) & (nbr_t == cnb)
                        & (nbr_s >= spec.r_cnb_min[r])
                        & (nbr_s < spec.r_cnb_max[r]), dim=-1)
    m = m & ((cnb < 0) | has_cnb)

    w = state.reaction_rates[r] * spec.dt * cfg.reaction_interval
    u = pair_uniform(seed, state.step, lo, hi, 4 * r + dir_salt)
    return m & (u < w), u


def _channel_accept(spec, cfg, state, seed, i_idx, j, r2, slot_valid, r: int,
                    t1_is_lo: bool):
    """Directed acceptance of channel ``r`` for neighbour slots:
    ``t1_is_lo`` tests the pair's lower index as the type_1 side."""
    lo = torch.minimum(i_idx, j)
    hi = torch.maximum(i_idx, j)
    a, b = (lo, hi) if t1_is_lo else (hi, lo)
    return _accept(spec, cfg, state, seed, a, b, r2, slot_valid, r,
                   0 if t1_is_lo else 1)


def match_reactions(spec, cfg, state, seed, nbr_idx, excl_mask):
    """Fired events from full neighbour rows ``nbr_idx`` (N, K) with their
    exclusion mask: each particle's best accepted slot over both
    directions of every channel, matched mutually (each particle in at most
    one event), then the first ``max_events`` by key.  Returns (ev_valid,
    ev_a, ev_b, ev_r, ev_dist), ``a`` the type_1 side."""
    n = state.pos.shape[0]
    dev = state.pos.device
    i_idx = torch.arange(n, dtype=I32, device=dev)[:, None]
    j = nbr_idx
    jl = j.long()
    dr = _min_image(state.pos[:, None, :] - state.pos[jl], state.box)
    r2 = _norm2(dr)
    # excluded pairs are not candidates: the reference's Verlet list is
    # built with the exclusion list
    slot_valid = (j != i_idx) & state.active[:, None] & state.active[jl] \
        & ~excl_mask

    big = torch.tensor(_BIG, dtype=F32, device=dev)
    R = cfg.n_reactions
    acc = [_channel_accept(spec, cfg, state, seed, i_idx, j, r2, slot_valid,
                           r, d) for d in (True, False) for r in range(R)]
    m_cat = torch.stack([m for m, _ in acc])              # (2R, N, K)
    u_cat = torch.where(m_cat, torch.stack([u for _, u in acc]), big)
    pick = torch.argmin(u_cat, dim=0)
    best_u = torch.gather(u_cat, 0, pick[None])[0]
    best_r = torch.where(best_u < big, pick % R, -1).to(I32)
    best_dir = pick < R

    accepted = best_r >= 0
    key = torch.where(accepted, r2 if cfg.nearest_mode else best_u, big)

    slot = torch.argmin(key, dim=1)
    row = torch.arange(n, device=dev)
    partner = torch.where(accepted[row, slot], j[row, slot], -1)
    pp = torch.where(partner >= 0, partner[torch.clamp(partner, min=0).long()],
                     -2)
    fire = (partner >= 0) & (pp == row) & (row < partner)

    my_key = key[row, slot]
    my_r = best_r[row, slot]
    my_dir = best_dir[row, slot]

    order = torch.argsort(torch.where(fire, my_key, big), stable=True)
    take = order[:cfg.max_events]
    ev_valid = fire[take]
    if cfg.max_per_interval > 0:
        ev_valid = ev_valid & (torch.arange(take.shape[0], device=dev)
                               < cfg.max_per_interval)
    tp = partner[take]
    lo = torch.minimum(take, tp)
    hi = torch.maximum(take, tp)
    ev_a = torch.where(ev_valid, torch.where(my_dir[take], lo, hi), -1)
    ev_b = torch.where(ev_valid, torch.where(my_dir[take], hi, lo), -1)
    ev_r = torch.where(ev_valid, my_r[take], -1)
    dp = _min_image(state.pos[torch.clamp(ev_a, min=0)]
                    - state.pos[torch.clamp(ev_b, min=0)], state.box)
    ev_dist = torch.where(ev_valid, torch.sqrt(_norm2(dp)), -1.0)
    return ev_valid, ev_a.to(I32), ev_b.to(I32), ev_r.to(I32), ev_dist


# ---------------------------------------------------------------------------
# compact candidate matching
# ---------------------------------------------------------------------------

def side1_mask(spec, cfg, state):
    """Particles that can be the type_1 side of any active normal channel."""
    m = torch.zeros_like(state.active)
    for r in range(cfg.n_reactions):
        ok = state.reaction_active[r] & ~spec.r_is_diss[r]
        m |= ok & (state.type_id == spec.r_t1[r]) \
            & (state.chem_state >= spec.r_min1[r]) \
            & (state.chem_state < spec.r_max1[r])
    return m & state.active


def match_reactions_compact(spec, cfg, state, seed, rowsel, row_ok, cand,
                            excl_hit):
    """Fired events from compacted candidate rows: each S1 row proposes its
    best accepted candidate; proposals resolve by scatter-min over both
    endpoints with an index tie-break.  Returns (ev_valid, ev_a, ev_b, ev_r,
    ev_dist), ``a`` the type_1 side."""
    n = state.pos.shape[0]
    dev = state.pos.device
    a = rowsel[:, None]
    j = torch.clamp(cand, min=0)
    jl = j.long()
    dr = _min_image(state.pos[a[:, 0].long()][:, None, :] - state.pos[jl],
                    state.box)
    r2 = _norm2(dr)
    slot_valid = (cand >= 0) & (j != a) & row_ok[:, None] \
        & state.active[jl] & ~excl_hit

    big = torch.tensor(_BIG, dtype=F32, device=dev)
    # ``a`` (R, 1) is the type_1 side of every candidate
    asym_salt = torch.where(a == torch.minimum(a, j), 0, 1)
    ms, us = zip(*(_accept(spec, cfg, state, seed, a, j, r2, slot_valid, r,
                           asym_salt)
                   for r in range(cfg.n_reactions)))
    u_cat = torch.where(torch.stack(ms), torch.stack(us), big)
    pick = torch.argmin(u_cat, dim=0)
    best_u = torch.gather(u_cat, 0, pick[None])[0]
    accepted = best_u < big
    best_r = torch.where(accepted, pick, -1).to(I32)
    key = torch.where(accepted, r2 if cfg.nearest_mode else best_u, big)

    slot = torch.argmin(key, dim=1)
    rr = torch.arange(rowsel.shape[0], device=dev)
    prop_key = key[rr, slot]
    prop_b = torch.where(prop_key < big, j[rr, slot], -1)
    prop_r = best_r[rr, slot]
    has_prop = prop_b >= 0

    win = torch.full((n + 1,), _BIG, dtype=F32, device=dev).scatter_reduce(
        0, torch.where(has_prop, prop_b, n).long(), prop_key, reduce="amin")
    wins_b = has_prop & (prop_key == win[torch.clamp(prop_b, min=0).long()])
    claimed = win[rowsel.long()]
    fire = wins_b & ((claimed > prop_key)
                     | ((claimed == prop_key) & (rowsel < prop_b)))

    order = torch.argsort(torch.where(fire, prop_key, big), stable=True)
    take = order[:cfg.max_events]
    ev_valid = fire[take]
    if cfg.max_per_interval > 0:
        ev_valid = ev_valid & (torch.arange(take.shape[0], device=dev)
                               < cfg.max_per_interval)
    ev_a = torch.where(ev_valid, rowsel[take], -1).to(I32)
    ev_b = torch.where(ev_valid, prop_b[take], -1).to(I32)
    ev_r = torch.where(ev_valid, prop_r[take], -1).to(I32)
    dp = _min_image(state.pos[torch.clamp(ev_a, min=0).long()]
                    - state.pos[torch.clamp(ev_b, min=0).long()], state.box)
    ev_dist = torch.where(ev_valid, torch.sqrt(_norm2(dp)), -1.0)
    return ev_valid, ev_a, ev_b, ev_r, ev_dist


def compact_candidates_from_rows(state, rowsel):
    """Candidate tile for the compact match from the persistent rows: the
    R rows (their self-padding slots as -1) and their exclusion mask."""
    rs = rowsel.long()
    cand = state.nbr.idx[rs]
    return (torch.where(cand == rowsel[:, None], -1, cand),
            state.nbr.excl_mask[rs])


def compact_candidates_from_cells(spec, cfg, state, rowsel):
    """Candidate tile for the compact match on the reaction cell grid:
    buckets over all actives, stencil gather for the R rows.  Returns
    (cand (R, S*cap), excl_hit, overflow)."""
    dims = cfg.rx_dims
    dev = state.pos.device
    buckets, ci, b_ovf, _ = neighbor.build_cell_buckets(
        state.pos, state.box, state.active, dims, cfg.rx_cell_cap)
    offsets = torch.from_numpy(neighbor.neighbor_cell_offsets(dims)).to(dev)
    dims_t = torch.tensor(dims, dtype=I32, device=dev)
    R = rowsel.shape[0]
    nc = torch.remainder(ci[rowsel.long()][:, None, :] + offsets[None], dims_t)
    ncid = ((nc[..., 0] * dims[1] + nc[..., 1]) * dims[2] + nc[..., 2]).long()
    cand = buckets[ncid].reshape(R, -1)
    excl_rows, e_ovf = neighbor.build_exclusion_rows(
        state.excl, state.pos.shape[0], cfg.excl_cap)
    er = excl_rows[rowsel.long()]
    excl_hit = torch.any(cand[:, None, :] == er[:, :, None], dim=1)
    return cand, excl_hit, b_ovf | e_ovf


# ---------------------------------------------------------------------------
# event application
# ---------------------------------------------------------------------------

def _add(arr, dest, values):
    """``arr.at[dest].add(values, mode="drop")``, ``dest == len(arr)``
    dropped."""
    out = torch.cat([arr, torch.zeros_like(arr[:1])])
    out.index_add_(0, dest.long(), values.to(arr.dtype))
    return out[:arr.shape[0]]


def _ppnb_batched(spec, cfg, st, ev_valid, rr, ac, bc):
    """ChangeNeighboursProperty over all events at once: exact BFS level
    sets per event as frontier expansions; overlaps between events resolve
    in event order, the later event's write kept (``topo.set_last``; the
    reference's own event order is arbitrary)."""
    E = ev_valid.shape[0]
    n = st.pos.shape[0]
    deg = st.adj.shape[1]
    tid, chem, mass, q = st.type_id, st.chem_state, st.mass, st.q
    for s_code, ends in ((0, ac), (1, bc)):
        seen = ends[:, None]
        seen_v = ev_valid[:, None]
        frontier, frontier_v = seen, seen_v
        level_sets = []
        for _ in range(cfg.max_nb_level):
            cand = st.adj[torch.clamp(frontier, min=0).long()].reshape(E, -1)
            cv = frontier_v.repeat_interleave(deg, dim=1) & (cand >= 0)
            # invalid frontier padding is clamped to particle 0; its
            # neighbours sit in `seen` with a False bit and must not
            # suppress genuine candidates
            cv = cv & ~torch.any((cand[:, :, None] == seen[:, None, :])
                                 & seen_v[:, None, :], dim=2)
            level_sets.append((cand, cv))
            seen = torch.cat([seen, cand], dim=1)
            seen_v = torch.cat([seen_v, cv], dim=1)
            frontier, frontier_v = cand, cv
        for p in range(cfg.max_ppnb):
            owner = ev_valid & (spec.ppnb_reaction[p] == rr) \
                & ((spec.ppnb_side[p] == s_code) | (spec.ppnb_side[p] == 2))
            for lev, (cand, cv) in enumerate(level_sets, start=1):
                cl = cand.long()
                m = cv & owner[:, None] & (spec.ppnb_level[p] == lev) \
                    & (tid[cl] == spec.ppnb_old_type[p]) \
                    & (chem[cl] >= spec.ppnb_min_state[p]) \
                    & (chem[cl] < spec.ppnb_max_state[p]) & st.active[cl]
                sel = torch.where(m, cand, n)
                nt = spec.ppnb_new_type[p]
                ns = spec.ppnb_new_state[p]
                newc = torch.where(ns >= 0, ns,
                                   chem[cl] + spec.ppnb_incr_state[p])
                # two events' level sets may share a particle: the later
                # event's write wins on every device
                tid = topo.set_last(tid, sel, nt)
                mass = topo.set_last(mass, sel, spec.type_mass[nt.long()])
                q = topo.set_last(q, sel, spec.type_q[nt.long()])
                chem = topo.set_last(chem, sel, newc)
    return dataclasses.replace(st, type_id=tid, chem_state=chem, mass=mass,
                               q=q)


def _apply_events_batched(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r):
    """Vectorised event application (no per-event scan), valid when no
    sequential-semantics extension is active: mutual matching makes the new
    edges vertex-disjoint.  A dihedral spanning two new bonds joined by an
    old edge is enumerated by both owning events; the copy owned by the
    event with the smaller min endpoint is kept."""
    dev = state.pos.device
    rr = torch.clamp(ev_r, min=0).long()
    ac = torch.clamp(ev_a, min=0)
    bc = torch.clamp(ev_b, min=0)
    n = state.pos.shape[0]
    E = ev_valid.shape[0]
    grp = torch.clamp(spec.r_group[rr], min=0)
    gl = grp.long()
    make_bond = ev_valid & ~spec.r_virtual[rr]
    new_lam = torch.where(spec.hybrid_bond_rate > 0.0, 0.0, 1.0)

    bonds, ov1 = topo.table_append(
        state.bonds, torch.stack([ac, bc], dim=1), spec.g_func[gl],
        spec.g_params[gl], make_bond,
        typelookup=torch.zeros(E, dtype=torch.bool, device=dev),
        lam=new_lam.to(state.bonds.lam.dtype).expand(E), group=grp)

    # adjacency: rows are distinct across events, one scatter per side
    adj = state.adj
    ov2 = torch.zeros((), dtype=torch.bool, device=dev)
    for x, y in ((ac, bc), (bc, ac)):
        rows = adj[x.long()]
        free = rows < 0
        slot = torch.argmax(free.to(torch.uint8), dim=1)
        ok = torch.gather(free, 1, slot[:, None])[:, 0] & make_bond
        ov2 = ov2 | torch.any(make_bond & ~ok)
        ext = torch.cat([adj, adj[:1]])
        ext[torch.where(ok, x, n).long(), slot] = torch.where(ok, y, -1)
        adj = ext[:n]

    # molecule union: sequential relabel, in event order
    mol = state.mol_id
    with perf.span(perf.RX_MERGE):
        for k in range(E):
            mol = topo.merge_molecules(mol, ev_a[k], ev_b[k], make_bond[k])
    state = dataclasses.replace(state, bonds=bonds, adj=adj, mol_id=mol)

    # neighbour property transfers BEFORE term generation
    if cfg.max_ppnb > 0:
        state = _ppnb_batched(spec, cfg, state, ev_valid, rr, ac, bc)

    # term generation against the final adjacency
    partner = torch.full((n + 1,), -2, dtype=I32, device=dev)
    partner[torch.where(make_bond, ac, n).long()] = bc
    partner[torch.where(make_bond, bc, n).long()] = ac

    ang_idx, ang_v = topo.enumerate_new_angles(state.adj, ac, bc)
    ang_v = (ang_v & make_bond[:, None]).reshape(-1)
    ang_idx = ang_idx.reshape(-1, 3)
    t = state.type_id[torch.clamp(ang_idx, min=0).long()].long()
    funcs = spec.angle_func_tt[t[:, 0], t[:, 1], t[:, 2]]
    pars = spec.angle_par_tt[t[:, 0], t[:, 1], t[:, 2]]
    ang_ok = ang_v & (funcs > 0)
    ang_lam = torch.where(spec.hybrid_angle_rate > 0, 0.0, 1.0).to(
        state.angles.lam.dtype).expand(ang_idx.shape[0])
    angles, ov3 = topo.table_append(state.angles, ang_idx, funcs, pars,
                                    ang_ok, lam=ang_lam)

    dih_idx, dih_v = topo.enumerate_new_dihedrals(state.adj, ac, bc)
    dih_v = dih_v & make_bond[:, None]
    deg2 = state.adj.shape[1] ** 2
    ev_min = torch.minimum(ac, bc)[:, None]
    o2 = dih_idx[:, deg2:2 * deg2, 0]
    n2 = dih_idx[:, deg2:2 * deg2, 1]
    dup2 = (partner[torch.clamp(n2, 0, n).long()] == o2) \
        & (ev_min > torch.minimum(o2, n2))
    m3 = dih_idx[:, 2 * deg2:, 2]
    q3 = dih_idx[:, 2 * deg2:, 3]
    dup3 = (partner[torch.clamp(m3, 0, n).long()] == q3) \
        & (ev_min > torch.minimum(m3, q3))
    dih_v = torch.cat([dih_v[:, :deg2], dih_v[:, deg2:2 * deg2] & ~dup2,
                       dih_v[:, 2 * deg2:] & ~dup3], dim=1)
    dih_idx = dih_idx.reshape(-1, 4)
    dih_v = dih_v.reshape(-1)
    if state.dihedrals.capacity > 1:
        td = state.type_id[torch.clamp(dih_idx, min=0).long()].long()
        dfuncs = spec.dih_func_tt[td[:, 0], td[:, 1], td[:, 2], td[:, 3]]
        dpars = spec.dih_par_tt[td[:, 0], td[:, 1], td[:, 2], td[:, 3]]
        dih_ok = dih_v & (dfuncs > 0)
        dih_lam = torch.where(spec.hybrid_dihedral_rate > 0, 0.0, 1.0).to(
            state.dihedrals.lam.dtype).expand(dih_idx.shape[0])
        dihedrals, ov4 = topo.table_append(state.dihedrals, dih_idx, dfuncs,
                                           dpars, dih_ok, lam=dih_lam)
    else:
        dihedrals = state.dihedrals
        ov4 = torch.zeros((), dtype=torch.bool, device=dev)
        dih_ok = torch.zeros_like(dih_v)

    excl, n_excl = state.excl, state.n_excl
    ov5 = torch.zeros((), dtype=torch.bool, device=dev)
    if cfg.exclude_new_bonds:
        pairs = torch.cat([torch.stack([ac, bc], dim=1), ang_idx[:, [0, 2]],
                           dih_idx[:, [0, 3]]])
        pv = torch.cat([make_bond, ang_ok, dih_ok])
        excl, n_excl, ov5 = topo.excl_append(excl, n_excl, pairs, pv)

    state = dataclasses.replace(state, angles=angles, dihedrals=dihedrals,
                                excl=excl, n_excl=n_excl)
    return state, ov1 | ov2 | ov3 | ov4 | ov5


def _generate_terms_for_bond(spec, state, a, b, enable, add_excl: bool):
    """The topology manager's answer to one new bond (a, b) (0-d): the
    angles and dihedrals it closes, by type signature, and their
    exclusions.  Returns (state, overflow)."""
    ac = torch.clamp(a, min=0)[None]
    bc = torch.clamp(b, min=0)[None]
    dev = state.pos.device
    ang_idx, ang_v = topo.enumerate_new_angles(state.adj, ac, bc)
    ang_idx, ang_v = ang_idx[0], ang_v[0] & enable
    t = state.type_id[torch.clamp(ang_idx, min=0).long()].long()
    funcs = spec.angle_func_tt[t[:, 0], t[:, 1], t[:, 2]]
    pars = spec.angle_par_tt[t[:, 0], t[:, 1], t[:, 2]]
    ang_v = ang_v & (funcs > 0)
    ang_lam = torch.where(spec.hybrid_angle_rate > 0, 0.0, 1.0).to(
        state.angles.lam.dtype).expand(ang_idx.shape[0])
    angles, ov1 = topo.table_append(state.angles, ang_idx, funcs, pars,
                                    ang_v, lam=ang_lam)

    dih_idx, dih_v = topo.enumerate_new_dihedrals(state.adj, ac, bc)
    dih_idx, dih_v = dih_idx[0], dih_v[0] & enable
    if state.dihedrals.capacity > 1:
        td = state.type_id[torch.clamp(dih_idx, min=0).long()].long()
        dfuncs = spec.dih_func_tt[td[:, 0], td[:, 1], td[:, 2], td[:, 3]]
        dpars = spec.dih_par_tt[td[:, 0], td[:, 1], td[:, 2], td[:, 3]]
        dih_v = dih_v & (dfuncs > 0)
        dih_lam = torch.where(spec.hybrid_dihedral_rate > 0, 0.0, 1.0).to(
            state.dihedrals.lam.dtype).expand(dih_idx.shape[0])
        dihedrals, ov2 = topo.table_append(state.dihedrals, dih_idx, dfuncs,
                                           dpars, dih_v, lam=dih_lam)
    else:
        dihedrals = state.dihedrals
        ov2 = torch.zeros((), dtype=torch.bool, device=dev)
        dih_v = torch.zeros_like(dih_v)

    excl, n_excl = state.excl, state.n_excl
    ov3 = torch.zeros((), dtype=torch.bool, device=dev)
    if add_excl:
        pairs = torch.cat([torch.stack([ac, bc], dim=1), ang_idx[:, [0, 2]],
                           dih_idx[:, [0, 3]]])
        pv = torch.cat([torch.as_tensor(enable, device=dev).reshape(1),
                        ang_v, dih_v])
        excl, n_excl, ov3 = topo.excl_append(excl, n_excl, pairs, pv)
    return dataclasses.replace(state, angles=angles, dihedrals=dihedrals,
                               excl=excl, n_excl=n_excl), ov1 | ov2 | ov3


def _first_rows(mask, k: int):
    """The first ``k`` row ids of a stable sort putting ``mask`` first
    (the reference's ``argsort(~mask)[:k]``)."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)[:k]


def _remove_terms_of_edges(state, edges, edge_valid, cap_a: int,
                           cap_d: int):
    """Invalidate the angles and dihedrals that hold any valid row of
    ``edges``, and remove the exclusions of the edges and of those terms'
    end pairs; the term hits are compacted to their first ``cap_a`` and
    ``cap_d`` rows before the exclusion sweep.  Returns (angles,
    dihedrals, excl)."""
    angles, hit_a = topo.invalidate_terms_with_edges(state.angles, edges,
                                                     edge_valid)
    dihedrals, hit_d = topo.invalidate_terms_with_edges(state.dihedrals,
                                                        edges, edge_valid)
    excl = topo.excl_remove(state.excl, edges, edge_valid)
    ha = _first_rows(hit_a, cap_a)
    excl = topo.excl_remove(excl, state.angles.idx[ha][:, [0, 2]], hit_a[ha])
    if state.dihedrals.capacity > 1:
        hd = _first_rows(hit_d, cap_d)
        excl = topo.excl_remove(excl, state.dihedrals.idx[hd][:, [0, 3]],
                                hit_d[hd])
    return angles, dihedrals, excl


MAX_RM = 8   # bonds one RemoveNeighboursBonds side may remove per event


def _apply_ppnb(spec, cfg, st, valid, a, b, r):
    """ChangeNeighboursProperty around one event: BFS type transfers."""
    dist_a = topo.bfs_distances(st.adj, torch.where(valid, a, -1),
                                cfg.max_nb_level)
    dist_b = topo.bfs_distances(st.adj, torch.where(valid, b, -1),
                                cfg.max_nb_level)
    tid, chem, mass, q = st.type_id, st.chem_state, st.mass, st.q
    for p in range(cfg.max_ppnb):
        owner = spec.ppnb_reaction[p] == r
        side = spec.ppnb_side[p]
        nt = spec.ppnb_new_type[p]
        ns = spec.ppnb_new_state[p]
        for s_code, dist in ((0, dist_a), (1, dist_b)):
            use = valid & owner & ((side == s_code) | (side == 2))
            m = use & (dist == spec.ppnb_level[p]) \
                & (tid == spec.ppnb_old_type[p]) \
                & (chem >= spec.ppnb_min_state[p]) \
                & (chem < spec.ppnb_max_state[p]) & st.active
            tid = torch.where(m, nt, tid)
            mass = torch.where(m, spec.type_mass[nt.long()], mass)
            q = torch.where(m, spec.type_q[nt.long()], q)
            chem = torch.where(
                m, torch.where(ns >= 0, ns, chem + spec.ppnb_incr_state[p]),
                chem)
    return dataclasses.replace(st, type_id=tid, chem_state=chem, mass=mass,
                               q=q)


def _fd_def_of(spec, cfg, type_id, fixd_dummy):
    """Each constraint row's FixDistances definition, by its dummy's
    type."""
    t_dummy = type_id[torch.clamp(fixd_dummy, min=0).long()]
    def_idx = torch.zeros_like(fixd_dummy)
    for k in range(cfg.n_fd):
        def_idx = torch.where(t_dummy == spec.fd_dummy_type[k], k, def_idx)
    return def_idx.long()


def _release_constraints(spec, cfg, st, p, count, enable):
    """PostProcessReleaseParticles: free up to ``count`` dummies of host
    ``p``; each takes its definition's target type and release lambda."""
    mask = enable & (st.fixd_host == p) & (st.fixd_host >= 0)
    rank = torch.cumsum(mask.to(I32), 0) - 1
    rel = mask & (rank < count)
    n = st.pos.shape[0]
    dsel = torch.where(rel, torch.clamp(st.fixd_dummy, min=0), n)
    def_idx = _fd_def_of(spec, cfg, st.type_id, st.fixd_dummy)
    return dataclasses.replace(
        st,
        type_id=topo.set_drop(st.type_id, dsel, torch.clamp(
            spec.fd_target_type[def_idx], min=0)),
        lam=topo.set_drop(st.lam, dsel, spec.fd_release_lam[def_idx]),
        fixd_host=torch.where(rel, -1, st.fixd_host),
        fixd_dummy=torch.where(rel, -1, st.fixd_dummy))


def _remove_neighbour_bonds(spec, cfg, st, valid, anchor, r, s_code: int):
    """PostProcessRemoveNeighbourBond: break the (t1, t2) bonds whose
    nearer endpoint lies ``level`` hops from the anchor, with their
    dependent angles, dihedrals, exclusions and adjacency edges.  At most
    ``MAX_RM`` bonds are removed with their dependents; more raise the
    sticky overflow flag.  Returns (state, overflow)."""
    dist = topo.bfs_distances(st.adj, torch.where(valid, anchor, -1),
                              cfg.max_nb_level + 1)
    bi = torch.clamp(st.bonds.idx[:, 0], min=0).long()
    bj = torch.clamp(st.bonds.idx[:, 1], min=0).long()
    ti, tj = st.type_id[bi], st.type_id[bj]
    anchor_t = st.type_id[torch.clamp(anchor, min=0).long()]
    dmin = torch.minimum(dist[bi], dist[bj])
    hit = torch.zeros(st.bonds.capacity, dtype=torch.bool, device=bi.device)
    for p in range(cfg.n_rb):
        owner = valid & (spec.rb_reaction[p] == r) \
            & (anchor_t == spec.rb_anchor_type[p]) \
            & ((spec.rb_side[p] == s_code) | (spec.rb_side[p] == 2))
        tmatch = ((ti == spec.rb_t1[p]) & (tj == spec.rb_t2[p])) \
            | ((ti == spec.rb_t2[p]) & (tj == spec.rb_t1[p]))
        hit = hit | (owner & st.bonds.valid & tmatch
                     & (dmin == spec.rb_level[p]))
    rm_overflow = hit.sum() > MAX_RM
    order = _first_rows(hit, MAX_RM)
    rm_valid = hit[order]
    edges = torch.where(rm_valid[:, None], st.bonds.idx[order], -1)
    bonds = dataclasses.replace(
        st.bonds, idx=torch.where(hit[:, None], -1, st.bonds.idx))
    angles, dihedrals, excl = _remove_terms_of_edges(
        st, edges, rm_valid, 4 * MAX_RM, 8 * MAX_RM)
    adj = topo.adj_remove_edges(st.adj, edges, rm_valid)
    return dataclasses.replace(st, bonds=bonds, angles=angles,
                               dihedrals=dihedrals, excl=excl,
                               adj=adj), rm_overflow


def _join(spec, st, valid, a, b, r):
    """JoinMolecule: capture the type_2 particle ``b`` as an invisible
    dummy constrained to the type_1 host ``a``.  Every write is gated on a
    free constraint slot.  Returns (state, overflow: no free slot)."""
    jdef = spec.r_join_def[torch.clamp(r, min=0).long()]
    jsel = torch.clamp(jdef, min=0).long()
    do_join = valid & (jdef >= 0)
    n = st.pos.shape[0]
    cap = st.fixd_host.shape[0]
    free = torch.argmax((st.fixd_host < 0).to(torch.uint8))
    slot_ok = do_join & (st.fixd_host[free] < 0)
    bsel = torch.where(slot_ok, torch.clamp(b, min=0), n)
    fsel = torch.where(slot_ok, free, cap)
    return dataclasses.replace(
        st,
        type_id=topo.set_drop(st.type_id, bsel, torch.clamp(
            spec.fd_dummy_type[jsel], min=0)),
        lam=topo.set_drop(st.lam, bsel, spec.fd_capture_lam[jsel]),
        chem_state=topo.set_drop(st.chem_state, bsel,
                                 spec.fd_capture_state[jsel]),
        fixd_host=topo.set_drop(st.fixd_host, fsel, torch.clamp(a, min=0)),
        fixd_dummy=topo.set_drop(st.fixd_dummy, fsel,
                                 torch.clamp(b, min=0))), do_join & ~slot_ok


def _apply_event(spec, cfg, st, valid, a, b, r):
    """One event of the sequential scan (0-d ``valid``, ``a``, ``b``,
    ``r``): the bond, ChangeNeighboursProperty, the releases,
    RemoveNeighboursBonds on each side, the JoinMolecule capture, then the
    angles, dihedrals and exclusions the bond closes.  Every write is gated
    on ``valid``.  Returns (state, overflow)."""
    dev = st.pos.device
    new_lam = torch.where(spec.hybrid_bond_rate > 0.0, 0.0, 1.0).to(
        st.bonds.lam.dtype).reshape(1)
    rc = torch.clamp(r, min=0).long()
    grp = torch.clamp(spec.r_group[rc], min=0)
    make_bond = valid & ~spec.r_virtual[rc]
    bonds, ov1 = topo.table_append(
        st.bonds, torch.stack([a, b])[None], spec.g_func[grp.long()][None],
        spec.g_params[grp.long()][None], make_bond[None],
        typelookup=torch.zeros(1, dtype=torch.bool, device=dev),
        lam=new_lam, group=grp[None])
    adj, ov2 = topo.adj_add_edge(st.adj, a, b, make_bond)
    mol = topo.merge_molecules(st.mol_id, a, b, make_bond)
    st = dataclasses.replace(st, bonds=bonds, adj=adj, mol_id=mol)
    overflow = ov1 | ov2
    if cfg.max_ppnb > 0:
        st = _apply_ppnb(spec, cfg, st, valid, a, b, r)
    if cfg.has_fixd:
        rn = spec.r_release_n[rc]
        side = spec.r_release_side[rc]
        st = _release_constraints(spec, cfg, st, a, rn,
                                  valid & (rn > 0) & (side != 1))
        st = _release_constraints(spec, cfg, st, b, rn,
                                  valid & (rn > 0) & (side != 0))
    if cfg.n_rb > 0:
        for s_code, anchor in ((0, a), (1, b)):
            st, rm_ov = _remove_neighbour_bonds(spec, cfg, st, valid,
                                                anchor, rc, s_code)
            overflow = overflow | rm_ov
    if cfg.has_fixd:
        st, j_ov = _join(spec, st, valid, a, b, r)
        overflow = overflow | j_ov
    st, ov3 = _generate_terms_for_bond(spec, st, a, b, make_bond,
                                       cfg.exclude_new_bonds)
    return st, overflow | ov3


def _apply_events_sequential(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r):
    """``_apply_event`` for one event at a time, so that each sees the
    topology of all earlier ones.  A row whose ``ev_valid`` is False writes
    nothing, so only the fired rows run, their ids read once; the loop
    over all ``max_events`` rows gives the same state."""
    overflow = torch.zeros((), dtype=torch.bool, device=state.pos.device)
    for k in torch.nonzero(ev_valid).flatten().tolist():
        state, ov = _apply_event(spec, cfg, state, ev_valid[k], ev_a[k],
                                 ev_b[k], ev_r[k])
        overflow = overflow | ov
    return state, overflow


def apply_reaction_events(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r):
    """Apply fired normal-reaction events: per-particle updates, then the
    batched topology path, or, with RemoveNeighboursBonds or FixDistances,
    the sequential scan.  Returns (state, overflow)."""
    rr = torch.clamp(ev_r, min=0).long()
    ac = torch.clamp(ev_a, min=0).long()
    bc = torch.clamp(ev_b, min=0).long()
    n = state.pos.shape[0]
    chem = _add(state.chem_state, torch.where(ev_valid, ac, n),
                spec.r_delta1[rr])
    chem = _add(chem, torch.where(ev_valid, bc, n), spec.r_delta2[rr])
    counts = _add(state.reaction_counts,
                  torch.where(ev_valid, rr, cfg.n_reactions),
                  torch.ones_like(ev_r))
    intra = torch.sum(ev_valid & (state.mol_id[ac] == state.mol_id[bc]))
    inter = torch.sum(ev_valid) - intra
    state = dataclasses.replace(
        state, chem_state=chem, reaction_counts=counts,
        intra_counts=state.intra_counts + torch.stack([intra, inter]).to(I32))

    for e_side, new_t in ((ac, spec.r_new_type1[rr]),
                          (bc, spec.r_new_type2[rr])):
        te = torch.where(ev_valid & (new_t >= 0), new_t, -1)
        dest = torch.where(te >= 0, e_side, n)
        tc = torch.clamp(te, min=0).long()
        state = dataclasses.replace(
            state, type_id=topo.set_drop(state.type_id, dest, tc),
            mass=topo.set_drop(state.mass, dest, spec.type_mass[tc]),
            q=topo.set_drop(state.q, dest, spec.type_q[tc]))

    if cfg.n_rb or cfg.has_fixd:
        return _apply_events_sequential(spec, cfg, state, ev_valid, ev_a,
                                        ev_b, ev_r)
    return _apply_events_batched(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r)


# ---------------------------------------------------------------------------
# dissociation
# ---------------------------------------------------------------------------

def match_dissociations(spec, cfg, state, seed):
    """Bond rows to break: (ev_valid, ev_row, ev_r), each (max_events,).
    A bond breaks by channel r when it is farther than the channel's
    cutoff and the draw (salt ``1024 + 4r``) passes ``rate * dt *
    interval``, or spontaneously when the draw of salt ``1024 + 4r + 1``
    passes ``diss_rate * dt * interval``; among channels the smallest
    first draw wins (the first channel on ties), and the first
    ``max_events`` breaks by that draw are kept."""
    bonds = state.bonds
    dev = state.pos.device
    i = torch.clamp(bonds.idx[:, 0], min=0)
    j = torch.clamp(bonds.idx[:, 1], min=0)
    il, jl = i.long(), j.long()
    r2 = _norm2(_min_image(state.pos[il] - state.pos[jl], state.box))
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    ti, tj = state.type_id[il], state.type_id[jl]
    si, sj = state.chem_state[il], state.chem_state[jl]
    dt_i = spec.dt * cfg.reaction_interval
    big = torch.tensor(_BIG, dtype=F32, device=dev)
    us = []
    for r in range(cfg.n_reactions):
        fwd = (ti == spec.r_t1[r]) & (tj == spec.r_t2[r]) \
            & (si >= spec.r_min1[r]) & (si < spec.r_max1[r]) \
            & (sj >= spec.r_min2[r]) & (sj < spec.r_max2[r])
        bwd = (tj == spec.r_t1[r]) & (ti == spec.r_t2[r]) \
            & (sj >= spec.r_min1[r]) & (sj < spec.r_max1[r]) \
            & (si >= spec.r_min2[r]) & (si < spec.r_max2[r])
        m = bonds.valid & spec.r_is_diss[r] & state.reaction_active[r] \
            & (fwd | bwd)
        u1 = pair_uniform(seed, state.step, lo, hi, 1024 + 4 * r)
        u2 = pair_uniform(seed, state.step, lo, hi, 1024 + 4 * r + 1)
        far_break = (r2 > spec.r_cutoff2[r]) \
            & (u1 < state.reaction_rates[r] * dt_i)
        spont = u2 < spec.r_diss_rate[r] * dt_i
        us.append(torch.where(m & (far_break | spont), u1, big))
    u_all = torch.stack(us)
    pick = torch.argmin(u_all, dim=0)
    best_u = torch.gather(u_all, 0, pick[None])[0]
    best_r = torch.where(best_u < big, pick, -1).to(I32)
    broke = best_r >= 0
    order = torch.argsort(torch.where(broke, best_u, big), stable=True)
    take = order[:cfg.max_events]
    ev_valid = broke[take]
    ev_row = torch.where(ev_valid, take, -1).to(I32)
    ev_r = torch.where(ev_valid, best_r[take], -1).to(I32)
    return ev_valid, ev_row, ev_r


def apply_dissociation_events(spec, cfg, state, ev_valid, ev_row, ev_r):
    """Break bonds: per-side deltas and types (oriented by the channel's
    type_1), or with ``alpha`` set the old type kept at lambda 0 (the fade
    that ``integrate._dynamic_resolution`` completes); the bond rows, their
    dependent angles, dihedrals and exclusions and their adjacency edges
    removed; molecules relabelled.  Invalid rows write nothing, so after
    one read nothing runs when none fired."""
    if not bool(ev_valid.any()):
        return state
    rows = torch.clamp(ev_row, min=0).long()
    edges = state.bonds.idx[rows]
    a = torch.clamp(edges[:, 0], min=0).long()
    b = torch.clamp(edges[:, 1], min=0).long()
    rr = torch.clamp(ev_r, min=0).long()
    n = state.chem_state.shape[0]

    a_is_t1 = state.type_id[a] == spec.r_t1[rr]
    d_a = torch.where(a_is_t1, spec.r_delta1[rr], spec.r_delta2[rr])
    d_b = torch.where(a_is_t1, spec.r_delta2[rr], spec.r_delta1[rr])
    nt_a = torch.where(a_is_t1, spec.r_new_type1[rr], spec.r_new_type2[rr])
    nt_b = torch.where(a_is_t1, spec.r_new_type2[rr], spec.r_new_type1[rr])
    chem = _add(state.chem_state, torch.where(ev_valid, a, n), d_a)
    chem = _add(chem, torch.where(ev_valid, b, n), d_b)
    fade = spec.r_diss_fade[rr]
    tid, mass, q, lam = state.type_id, state.mass, state.q, state.lam
    for p, nt in ((a, nt_a), (b, nt_b)):
        sel = torch.where(ev_valid & (nt >= 0) & ~fade, p, n)
        ntc = torch.clamp(nt, min=0).long()
        tid = topo.set_drop(tid, sel, ntc)
        mass = topo.set_drop(mass, sel, spec.type_mass[ntc])
        q = topo.set_drop(q, sel, spec.type_q[ntc])
        lam = topo.set_drop(lam, torch.where(ev_valid & fade, p, n), 0.0)
    counts = _add(state.reaction_counts,
                  torch.where(ev_valid, rr, cfg.n_reactions),
                  torch.ones_like(ev_r))
    bonds = dataclasses.replace(state.bonds, idx=topo.set_drop(
        state.bonds.idx, torch.where(ev_valid, rows, state.bonds.capacity),
        -1))
    cap_a = 4 * edges.shape[0]
    angles, dihedrals, excl = _remove_terms_of_edges(state, edges, ev_valid,
                                                     cap_a, 2 * cap_a)
    adj = topo.adj_remove_edges(state.adj, edges, ev_valid)
    # molecules may have split
    return dataclasses.replace(
        state, chem_state=chem, type_id=tid, mass=mass, q=q, lam=lam,
        reaction_counts=counts, bonds=bonds, angles=angles,
        dihedrals=dihedrals, excl=excl, adj=adj,
        mol_id=topo.relabel_components(adj, state.active))


# ---------------------------------------------------------------------------
# the reaction step
# ---------------------------------------------------------------------------

def reaction_step(spec, cfg, state, rng_seed: int = 0):
    """One ChemicalReaction invocation (every ``interval`` MD steps):
    compact matching when the build chose it, else full rows (built fresh
    on the reaction grid on the lazy-row path, the persistent rows on the
    row path); then the dissociation channels over the bond table.  On the
    row path the rows' exclusion mask is refreshed when an event fired."""
    with perf.span(perf.RX_MATCH):
        if cfg.rx_compact:
            s1 = side1_mask(spec, cfg, state)
            order = torch.argsort((~s1).to(torch.uint8), stable=True)
            rowsel = order[:cfg.rx_rows_cap].to(I32)
            row_ok = s1[rowsel.long()]
            rx_overflow = s1.sum() > cfg.rx_rows_cap
            if cfg.lazy_rows:
                cand, excl_hit, c_ovf = compact_candidates_from_cells(
                    spec, cfg, state, rowsel)
                rx_overflow = rx_overflow | c_ovf
            else:
                cand, excl_hit = compact_candidates_from_rows(state, rowsel)
            ev_valid, ev_a, ev_b, ev_r, ev_dist = match_reactions_compact(
                spec, cfg, state, rng_seed, rowsel, row_ok, cand, excl_hit)
        elif cfg.lazy_rows:
            # rows exist only here, on the reaction-sized grid
            rx_nbr = neighbor.build_neighbor_state(
                state.pos, state.box, state.active, state.excl, cfg.rx_rc,
                dims=cfg.rx_dims, cell_cap=cfg.rx_cell_cap,
                max_neighbors=cfg.rx_k, excl_cap=cfg.excl_cap)
            rx_overflow = rx_nbr.overflow
            ev_valid, ev_a, ev_b, ev_r, ev_dist = match_reactions(
                spec, cfg, state, rng_seed, rx_nbr.idx, rx_nbr.excl_mask)
        else:
            rx_overflow = torch.zeros((), dtype=torch.bool,
                                      device=state.pos.device)
            ev_valid, ev_a, ev_b, ev_r, ev_dist = match_reactions(
                spec, cfg, state, rng_seed, state.nbr.idx, state.nbr.excl_mask)
    state = dataclasses.replace(
        state, ev_log_step=state.step.clone(), ev_log_a=ev_a, ev_log_b=ev_b,
        ev_log_r=ev_r, ev_log_dist=ev_dist.to(state.ev_log_dist.dtype))
    with perf.span(perf.RX_APPLY):
        state, topo_overflow = apply_reaction_events(spec, cfg, state,
                                                     ev_valid, ev_a, ev_b,
                                                     ev_r)
    any_event = torch.any(ev_valid)
    if cfg.has_dissociation:
        with perf.span(perf.RX_DISSOCIATE):
            dv, drow, dr = match_dissociations(spec, cfg, state, rng_seed)
            state = apply_dissociation_events(spec, cfg, state, dv, drow,
                                              dr)
        any_event = any_event | torch.any(dv)
    if not cfg.lazy_rows and bool(any_event):
        # positions did not move, so the rows stay valid: only the
        # exclusions changed (new 1-2/1-3/1-4 pairs, removals from breaks)
        excl_rows, e_ovf = neighbor.build_exclusion_rows(
            state.excl, state.pos.shape[0], cfg.excl_cap)
        idx = state.nbr.idx
        excl_mask = torch.any(idx[:, None, :] == excl_rows[:, :, None],
                              dim=1)
        state = dataclasses.replace(state, nbr=dataclasses.replace(
            state.nbr, excl_mask=excl_mask,
            overflow=state.nbr.overflow | e_ovf))
    nbr = dataclasses.replace(
        state.nbr, overflow=state.nbr.overflow | topo_overflow
        | rx_overflow)
    return dataclasses.replace(state, nbr=nbr)


# ---------------------------------------------------------------------------
# the periodic extensions: ATRPActivator, ChangeParticleType, FreezeRegion
# ---------------------------------------------------------------------------

def _on(x, device):
    """An injected draw as a tensor on ``device`` (numpy input copied)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _uniform(gen, shape, like, what: str):
    if gen is None:
        raise ValueError("%s needs its draws or a torch.Generator" % what)
    return torch.rand(shape, generator=gen, dtype=F32, device=like.device)


def atrp_step(spec, cfg, state, draws=None, gen=None):
    """ATRPActivator: activator/deactivator Monte Carlo over sampled
    particles.  ``draws`` is (ranks, u), each (atrp_num,): the ranks index
    all particles (``select_from_all``) or the active reactive centres in
    row order, in [0, max(count, 1)); u are the acceptance uniforms.
    Without ``draws`` both come from ``gen``, ranks first.  A particle
    sampled twice acts once (its first sample).  The picks are scanned in
    order on the host, after three reads (the picks, the draws and pool,
    the entries), because each accepted flip shifts the catalyst pool
    that the next acceptance reads; the pool and the acceptance run in f32
    as on the device."""
    num = cfg.atrp_num
    n = state.pos.shape[0]
    dev = state.pos.device
    if cfg.atrp_select_from_all:
        high = cfg.n_particles
        picks_ok = True
    else:
        center = torch.zeros_like(state.active)
        for e in range(cfg.n_atrp):
            center |= (state.type_id == spec.atrp_type[e]) \
                & (state.chem_state == spec.atrp_state[e])
        elig = state.active & center
        order = torch.argsort((~elig).to(torch.uint8), stable=True)
        cnt = elig.sum()
        high = torch.clamp(cnt, min=1)
        picks_ok = cnt > 0
    if draws is None:
        ranks = torch.clamp((_uniform(gen, (num,), state.pos, "atrp_step")
                             * high).long(), max=high - 1)
        u = _uniform(gen, (num,), state.pos, "atrp_step")
    else:
        ranks, u = (_on(d, dev) for d in draws)
    ranks = ranks.long()
    picks = ranks if cfg.atrp_select_from_all else order[ranks]

    # first occurrence of each pick
    rev = torch.arange(num - 1, -1, -1, dtype=I32, device=dev)
    seen = torch.zeros(n, dtype=I32, device=dev).scatter_reduce(
        0, picks, rev, reduce="amax")
    fresh = (seen[picks] == rev) & picks_ok

    # one read of the picks' integers, one of the floats, one of the
    # entries and the counters
    ints = torch.stack([picks, fresh.long(), state.type_id[picks].long(),
                        state.chem_state[picks].long(),
                        state.active[picks].long()]).cpu().numpy()
    floats = torch.cat([u.to(F32), state.atrp_ratios.to(F32),
                        torch.stack([spec.atrp_k_activate,
                                     spec.atrp_k_deactivate,
                                     spec.atrp_delta_catalyst]).to(F32)]
                       ).cpu().numpy()
    entries = torch.cat([spec.atrp_type.long(), spec.atrp_state.long(),
                         spec.atrp_is_activator.long(),
                         state.atrp_stats.long()]).cpu().numpy()
    p_h, fresh_h, t_h, s_h, act_h = ints
    u_h, ratios = floats[:num], floats[num:num + 2]
    k_act, k_deact, dcat = floats[num + 2:]
    a_type, a_state, a_act = entries[:3 * cfg.n_atrp].reshape(3, -1)
    stats = entries[3 * cfg.n_atrp:].astype(np.int32)
    f32 = np.float32
    ratios = ratios.copy()
    flips = []
    for i in range(num):
        if not (fresh_h[i] and act_h[i]):
            continue
        for e in range(cfg.n_atrp):
            if not (t_h[i] == a_type[e] and s_h[i] == a_state[e]):
                continue
            is_act = bool(a_act[e])
            pool = ratios[0] if is_act else ratios[1]
            k = k_act if is_act else k_deact
            if u_h[i] < f32(k * pool):
                dc = -dcat if is_act else dcat
                ratios = ratios + np.asarray([dc, -dc], f32)
                stats[0 if is_act else 1] += 1
                flips.append((int(p_h[i]), e))
                break
    out = dataclasses.replace(
        state, atrp_ratios=torch.from_numpy(ratios).to(dev),
        atrp_stats=torch.from_numpy(stats).to(dev))
    if not flips:
        return out
    sel = torch.tensor([p for p, _ in flips], dtype=torch.long, device=dev)
    ent = torch.tensor([e for _, e in flips], dtype=torch.long, device=dev)
    nt = spec.atrp_new_type[ent]
    tid, chem = state.type_id.clone(), state.chem_state.clone()
    mass, q = state.mass.clone(), state.q.clone()
    tid[sel] = nt
    mass[sel] = spec.type_mass[nt.long()]
    q[sel] = spec.type_q[nt.long()]
    chem[sel] = chem[sel] + spec.atrp_delta[ent]
    return dataclasses.replace(out, type_id=tid, chem_state=chem, mass=mass,
                               q=q)


def change_particle_type_step(spec, cfg, state, u=None, gen=None):
    """ChangeParticleType: up to ``cpt_num`` active particles of type
    ``cpt_old`` become ``cpt_new``, those with the smallest of the
    uniforms ``u`` (N,) (drawn from ``gen`` when not given)."""
    n = state.pos.shape[0]
    if u is None:
        u = _uniform(gen, (n,), state.pos, "change_particle_type_step")
    match = state.active & (state.type_id == spec.cpt_old)
    score = torch.where(match, _on(u, state.device), 2.0)
    order = torch.argsort(score, stable=True)[:cfg.cpt_num]
    sel = torch.where(match[order], order, n)
    nt = torch.clamp(spec.cpt_new, min=0).long()
    return dataclasses.replace(
        state, type_id=topo.set_drop(state.type_id, sel, nt),
        mass=topo.set_drop(state.mass, sel, spec.type_mass[nt]),
        q=topo.set_drop(state.q, sel, spec.type_q[nt]))


def _remove_dead(cfg, st):
    """Scrub removed (inactive) particles from the term tables (and their
    dense and irregular copies), the adjacency and the exclusions, then
    re-derive the dense exclusion operands."""
    from . import excl_dense

    dead = ~st.active

    def scrub(table):
        t_idx = table.idx
        bad = torch.any(torch.where(
            t_idx >= 0, dead[torch.clamp(t_idx, min=0).long()], False), -1)
        return dataclasses.replace(
            table, idx=torch.where(bad[:, None], -1, t_idx))

    adj = st.adj
    adj = torch.where((adj >= 0) & dead[torch.clamp(adj, min=0).long()], -1,
                      adj)
    adj = torch.where(dead[:, None], -1, adj)
    e = st.excl
    bad_e = torch.any(torch.where(e >= 0, dead[torch.clamp(e, min=0).long()],
                                  False), -1)
    upd = dict(bonds=scrub(st.bonds), angles=scrub(st.angles),
               dihedrals=scrub(st.dihedrals), adj=adj,
               excl=torch.where(bad_e[:, None], -1, e))
    if cfg.bonded_dense and st.bonds_dense is not None:
        # the derived copies are re-derived only at reaction steps
        upd.update(bonds_dense=scrub(st.bonds_dense),
                   bonds_irr=scrub(st.bonds_irr),
                   angles_dense=scrub(st.angles_dense),
                   angles_irr=scrub(st.angles_irr))
    st = dataclasses.replace(st, **upd)
    if cfg.excl_offsets and st.excl_masks is not None:
        st = excl_dense.rederive(cfg, st)
    return st


def freeze_region_step(spec, cfg, state, u=None, gen=None):
    """FreezeRegion: active particles of ``fr_target_type`` within
    ``fr_width`` of the chosen box faces freeze (type ``fr_final_type``,
    velocity and force zero from then on) or, with ``fr_remove``, leave
    the system.  ``fr_prob`` per particle, or ``fr_p_num`` / a
    ``fr_p_pct`` share of the candidates with the smallest uniforms.  The
    uniforms ``u`` (N,) come from ``gen`` when not given (every step).  A
    removal scrubs the topology (``_remove_dead``); whether one happened
    is read on the host."""
    pos, box, w = state.pos, state.box, spec.fr_width
    n = pos.shape[0]
    if u is None:
        u = _uniform(gen, (n,), pos, "freeze_region_step")
    u = _on(u, state.device)
    in_region = torch.zeros_like(state.active)
    for k, (axis, low_side) in enumerate(((0, True), (0, False), (1, True),
                                          (1, False), (2, True),
                                          (2, False))):
        side = (pos[:, axis] < w[axis]) if low_side else \
            (pos[:, axis] > box[axis] - w[axis])
        in_region |= spec.fr_dirs[k] & side
    cand = state.active & in_region & (state.type_id == spec.fr_target_type)
    if cfg.freeze_mode == "prob":
        hit = cand & (u < spec.fr_prob)
    else:
        n_cand = cand.sum()
        k = (spec.fr_p_num if cfg.freeze_mode == "num"
             else torch.floor(spec.fr_p_pct * n_cand).to(I32))
        order = torch.argsort(torch.where(cand, u, torch.inf), stable=True)
        rank = torch.empty(n, dtype=I32, device=state.device)
        rank[order] = torch.arange(n, dtype=I32, device=state.device)
        hit = cand & (rank < k)
    type_id = torch.where(hit & ~spec.fr_remove,
                          torch.clamp(spec.fr_final_type, min=0),
                          state.type_id)
    pinned = hit | (state.active & (type_id == spec.fr_final_type))
    removed = hit & spec.fr_remove
    state = dataclasses.replace(
        state, type_id=type_id,
        vel=torch.where(pinned[:, None], 0.0, state.vel),
        force=torch.where(pinned[:, None], 0.0, state.force),
        active=state.active & ~removed,
        freeze_count=state.freeze_count + hit.sum().to(I32))
    if bool(removed.any()):
        state = _remove_dead(cfg, state)
    return state
