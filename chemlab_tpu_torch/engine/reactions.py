"""The reactive layer: matching and batched event application.

Port of ``chemlab_tpu/engine/reactions.py`` for the lazy-row paths of
``reaction_step``:

- compact (``cfg.rx_compact``, the type_1 side is a minority): candidates
  on the reaction cell grid for the particles that can be the type_1 side
  of a channel (``side1_mask``, ``compact_candidates_from_cells``),
  conflicts resolved by deterministic scatter-min
  (``match_reactions_compact``);
- full-row (the type_1 side spans the bulk, as in step-growth chemistry):
  fresh neighbour rows on the reaction grid
  (``neighbor.build_neighbor_state`` at ``cfg.rx_rc``), both directions of
  every channel tested for every slot (``_channel_accept``) and conflicts
  resolved by mutual argmin (``match_reactions``).

Both accept with the pair-symmetric integer hash (``pair_uniform``,
bit-exact with the reference) and apply the events in one batch
(``apply_reaction_events`` dispatching to ``_apply_events_batched``,
ChangeNeighboursProperty transfers included).

Out of the slice, raising at build: dissociation, the sequential event scan
(RemoveNeighboursBonds, FixDistances), RestrictReaction, ATRP,
ChangeParticleType and freeze regions (ROADMAP M12).

uint32 hashing runs in int64 with ``& 0xFFFFFFFF`` and a 16-bit split
multiply (no signed overflow); every sort is ``stable=True``.
"""

from __future__ import annotations

import dataclasses

import torch

from . import neighbor, topo
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
    if spec.restrict_lo.shape[0]:
        raise NotImplementedError("RestrictReaction (ROADMAP M12)")
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
    by scatter order (the reference's own event order is arbitrary)."""
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
                tid = topo.set_drop(tid, sel, nt)
                mass = topo.set_drop(mass, sel, spec.type_mass[nt.long()])
                q = topo.set_drop(q, sel, spec.type_q[nt.long()])
                chem = topo.set_drop(chem, sel, newc)
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


def apply_reaction_events(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r):
    """Apply fired normal-reaction events: per-particle updates, then the
    batched topology path."""
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
        raise NotImplementedError("the sequential event scan "
                                  "(RemoveNeighboursBonds, FixDistances): "
                                  "ROADMAP M12")
    return _apply_events_batched(spec, cfg, state, ev_valid, ev_a, ev_b, ev_r)


# ---------------------------------------------------------------------------
# the reaction step
# ---------------------------------------------------------------------------

def reaction_step(spec, cfg, state, rng_seed: int = 0):
    """One ChemicalReaction invocation (every ``interval`` MD steps) on the
    lazy-row path: compact matching when the build chose it, else full
    rows built fresh on the reaction grid."""
    if not cfg.lazy_rows or cfg.has_dissociation:
        raise NotImplementedError("reaction_step with dissociation "
                                  "(ROADMAP M12)")
    if cfg.rx_compact:
        s1 = side1_mask(spec, cfg, state)
        order = torch.argsort((~s1).to(torch.uint8), stable=True)
        rowsel = order[:cfg.rx_rows_cap].to(I32)
        row_ok = s1[rowsel.long()]
        rx_overflow = s1.sum() > cfg.rx_rows_cap
        cand, excl_hit, c_ovf = compact_candidates_from_cells(
            spec, cfg, state, rowsel)
        rx_overflow = rx_overflow | c_ovf
        ev_valid, ev_a, ev_b, ev_r, ev_dist = match_reactions_compact(
            spec, cfg, state, rng_seed, rowsel, row_ok, cand, excl_hit)
    else:
        # rows exist only here, on the reaction-sized grid
        rx_nbr = neighbor.build_neighbor_state(
            state.pos, state.box, state.active, state.excl, cfg.rx_rc,
            dims=cfg.rx_dims, cell_cap=cfg.rx_cell_cap,
            max_neighbors=cfg.rx_k, excl_cap=cfg.excl_cap)
        rx_overflow = rx_nbr.overflow
        ev_valid, ev_a, ev_b, ev_r, ev_dist = match_reactions(
            spec, cfg, state, rng_seed, rx_nbr.idx, rx_nbr.excl_mask)
    state = dataclasses.replace(
        state, ev_log_step=state.step.clone(), ev_log_a=ev_a, ev_log_b=ev_b,
        ev_log_r=ev_r, ev_log_dist=ev_dist.to(state.ev_log_dist.dtype))
    state, topo_overflow = apply_reaction_events(spec, cfg, state, ev_valid,
                                                 ev_a, ev_b, ev_r)
    nbr = dataclasses.replace(
        state.nbr, overflow=state.nbr.overflow | topo_overflow
        | rx_overflow)
    return dataclasses.replace(state, nbr=nbr)
