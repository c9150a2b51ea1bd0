"""Nonbonded pair forces over the Verlet neighbour rows (the row path).

Port of ``chemlab_tpu/engine/pair_forces.py``.  One evaluation covers
every nonbonded variant: plain and energy-capped LJ (funcs 1, 15, 16),
plain, capped, blended, multi-range and λ-scaled tables (funcs 8-14, 17),
the ParticlePairScaling ramp (func 14) and truncated Coulomb.  Dispatch is
branchless: per-type-pair rows are gathered per neighbour slot and every
kind contributes through masks, in the reference's per-slot op order.

Conventions (the reference's):
  - tables store F = -dU/dr; the force on i from j is F(r) (r_i - r_j)/r;
  - LJ energies are shifted so U(cutoff) = 0;
  - capped variants clamp r to caprad: flat energy, zero force below it;
  - λ-scaled pairs scale U and F by λ_i λ_j.

Plain PyTorch on (N, K) planes.  The forces are closed-form, as in the
reference; only the row-path virial differentiates the energies (by
autograd in s, ``integrate.virial_pressure``).
"""

from __future__ import annotations

import torch

from . import tables
from .spec import MIX_OBS, PAIR_LJ, PAIR_TAB


def _clip(x, lo: float, hi: float):
    """``jnp.clip``: the bounds rounded to ``x``'s dtype, and at a tie the
    gradient split in half between ``x`` and the bound (``torch.clamp``
    passes all of it), which the row-path virial differentiates through."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


def resolve_pair_tables(spec, obs_x, n_mix_entries: int):
    """Per-type-pair (tab_a, tab_b, x) for this step, with the func-9
    MultiTabulated range switch and the func-17 multi-range blend applied
    in the order of the build's mix entries."""
    tab_a = spec.pair_tab_a
    tab_b = spec.pair_tab_b
    x = torch.where(spec.pair_mix_mode == MIX_OBS,
                    obs_x[spec.pair_obs.long()], spec.pair_mix_x)
    pairs = torch.arange(tab_a.shape[0], device=tab_a.device)
    for m in range(n_mix_entries):
        # entry m writes its type pair only; one-element slices keep every
        # index on the device (a 0-d index tensor is read on the host)
        e = slice(m, m + 1)
        at_p = pairs == spec.mix_pair[e]
        xv = obs_x[spec.mix_obs[e].long()]
        active = (xv >= spec.mix_lo[e]) & (xv < spec.mix_hi[e])
        is_blend = spec.mix_tab_a[e] != spec.mix_tab_b[e]
        tab_a = torch.where(at_p & active, spec.mix_tab_a[e], tab_a)
        tab_b = torch.where(at_p & active, spec.mix_tab_b[e], tab_b)
        # func-17 entries blend inside the range with the raw conversion;
        # func-9 entries (tab_a == tab_b) are pure table switches
        x = torch.where(at_p, torch.where(active & is_blend, xv,
                                          torch.where(active, 1.0, x)), x)
    return tab_a, tab_b, x


def row_block(n: int, n_ranks: int, rank: int):
    """``rank``'s contiguous block of rows (lo, hi) when ``n_ranks`` ranks
    split ``n`` rows: the first ``n % n_ranks`` blocks one row longer."""
    base, extra = divmod(n, n_ranks)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


def pair_forces(spec, n_types: int, pos, box, type_id, q, lam, nbr_idx,
                excl_mask, tab_a, tab_b, mix_x, cfg=None, pps_step=None,
                pps_birth=None, rows=None):
    """Nonbonded forces and energies over the neighbour rows.

    Returns (force (N, 3), energies): the per-kind sums 'lj', 'lj-tab' and
    'coulomb', halved for double counting.  With ``cfg`` its static flags
    leave out absent physics (tables, LJ, Coulomb, caps, λ scaling,
    blends) and the func-14 ramp runs from ``pps_step`` and the rows'
    ``pps_birth``; without it every branch runs and no ramp applies.
    ``rows`` = (lo, hi) evaluates those rows only (``row_block``): the
    force is then (hi - lo, 3) and the energies are those rows' share.
    Each row's sum is its own, so a block's rows are the whole call's."""
    has_tab = cfg is None or cfg.has_tabulated
    has_lj = cfg is None or cfg.has_lj
    has_qq = cfg is None or cfg.has_coulomb
    has_cap = cfg is None or cfg.has_caps
    has_lam = cfg is None or cfg.has_lambda_pairs
    has_mix = cfg is None or cfg.has_mixed_tables
    lo, hi = (0, pos.shape[0]) if rows is None else rows
    j = nbr_idx[lo:hi].long()
    # one packed (N, K, 4) [x, y, z, type] gather; the math on (N, K) planes
    packed = torch.cat([pos, type_id.to(pos.dtype)[:, None]], dim=-1)
    pj = packed[j]
    drs = []
    r2 = torch.zeros(j.shape, dtype=pos.dtype, device=pos.device)
    for ax in range(3):
        d = pos[lo:hi, ax][:, None] - pj[..., ax]
        d = d - box[ax] * torch.round(d / box[ax])
        drs.append(d)
        r2 = r2 + d * d
    self_idx = torch.arange(lo, hi, dtype=j.dtype, device=pos.device)[:, None]
    mask = (j != self_idx) & ~excl_mask[lo:hi]
    r2 = torch.where(mask, r2, 1.0)     # keep the math finite on dead slots
    r = torch.sqrt(r2)

    ti = type_id[lo:hi, None].long()
    tj = pj[..., 3].to(torch.int64)     # exact: type ids << 2^24
    p = ti * n_types + tj

    # one packed row per type pair: cutoff2, [kind | 4 lam | 8 tab_a], r0, dr
    if has_lam:
        lam_flag = spec.pair_lam_scale.to(torch.float32)
    else:
        lam_flag = torch.zeros_like(spec.pair_cutoff2)
    combo = (spec.pair_kind.to(torch.float32) + 4.0 * lam_flag
             + 8.0 * tab_a.to(torch.float32))
    tab_al = tab_a.long()
    row_a = torch.stack([spec.pair_cutoff2, combo, spec.nb_r0[tab_al],
                         spec.nb_dr[tab_al]], dim=-1)
    ra = row_a[p]
    c_int = ra[..., 1].to(torch.int32)
    kind = c_int & 3
    in_cut = r2 < ra[..., 0]
    zero = torch.zeros_like(r2)
    if has_cap:
        row_c = torch.stack([spec.pair_caprad, spec.pair_max_force,
                             torch.zeros_like(spec.pair_caprad),
                             torch.zeros_like(spec.pair_caprad)], dim=-1)
        rc_ = row_c[p]
        caprad = rc_[..., 0]
        r_eff = torch.where(caprad > 0.0, torch.maximum(r, caprad), r)
        above_cap = r >= caprad
    else:
        r_eff = r
        above_cap = torch.ones_like(mask)

    # ---- Lennard-Jones ----
    if has_lj:
        row_l = torch.stack([spec.pair_sig, spec.pair_eps, spec.pair_shift,
                             torch.zeros_like(spec.pair_sig)], dim=-1)
        rl = row_l[p]
        sig = rl[..., 0]
        eps = rl[..., 1]
        s2 = (sig * sig) / (r_eff * r_eff)
        s6 = s2 * s2 * s2
        lj_mask = mask & (kind == PAIR_LJ) & in_cut
        e_lj = torch.where(lj_mask, 4.0 * eps * (s6 * s6 - s6) - rl[..., 2],
                           0.0)
        # F(r)/r with F = -dU/dr; zero below caprad (flat capped energy)
        f_lj = torch.where(lj_mask & above_cap,
                           48.0 * eps * (s6 * s6 - 0.5 * s6)
                           / (r_eff * r_eff), 0.0)
    else:
        e_lj, f_lj = zero, zero

    # ---- tabulated (with blending) ----
    if has_tab:
        tab_mask = mask & (kind == PAIR_TAB) & in_cut
        # the flat-index form with row-sourced r0/dr, op for op
        # tables.interpolate4's values
        n_bins = spec.nb_ef4.shape[1]
        ef4_flat = spec.nb_ef4.reshape(-1, 4)
        ta = (c_int >> 3).long()
        u = (r_eff - ra[..., 2]) / ra[..., 3]
        u = _clip(u, 0.0, n_bins - 1.000001)
        i0 = u.to(torch.int32)
        frac = (u - i0.to(u.dtype))[..., None]
        v = ef4_flat[ta * n_bins + i0.long()]
        ef_ab = v[..., :2] * (1.0 - frac) + v[..., 2:] * frac
        ea, fa = ef_ab[..., 0], ef_ab[..., 1]
        if has_mix:
            eb, fb = tables.interpolate4(spec.nb_ef4, spec.nb_r0, spec.nb_dr,
                                         tab_b[p], r_eff)
            xm = mix_x[p]
            e_tab = xm * ea + (1.0 - xm) * eb
            f_tab = xm * fa + (1.0 - xm) * fb
        else:
            e_tab, f_tab = ea, fa
        e_tab = torch.where(tab_mask, e_tab, 0.0)
        f_tab = torch.where(tab_mask & above_cap, f_tab / r, 0.0)
    else:
        e_tab, f_tab = zero, zero

    # ---- λ scaling (funcs 11 and 15) ----
    if has_lam:
        w = torch.where((c_int & 4) > 0, lam[lo:hi, None] * lam[j], 1.0)
        e_lj, f_lj = e_lj * w, f_lj * w
        e_tab, f_tab = e_tab * w, f_tab * w

    # ---- ParticlePairScaling (func 14): a new pair ramps from 0 to 1 by
    #      pps_incr a step from the step it entered the rows ----
    if cfg is not None and cfg.has_pps and pps_step is not None:
        incr = spec.pair_pps_incr[p]
        age = (pps_step - pps_birth[lo:hi]).to(torch.float32)
        ramp = torch.clamp(age * incr, 0.0, 1.0)
        w14 = torch.where(incr > 0.0, ramp, 1.0)
        e_tab, f_tab = e_tab * w14, f_tab * w14
        e_lj, f_lj = e_lj * w14, f_lj * w14

    # ---- per-pair force cap ----
    f_nb = f_lj + f_tab
    if has_cap:
        fmax = rc_[..., 1]
        fmag = torch.abs(f_nb) * r
        scale = torch.where((fmax > 0.0) & (fmag > fmax),
                            fmax / torch.clamp(fmag, min=1e-30), 1.0)
        f_nb = f_nb * scale

    # ---- truncated Coulomb ----
    if has_qq:
        qq_mask = mask & (r2 < spec.qq_cutoff2) & (spec.qq_prefactor > 0.0)
        qq = spec.qq_prefactor * q[lo:hi, None] * q[j]
        e_qq = torch.where(qq_mask, qq / r, 0.0)
        f_qq = torch.where(qq_mask, qq / (r2 * r), 0.0)
    else:
        e_qq, f_qq = zero, zero

    f_over_r = f_nb + f_qq
    force = torch.stack([torch.sum(f_over_r * d, dim=1) for d in drs],
                        dim=-1)
    energies = {"lj": 0.5 * torch.sum(e_lj),
                "lj-tab": 0.5 * torch.sum(e_tab),
                "coulomb": 0.5 * torch.sum(e_qq)}
    return force, energies
