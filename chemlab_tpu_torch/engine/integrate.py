"""Velocity-Verlet integration with the thermostats and barostats.

Port of ``chemlab_tpu/engine/integrate.py``: ``compute_forces`` on the
cell-tile path (kernel sum minus the excluded-pair correction; LJ or
Chebyshev-tabulated pairs, with the conversion observables computed on the
device when a func-10 blend reads them; the kernel sum split by x-slab
over the ranks of a mesh when ``cell_pair_halo.supports`` the config) or
on the Verlet row path (``pair_forces`` over the persistent rows, every
nonbonded variant; under a mesh each rank evaluates its block of rows
and one ``all_reduce`` sums them), plus bonded forces, plus the global
CapForce;
``_langevin_adjust``, the rescaling thermostats (``_rescale_thermostat``:
CSVR, Berendsen, isokinetic), ``_fix_distances`` and
``_dynamic_resolution``, ``virial_pressure`` (kernel path: the kernel's
pair-virial channel minus the excluded pairs' share, minus the bonded
strain derivative; row path: W = -dU/ds over the rows and the bonded
terms by autograd at s = 1), ``_barostat_step`` (Berendsen and
the Langevin piston), ``maybe_rebuild_neighbors`` (a bucket refresh on
the lazy-row path, the full row rebuild with func-14 births on the row
path), and ``md_step``.

The noise is an argument: ``md_step`` takes the Langevin noise tensor,
CSVR's scalar normal and the Langevin barostat's scalar draw (the tests
pass the reference's draws) or a ``torch.Generator`` to draw them from, in
that order.  The rebuild trigger is read on the host each step; the box
stays on the device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import (bonded_forces, cell_pair, cell_pair_halo, excl_dense,
               neighbor, observables, pair_forces, perf, reactions, topo)
from .state import I32


def _dense_of(cfg, state):
    """The derived dense/irregular bonded operands, when enabled."""
    if cfg.bonded_dense and state.bonds_dense is not None:
        return (state.bonds_dense, state.bonds_irr, state.angles_dense,
                state.angles_irr)
    return None


def _excl_correction(spec, cfg, state, obs_x):
    """Excluded-pair correction: the dense-static leg when derived operands
    exist, else the flat-list correction."""
    with perf.span(perf.EXCL_CORRECTION):
        kwargs = dict(active=state.active,
                      cheb=((cfg.cheb_kw, cfg.cheb_ko) if cfg.tab_cheb
                            else None),
                      cheb_mix=cfg.cheb_mix, obs_x=obs_x)
        if cfg.excl_offsets and state.excl_masks is not None:
            return excl_dense.correction(spec, cfg, state.pos, state.box,
                                         state.type_id, state.excl_masks,
                                         state.excl_irr, **kwargs)
        return cell_pair.excluded_pair_correction(
            spec, cfg.n_types, state.pos, state.box, state.type_id,
            state.excl, **kwargs)


def _pair_sum(spec, cfg, state, **kw):
    """The unexcluded all-pairs sum: slab by slab over the mesh's ranks
    (K1f) where the slab path takes the config, else on the whole grid."""
    with perf.span(perf.PAIR_SUM):
        args = (state.pos, state.type_id, state.active, state.box,
                state.nbr.buckets, state.nbr.slot_of, cfg.cell_dims, spec,
                cfg.n_types)
        kw.update(uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj,
                  cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0,
                  cheb_ko=cfg.cheb_ko, cheb_ntab=cfg.cheb_ntab,
                  cheb_mix=cfg.cheb_mix)
        if cell_pair_halo.supports(cfg):
            cell_pair.check_pair_kernel(kw.pop("kernel"), slab=True)
            return cell_pair_halo.cell_pair_forces_halo(
                *args, mesh=cfg.mesh, **kw)
        return cell_pair.cell_pair_forces(*args, **kw)


def compute_forces(spec, cfg, state, want_energy: bool = True,
                   pair_kernel: str = "auto"):
    """All conservative forces + per-term potential energies + conversions.

    ``want_energy=False`` (the per-step call) skips the pair-energy channel;
    the returned pair energies are then zeros (K1' and K3a-K3d fill it
    anyway).  ``pair_kernel`` names the pair kernel
    (``cell_pair.cell_pair_forces``' ``kernel``; the reference's
    CHEMLAB_KERNEL)."""
    if cfg.needs_conversions:
        obs_x = observables.conversions(spec, state.type_id, state.chem_state,
                                        state.active)
    else:
        obs_x = torch.zeros(spec.obs_total.shape[0], dtype=torch.float32,
                            device=state.pos.device)
    if cfg.use_pallas:
        f_all, e_lj_all, e_tab_all, _ = _pair_sum(
            spec, cfg, state, want_energy=want_energy, obs_x=obs_x,
            kernel=pair_kernel)
        f_ex, e_lj_ex, e_tab_ex, _ = _excl_correction(spec, cfg, state,
                                                      obs_x)
        f_pair = f_all - f_ex
        e_pair = {"lj": e_lj_all - e_lj_ex, "lj-tab": e_tab_all - e_tab_ex,
                  "coulomb": torch.zeros((), dtype=state.pos.dtype,
                                         device=state.pos.device)}
    else:
        f_pair, e_pair = row_pair_forces(spec, cfg, state, obs_x)
    f_bond, e_bond = bonded_forces.bonded_forces(
        spec, cfg, state.pos, state.box, state.type_id, state.q, state.bonds,
        state.angles, state.dihedrals, state.pairs14,
        dense=_dense_of(cfg, state))
    force = f_pair + f_bond
    # global CapForce; overflow-safe norm (sum(F^2) can exceed f32 range)
    fmax = torch.amax(torch.abs(force), dim=-1, keepdim=True)
    fdir = force / torch.clamp(fmax, min=1e-30)
    fmag = fmax * torch.sqrt(torch.sum(fdir * fdir, dim=-1, keepdim=True))
    cap = spec.max_force
    force = torch.where(cap > 0.0, force * torch.clamp(
        cap / torch.clamp(fmag, min=1e-30), max=1.0), force)
    force = torch.where(state.active[:, None], force, 0.0)
    return force, {**e_pair, **e_bond}, obs_x


def _row_split(cfg, n: int):
    """This rank's block of rows under a mesh of two or more ranks, else
    None (every row here)."""
    mesh = cfg.mesh
    if mesh is None or mesh.world_size < 2:
        return None
    return pair_forces.row_block(n, mesh.world_size, mesh.rank)


def _sum_over_ranks(cfg, parts):
    """``parts`` (tensors of one dtype) summed over the mesh's ranks by one
    ``all_reduce``: every rank gets the same bits."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    dist.all_reduce(flat, group=cfg.mesh.group)
    out, k = [], 0
    for p in parts:
        out.append(flat[k:k + p.numel()].reshape(p.shape))
        k += p.numel()
    return out


def row_pair_forces(spec, cfg, state, obs_x):
    """The row path's pair forces and energies (reference
    ``integrate.py:106-113``): the step's tables resolved from the
    conversions, then ``pair_forces.pair_forces`` over the persistent rows
    with the func-14 ramp where the system has one.  Under a mesh each
    rank evaluates its block of rows (``pair_forces.row_block``), the
    other rows' forces zero, and one ``all_reduce`` sums the (N, 3) forces
    and the energies: a row's force is nonzero on one rank only."""
    with perf.span(perf.PAIR_SUM):
        tab_a, tab_b, mix_x = pair_forces.resolve_pair_tables(
            spec, obs_x, cfg.n_mix_entries)
        rows = _row_split(cfg, state.pos.shape[0])
        force, e = pair_forces.pair_forces(
            spec, cfg.n_types, state.pos, state.box, state.type_id,
            state.q, state.lam, state.nbr.idx, state.nbr.excl_mask, tab_a,
            tab_b, mix_x, cfg=cfg,
            pps_step=state.step if cfg.has_pps else None,
            pps_birth=state.nbr.birth if cfg.has_pps else None, rows=rows)
        if rows is None:
            return force, e
        lo, hi = rows
        full = torch.zeros_like(state.pos)
        full[lo:hi] = force
        keys = sorted(e)
        full, *vals = _sum_over_ranks(cfg, [full] + [e[k] for k in keys])
        return full, dict(zip(keys, vals))


def _langevin_adjust(spec, state, force, noise):
    """Langevin friction + noise folded into the force array."""
    sel = state.active & spec.thermal_type_mask[state.type_id.long()]
    m = state.mass[:, None]
    amp = torch.sqrt(2.0 * spec.kT * spec.gamma * m / spec.dt)
    adj = -spec.gamma * m * state.vel + amp * noise
    return force + torch.where(sel[:, None], adj, 0.0)


def _rescale_thermostat(spec, cfg, state, r=None):
    """The velocity-rescaling thermostats, after the kick: 'vr' (Bussi's
    CSVR, with ``r`` its one standard normal), 'br' (Berendsen) and 'iso'
    (isokinetic, every ``cfg.iso_coupling`` steps)."""
    kT_now = observables.temperature(state.mass, state.vel, state.active,
                                     spec.thermal_type_mask, state.type_id)
    sel = state.active & spec.thermal_type_mask[state.type_id.long()]
    nf = 3.0 * torch.clamp(sel.sum(), min=1)
    if cfg.thermostat == "vr":
        tau = torch.maximum(spec.gamma, spec.dt)
        c = torch.exp(-spec.dt / tau)
        k_now = 0.5 * nf * kT_now
        k_target = 0.5 * nf * spec.kT
        k_new = (k_now * c
                 + k_target / nf * (1.0 - c) * (nf - 1.0 + r * r)
                 + 2.0 * r * torch.sqrt(k_now * k_target / nf * (1.0 - c)
                                        * c))
        scale = torch.sqrt(torch.clamp(k_new, min=1e-30)
                           / torch.clamp(k_now, min=1e-30))
    elif cfg.thermostat == "br":
        tau = torch.maximum(spec.gamma, spec.dt)
        scale = torch.sqrt(1.0 + spec.dt / tau * (
            spec.kT / torch.clamp(kT_now, min=1e-30) - 1.0))
    else:  # 'iso'
        due = (state.step % cfg.iso_coupling) == 0
        scale = torch.where(
            due, torch.sqrt(spec.kT / torch.clamp(kT_now, min=1e-30)), 1.0)
    vel = torch.where(sel[:, None], state.vel * scale, state.vel)
    return dataclasses.replace(state, vel=vel)


def _fix_distances(spec, cfg, state):
    """FixDistances: release a constraint whose host no longer has its
    definition's host type (the dummy becomes the target type at the
    release lambda), then pin each remaining dummy at ``eq`` from its
    host along the current separation, with the host's velocity."""
    h, d = state.fixd_host, state.fixd_dummy
    valid = (h >= 0) & (d >= 0)
    hc = torch.clamp(h, min=0).long()
    dc = torch.clamp(d, min=0).long()
    n = state.pos.shape[0]
    def_idx = reactions._fd_def_of(spec, cfg, state.type_id, d)
    eq = spec.fd_eq[def_idx]
    host_t = spec.fd_host_type[def_idx]
    target_t = torch.clamp(spec.fd_target_type[def_idx], min=0).long()

    release = valid & (host_t >= 0) & (state.type_id[hc] != host_t)
    dsel = torch.where(release, dc, n)
    type_id = topo.set_drop(state.type_id, dsel, target_t)
    mass = topo.set_drop(state.mass, dsel, spec.type_mass[target_t])
    lam = topo.set_drop(state.lam, dsel, spec.fd_release_lam[def_idx])
    h = torch.where(release, -1, h)
    d = torch.where(release, -1, d)
    valid = valid & ~release

    box = state.box
    dr = state.pos[dc] - state.pos[hc]
    dr = dr - box * torch.round(dr / box)
    norm = torch.sqrt(torch.sum(dr * dr, -1, keepdim=True))
    unit = torch.where(norm > 1e-9, dr / torch.clamp(norm, min=1e-9),
                       torch.tensor([[1.0, 0.0, 0.0]], dtype=dr.dtype,
                                    device=dr.device))
    target = state.pos[hc] + eq[:, None] * unit
    target = target - box * torch.floor(target / box)
    dest = torch.where(valid, dc, n)
    pos = topo.set_drop(state.pos, dest, target)
    vel = topo.set_drop(state.vel, dest, state.vel[hc])
    return dataclasses.replace(state, pos=pos, vel=vel, type_id=type_id,
                               mass=mass, lam=lam, fixd_host=h, fixd_dummy=d)


def _dynamic_resolution(spec, state):
    """BasicDynamicResolution: lambda += alpha(type) each step; a particle
    whose lambda crosses 1 this step takes its type's final type (mass,
    charge; the atomtype's chemical state where ``dr_set_state``)."""
    tl = state.type_id.long()
    alpha = spec.dr_alpha[tl]
    ramp = state.active & (alpha > 0.0)
    lam = torch.where(ramp, torch.clamp(state.lam + alpha, max=1.0),
                      state.lam)
    final = spec.dr_final_type[tl]
    fire = ramp & (state.lam < 1.0) & (lam >= 1.0) & (final >= 0)
    fc = torch.clamp(final, min=0).long()
    return dataclasses.replace(
        state, lam=lam, type_id=torch.where(fire, fc.to(I32), state.type_id),
        mass=torch.where(fire, spec.type_mass[fc], state.mass),
        q=torch.where(fire, spec.type_q[fc], state.q),
        chem_state=torch.where(fire & spec.dr_set_state[tl],
                               spec.type_state[fc], state.chem_state))


def row_strain_derivative(spec, cfg, state):
    """dU/ds at s = 1 on the row path, positions and box scaled by s: every
    pair of the rows plus the bonded terms (reference
    ``integrate.py:224-241``); under a mesh each rank differentiates its
    block of rows and one ``all_reduce`` sums the D derivatives.  The pair
    energies come from ``pair_forces`` without ``cfg``, as the reference
    calls it there: every branch runs and no func-14 ramp applies."""
    obs_x = observables.conversions(spec, state.type_id, state.chem_state,
                                    state.active)
    tab_a, tab_b, mix_x = pair_forces.resolve_pair_tables(
        spec, obs_x, cfg.n_mix_entries)
    rows = _row_split(cfg, state.pos.shape[0])
    with torch.enable_grad():
        s = torch.ones((), dtype=state.pos.dtype, device=state.pos.device,
                       requires_grad=True)
        _, e_pair = pair_forces.pair_forces(
            spec, cfg.n_types, state.pos.detach() * s,
            state.box.detach() * s, state.type_id, state.q, state.lam,
            state.nbr.idx, state.nbr.excl_mask, tab_a, tab_b, mix_x,
            rows=rows)
        (grad,) = torch.autograd.grad(sum(e_pair.values()), s)
    if rows is not None:
        (grad,) = _sum_over_ranks(cfg, [grad])
    return grad + bonded_forces.bonded_strain_derivative(
        spec, cfg, state.pos, state.box, state.type_id, state.q,
        state.bonds, state.angles, state.dihedrals, state.pairs14,
        dense=_dense_of(cfg, state))


def virial_pressure(spec, cfg, state, pair_kernel: str = "auto"):
    """Instantaneous pressure P = (2 Ekin + W) / 3V (reference
    ``integrate.virial_pressure``).  Kernel path: W is the pair virial from
    the kernel's virial channel (K1/K1b or K2; K1c/K1d/K1e on a tabulated
    system) minus the excluded pairs' share, minus the bonded strain
    derivative dU_bonded/ds; on a mesh the kernel's channel is summed slab
    by slab (K1f); ``pair_kernel`` as in ``compute_forces``.  Row path:
    W = -dU/ds over the rows and the bonded terms
    (``row_strain_derivative``)."""
    if cfg.use_pallas:
        obs_x = (observables.conversions(spec, state.type_id,
                                         state.chem_state, state.active)
                 if cfg.cheb_mix else None)
        _, _, _, w_all = _pair_sum(spec, cfg, state, want_virial=True,
                                   obs_x=obs_x, kernel=pair_kernel)
        _, _, _, w_ex = _excl_correction(spec, cfg, state, obs_x)
        w = (w_all - w_ex) - bonded_forces.bonded_strain_derivative(
            spec, cfg, state.pos, state.box, state.type_id, state.q,
            state.bonds, state.angles, state.dihedrals, state.pairs14,
            dense=_dense_of(cfg, state))
    else:
        w = -row_strain_derivative(spec, cfg, state)
    ekin = observables.kinetic_energy(state.mass, state.vel, state.active)
    return (2.0 * ekin + w) / (3.0 * torch.prod(state.box))


def _barostat_step(spec, cfg, state, noise=None, pair_kernel: str = "auto"):
    """Isotropic box scaling (reference ``integrate._barostat_step``).

    'br': Berendsen, mu = clip(1 - dt/tau (P0 - P), 0.9, 1.1)^(1/3);
    'lv': Langevin piston on ``baro_v`` with friction gammaP and the scalar
    standard normal ``noise``, mu = exp(dt baro_v).  Either way mu is
    clipped to 0.98-1.02 per step; active positions and the box scale by
    it.  The pressure pass runs ``pair_kernel``."""
    with perf.span(perf.BAROSTAT):
        p_now = virial_pressure(spec, cfg, state, pair_kernel)
        dt = spec.dt
        if cfg.barostat == "br":
            base = torch.clamp(1.0 - dt / spec.barostat_tau
                               * (spec.pressure - p_now), 0.9, 1.1)
            mu = base ** (1.0 / 3.0)
            baro_v = state.baro_v
        else:  # 'lv'
            w = torch.clamp(spec.barostat_mass, min=1e-6)
            vol = torch.prod(state.box)
            dv = (dt * 3.0 * vol * (p_now - spec.pressure) / w
                  - dt * spec.barostat_gammaP * state.baro_v
                  + torch.sqrt(2.0 * spec.kT * spec.barostat_gammaP * dt / w)
                  * noise)
            baro_v = state.baro_v + dv
            mu = torch.exp(dt * baro_v)
        mu = torch.clamp(mu, 0.98, 1.02)
        pos = torch.where(state.active[:, None], state.pos * mu, state.pos)
        return dataclasses.replace(state, pos=pos, box=state.box * mu,
                                   baro_v=baro_v)


def maybe_rebuild_neighbors(spec, cfg, state, force: bool = False):
    """When the skin criterion fires (read on the host) or ``force``:
    refresh the cell buckets on the lazy-row path, rebuild the rows on the
    row path (a func-14 pair keeps its birth step across the rebuild; the
    overflow flag stays sticky)."""
    if not force:
        with perf.span(perf.REBUILD_CHECK):
            due = bool(neighbor.needs_rebuild(state.pos, state.nbr,
                                              state.box, spec.skin))
        if not due:
            return state
    with perf.span(perf.REBUILD):
        if cfg.lazy_rows:
            nbr = neighbor.refresh_buckets(state.nbr, state.pos, state.box,
                                           state.active, dims=cfg.cell_dims,
                                           cell_cap=cfg.cell_cap)
            return dataclasses.replace(state, nbr=nbr)
        rc_skin = torch.sqrt(torch.max(spec.pair_cutoff2)) + spec.skin
        nbr = neighbor.build_neighbor_state(
            state.pos, state.box, state.active, state.excl, rc_skin,
            dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
            max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap,
            track_birth=cfg.has_pps,
            prev=state.nbr if cfg.has_pps else None, step=state.step)
        nbr = dataclasses.replace(nbr, n_rebuilds=state.nbr.n_rebuilds + 1,
                                  overflow=state.nbr.overflow | nbr.overflow)
        return dataclasses.replace(state, nbr=nbr)


def _draw(gen, shape, like, what: str):
    if gen is None:
        raise ValueError("%s needs its noise or a torch.Generator" % what)
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def md_step(spec, cfg, state, noise=None, gen=None, baro_noise=None,
            pair_kernel: str = "auto", rescale_noise=None):
    """One velocity-Verlet step (FixDistances and dynamic resolution after
    the drift), then the rescaling thermostat and the barostat.  The draws,
    in this order: the Langevin noise (``noise``), CSVR's scalar normal
    (``rescale_noise``) and the Langevin barostat's (``baro_noise``); each
    one not given comes from ``gen``.  The force and the pressure passes
    run the pair kernel ``pair_kernel``."""
    with perf.span(perf.MD_STEP):
        dt = spec.dt
        inv_m = torch.where(state.active, 1.0 / state.mass, 0.0)[:, None]

        # half kick + drift (state.force carries the previous full force,
        # thermostat included)
        vel = state.vel + 0.5 * dt * state.force * inv_m
        pos = state.pos + dt * vel
        shift = torch.floor(pos / state.box).to(torch.int32)
        pos = pos - shift.to(pos.dtype) * state.box
        state = dataclasses.replace(state, pos=pos, vel=vel,
                                    image=state.image + shift)
        if cfg.has_fixd:
            state = _fix_distances(spec, cfg, state)
        if cfg.has_dyn_resolution:
            state = _dynamic_resolution(spec, state)

        state = maybe_rebuild_neighbors(spec, cfg, state)
        force, _, _ = compute_forces(spec, cfg, state, want_energy=False,
                                     pair_kernel=pair_kernel)
        if cfg.thermostat == "lv":
            if noise is None:
                noise = _draw(gen, state.vel.shape, state.vel,
                              "the Langevin md_step")
            force = _langevin_adjust(spec, state, force, noise)

        vel = state.vel + 0.5 * dt * force * inv_m
        state = dataclasses.replace(state, vel=vel, force=force,
                                    step=state.step + 1)
        if cfg.thermostat in ("vr", "br", "iso"):
            if cfg.thermostat == "vr" and rescale_noise is None:
                rescale_noise = _draw(gen, (), state.vel,
                                      "the CSVR thermostat")
            state = _rescale_thermostat(spec, cfg, state, rescale_noise)
        if cfg.barostat != "no":
            if cfg.barostat != "br" and baro_noise is None:
                baro_noise = _draw(gen, (), state.baro_v,
                                   "the Langevin barostat")
            state = _barostat_step(spec, cfg, state, baro_noise, pair_kernel)
        return state
