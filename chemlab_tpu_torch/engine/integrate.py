"""Velocity-Verlet integration with a Langevin thermostat and barostats.

Port of ``chemlab_tpu/engine/integrate.py`` for the slice: ``compute_forces``
on the cell-tile path (kernel sum minus the excluded-pair correction, plus
bonded forces, plus the global CapForce; LJ or Chebyshev-tabulated pairs,
with the conversion observables computed on the device when a func-10
blend reads them; the kernel sum split by x-slab over the ranks of a mesh
when ``cell_pair_halo.supports`` the config), ``_langevin_adjust``, ``virial_pressure`` in its kernel
branch (the kernel's pair-virial channel minus the excluded pairs' share,
minus the bonded strain derivative), ``_barostat_step`` (Berendsen and the
Langevin piston), ``maybe_rebuild_neighbors`` in its lazy-row branch, and
``md_step``.

The noise is an argument: ``md_step`` takes the Langevin noise tensor and
the Langevin barostat's scalar draw (the tests pass the reference's draws)
or a ``torch.Generator`` to draw them from, the thermostat's first.  The
rebuild trigger is read on the host each step; the box stays on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from . import (bonded_forces, cell_pair, cell_pair_halo, excl_dense,
               neighbor, observables)


def _dense_of(cfg, state):
    """The derived dense/irregular bonded operands, when enabled."""
    if cfg.bonded_dense and state.bonds_dense is not None:
        return (state.bonds_dense, state.bonds_irr, state.angles_dense,
                state.angles_irr)
    return None


def _excl_correction(spec, cfg, state, obs_x):
    """Excluded-pair correction: the dense-static leg when derived operands
    exist, else the flat-list correction."""
    kwargs = dict(active=state.active,
                  cheb=(cfg.cheb_kw, cfg.cheb_ko) if cfg.tab_cheb else None,
                  cheb_mix=cfg.cheb_mix, obs_x=obs_x)
    if cfg.excl_offsets and state.excl_masks is not None:
        return excl_dense.correction(spec, cfg, state.pos, state.box,
                                     state.type_id, state.excl_masks,
                                     state.excl_irr, **kwargs)
    return cell_pair.excluded_pair_correction(
        spec, cfg.n_types, state.pos, state.box, state.type_id, state.excl,
        **kwargs)


def _pair_sum(spec, cfg, state, **kw):
    """The unexcluded all-pairs sum: slab by slab over the mesh's ranks
    (K1f) where the slab path takes the config, else on the whole grid."""
    args = (state.pos, state.type_id, state.active, state.box,
            state.nbr.buckets, state.nbr.slot_of, cfg.cell_dims, spec,
            cfg.n_types)
    kw.update(uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj,
              cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0, cheb_ko=cfg.cheb_ko,
              cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix)
    if cell_pair_halo.supports(cfg):
        cell_pair.check_pair_kernel(kw.pop("kernel"), slab=True)
        return cell_pair_halo.cell_pair_forces_halo(*args, mesh=cfg.mesh,
                                                    **kw)
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
    f_all, e_lj_all, e_tab_all, _ = _pair_sum(spec, cfg, state,
                                              want_energy=want_energy,
                                              obs_x=obs_x, kernel=pair_kernel)
    f_ex, e_lj_ex, e_tab_ex, _ = _excl_correction(spec, cfg, state, obs_x)
    f_pair = f_all - f_ex
    e_pair = {"lj": e_lj_all - e_lj_ex, "lj-tab": e_tab_all - e_tab_ex,
              "coulomb": torch.zeros((), dtype=state.pos.dtype,
                                     device=state.pos.device)}
    f_bond, e_bond = bonded_forces.bonded_forces(
        spec, cfg, state.pos, state.box, state.type_id, state.bonds,
        state.angles, dense=_dense_of(cfg, state))
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


def _langevin_adjust(spec, state, force, noise):
    """Langevin friction + noise folded into the force array."""
    sel = state.active & spec.thermal_type_mask[state.type_id.long()]
    m = state.mass[:, None]
    amp = torch.sqrt(2.0 * spec.kT * spec.gamma * m / spec.dt)
    adj = -spec.gamma * m * state.vel + amp * noise
    return force + torch.where(sel[:, None], adj, 0.0)


def virial_pressure(spec, cfg, state, pair_kernel: str = "auto"):
    """Instantaneous pressure P = (2 Ekin + W) / 3V (reference: the kernel
    branch of ``integrate.virial_pressure``).  W is the pair virial from
    the kernel's virial channel (K1/K1b or K2; K1c/K1d/K1e on a tabulated
    system) minus the excluded pairs' share, minus the bonded strain
    derivative dU_bonded/ds; on a mesh the kernel's channel is summed slab
    by slab (K1f); ``pair_kernel`` as in ``compute_forces``.  The row
    path's branch waits for M10."""
    obs_x = (observables.conversions(spec, state.type_id, state.chem_state,
                                     state.active) if cfg.cheb_mix else None)
    _, _, _, w_all = _pair_sum(spec, cfg, state, want_virial=True,
                               obs_x=obs_x, kernel=pair_kernel)
    _, _, _, w_ex = _excl_correction(spec, cfg, state, obs_x)
    w = (w_all - w_ex) - bonded_forces.bonded_strain_derivative(
        spec, cfg, state.pos, state.box, state.type_id, state.bonds,
        state.angles, dense=_dense_of(cfg, state))
    ekin = observables.kinetic_energy(state.mass, state.vel, state.active)
    return (2.0 * ekin + w) / (3.0 * torch.prod(state.box))


def _barostat_step(spec, cfg, state, noise=None, pair_kernel: str = "auto"):
    """Isotropic box scaling (reference ``integrate._barostat_step``).

    'br': Berendsen, mu = clip(1 - dt/tau (P0 - P), 0.9, 1.1)^(1/3);
    'lv': Langevin piston on ``baro_v`` with friction gammaP and the scalar
    standard normal ``noise``, mu = exp(dt baro_v).  Either way mu is
    clipped to 0.98-1.02 per step; active positions and the box scale by
    it.  The pressure pass runs ``pair_kernel``."""
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


def maybe_rebuild_neighbors(spec, cfg, state):
    """Refresh the cell buckets when the skin criterion fires (read on the
    host)."""
    if not bool(neighbor.needs_rebuild(state.pos, state.nbr, state.box,
                                       spec.skin)):
        return state
    nbr = neighbor.refresh_buckets(state.nbr, state.pos, state.box,
                                   state.active, dims=cfg.cell_dims,
                                   cell_cap=cfg.cell_cap)
    return dataclasses.replace(state, nbr=nbr)


def _draw(gen, shape, like, what: str):
    if gen is None:
        raise ValueError("%s needs its noise or a torch.Generator" % what)
    return torch.randn(shape, generator=gen, dtype=like.dtype,
                       device=like.device)


def md_step(spec, cfg, state, noise=None, gen=None, baro_noise=None,
            pair_kernel: str = "auto"):
    """One velocity-Verlet step, then the barostat.  With the Langevin
    thermostat the noise is ``noise`` when given, else a standard normal
    draw from ``gen``; the Langevin barostat's scalar draw is
    ``baro_noise`` when given, else drawn from ``gen`` after it.  The force
    and the pressure passes run the pair kernel ``pair_kernel``."""
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
    if cfg.barostat != "no":
        if cfg.barostat != "br" and baro_noise is None:
            baro_noise = _draw(gen, (), state.baro_v,
                               "the Langevin barostat")
        state = _barostat_step(spec, cfg, state, baro_noise, pair_kernel)
    return state
