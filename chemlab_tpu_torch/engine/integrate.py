"""Velocity-Verlet integration with a Langevin thermostat.

Port of ``chemlab_tpu/engine/integrate.py`` for the slice: ``compute_forces``
on the cell-tile path (kernel sum minus the excluded-pair correction, plus
bonded forces, plus the global CapForce; LJ or Chebyshev-tabulated pairs,
with the conversion observables computed on the device when a func-10
blend reads them), ``_langevin_adjust``,
``maybe_rebuild_neighbors`` in its lazy-row branch, and ``md_step``.

The Langevin noise is an argument: ``md_step`` takes either the noise
tensor itself (the tests pass the reference's draw) or a ``torch.Generator``
to draw it from.  The rebuild trigger is read on the host each step.
"""

from __future__ import annotations

import dataclasses

import torch

from . import bonded_forces, cell_pair, excl_dense, neighbor, observables


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


def compute_forces(spec, cfg, state, want_energy: bool = True):
    """All conservative forces + per-term potential energies + conversions.

    ``want_energy=False`` (the per-step call) skips the pair-energy channel;
    the returned pair energies are then zeros."""
    if cfg.needs_conversions:
        obs_x = observables.conversions(spec, state.type_id, state.chem_state,
                                        state.active)
    else:
        obs_x = torch.zeros(spec.obs_total.shape[0], dtype=torch.float32,
                            device=state.pos.device)
    f_all, e_lj_all, e_tab_all, _ = cell_pair.cell_pair_forces(
        state.pos, state.type_id, state.active, state.box, state.nbr.buckets,
        state.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, want_energy=want_energy,
        cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0, cheb_ko=cfg.cheb_ko,
        cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix, obs_x=obs_x)
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


def md_step(spec, cfg, state, noise=None, gen=None):
    """One velocity-Verlet step.  With the Langevin thermostat the noise is
    ``noise`` when given, else a standard normal draw from ``gen``."""
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
    force, _, _ = compute_forces(spec, cfg, state, want_energy=False)
    if cfg.thermostat == "lv":
        if noise is None:
            if gen is None:
                raise ValueError("Langevin md_step needs noise or a "
                                 "torch.Generator")
            noise = torch.randn(state.vel.shape, generator=gen,
                                dtype=state.vel.dtype, device=state.device)
        force = _langevin_adjust(spec, state, force, noise)

    vel = state.vel + 0.5 * dt * force * inv_m
    return dataclasses.replace(state, vel=vel, force=force,
                               step=state.step + 1)
