"""Run blocks: MD steps with the interval-gated reaction extension.

Port of ``chemlab_tpu/engine/runner.py``.  The reference runs a block as
one ``lax.fori_loop`` program with ``lax.cond`` on the rebuild trigger and
the reaction interval; here a block is a Python loop that branches on the
host.  The reaction gate needs no per-step read: ``reactions_on`` and the
step counter are read once per block and the step is counted on the host.
The rebuild trigger is read every step (``integrate.maybe_rebuild_neighbors``).

The Langevin noise (and the Langevin barostat's draw) comes from a
``torch.Generator`` that the caller owns and passes to ``run_block``
(``make_generator``).

Under a mesh (``parallel.sharding``) every rank holds the whole state and
runs the same step; only the pair sum is split by slab.  The host reads
(the rebuild trigger, the reaction gate) then agree on every rank as long
as the replicas do, which takes the same seed for every rank's generator
and float sums that give the same bits on every call.  ``run_block``
checks at each block's end that the replicas still agree
(``check_replicas``) and raises if they do not.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from . import bonded_dense, excl_dense, integrate, observables, reactions


def make_generator(seed: int, device) -> torch.Generator:
    """The Langevin noise stream for a run on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _hybrid_lambda_ramp(spec, state, cfg=None):
    """Per-step lambda ramp for reaction-created terms (hybrid bonds; the
    angle and dihedral variants); the dense/irregular copies ramp in
    lockstep with the canonical tables."""
    def bond_ramp(t):
        lam = torch.where((t.group >= 0) & (t.lam < 1.0),
                          torch.clamp(t.lam + spec.hybrid_bond_rate, max=1.0),
                          t.lam)
        return dataclasses.replace(t, lam=lam)

    def ramp(t, rate):
        lam = torch.where(t.lam < 1.0, torch.clamp(t.lam + rate, max=1.0),
                          t.lam)
        return dataclasses.replace(t, lam=lam)

    upd = dict(bonds=bond_ramp(state.bonds),
               angles=ramp(state.angles, spec.hybrid_angle_rate),
               dihedrals=ramp(state.dihedrals, spec.hybrid_dihedral_rate))
    if cfg is not None and cfg.bonded_dense and state.bonds_dense is not None:
        upd.update(bonds_dense=bond_ramp(state.bonds_dense),
                   bonds_irr=bond_ramp(state.bonds_irr),
                   angles_dense=ramp(state.angles_dense,
                                     spec.hybrid_angle_rate),
                   angles_irr=ramp(state.angles_irr, spec.hybrid_angle_rate))
    return dataclasses.replace(state, **upd)


def _fire_reactions(spec, cfg, state, rng_seed: int):
    """A reaction step, then the dense operands re-derived from the changed
    tables (the only place inside a block where the tables change)."""
    state = reactions.reaction_step(spec, cfg, state, rng_seed)
    return excl_dense.rederive(cfg, bonded_dense.rederive(cfg, state))


def step_with_extensions(spec, cfg, state, rng_seed: int = 0, gen=None,
                         fire=None, noise=None, pair_kernel: str = "auto"):
    """One MD step + the interval-gated reaction step.  ``fire`` is the
    host's reaction gate; None reads it from the state.  The Langevin noise
    is ``noise`` when given, else drawn from ``gen`` (as is the Langevin
    barostat's draw).  ``pair_kernel`` names the pair kernel
    (``integrate.compute_forces``)."""
    state = integrate.md_step(spec, cfg, state, noise=noise, gen=gen,
                              pair_kernel=pair_kernel)
    if cfg.has_reactions:
        state = _hybrid_lambda_ramp(spec, state, cfg)
        if fire is None:
            fire = (bool(state.reactions_on)
                    and int(state.step) % cfg.reaction_interval == 0)
        if fire:
            state = _fire_reactions(spec, cfg, state, rng_seed)
    return state


def run_block(spec, cfg, state, n_steps: int, rng_seed: int = 0, gen=None,
              pair_kernel: str = "auto"):
    """Run ``n_steps`` steps (one outer-loop iteration) with the pair kernel
    ``pair_kernel``; under a mesh, then check that the ranks' replicas still
    agree."""
    on = cfg.has_reactions and bool(state.reactions_on)
    step0 = int(state.step)
    for k in range(n_steps):
        fire = on and (step0 + k + 1) % cfg.reaction_interval == 0
        state = step_with_extensions(spec, cfg, state, rng_seed, gen=gen,
                                     fire=fire, pair_kernel=pair_kernel)
    check_replicas(cfg, state)
    return state


def _replica_fields(state):
    """(name, tensor) of the state the replicas must agree on, in the
    order ``check_replicas`` names the first that differs."""
    return [("pos", state.pos), ("vel", state.vel), ("force", state.force),
            ("box", state.box), ("bonds.idx", state.bonds.idx),
            ("bonds.valid", state.bonds.valid),
            ("bonds.lam", state.bonds.lam), ("type_id", state.type_id),
            ("chem_state", state.chem_state),
            ("reaction_counts", state.reaction_counts),
            ("n_excl", state.n_excl)]


def _bits_hash(t):
    """A 0-d int64 hash of a tensor's bits, below 2**62: the sum of each
    element's bits plus a constant, weighted by 2k + 1 at position k, so
    any change of one element (one ulp included) changes it."""
    if t.is_floating_point():
        v = t.contiguous().view(torch.int32 if t.element_size() == 4
                                else torch.int64).to(torch.int64)
    else:
        v = t.to(torch.int64)
    v = v.reshape(-1) + 0x5BD1E995
    w = 2 * torch.arange(v.numel(), dtype=torch.int64, device=v.device) + 1
    return torch.sum(v * w) & ((1 << 62) - 1)


def check_replicas(cfg, state):
    """Under a mesh of two or more ranks: one ``all_reduce`` (MAX of each
    field's hash and of its negation, so the MAX and the MIN) tells
    whether every rank holds the same bits; raises naming the first field
    that differs.  A no-op without a mesh."""
    mesh = cfg.mesh
    if mesh is None or mesh.world_size < 2:
        return
    fields = _replica_fields(state)
    h = torch.stack([_bits_hash(t) for _, t in fields])
    both = torch.cat([h, -h])
    dist.all_reduce(both, op=dist.ReduceOp.MAX, group=mesh.group)
    differs = (both[:len(fields)] != -both[len(fields):]).tolist()
    if any(differs):
        raise RuntimeError(
            "the %d ranks' replicas of the state differ, first in %s "
            "(rank %d)" % (mesh.world_size, fields[differs.index(True)][0],
                           mesh.rank))


def initial_forces(spec, cfg, state):
    """Populate state.force before the first step."""
    force, _, _ = integrate.compute_forces(spec, cfg, state)
    return dataclasses.replace(state, force=force)


def _counts(cfg, state, out):
    out["reaction_counts"] = state.reaction_counts
    out["n_bonds"] = state.bonds.valid.sum(dtype=torch.int32)
    out["n_angles"] = state.angles.valid.sum(dtype=torch.int32)
    out["n_dihedrals"] = state.dihedrals.valid.sum(dtype=torch.int32)
    out["n_excl"] = state.n_excl
    if cfg.bonded_dense:
        out["n_bonds_irr"] = state.bonds_irr.valid.sum(dtype=torch.int32)
        out["n_angles_irr"] = state.angles_irr.valid.sum(dtype=torch.int32)
    if cfg.excl_offsets and state.excl_irr is not None:
        out["n_excl_irr"] = (state.excl_irr[:, 0] >= 0).sum(dtype=torch.int32)
    if cfg.n_groups:
        out["group_bonds"] = observables.group_bond_counts(state.bonds,
                                                           cfg.n_groups)
    return out


def measure_cheap(spec, cfg, state):
    """Per-block bookkeeping without the force recompute."""
    out = {"conversions": observables.conversions(
               spec, state.type_id, state.chem_state, state.active),
           "overflow": state.nbr.overflow}
    return _counts(cfg, state, out)


def measure(spec, cfg, state):
    """One observable pass: energies, temperature, counters, and the
    pressure and box edge under a barostat or ``store_pressure``."""
    force, energies, _ = integrate.compute_forces(spec, cfg, state)
    out = dict(energies)
    out["T"] = observables.temperature(state.mass, state.vel, state.active,
                                       spec.thermal_type_mask, state.type_id)
    out["ekin"] = observables.kinetic_energy(state.mass, state.vel,
                                             state.active)
    out["epot"] = sum(energies.values())
    out["conversions"] = observables.conversions(
        spec, state.type_id, state.chem_state, state.active)
    if cfg.barostat != "no" or cfg.store_pressure:
        out["P"] = integrate.virial_pressure(spec, cfg, state)
        out["boxL"] = state.box[0]
    _counts(cfg, state, out)
    out["n_part"] = state.active.sum(dtype=torch.int32)
    out["max_force"] = observables.max_force(force, state.active)
    if cfg.has_reactions:
        chem_rows = state.bonds.valid & (state.bonds.group >= 0)
        nsel = torch.clamp(chem_rows.sum(), min=1)
        out["res_fpl"] = torch.sum(torch.where(chem_rows, state.bonds.lam,
                                               0.0)) / nsel
    out["overflow"] = state.nbr.overflow
    return out
