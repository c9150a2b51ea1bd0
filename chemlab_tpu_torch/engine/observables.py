"""Observables: conversions, temperature, kinetic energy, max force, bond
counts per reaction group, the centre-of-mass velocity reset and the
angle histogram.

Port of ``chemlab_tpu/engine/observables.py`` (the reductions ``measure``
reads, the CLI's start-up reset and the hooks' ``AngleDistribution``).
"""

from __future__ import annotations

import math

import torch

from .state import TermTable


def conversions(spec, type_id, chem_state, active) -> torch.Tensor:
    """Conversion observables x_o = count_o / total_o, (n_obs,) float32."""
    n_obs = spec.obs_total.shape[0]
    counts = torch.zeros(n_obs, dtype=torch.float32, device=type_id.device)
    for e in range(spec.obs_entry_obs.shape[0]):
        t = spec.obs_entry_type[e]
        s = spec.obs_entry_state[e]
        match = active & (type_id == t) & ((s < 0) | (chem_state == s))
        counts = counts.index_add(0, spec.obs_entry_obs[e:e + 1].long(),
                                  match.sum().to(torch.float32)[None])
    return counts / torch.clamp(spec.obs_total, min=1.0)


def kinetic_energy(mass, vel, active) -> torch.Tensor:
    v2 = torch.sum(vel * vel, dim=-1)
    return 0.5 * torch.sum(torch.where(active, mass * v2, 0.0))


def temperature(mass, vel, active, type_mask=None,
                type_id=None) -> torch.Tensor:
    """Instantaneous kT = 2 Ekin / (3 N) over the thermal group."""
    sel = active
    if type_mask is not None and type_id is not None:
        sel = sel & type_mask[type_id.long()]
    v2 = torch.sum(vel * vel, dim=-1)
    ekin = 0.5 * torch.sum(torch.where(sel, mass * v2, 0.0))
    n = torch.clamp(sel.sum(), min=1)
    return 2.0 * ekin / (3.0 * n)


def group_bond_counts(bonds: TermTable, n_groups: int) -> torch.Tensor:
    """Valid bonds per reaction group, (G,) int32."""
    valid = bonds.valid
    grp = torch.where(valid, bonds.group, n_groups)
    counts = torch.zeros(n_groups + 1, dtype=torch.int32,
                         device=bonds.idx.device)
    counts.index_add_(0, torch.clamp(grp, 0, n_groups).long(),
                      (valid & (bonds.group >= 0)).to(torch.int32))
    return counts[:n_groups]


def max_force(force, active) -> torch.Tensor:
    f2 = torch.sum(force * force, dim=-1)
    return torch.sqrt(torch.max(torch.where(active, f2, 0.0)))


def cm_velocity(mass, vel, active) -> torch.Tensor:
    m = torch.where(active, mass, 0.0)
    p = torch.sum(m[:, None] * vel, dim=0)
    return p / torch.clamp(torch.sum(m), min=1e-30)


def reset_cm_velocity(mass, vel, active) -> torch.Tensor:
    """The velocities with the centre-of-mass drift removed (the
    reference's ``CMVelocity().reset()``)."""
    v_cm = cm_velocity(mass, vel, active)
    return torch.where(active[:, None], vel - v_cm, vel)


def angle_distribution(pos, box, angles: TermTable,
                       n_bins: int = 180) -> torch.Tensor:
    """Histogram of the valid angle-table angles over [0, pi], (n_bins,)
    int32 (espressopp's ``analysis.AngleDistribution``)."""
    i, j, k = (torch.clamp(angles.idx[:, c], min=0).long() for c in range(3))
    valid = angles.idx[:, 0] >= 0
    rij = pos[i] - pos[j]
    rij = rij - box * torch.round(rij / box)
    rkj = pos[k] - pos[j]
    rkj = rkj - box * torch.round(rkj / box)
    nij = torch.sqrt(torch.sum(rij * rij, -1) + 1e-30)
    nkj = torch.sqrt(torch.sum(rkj * rkj, -1) + 1e-30)
    c = torch.clamp(torch.sum(rij * rkj, -1) / (nij * nkj), -1.0, 1.0)
    theta = torch.arccos(c)
    bins = torch.clamp((theta / math.pi * n_bins).to(torch.int32), 0,
                       n_bins - 1)
    hist = torch.zeros(n_bins + 1, dtype=torch.int32, device=pos.device)
    hist.index_add_(0, torch.where(valid, bins, n_bins).long(),
                    torch.ones_like(bins))
    return hist[:n_bins]
