"""Observables: conversions, temperature, kinetic energy, max force and
bond counts per reaction group.

Port of ``chemlab_tpu/engine/observables.py`` (the reductions the melt's
``measure`` reads).
"""

from __future__ import annotations

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
