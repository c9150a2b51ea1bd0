"""The reactive trimer LJ melt: build, warmup and initiator activation.

Port of ``build_melt``, ``warmup`` and ``activate_initiators`` from
``chemlab_tpu/testsystems.py``.  The melt's topology text, coordinates and
reaction cfg are imported from the reference module, which is jax-free at
import.  ``build_melt`` reproduces the reference's build bit for bit
(initial velocities included: both draw from ``np.random.RandomState``);
``warmup`` re-draws velocities from a ``torch.Generator``, so its
velocities differ from the reference's ``jax.random`` draw.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from chemlab_tpu import reaction_parser, topfile
from chemlab_tpu.testsystems import (ATRP_CFG_TEXT, _melt_topology_text,
                                     melt_coordinates)
from chemlab_tpu.topology import compile_system_topology

from .engine import build, integrate, runner


def build_melt(n_mols: int = 2000, density: float = 0.27, kT: float = 1.0,
               reactive: bool = True, seed: int = 42, device="cpu",
               **opt_overrides):
    """Build the reactive melt on ``device``; returns (BuiltSystem,
    SystemTopology, Coordinates) like the reference."""
    top = topfile.parse_lines(_melt_topology_text(n_mols).splitlines(),
                              "<generated>")
    systop = compile_system_topology(top)
    coords = melt_coordinates(n_mols, density, seed=seed)
    rcfg = None
    if reactive:
        rcfg = reaction_parser.parse_config_lines(ATRP_CFG_TEXT.splitlines())
    # capacity sizing for liquid density (the reference's choice)
    rc_skin = 2.5 + 0.4
    k_liq = int(0.95 * 4.0 / 3.0 * np.pi * rc_skin**3 * 1.25)
    opts_kw = dict(lj_cutoff=2.5, cg_cutoff=2.5, skin=0.4, dt=0.0025, kT=kT,
                   thermostat="lv", thermostat_gamma=1.0, gen_velocity=True,
                   rng_seed=seed, max_neighbors=-(-k_liq // 8) * 8)
    opts_kw.update(opt_overrides)
    built = build.build_system(systop, coords, build.SimOptions(**opts_kw),
                               reaction_config=rcfg, device=device)
    return built, systop, coords


def warmup(built, state, steps: int = 400, max_disp: float = 0.05, kT=None,
           seed: int = 7):
    """Resolve overlaps by displacement-capped steepest descent (each
    particle moves along its force by at most ``max_disp``), then draw
    Maxwell-Boltzmann velocities and recompute forces."""
    spec, cfg = built.spec, built.cfg
    for _ in range(steps):
        state = integrate.maybe_rebuild_neighbors(spec, cfg, state)
        force, _, _ = integrate.compute_forces(spec, cfg, state)
        # overflow-safe normalisation: |F| can exceed 1e21 on overlaps
        fmax = torch.amax(torch.abs(force), dim=-1, keepdim=True)
        nonzero = fmax > 0.0
        fdir = torch.where(nonzero,
                           force / torch.where(nonzero, fmax, 1.0), 0.0)
        fnorm = torch.sqrt(torch.sum(fdir**2, dim=-1, keepdim=True))
        ok = fnorm > 0.0
        unit = torch.where(ok, fdir / torch.where(ok, fnorm, 1.0), 0.0)
        step_len = torch.clamp(fmax * fnorm * 1e-4, max=max_disp)
        pos = state.pos + torch.where(state.active[:, None],
                                      unit * step_len, 0.0)
        shift = torch.floor(pos / state.box)
        state = dataclasses.replace(state, pos=pos - shift * state.box)
    tgt = float(spec.kT) if kT is None else kT
    gen = runner.make_generator(seed, state.device)
    v = torch.randn(state.vel.shape, generator=gen, dtype=state.vel.dtype,
                    device=state.device)
    v = v * torch.sqrt(tgt / state.mass)[:, None]
    v = torch.where(state.active[:, None], v, 0.0)
    mtot = torch.sum(torch.where(state.active, state.mass, 0.0))
    v = v - torch.sum(state.mass[:, None] * v, dim=0) / mtot
    v = torch.where(state.active[:, None], v, 0.0)
    state = dataclasses.replace(state, vel=v,
                                step=torch.zeros_like(state.step))
    return runner.initial_forces(spec, cfg, state)


def activate_initiators(built, systop, state, n: int = 20, seed: int = 1):
    """Flip n MA monomers to FA radicals in state 3 and switch reactions on
    (the same numpy draw as the reference)."""
    tsym = systop.atomsym_atomtype
    rng = np.random.RandomState(seed)
    type_id = state.type_id.cpu().numpy()
    rows = np.where((type_id == tsym["MA"])
                    & state.active.cpu().numpy())[0]
    picks = torch.from_numpy(rng.choice(rows, n, replace=False)).to(
        state.device)
    tid = state.type_id.clone()
    tid[picks] = tsym["FA"]
    chem = state.chem_state.clone()
    chem[picks] = 3
    return dataclasses.replace(
        state, type_id=tid, chem_state=chem,
        reactions_on=torch.ones((), dtype=torch.bool, device=state.device))
