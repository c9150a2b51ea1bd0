"""The jobs ``launch`` runs on each rank.

A job is ``job(mesh, **kwargs)`` and returns a dict; its tensors go back
to the caller as numpy arrays.  A system arrives as ``bridge.to_numpy``'s
(config, spec, state) triple and is placed on the rank's device with the
rank's mesh on its config, so the engine takes the slab path wherever
``engine.cell_pair_halo.supports`` the config.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import bridge
from ..engine import cell_pair, integrate, runner
from .sharding import meshed_cfg


def _system(mesh, system):
    cfg, spec, state = bridge.from_numpy(*system, mesh.device)
    return meshed_cfg(cfg, mesh), spec, state


def _sync(mesh):
    if mesh.device.startswith("cuda"):
        torch.cuda.synchronize(mesh.device)


def launches() -> dict:
    return {name: k.launches for name, k in cell_pair.BY_NAME.items()}


def forces(mesh, system) -> dict:
    """``compute_forces`` (energies on) and ``virial_pressure`` once."""
    cfg, spec, state = _system(mesh, system)
    force, e, _ = integrate.compute_forces(spec, cfg, state)
    return {"force": force, "e_lj": e["lj"], "e_tab": e["lj-tab"],
            "P": integrate.virial_pressure(spec, cfg, state),
            "launches": launches()}


def run_blocks(mesh, system, n_blocks: int, block_steps: int, seed: int,
               rng_seed: int = 0) -> dict:
    """``n_blocks`` blocks of ``run_block`` (each ends in the replica
    check) with the Langevin noise from ``make_generator(seed)``: the
    final state, each block's wall seconds, the kernels' launches over the
    blocks, then the temperature and overflow flag of the end state."""
    cfg, spec, state = _system(mesh, system)
    gen = runner.make_generator(seed, mesh.device)
    for k in cell_pair.KERNELS:
        k.launches = 0
    walls = []
    for _ in range(n_blocks):
        _sync(mesh)
        t0 = time.perf_counter()
        state = runner.run_block(spec, cfg, state, block_steps, rng_seed,
                                 gen=gen)
        _sync(mesh)
        walls.append(time.perf_counter() - t0)
    counts = launches()
    m = runner.measure(spec, cfg, state)
    return {"pos": state.pos, "vel": state.vel, "box": state.box,
            "bonds_idx": state.bonds.idx, "n_bonds": m["n_bonds"],
            "reaction_counts": state.reaction_counts,
            "n_excl": state.n_excl, "T": m["T"], "overflow": m["overflow"],
            "walls": np.asarray(walls), "launches": counts}


def check_replicas(mesh, system, perturb_rank: int = -1) -> dict:
    """``runner.check_replicas`` on the system, after moving one position
    of rank ``perturb_rank`` by one ulp (none for -1)."""
    cfg, spec, state = _system(mesh, system)
    if mesh.rank == perturb_rank:
        pos = state.pos.clone()
        pos[0, 0] = torch.nextafter(pos[0, 0], pos[0, 0] + 1.0)
        state = dataclasses.replace(state, pos=pos)
    runner.check_replicas(cfg, state)
    return {}


def imported_modules(mesh) -> dict:
    """The modules of jax or of the JAX package this rank has imported."""
    return {"modules": sorted(
        m for m in sys.modules if m in ("jax", "jaxlib", "chemlab_tpu")
        or m.startswith(("jax.", "jaxlib.", "chemlab_tpu.")))}


JOBS = {"forces": forces, "run_blocks": run_blocks,
        "check_replicas": check_replicas,
        "imported_modules": imported_modules}
