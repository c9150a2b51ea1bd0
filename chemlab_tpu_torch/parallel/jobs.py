"""The jobs ``launch`` runs on each rank.

A job is ``job(mesh, **kwargs)`` and returns a dict; its tensors go back
to the caller as numpy arrays.  A system arrives as ``bridge.to_numpy``'s
(config, spec, state) triple and is placed on the rank's device with the
rank's mesh on its config, so the engine takes the slab path wherever
``engine.cell_pair_halo.supports`` the config (and splits the rows on the
row path).  The ``cli`` job runs ``start_simulation.main`` as one rank of
``--node_grid``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import sys
import time

import numpy as np
import torch

from .. import bridge
from ..engine import build, cell_pair, integrate, runner
from .sharding import meshed_cfg


def _system(mesh, system):
    cfg, spec, state = bridge.from_numpy(*system, mesh.device)
    return meshed_cfg(cfg, mesh), spec, state


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def launches() -> dict:
    return {name: k.launches for name, k in cell_pair.BY_NAME.items()}


def forces(mesh, system) -> dict:
    """``compute_forces`` (energies on) and ``virial_pressure`` once."""
    cfg, spec, state = _system(mesh, system)
    force, e, _ = integrate.compute_forces(spec, cfg, state)
    return {"force": force, "e_lj": e["lj"], "e_tab": e["lj-tab"],
            "energies": e, "P": integrate.virial_pressure(spec, cfg, state),
            "launches": launches()}


CAP_CHANGES = {"grow": build.grow_neighbor_caps,
               "shrink": build.shrink_neighbor_caps}


def blocks(spec, cfg, state, n_blocks: int, block_steps: int, gen,
           rng_seed: int = 0, cap_changes=()):
    """``n_blocks`` blocks of ``run_block`` (each ends in the replica
    check) with the noise from ``gen``; after block b, each
    ``(b, "grow" | "shrink")`` of ``cap_changes`` regrows or shrinks the
    neighbour caps (``CAP_CHANGES``), then checks the replicas.  The same
    loop serves one rank (``cfg`` without a mesh).  Returns (cfg, state,
    each block's wall seconds)."""
    walls = []
    for b in range(n_blocks):
        _sync(state.pos.device)
        t0 = time.perf_counter()
        state = runner.run_block(spec, cfg, state, block_steps, rng_seed,
                                 gen=gen)
        _sync(state.pos.device)
        walls.append(time.perf_counter() - t0)
        for after, what in cap_changes:
            if after == b:
                cfg, state = CAP_CHANGES[what](cfg, spec, state)
                runner.check_replicas(cfg, state)
    return cfg, state, walls


def run_blocks(mesh, system, n_blocks: int, block_steps: int, seed: int,
               rng_seed: int = 0, cap_changes=()) -> dict:
    """``blocks`` on this rank with ``make_generator(seed)``'s noise: the
    final state (and its whole tree, as numpy arrays), each block's wall
    seconds, the kernels' launches over the blocks, the final caps, then
    the temperature and overflow flag of the end state."""
    cfg, spec, state = _system(mesh, system)
    gen = runner.make_generator(seed, mesh.device)
    for k in cell_pair.KERNELS:
        k.launches = 0
    cfg, state, walls = blocks(spec, cfg, state, n_blocks, block_steps, gen,
                               rng_seed, cap_changes)
    counts = launches()
    m = runner.measure(spec, cfg, state)
    return {"pos": state.pos, "vel": state.vel, "box": state.box,
            "bonds_idx": state.bonds.idx, "n_bonds": m["n_bonds"],
            "reaction_counts": state.reaction_counts,
            "n_excl": state.n_excl, "T": m["T"], "overflow": m["overflow"],
            "walls": np.asarray(walls), "launches": counts,
            "caps": {f: getattr(cfg, f) for f in build.NEIGHBOR_CAP_FIELDS},
            "state": bridge.tree_to_numpy(state)}


def _nudged(t):
    """``t`` with its first element one ulp up (floats), one up (ints) or
    flipped (bools)."""
    t = t.clone()
    flat = t.view(-1)
    if t.is_floating_point():
        flat[0] = torch.nextafter(flat[0], flat[0] + 1.0)
    elif t.dtype == torch.bool:
        flat[0] = ~flat[0]
    else:
        flat[0] = flat[0] + 1
    return t


def check_replicas(mesh, system, perturb_rank: int = -1,
                   field: str = "pos", catch: bool = False) -> dict:
    """``runner.check_replicas`` on the system, after nudging the first
    element of the state's ``field`` (a dotted name such as "nbr.birth")
    on rank ``perturb_rank`` (none for -1): one ulp, one count or one
    flipped bit.  With ``catch`` the check's error comes back as
    ``{"error": message}`` (None when it passed) instead of failing the
    rank: every rank raises together, after the check's one collective."""
    cfg, spec, state = _system(mesh, system)
    if mesh.rank == perturb_rank:
        *path, leaf = field.split(".")
        trees = [state]
        for name in path:
            trees.append(getattr(trees[-1], name))
        new = _nudged(getattr(trees[-1], leaf))
        for tree, name in zip(reversed(trees), reversed([*path, leaf])):
            new = dataclasses.replace(tree, **{name: new})
        state = new
    if not catch:
        runner.check_replicas(cfg, state)
        return {}
    try:
        runner.check_replicas(cfg, state)
    except RuntimeError as exc:
        return {"error": str(exc)}
    return {"error": None}


class _WriteAudit:
    """The paths under ``root`` that this process opens for writing,
    renames, replaces or removes, recorded by an audit hook (``sys``
    audit events; files that a C library opens itself are not seen)."""

    def __init__(self, root):
        self.root = os.path.realpath(root)
        self.paths = set()
        self.on = False
        sys.addaudithook(self._hook)

    def _hook(self, event, args):
        if not self.on:
            return
        if event == "open":
            path, mode, flags = args
            writing = (any(c in (mode or "") for c in "wax+") if mode
                       else bool(flags & (os.O_WRONLY | os.O_RDWR)))
            if not writing or not isinstance(path, (str, bytes, os.PathLike)):
                return
            paths = [path]
        elif event in ("os.rename", "os.replace", "os.remove"):
            paths = [p for p in args[:2] if isinstance(p, (str, os.PathLike))]
        else:
            return
        for p in paths:
            p = os.path.realpath(os.fsdecode(p))
            if p == self.root or p.startswith(self.root + os.sep):
                self.paths.add(os.path.relpath(p, self.root))


def cli(mesh, argv, cwd, h5md_writer=None) -> dict:
    """``start_simulation.main(argv)`` as this rank of the mesh, in
    ``cwd``: its exit code, its standard output, the kernels' launches
    and the files under ``cwd`` it opened for writing (``_WriteAudit``)."""
    from .. import start_simulation

    audit = _WriteAudit(cwd)
    out = io.StringIO()
    for k in cell_pair.KERNELS:
        k.launches = 0
    os.chdir(cwd)
    audit.on = True
    try:
        with contextlib.redirect_stdout(out):
            rc = start_simulation.main(argv, device=mesh.device, mesh=mesh,
                                       h5md_writer=h5md_writer)
    finally:
        audit.on = False
    return {"rc": rc, "stdout": out.getvalue(), "launches": launches(),
            "writes": sorted(audit.paths)}


def imported_modules(mesh) -> dict:
    """The modules of jax or of the JAX package this rank has imported."""
    return {"modules": sorted(
        m for m in sys.modules if m in ("jax", "jaxlib", "chemlab_tpu")
        or m.startswith(("jax.", "jaxlib.", "chemlab_tpu.")))}


JOBS = {"forces": forces, "run_blocks": run_blocks,
        "check_replicas": check_replicas, "cli": cli,
        "imported_modules": imported_modules}
