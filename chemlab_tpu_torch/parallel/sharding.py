"""Slab meshes and the placement of a built system on a rank.

Port of ``chemlab_tpu/parallel/sharding.py``, with the reference's names.
The reference row-shards the state over a JAX mesh and leaves the split of
the step to XLA's partitioner; PyTorch has none, and a row-sharded torch
step would need collectives in every module.  So here every rank of a
``torch.distributed`` process group holds the whole state, replicated, and
runs the same step; only the pair sum is split, by x-slab
(``engine.cell_pair_halo``) or, on the row path, by blocks of rows
(``engine.integrate.row_pair_forces``), and combined with one
``all_reduce``.  A
``SlabMesh`` names the group, the rank and the device its tensors live on;
``meshed_cfg`` puts it on the config, which turns the slab path on.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class SlabMesh:
    """This rank's view of the process group: frozen and hashable, so an
    ``EngineConfig`` can carry it (the group itself is left out of the
    comparison)."""

    rank: int
    world_size: int
    device: str
    group: object = dataclasses.field(default=None, compare=False)


def make_mesh(n_devices: int | None = None, node_grid=None,
              device=None) -> SlabMesh:
    """The mesh of the initialised default process group.

    ``node_grid`` takes the reference's ``x,y,z`` process-grid flag and
    flattens it to a rank count, as the reference does.  Asking for more
    ranks than the group has raises, as in the reference; a slab mesh spans
    the whole group, so asking for fewer raises too.  ``device`` is where
    this rank's tensors live: ``cuda:LOCAL_RANK`` by default (one card per
    rank), ``cuda:0`` for every rank sharing one card, ``cpu`` only when
    the caller passes it."""
    if node_grid is not None:
        if isinstance(node_grid, str):
            node_grid = tuple(int(x) for x in node_grid.split(","))
        n_devices = int(np.prod(node_grid))
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (parallel.launch starts one)")
    world = dist.get_world_size()
    if n_devices is not None and n_devices > world:
        raise ValueError("requested %d devices, only %d available"
                         % (n_devices, world))
    if n_devices is not None and n_devices < world:
        raise ValueError("a slab mesh spans the whole process group: %d "
                         "ranks requested of %d" % (n_devices, world))
    rank = dist.get_rank()
    if device is None:
        device = "cuda:%d" % int(os.environ.get("LOCAL_RANK", rank))
    return SlabMesh(rank=rank, world_size=world, device=str(device),
                    group=dist.group.WORLD)


def meshed_cfg(cfg, mesh: SlabMesh):
    """The ``EngineConfig`` carrying ``mesh``."""
    return dataclasses.replace(cfg, mesh=mesh)


def shard_state(mesh: SlabMesh, state):
    """The state on this rank's device: every rank holds all of it."""
    return state.to(mesh.device)


def shard_system(built, mesh: SlabMesh):
    """A built system's (spec, state) on this rank's device; pair with
    :func:`meshed_cfg`."""
    return built.spec.to(mesh.device), shard_state(mesh, built.state)
