"""The pair sum split by x-slab over the ranks of a process group.

Port of ``chemlab_tpu/engine/pallas_halo.py`` (the reference's multi-device
path, its answer to the reference MD code's domain decomposition).  The
cell grid is cut along x into D slabs of w = nx / D layers; rank r sums
the pairs of its slab's cells with K1f, the pair kernel in ``x_halo`` mode
(``cell_pair.pair_rows(..., x_halo=True)``), on a slab of w + 2 layers: its
own and one halo layer on each side, layers (r*w - 1) mod nx ...
((r+1)*w) mod nx.

The reference row-shards the rest of the step through XLA's partitioner
and fetches the halo layers with ``ppermute``.  Here every rank holds the
whole state, replicated (``parallel.sharding``), so it reads its halo
layers from its own bucket table and needs no exchange.  Each rank
gathers its own particles' force rows through ``slot_of`` (zero for a
particle outside its slab), and one ``all_reduce`` sums the (N, 3) forces
and the spare-channel scalar over the ranks.  A particle's force is
nonzero on exactly one rank, so the summed forces equal the one-rank
path's bit for bit (K1f's rows are K1's rows); the scalar is a sum of D
partial sums, equal to the one-rank sum to f32 rounding.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from . import cell_pair


def supports(cfg) -> bool:
    """The slab path runs on a mesh of two or more ranks whose count
    divides the x-layer count (reference: ``pallas_halo.supports``), on a
    grid of at least 3 x-layers: with 2, the two halo layers of a slab
    would be one layer, counted twice (the reference does so; ROADMAP,
    Queue 3), and the one-rank path takes K2 there."""
    mesh = cfg.mesh
    if mesh is None or mesh.world_size < 2:
        return False
    nx = int(cfg.cell_dims[0])
    return nx >= 3 and nx % mesh.world_size == 0


def slab_layers(nx: int, n_ranks: int, rank: int) -> list:
    """The w + 2 x-layers of ``rank``'s haloed slab, in order."""
    w = nx // n_ranks
    return [(rank * w - 1 + k) % nx for k in range(w + 2)]


@functools.lru_cache(maxsize=None)
def slab_cells(dims, n_ranks: int, rank: int, device):
    """The full-grid cell ids of ``rank``'s haloed slab, made once per
    (grid, mesh, rank) on ``device``: a host copy per call would
    synchronise the stream."""
    nx, ny, nz = dims
    layer = ny * nz
    ids = [x * layer + k for x in slab_layers(nx, n_ranks, rank)
           for k in range(layer)]
    return torch.tensor(ids, dtype=torch.long, device=device)


def cell_pair_forces_halo(pos, type_id, active, box, buckets, slot_of, dims,
                          spec, n_types: int, mesh, uniform_lj: bool = False,
                          all_lj: bool = False, want_energy: bool = True,
                          want_virial: bool = False, cheb_kw: int = 0,
                          cheb_ko: int = 0, cheb_ntab: int = 0,
                          cheb_mix: bool = False, obs_x=None):
    """``cell_pair.cell_pair_forces`` (same arguments, same return tuple)
    summed slab by slab over ``mesh``'s ranks; every rank returns the
    same result.  Raises on a grid K1 cannot take (the reference's slab
    path has no per-cell fallback either) or one the mesh does not cut."""
    nx, ny, nz = (int(d) for d in dims)
    cap = buckets.shape[1]
    n_ranks, rank = mesh.world_size, mesh.rank
    if not cell_pair.colt_legal(cap, dims):
        raise ValueError("the slab path needs a K1 grid (cap %% 8 == 0, "
                         "min(dims) >= 3): cap %d, dims %s" % (cap, dims))
    if n_ranks < 2 or nx % n_ranks:
        raise ValueError("%d ranks do not cut %d x-layers into slabs"
                         % (n_ranks, nx))
    w = nx // n_ranks
    ids = slab_cells((nx, ny, nz), n_ranks, rank, pos.device)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, type_id, active), buckets[ids], ids.numel())
    out_flat = cell_pair.pair_rows(
        cells, counts, box, (w + 2, ny, nz), spec, n_types, uniform_lj,
        all_lj, want_energy, want_virial, cheb_kw, cheb_ko, cheb_ntab,
        cheb_mix, obs_x, x_halo=True)
    # this rank's slots are [lo, lo + w*ny*nz*cap) of the full grid's
    n_slots = out_flat.shape[0]
    local = slot_of.long() - rank * n_slots
    own = (local >= 0) & (local < n_slots)
    rows_f = out_flat[torch.where(own, local, 0)]
    force = torch.where(own[:, None], rows_f[:, :3], 0.0)
    buf = torch.cat([force.reshape(-1), torch.sum(out_flat[:, 3])[None]])
    dist.all_reduce(buf, group=mesh.group)
    return cell_pair.pair_result(buf[:-1].reshape(force.shape), buf[-1],
                                 want_virial, cheb_kw)
