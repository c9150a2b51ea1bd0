"""Cell binning: the port's buckets against the reference's, integer for
integer.

Bucket order follows a stable sort of the cell ids (``jnp.argsort`` is
stable; the port passes ``stable=True``), and ``slot_of`` is its exact
inverse, so ``buckets``, ``slot_of``, ``ci`` and ``overflow`` must be
exactly equal.  Inputs are seeded numpy positions on the 70-trimer melt's
box and grid (3x3x3 cells, cap 24).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import neighbor as rnb
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import neighbor as pnb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def melt():
    built, _, _ = rts.build_melt(n_mols=70, reactive=True, use_pallas=True)
    return built


def _positions(built, kind: str):
    """(pos, active) of the melt's padded shape, made from a seed."""
    st = built.state
    box = np.array(st.box)
    n = st.pos.shape[0]
    active = np.asarray(st.active).copy()
    rng = np.random.RandomState(11)
    if kind == "melt":
        pos = np.array(st.pos)
    elif kind == "uniform":
        pos = (rng.uniform(0.0, 1.0, (n, 3)) * box).astype(np.float32)
    elif kind == "clustered":
        # every particle in two cells: many equal keys, overflow at cap 24
        corner = rng.uniform(0.0, 0.3, (n, 3)) * box / 3.0
        corner[::2] += box / 3.0
        pos = corner.astype(np.float32)
    elif kind == "inactive":
        pos = np.array(st.pos)
        active[rng.uniform(size=n) < 0.3] = False
    elif kind == "edges":
        # exactly on cell faces and on the box edge (clamped to the last cell)
        pos = (rng.randint(0, 4, (n, 3)) * box / 3.0).astype(np.float32)
        pos = np.minimum(pos, np.nextafter(box, 0).astype(np.float32))
    else:
        raise ValueError(kind)
    return pos, active, box


@pytest.mark.parametrize("kind", ["melt", "uniform", "clustered",
                                  "inactive", "edges"])
def test_build_cell_buckets_exact(melt, kind):
    cfg = melt.cfg
    pos, active, box = _positions(melt, kind)
    ref = rnb.build_cell_buckets(jnp.asarray(pos), jnp.asarray(box),
                                 jnp.asarray(active), cfg.cell_dims,
                                 cfg.cell_cap)
    got = pnb.build_cell_buckets(torch.from_numpy(pos), torch.from_numpy(box),
                                 torch.from_numpy(active), cfg.cell_dims,
                                 cfg.cell_cap)
    for name, r, g in zip(("buckets", "ci", "overflow", "slot_of"), ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    if kind == "clustered":
        assert bool(got[2])


def test_refresh_buckets_and_rebuild_trigger(melt):
    cfg, spec = melt.cfg, melt.spec
    _, _, pst = bridge.from_trees(cfg, spec, melt.state, "cpu")
    rng = np.random.RandomState(3)
    skin = float(spec.skin)
    # displacements just below and just above the skin/2 trigger
    for scale, fires in ((0.45 * skin / np.sqrt(3), False),
                         (0.55 * skin, True)):
        d = np.zeros_like(np.asarray(melt.state.pos))
        d[rng.randint(0, cfg.n_particles)] = scale
        pos = np.mod(np.asarray(melt.state.pos) + d,
                     np.asarray(melt.state.box)).astype(np.float32)
        r_fire = rnb.needs_rebuild(jnp.asarray(pos), melt.state.nbr,
                                   melt.state.box, spec.skin)
        p_fire = pnb.needs_rebuild(torch.from_numpy(pos), pst.nbr, pst.box,
                                   pst.box.new_tensor(skin))
        assert bool(r_fire) == bool(p_fire) == fires
    ref = rnb.refresh_buckets(melt.state.nbr, jnp.asarray(pos),
                              melt.state.box, melt.state.active,
                              dims=cfg.cell_dims, cell_cap=cfg.cell_cap)
    got = pnb.refresh_buckets(pst.nbr, torch.from_numpy(pos), pst.box,
                              pst.active, dims=cfg.cell_dims,
                              cell_cap=cfg.cell_cap)
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(ref, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("excl_cap", [4, 16])
def test_build_exclusion_rows_exact(melt, excl_cap):
    """Per-particle exclusion rows; cap 4 overflows on the melt's middle
    beads (two 1-2 and up to two 1-3 partners plus reaction pairs)."""
    st = melt.state
    excl = np.asarray(st.excl).copy()
    # a few extra irregular pairs, so rows hold more than the chain pattern
    n_excl = int(st.n_excl)
    excl[n_excl:n_excl + 4] = [[0, 7], [7, 30], [0, 30], [5, 7]]
    n_pad = st.pos.shape[0]
    r_rows, r_ovf = rnb.build_exclusion_rows(jnp.asarray(excl), n_pad,
                                             excl_cap)
    p_rows, p_ovf = pnb.build_exclusion_rows(torch.from_numpy(excl), n_pad,
                                             excl_cap)
    np.testing.assert_array_equal(p_rows.numpy(), np.asarray(r_rows))
    assert bool(p_ovf) == bool(r_ovf) == (excl_cap == 4)


def test_build_neighbor_state_exact(melt):
    """The build-time K-nearest rows and their exclusion mask."""
    cfg = melt.cfg
    pos, active, box = _positions(melt, "uniform")
    excl = melt.state.excl
    rc = 2.5 + 0.4
    kw = dict(dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
              max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap)
    ref = rnb.build_neighbor_state(jnp.asarray(pos), jnp.asarray(box),
                                   jnp.asarray(active), excl, rc, **kw)
    got = pnb.build_neighbor_state(torch.from_numpy(pos),
                                   torch.from_numpy(box),
                                   torch.from_numpy(active),
                                   torch.from_numpy(np.array(excl)), rc,
                                   **kw)
    for name in ("idx", "excl_mask", "buckets", "slot_of", "overflow"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_stable_sort_keeps_row_order_within_a_cell():
    """The stable-sort hazard: with every particle in one cell, bucket order
    must be the particles' row order (an unstable sort would permute it)."""
    n = 64
    pos = torch.full((n, 3), 0.25)
    box = torch.tensor([3.0, 3.0, 3.0])
    buckets, _, ovf, slot_of = pnb.build_cell_buckets(
        pos, box, torch.ones(n, dtype=torch.bool), (3, 3, 3), 64)
    assert not bool(ovf)
    np.testing.assert_array_equal(buckets[0].numpy(), np.arange(n))
    np.testing.assert_array_equal(slot_of.numpy(), np.arange(n))
