"""Whole-state checkpoints in the reference's ``.npz`` format.

Port of ``chemlab_tpu/checkpoint.py``.  The file holds ``__n__`` leaves
``leaf_0 .. leaf_{n-1}``: the MDState's tensors in declared field order,
nested TermTables and the NeighborState flattened in place, ``None`` fields
skipped, and the derived operands (dense/irregular bonded tables, dense
exclusion masks) stripped on save and re-derived on load.  With a config
it also holds the neighbor caps (``__caps__``) and the term caps plus the
exclusion pair cap (``__term_caps__``), so that a checkpoint written after
a regrowth restores into a fresh build.

The port's MDState lacks one field of the reference's, its first: the
threefry ``key``.  So that the reference can load a port file, the port
writes a ``key`` leaf at that position, ``PRNGKey(rng_seed)``'s two uint32
words, and skips that leaf when it reads either package's file.  The
port's own noise stream is the ``torch.Generator``'s state, stored under
``__torch_rng__`` (which the reference ignores) and given back by
``load_state``, so that a resumed port run continues bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import bonded_dense, build, excl_dense
from .engine.state import MDState

# derived from the canonical tables and the flat exclusion list
_DERIVED_FIELDS = ("bonds_dense", "bonds_irr", "angles_dense", "angles_irr")
_DERIVED_EXCL = ("excl_masks", "excl_irr")


def _strip_derived(state):
    upd = {}
    if getattr(state, _DERIVED_FIELDS[0], None) is not None:
        upd.update({f: None for f in _DERIVED_FIELDS})
    if getattr(state, _DERIVED_EXCL[0], None) is not None:
        upd.update({f: None for f in _DERIVED_EXCL})
    return dataclasses.replace(state, **upd) if upd else state


def _leaves(obj) -> list:
    """The tensors of a dataclass tree in declared field order, None
    skipped (``jax.tree_util.tree_flatten`` of the reference's tree)."""
    out = []
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _unflatten(obj, leaves):
    """``obj`` with its leaves replaced, in ``_leaves`` order."""
    upd = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            continue
        upd[f.name] = (_unflatten(v, leaves) if dataclasses.is_dataclass(v)
                       else leaves.pop(0))
    return dataclasses.replace(obj, **upd)


def prng_key_words(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 32-bit types: [0, seed mod 2^32]."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def save_state(path: str, state: MDState, cfg=None, gen=None,
               rng_seed: int = 0) -> None:
    """Write the state; with ``cfg`` also its caps, with ``gen`` the
    generator's state.  ``rng_seed`` makes the ``key`` leaf."""
    leaves = _leaves(_strip_derived(state))
    arrays = {"__n__": np.asarray(len(leaves) + 1),
              "leaf_0": prng_key_words(rng_seed)}
    for i, leaf in enumerate(leaves):
        arrays["leaf_%d" % (i + 1)] = leaf.detach().cpu().numpy()
    if cfg is not None:
        arrays["__caps__"] = np.asarray(
            [getattr(cfg, f) for f in build.NEIGHBOR_CAP_FIELDS], np.int64)
        arrays["__term_caps__"] = np.asarray(
            [getattr(cfg, f) for f in build.TERM_CAP_FIELDS]
            + [state.excl.shape[0]], np.int64)
    if gen is not None:
        arrays["__torch_rng__"] = gen.get_state().numpy()
    np.savez_compressed(path, **arrays)


def load_state(path: str, template: MDState, cfg=None, spec=None, gen=None):
    """Restore into the template's structure, on the template's device.

    With ``cfg``/``spec`` the caps recorded in the file are applied to the
    template first and ``(state, cfg)`` is returned; without them the
    shapes must match and the state is returned.  With ``gen`` the stored
    generator state, if the file has one, is set on it."""
    data = np.load(path)
    want_cfg = cfg is not None
    if want_cfg and "__caps__" in data:
        caps = {f: int(v) for f, v in zip(build.NEIGHBOR_CAP_FIELDS,
                                          data["__caps__"])}
        if any(getattr(cfg, f) != v for f, v in caps.items()):
            cfg, template = build.apply_neighbor_caps(cfg, spec, template,
                                                      caps)
    if want_cfg and "__term_caps__" in data:
        tvals = data["__term_caps__"]
        tcaps = {f: int(v) for f, v in zip(build.TERM_CAP_FIELDS, tvals)}
        excl_pair_cap = int(tvals[len(build.TERM_CAP_FIELDS)])
        if (any(getattr(cfg, f) != v for f, v in tcaps.items())
                or excl_pair_cap != template.excl.shape[0]):
            cfg, template = build.apply_term_caps(cfg, template, tcaps,
                                                  excl_pair_cap)
    has_dense = template.bonds_dense is not None
    stripped = _strip_derived(template)
    leaves = _leaves(stripped)
    n = int(data["__n__"])
    if n != len(leaves) + 1:
        raise ValueError("checkpoint has %d leaves, state needs %d (its "
                         "tensors and the key)" % (n, len(leaves) + 1))
    new_leaves = []
    for i, leaf in enumerate(leaves):
        arr = data["leaf_%d" % (i + 1)]
        if arr.shape != tuple(leaf.shape):
            raise ValueError("leaf %d shape %s != expected %s: was the "
                             "checkpoint made with different inputs?"
                             % (i + 1, arr.shape, tuple(leaf.shape)))
        new_leaves.append(torch.from_numpy(np.array(arr, copy=True)).to(
            device=leaf.device, dtype=leaf.dtype))
    state = _unflatten(stripped, new_leaves)
    if has_dense:
        npart = state.pos.shape[0]
        bdn, bir, _ = bonded_dense.derive_aligned(
            state.bonds, npart, template.bonds_irr.capacity)
        adn, air, _ = bonded_dense.derive_aligned(
            state.angles, npart, template.angles_irr.capacity)
        state = dataclasses.replace(state, bonds_dense=bdn, bonds_irr=bir,
                                    angles_dense=adn, angles_irr=air)
    if template.excl_masks is not None:
        if cfg is None or not cfg.excl_offsets:
            raise ValueError("template carries dense-exclusion operands; "
                             "pass cfg (with excl_offsets) to load_state")
        # a checkpoint written after mid-run growth can carry more
        # irregular pairs than a fresh build's irregular cap: grow it first
        e = state.excl.cpu().numpy()
        ev = (e[:, 0] >= 0) & (e[:, 1] >= 0)
        n_irr = int((ev & ~np.isin(np.abs(e[:, 1] - e[:, 0]),
                                   cfg.excl_offsets)).sum())
        if n_irr + 128 > cfg.excl_irr_cap:
            cfg = dataclasses.replace(
                cfg, excl_irr_cap=-(-(n_irr + 128) // 128) * 128)
        masks, irr, _ = excl_dense.derive(
            state.excl, state.pos.shape[0], cfg.excl_offsets,
            cfg.excl_irr_cap)
        state = dataclasses.replace(state, excl_masks=masks, excl_irr=irr)
    if gen is not None and "__torch_rng__" in data:
        gen.set_state(torch.from_numpy(np.array(data["__torch_rng__"],
                                                copy=True)))
    return (state, cfg) if want_cfg else state
