"""Carry a built system across the two packages as plain numpy.

``to_numpy`` flattens the port's (EngineConfig, SimSpec, MDState) into a
config dict and nested dicts of numpy arrays; ``from_numpy`` is its
inverse.  ``tree_to_numpy`` flattens any dataclass tree whose leaves
convert with ``np.asarray`` — the reference's dataclasses included — so a
test can hand a reference state to the port without this module importing
jax.  A leaf the port does not model (the reference's PRNG ``key``) is
dropped on the way in, and so is the config's ``mesh`` either way: it
names a process's own devices or process group, and
``parallel.sharding.meshed_cfg`` puts the rank's mesh back.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine.spec import EngineConfig, SimSpec
from .engine.state import MDState, NeighborState, TensorDataclass, TermTable

_NESTED = {"nbr": NeighborState}


def _leaf_to_numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def tree_to_numpy(obj):
    """Dataclass (tree) -> dict of numpy arrays (nested dicts for nested
    dataclasses, None kept as None)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if v is None:
            out[f.name] = None
        elif dataclasses.is_dataclass(v):
            out[f.name] = tree_to_numpy(v)
        else:
            out[f.name] = _leaf_to_numpy(v)
    return out


def config_to_dict(cfg) -> dict:
    """Static config fields the port models (``mesh`` is dropped)."""
    names = {f.name for f in dataclasses.fields(EngineConfig)} - {"mesh"}
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name in names}


def _tensor(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def dataclass_from_numpy(cls, d: dict, device):
    """``cls`` from a dict of numpy arrays on ``device``: nested dicts become
    the NeighborState or TermTables, dataclasses already built are moved,
    and keys that are not fields of ``cls`` (the reference's ``key``) are
    ignored."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if v is None:
            kw[f.name] = None
        elif isinstance(v, TensorDataclass):
            kw[f.name] = v.to(device)
        elif isinstance(v, dict):
            sub = _NESTED.get(f.name, TermTable)
            kw[f.name] = dataclass_from_numpy(sub, v, device)
        else:
            kw[f.name] = _tensor(v, device)
    return cls(**kw)


def from_numpy(cfg_dict: dict, spec_np: dict, state_np: dict, device):
    """Build the port's (cfg, spec, state) on ``device`` from plain dicts."""
    cfg = EngineConfig(**{k: v for k, v in cfg_dict.items()
                          if k in {f.name for f in
                                   dataclasses.fields(EngineConfig)}})
    spec = dataclass_from_numpy(SimSpec, spec_np, device)
    state = dataclass_from_numpy(MDState, state_np, device)
    return cfg, spec, state


def from_trees(cfg, spec, state, device):
    """The port's (cfg, spec, state) from any dataclass trees with the same
    field names, such as the reference's built system."""
    return from_numpy(config_to_dict(cfg), tree_to_numpy(spec),
                      tree_to_numpy(state), device)


def to_numpy(cfg: EngineConfig, spec: SimSpec, state: MDState):
    """Inverse of :func:`from_numpy`."""
    return config_to_dict(cfg), tree_to_numpy(spec), tree_to_numpy(state)
