"""MDState, TermTable and NeighborState as dataclasses of torch tensors.

Port of ``chemlab_tpu/engine/state.py``.  Field names, shapes and dtypes
match the reference (f32 floats, int32 indices, bool masks; scalars are
0-d tensors) so a state can be compared with the reference field by field.
One field is absent: the reference's PRNG ``key``.  The port draws its
Langevin noise from a ``torch.Generator`` that the runner owns.

Index convention: all particle indices are 0-based rows; -1 marks padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# number of parameter slots per bonded term entry
N_BOND_PARAMS = 6

I32 = torch.int32
F32 = torch.float32


class TensorDataclass:
    """Mixin: ``.to(device)`` moves every tensor field (recursively)."""

    def to(self, device):
        upd = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TensorDataclass)):
                upd[f.name] = v.to(device)
        return dataclasses.replace(self, **upd)


@dataclasses.dataclass
class TermTable(TensorDataclass):
    """A padded bonded-term table (bonds/angles/dihedrals/1-4 pairs)."""

    idx: torch.Tensor         # (cap, arity) int32, -1 padded
    func: torch.Tensor        # (cap,) int32, 0 = invalid row
    params: torch.Tensor      # (cap, N_BOND_PARAMS) float32
    typelookup: torch.Tensor  # (cap,) bool: resolve params by particle types
    lam: torch.Tensor         # (cap,) float32 per-entry lambda (hybrid bonds)
    group: torch.Tensor       # (cap,) int32 reaction-group id, -1 = static
    count: torch.Tensor       # () int32 cursor (rows [0, count) may be valid)

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]

    @property
    def arity(self) -> int:
        return self.idx.shape[1]

    @property
    def valid(self) -> torch.Tensor:
        return self.idx[:, 0] >= 0

    @staticmethod
    def create_numpy(cap: int, arity: int, idx=None, func=None, params=None,
                     typelookup=None, lam=None, group=None) -> dict:
        """The padded table as a dict of numpy arrays (the reference's
        ``TermTable.create`` layout)."""
        n = 0 if idx is None else len(idx)
        out = dict(idx=np.full((cap, arity), -1, np.int32),
                   func=np.zeros(cap, np.int32),
                   params=np.zeros((cap, N_BOND_PARAMS), np.float32),
                   typelookup=np.zeros(cap, bool),
                   lam=np.ones(cap, np.float32),
                   group=np.full(cap, -1, np.int32),
                   count=np.asarray(n, np.int32))
        if n:
            out["idx"][:n] = idx
            if func is not None:
                out["func"][:n] = func
            if params is not None:
                out["params"][:n, : np.asarray(params).shape[1]] = params
            if typelookup is not None:
                out["typelookup"][:n] = typelookup
            if lam is not None:
                out["lam"][:n] = lam
            if group is not None:
                out["group"][:n] = group
        return out


@dataclasses.dataclass
class NeighborState(TensorDataclass):
    """Cell buckets and the Verlet rows (persistent on the row path)."""

    idx: torch.Tensor        # (N, K) int32 neighbor rows, self padded
    excl_mask: torch.Tensor  # (N, K) bool: pair is excluded
    ref_pos: torch.Tensor    # (N, 3) positions at last rebuild
    buckets: torch.Tensor    # (n_cells+1, cap) int32 cell-dense rows
    slot_of: torch.Tensor    # (N,) int32 inverse of buckets (n_cells*cap =
                             # dropped)
    birth: torch.Tensor      # (N, K) int32 step each pair entered the rows
                             # (func 14, ``cfg.has_pps``), else (1, 1)
    overflow: torch.Tensor   # () bool, sticky: a capacity overflowed
    n_rebuilds: torch.Tensor # () int32


@dataclasses.dataclass
class MDState(TensorDataclass):
    step: torch.Tensor       # () int32 global MD step

    # particle store
    pos: torch.Tensor        # (N, 3) float32, folded into box
    vel: torch.Tensor        # (N, 3)
    force: torch.Tensor      # (N, 3)
    image: torch.Tensor      # (N, 3) int32 periodic image counters
    type_id: torch.Tensor    # (N,) int32
    mass: torch.Tensor       # (N,) float32
    q: torch.Tensor          # (N,) float32
    chem_state: torch.Tensor # (N,) int32 chemical state
    res_id: torch.Tensor     # (N,) int32 residue id (from input)
    mol_id: torch.Tensor     # (N,) int32 connected-component id
    lam: torch.Tensor        # (N,) float32 lambda_adr resolution
    active: torch.Tensor     # (N,) bool, False for padding rows

    # dynamic topology
    bonds: TermTable
    angles: TermTable
    dihedrals: TermTable
    pairs14: TermTable
    excl: torch.Tensor       # (E, 2) int32 exclusion pairs, -1 padded
    n_excl: torch.Tensor     # () int32
    adj: torch.Tensor        # (N, DEG) int32 bonded adjacency, -1 padded

    # FixDistances constraint table (host, dummy) rows, -1 padded
    fixd_host: torch.Tensor
    fixd_dummy: torch.Tensor

    nbr: NeighborState

    box: torch.Tensor        # (3,) float32
    baro_v: torch.Tensor     # () float32

    # reaction runtime parameters
    reactions_on: torch.Tensor     # () bool master switch
    reaction_rates: torch.Tensor   # (R,) float32
    reaction_active: torch.Tensor  # (R,) bool
    reaction_counts: torch.Tensor  # (R,) int32 accepted events per channel
    intra_counts: torch.Tensor     # (2,) int32 [intra, inter] residue counts
    atrp_ratios: torch.Tensor      # (2,) float32
    atrp_stats: torch.Tensor       # (2,) int32
    freeze_count: torch.Tensor     # () int32
    # last reaction interval's accepted events, -1 padded
    ev_log_step: torch.Tensor      # () int32
    ev_log_a: torch.Tensor         # (E,) int32
    ev_log_b: torch.Tensor
    ev_log_r: torch.Tensor
    ev_log_dist: torch.Tensor      # (E,) float32

    # dense-static bonded operands (cfg.bonded_dense), DERIVED from the
    # canonical tables by bonded_dense.rederive
    bonds_dense: TermTable | None = None
    bonds_irr: TermTable | None = None
    angles_dense: TermTable | None = None
    angles_irr: TermTable | None = None

    # dense-static exclusion operands (cfg.excl_offsets), DERIVED from the
    # flat list by excl_dense.rederive
    excl_masks: torch.Tensor | None = None  # (n_offsets, N) bool
    excl_irr: torch.Tensor | None = None    # (excl_irr_cap, 2) int32

    @property
    def n_particles(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device


TERM_FIELDS = ("bonds", "angles", "dihedrals", "pairs14", "bonds_dense",
               "bonds_irr", "angles_dense", "angles_irr")
