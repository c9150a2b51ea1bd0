"""System topology compiler.

The port's own copy of ``chemlab_tpu/topology.py``, so that the port
imports nothing of the JAX package.  One change: the optional native
accelerator of ``generate_exclusions`` is dropped; the numpy path gives
the same set.

Turns a parsed GROMACS topology (``topfile.TopologyFile``) into flat,
replication-expanded arrays ready for the device engine:

  - a type registry (symbol <-> dense type id), including atom types that
    appear only in the master topology file so that reaction products that
    are absent from the initial configuration still get ids
    (ref: src/chemlab/gromacs_topology.py:257-267)
  - per-particle parameter arrays (type id, mass, charge, state)
  - replicated bond/angle/dihedral/pair index lists with resolved func+params
    (ref: gromacs_topology.py:276-296, 379-429)
  - exclusion pairs out to ``nrexcl`` bonds via per-molecule BFS, replicated
    (ref: gromacs_topology.py:298-377)

All particle indices in this module are 1-based atom ids, matching the file
formats; the engine converts to 0-based rows.
"""

from __future__ import annotations

import collections
import dataclasses
import logging

import numpy as np

from . import topfile

logger = logging.getLogger(__name__)


def convert_c6c12(c6: float, c12: float, combination_rule: int):
    """GROMACS c6/c12 -> sigma/epsilon under combination rule 1
    (ref: gromacs_topology.py:110-121)."""
    if combination_rule == 1:
        if c12 == 0.0:
            return 1.0, 0.0
        sig = (c12 / c6) ** (1.0 / 6.0)
        eps = 0.25 * c6 * sig ** (-6.0) if sig > 0.0 else 0.0
        return sig, eps
    return c6, c12


def combine_lj(sig_1, eps_1, sig_2, eps_2, combination_rule: int):
    """Mixing rules: 2 = Lorentz-Berthelot, otherwise geometric
    (ref: gromacs_topology.py:452-460)."""
    if combination_rule == 2:
        sig = 0.5 * (sig_1 + sig_2)
    else:
        sig = (sig_1 * sig_2) ** 0.5
    eps = (eps_1 * eps_2) ** 0.5
    return sig, eps


def generate_exclusions(bonds, nrexcl: int):
    """All atom pairs within ``nrexcl`` bonds of each other (one molecule).

    Iterative BFS over the bond graph; returns a set of sorted id pairs.
    The bonded pairs themselves are always included
    (ref: gromacs_topology.py:316-377).
    """
    adj = collections.defaultdict(set)
    for i, j in bonds:
        adj[i].add(j)
        adj[j].add(i)
    exclusions = {tuple(sorted(b)) for b in bonds}
    if nrexcl <= 0:
        return exclusions
    for root in adj:
        frontier = {root}
        visited = {root}
        for _ in range(nrexcl):
            nxt = set()
            for u in frontier:
                nxt |= adj[u] - visited
            visited |= nxt
            frontier = nxt
        for v in visited - {root}:
            exclusions.add(tuple(sorted((root, v))))
    return exclusions


@dataclasses.dataclass
class SystemTopology:
    """Fully expanded system topology.

    The reference keeps this state inside ``GromacsTopology``
    (ref: gromacs_topology.py:132-446); here it is a plain data container
    produced by :func:`build_system_topology`.
    """

    top: topfile.TopologyFile            # expanded (includes applied)
    master: topfile.TopologyFile         # master file only (no includes)

    # type registry
    atomsym_atomtype: dict               # symbol -> type id
    atomtype_atomsym: dict               # type id -> symbol
    used_atomtypes: set                  # symbols referenced anywhere

    # per-particle data, index = atom_id - 1
    n_atoms: int
    type_ids: np.ndarray                 # (N,) int32
    masses: np.ndarray                   # (N,) float
    charges: np.ndarray                  # (N,) float
    states: np.ndarray                   # (N,) int32
    sigmas: np.ndarray                   # (N,) float  per-particle LJ sigma
    epsilons: np.ndarray                 # (N,) float
    atom_names: list                     # (N,) str
    chain_names: list                    # (N,) str
    chain_idx: np.ndarray                # (N,) int   residue index from topology
    molecule_names: list                 # (N,) str   owning moleculetype

    # bonded term lists: dict (1-based id tuple) -> list[str] raw params
    bonds: dict
    angles: dict
    dihedrals: dict
    pairs: dict

    # type-level parameter tables keyed by type-id tuples
    bondparams: dict                     # (t1,t2) sorted -> {func, params}
    angleparams: dict                    # (t1,t2,t3) canonical -> {func, params}
    dihedralparams: dict                 # (t1..t4) canonical -> {func, params}

    # exclusions: sorted 1-based id pairs
    exclusions: set

    # next free type id (for dummy types added by post-processes)
    next_type_id: int = 0

    @property
    def defaults(self):
        return self.top.defaults

    def atomtype_record(self, symbol: str) -> dict:
        return self.top.atomtypes[symbol]

    def add_new_atomtype(self, symbol: str) -> int:
        """Register an extra atom type (dummy particles etc.;
        ref: gromacs_topology.py:172-183)."""
        tid = self.next_type_id
        self.atomsym_atomtype[symbol] = tid
        self.atomtype_atomsym[tid] = symbol
        self.next_type_id += 1
        return tid

    def canonical_angle_key(self, t1, t2, t3):
        return (t3, t2, t1) if t1 > t3 else (t1, t2, t3)

    def canonical_dihedral_key(self, t1, t2, t3, t4):
        return (t4, t3, t2, t1) if t4 > t1 else (t1, t2, t3, t4)


def _replicate(index_lists: dict, n_mols: int, n_atoms: int, offset: int) -> dict:
    """Replicate a per-molecule index list n_mols times with id shifts
    (ref: gromacs_topology.py:431-446)."""
    out = {}
    for mol in range(n_mols):
        shift = offset + mol * n_atoms
        for key, val in index_lists.items():
            out[tuple(shift + x for x in key)] = val
    return out


def build_system_topology(top_file: str, generate_excl: bool = True) -> SystemTopology:
    """Read + expand a topology file into a :class:`SystemTopology`."""
    top = topfile.read_topology_file(top_file, expand_includes=True)
    master = topfile.read_topology_file(top_file, expand_includes=False)
    return compile_system_topology(top, master, generate_excl=generate_excl)


def compile_system_topology(top: topfile.TopologyFile,
                            master: topfile.TopologyFile | None = None,
                            generate_excl: bool = True) -> SystemTopology:
    """Compile parsed topology objects into a :class:`SystemTopology`
    (programmatic entry point; used by generated test systems)."""
    if master is None:
        master = top
    if top.defaults is None:
        top.defaults = {"nbfunc": 1, "combinationrule": 1, "gen-pairs": False,
                        "fudgeLJ": 1.0, "fudgeQQ": 1.0, "func": 1}
    cr = top.defaults["combinationrule"]

    # ---- type registry: molecule-atom order first, then master types ------
    atomsym_atomtype: dict = {}
    used_atomtypes: set = set()
    for mol_name, _ in top.molecules:
        mol = top.molecule_defs[mol_name]
        for aid in sorted(mol.atoms):
            sym = mol.atoms[aid]["type"]
            used_atomtypes.add(sym)
            if sym not in atomsym_atomtype:
                atomsym_atomtype[sym] = len(atomsym_atomtype)
    # Master-topology union: atomtypes declared in the main .top file get ids
    # even when unused in the starting configuration (reaction products).
    for sym in master.atomtypes:
        used_atomtypes.add(sym)
        if sym not in atomsym_atomtype:
            atomsym_atomtype[sym] = len(atomsym_atomtype)

    # Convert nonbond_params func-1 c6/c12 entries under combination rule 1
    # (ref: gromacs_topology.py:249-255).
    for key, v in top.nonbond_params.items():
        if v["func"] == 1 and cr == 1 and v["params"] and not v.get("_converted"):
            c6, c12 = float(v["params"][0]), float(v["params"][1])
            sig, eps = convert_c6c12(c6, c12, cr)
            v["params"][0] = sig
            v["params"][1] = eps
            v["_converted"] = True

    # ---- replicate per-particle data ---------------------------------------
    type_ids, masses, charges, states = [], [], [], []
    sigmas, epsilons = [], []
    atom_names, chain_names, molecule_names = [], [], []
    chain_idx = []
    bonds, angles, dihedrals, pairs = {}, {}, {}, {}
    exclusions: set = set()

    offset = 0
    mol_counter = 0
    for mol_name, n_mols in top.molecules:
        mol = top.molecule_defs[mol_name]
        local_ids = sorted(mol.atoms)
        n_at = len(local_ids)
        logger.info("building %s x %d molecules", mol_name, n_mols)
        # per-atom static params for one copy
        rec = []
        for aid in local_ids:
            a = mol.atoms[aid]
            at = top.atomtypes[a["type"]]
            sig, eps = convert_c6c12(at["sigma"], at["epsilon"], cr)
            rec.append((
                atomsym_atomtype[a["type"]],
                a["mass"] if a["mass"] is not None else at["mass"],
                a["charge"] if a["charge"] is not None else at["charge"],
                at.get("state", 0),
                sig, eps, a["name"], a["res_name"],
            ))
        for _ in range(n_mols):
            for (tid, m, q, st, sig, eps, nm, cn) in rec:
                type_ids.append(tid)
                masses.append(m)
                charges.append(q)
                states.append(st)
                sigmas.append(sig)
                epsilons.append(eps)
                atom_names.append(nm)
                chain_names.append(cn)
                molecule_names.append(mol_name)
        # residue index: one residue per molecule copy, counted globally
        # across molecule types (overridden by .gro at runtime)
        for _ in range(n_mols):
            mol_counter += 1
            chain_idx.extend([mol_counter] * n_at)

        bonds.update(_replicate(mol.bonds, n_mols, n_at, offset))
        angles.update(_replicate(mol.angles, n_mols, n_at, offset))
        dihedrals.update(_replicate(mol.dihedrals, n_mols, n_at, offset))
        dihedrals.update(_replicate(mol.improper_dihedrals, n_mols, n_at, offset))
        pairs.update(_replicate(mol.pairs, n_mols, n_at, offset))

        if generate_excl and mol.bonds:
            mol_excl = generate_exclusions(list(mol.bonds), mol.nrexcl)
            for mol_copy in range(n_mols):
                shift = offset + mol_copy * n_at
                for (i, j) in mol_excl:
                    exclusions.add((shift + i, shift + j))
        offset += n_mols * n_at

    # ---- expand type-level bonded parameter tables to type-id keys --------
    bondparams, angleparams, dihedralparams = {}, {}, {}
    for (i, j), params in top.bondtypes.items():
        if i in atomsym_atomtype and j in atomsym_atomtype:
            t = tuple(sorted((atomsym_atomtype[i], atomsym_atomtype[j])))
            bondparams[t] = params
    for (i, j, k), params in top.angletypes.items():
        if all(s in atomsym_atomtype for s in (i, j, k)):
            t1, t2, t3 = (atomsym_atomtype[i], atomsym_atomtype[j], atomsym_atomtype[k])
            key = (t3, t2, t1) if t1 > t3 else (t1, t2, t3)
            angleparams[key] = params
    for (i, j, k, l), params in top.dihedraltypes.items():
        if all(s in atomsym_atomtype for s in (i, j, k, l)):
            t1, t2, t3, t4 = (atomsym_atomtype[i], atomsym_atomtype[j],
                              atomsym_atomtype[k], atomsym_atomtype[l])
            key = (t4, t3, t2, t1) if t4 > t1 else (t1, t2, t3, t4)
            dihedralparams[key] = params

    n_atoms = len(type_ids)
    st = SystemTopology(
        top=top,
        master=master,
        atomsym_atomtype=atomsym_atomtype,
        atomtype_atomsym={v: k for k, v in atomsym_atomtype.items()},
        used_atomtypes=used_atomtypes,
        n_atoms=n_atoms,
        type_ids=np.asarray(type_ids, dtype=np.int32),
        masses=np.asarray(masses, dtype=np.float64),
        charges=np.asarray(charges, dtype=np.float64),
        states=np.asarray(states, dtype=np.int32),
        sigmas=np.asarray(sigmas, dtype=np.float64),
        epsilons=np.asarray(epsilons, dtype=np.float64),
        atom_names=atom_names,
        chain_names=chain_names,
        chain_idx=np.asarray(chain_idx, dtype=np.int64) if chain_idx else np.zeros(0, dtype=np.int64),
        molecule_names=molecule_names,
        bonds=bonds,
        angles=angles,
        dihedrals=dihedrals,
        pairs=pairs,
        bondparams=bondparams,
        angleparams=angleparams,
        dihedralparams=dihedralparams,
        exclusions=exclusions,
        next_type_id=len(atomsym_atomtype),
    )
    return st
