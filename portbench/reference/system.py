"""The plain description of a melt configuration, read from the
``system`` block of its file under ``portbench/configs``.

Nothing here comes from the program: the types, potentials, reaction
channels and transfers are the configuration file's own copy of the
system's definition, and the start topology (bonds, angles, exclusions,
types, states, molecules) is worked out from it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np


@dataclasses.dataclass
class Channel:
    t1: int
    min1: int
    max1: int
    t2: int
    min2: int
    max2: int
    new1: int        # -1: the type_1 end keeps its type
    delta1: int
    new2: int
    delta2: int
    cutoff2: float
    rate: float
    intramolecular: bool
    intraresidual: bool


@dataclasses.dataclass
class Transfer:
    level: int
    old: int
    new: int
    state: int


@dataclasses.dataclass
class Barostat:
    form: str                   # 'br' (Berendsen) or 'lv' (Langevin piston)
    pressure: float             # P0
    tau: float = 0.0            # 'br'
    mass: float = 0.0           # 'lv': the piston's mass W
    gammaP: float = 0.0         # 'lv': the piston's friction


def load_barostat(block):
    """The ``system.barostat`` block (``form``, ``pressure``, and ``tau``
    or ``mass`` and ``gammaP``) as a ``Barostat``; None without one."""
    if block is None:
        return None
    form = block["form"]
    if form == "br":
        b = Barostat(form, float(block["pressure"]), tau=float(block["tau"]))
    elif form == "lv":
        b = Barostat(form, float(block["pressure"]),
                     mass=float(block["mass"]),
                     gammaP=float(block["gammaP"]))
    else:
        raise ValueError("barostat form %r: 'br' or 'lv'" % form)
    if b.pressure <= 0.0:
        raise ValueError("a barostat at pressure %r: the system runs none "
                         "at P0 <= 0" % b.pressure)
    return b


@dataclasses.dataclass
class System:
    types: list
    mass: float
    state0: np.ndarray          # (T,) start chemical state of each type
    mol_atoms: np.ndarray       # (M,) type of each atom of the molecule
    mol_bonds: np.ndarray       # (B, 2)
    mol_angles: np.ndarray      # (A, 3)
    nrexcl: int
    pair: dict
    bond_k: float               # U = bond_k (r - bond_r0)^2
    bond_r0: float
    angle_k: float              # U = angle_k (theta - angle_theta0)^2
    angle_theta0: float
    angle_types: set            # (ti, tj, tk) with (tk, tj, ti) alike
    dt: float
    kT: float
    gamma: float
    interval: int
    channels: list
    transfers: list
    barostat: Barostat = None   # None: constant volume


def load_system(block: dict) -> System:
    """The configuration's ``system`` block as a ``System`` (its
    ``barostat`` block optional: without one the volume is constant).  The
    bond of a bond type and the bond a reaction makes must be one
    potential, and so must every angle type: the reference then needs no
    table of per-type parameters."""
    types = list(block["types"])
    tid = {t: k for k, t in enumerate(types)}
    state0 = np.zeros(len(types), dtype=np.int64)
    for t, s in block.get("state", {}).items():
        state0[tid[t]] = s
    mol = block["molecule"]
    bond, angle = block["bond"], block["angle"]
    rx = block.get("reactions") or {}
    grp = rx.get("group_bond", {"K": bond["k"] / 2.0, "r0": bond["b0"]})
    if (abs(grp["K"] - bond["k"] / 2.0) > 1e-12
            or abs(grp["r0"] - bond["b0"]) > 1e-12):
        raise NotImplementedError("the reaction's bond differs from the "
                                  "bond type: give the reference both")
    channels = [Channel(
        t1=tid[c["t1"]], min1=c["min1"], max1=c["max1"], t2=tid[c["t2"]],
        min2=c["min2"], max2=c["max2"],
        new1=-1 if c["new1"] is None else tid[c["new1"]],
        delta1=c["delta1"],
        new2=-1 if c["new2"] is None else tid[c["new2"]],
        delta2=c["delta2"], cutoff2=c["cutoff"] ** 2, rate=c["rate"],
        intramolecular=c["intramolecular"],
        intraresidual=c["intraresidual"]) for c in rx.get("channels", [])]
    transfers = [Transfer(level=t["level"], old=tid[t["old"]],
                          new=tid[t["new"]], state=t["state"])
                 for t in rx.get("transfers", [])]
    angle_types = set()
    for a, b, c in block["angletypes"]:
        angle_types.add((tid[a], tid[b], tid[c]))
        angle_types.add((tid[c], tid[b], tid[a]))
    integ = block["integrator"]
    return System(
        types=types, mass=float(block["mass"]), state0=state0,
        mol_atoms=np.array([tid[t] for t in mol["atoms"]]),
        mol_bonds=np.array(mol["bonds"], dtype=np.int64).reshape(-1, 2),
        mol_angles=np.array(mol["angles"], dtype=np.int64).reshape(-1, 3),
        nrexcl=int(mol["nrexcl"]), pair=dict(block["pair"]),
        bond_k=bond["k"] / 2.0, bond_r0=bond["b0"],
        angle_k=angle["k"] / 2.0,
        angle_theta0=math.radians(angle["theta0_deg"]),
        angle_types=angle_types, dt=integ["dt"], kT=integ["kT"],
        gamma=integ["gamma"], interval=int(rx.get("interval", 0)),
        channels=channels, transfers=transfers,
        barostat=load_barostat(block.get("barostat")))


@dataclasses.dataclass
class Topology:
    """A melt's topology as plain arrays: the reference's own start, or
    the program's state read back for a comparison."""
    type_id: np.ndarray     # (N,)
    chem: np.ndarray        # (N,)
    mol: np.ndarray         # (N,) the smallest index of each molecule
    res: np.ndarray         # (N,) residue of each particle
    bonds: np.ndarray       # (B, 2), each row sorted
    angles: np.ndarray      # (A, 3), ends sorted
    excl: np.ndarray        # (X, 2) unordered excluded pairs, rows sorted


def start_topology(sys_: System, n_mols: int) -> Topology:
    """The melt as built: ``n_mols`` copies of the molecule, each its own
    residue, exclusions to ``nrexcl`` bonds apart."""
    m = len(sys_.mol_atoms)
    base = (np.arange(n_mols) * m)[:, None]
    bonds = np.sort((base[:, :, None] + sys_.mol_bonds[None]).reshape(-1, 2),
                    axis=1)
    angles = canon_angles((base[:, :, None]
                           + sys_.mol_angles[None]).reshape(-1, 3))
    type_id = np.tile(sys_.mol_atoms, n_mols)
    excl = graph_exclusions(bonds, n_mols * m, sys_.nrexcl)
    idx = np.arange(n_mols * m)
    return Topology(type_id=type_id, chem=sys_.state0[type_id],
                    mol=idx - idx % m, res=idx // m, bonds=bonds,
                    angles=angles, excl=excl)


def canon_angles(a: np.ndarray) -> np.ndarray:
    """Angles (i, j, k) with i < k, so that one angle has one row."""
    a = np.asarray(a, dtype=np.int64).reshape(-1, 3)
    flip = a[:, 0] > a[:, 2]
    out = a.copy()
    out[flip, 0], out[flip, 2] = a[flip, 2], a[flip, 0]
    return out


def graph_exclusions(bonds: np.ndarray, n: int, nrexcl: int) -> np.ndarray:
    """Unordered pairs at most ``nrexcl`` bonds apart (nrexcl 1 or 2)."""
    pairs = [np.sort(bonds, axis=1)]
    if nrexcl >= 2:
        nb = neighbours(bonds, n)
        for j in range(n):
            ks = nb[j]
            for x in range(len(ks)):
                for y in range(x + 1, len(ks)):
                    pairs.append(np.array([[min(ks[x], ks[y]),
                                            max(ks[x], ks[y])]]))
    if nrexcl > 2:
        raise NotImplementedError("nrexcl > 2")
    return unique_rows(np.concatenate(pairs))


def neighbours(bonds: np.ndarray, n: int) -> list:
    """Each particle's bonded partners, as lists."""
    nb = [[] for _ in range(n)]
    for i, j in bonds:
        nb[int(i)].append(int(j))
        nb[int(j)].append(int(i))
    return nb


def unique_rows(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.int64)
    if a.size == 0:
        return a.reshape(0, a.shape[1] if a.ndim == 2 else 2)
    return np.unique(a, axis=0)


def write_tables(out_dir: str, types: list, table: dict) -> None:
    """The func-8 pair tables ``table_T1_T2.pot`` of a tabulated melt,
    every sorted type pair one LJ table of ``table``'s epsilon and sigma,
    sampled every ``dr`` from ``dr`` to ``r_max``: the raw files the
    program and the reference both read."""
    dr, r_max = table["dr"], table["r_max"]
    r = np.arange(dr, r_max + dr / 2, dr)
    sr6 = (table["sigma"] / r) ** 6
    e = 4.0 * table["epsilon"] * (sr6 * sr6 - sr6)
    f = 24.0 * table["epsilon"] * (2.0 * sr6 * sr6 - sr6) / r
    names = sorted(types)
    for i, t1 in enumerate(names):
        for t2 in names[i:]:
            with open(os.path.join(out_dir, "table_%s_%s.pot" % (t1, t2)),
                      "w") as out:
                for k in range(len(r)):
                    out.write("%.6f %.8e %.8e\n" % (r[k], e[k], f[k]))


def read_tables(table_dir: str, types: list):
    """(r (P,), F (T, T, P)) of the pair tables in ``table_dir``: the
    force column of ``table_T1_T2.pot`` for each type pair, as written."""
    t = len(types)
    r_grid, force = None, None
    for a in range(t):
        for b in range(t):
            lo, hi = sorted((types[a], types[b]))
            data = np.loadtxt(os.path.join(table_dir,
                                           "table_%s_%s.pot" % (lo, hi)))
            if force is None:
                r_grid = data[:, 0]
                force = np.zeros((t, t, len(r_grid)))
            force[a, b] = data[:, 2]
    return r_grid, force
