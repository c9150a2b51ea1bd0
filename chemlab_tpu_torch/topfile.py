"""GROMACS .top/.itp topology-file parser and writer.

The port's own copy of ``chemlab_tpu/topfile.py`` (unchanged apart from
this note), so that the port imports nothing of the JAX package.

Covers the reference grammar plus the chemlab extensions
(ref: src/chemlab/files_io.py:401-976 and src/chemlab/gromacs_topology.py:29-107):

  - ``#include`` recursion and ``#define`` substitution in a preprocessing pass
  - sections: defaults, atomtypes, atomstate (chemlab extension mapping atom
    type -> initial chemical state), nonbond_params, bondtypes, angletypes,
    dihedraltypes, moleculetype, atoms, bonds, angles, dihedrals (a second
    [dihedrals] block is treated as improper_dihedrals), pairs, system,
    molecules
  - symmetric mirroring of type-keyed parameter tables
"""

from __future__ import annotations

import dataclasses
import logging
import os

from .files_io import prepare_path

logger = logging.getLogger(__name__)


def preprocess(file_name: str, cwd: str | None = None, defines: dict | None = None) -> list[str]:
    """Expand #include and collect/substitute #define values.

    Returns the flattened list of content lines (comments stripped).
    (ref: gromacs_topology.py:60-107)
    """
    if cwd is None:
        cwd = os.path.dirname(file_name) or "."
        file_name = os.path.basename(file_name)
    if defines is None:
        defines = {}
    lines: list[str] = []
    with open(os.path.join(cwd, file_name)) as f:
        for raw in f:
            line = raw.split(";")[0].rstrip("\n").strip()
            if not line:
                continue
            if line.startswith("#include"):
                name = line.split(None, 1)[1].strip().strip('"')
                sub_cwd = cwd
                if os.path.dirname(name):
                    sub_cwd = os.path.join(cwd, os.path.dirname(name))
                    name = os.path.basename(name)
                if os.path.exists(os.path.join(sub_cwd, name)):
                    lines.extend(preprocess(name, sub_cwd, defines))
                else:
                    logger.warning("missing #include %s (skipped)", name)
            elif line.startswith("#define"):
                t = line.split()
                if len(t) > 2:
                    defines[t[1]] = " ".join(t[2:])
            elif line.startswith("#"):
                continue
            else:
                lines.append(line)
    # Substitute defines token-wise.
    if defines:
        out = []
        for line in lines:
            toks = line.split()
            hit = next((t for t in toks if t in defines), None)
            out.append(line.replace(hit, defines[hit]) if hit else line)
        lines = out
    return lines


@dataclasses.dataclass
class MoleculeDef:
    """One [ moleculetype ] block: atoms and bonded index lists (1-based, local)."""

    name: str
    nrexcl: int
    # atoms: local_id -> dict(type, res_idx, res_name, name, cgnr, charge, mass)
    atoms: dict = dataclasses.field(default_factory=dict)
    bonds: dict = dataclasses.field(default_factory=dict)       # (i, j) -> [func, params...]
    angles: dict = dataclasses.field(default_factory=dict)      # (i, j, k) -> [...]
    dihedrals: dict = dataclasses.field(default_factory=dict)   # (i, j, k, l) -> [...]
    improper_dihedrals: dict = dataclasses.field(default_factory=dict)
    pairs: dict = dataclasses.field(default_factory=dict)       # (i, j) -> [...]

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)


@dataclasses.dataclass
class TopologyFile:
    """Parsed GROMACS topology content."""

    file_name: str = ""
    defaults: dict | None = None
    atomtypes: dict = dataclasses.field(default_factory=dict)   # name -> record
    atomstate: dict = dataclasses.field(default_factory=dict)   # name -> int state
    nonbond_params: dict = dataclasses.field(default_factory=dict)  # sorted (n1,n2) -> {func, params}
    bondtypes: dict = dataclasses.field(default_factory=dict)       # (i,j) -> {func, params}, mirrored
    angletypes: dict = dataclasses.field(default_factory=dict)      # (i,j,k) -> ..., mirrored
    dihedraltypes: dict = dataclasses.field(default_factory=dict)   # (i,j,k,l) -> ..., mirrored
    molecules: list = dataclasses.field(default_factory=list)       # ordered [(name, count)]
    molecule_defs: dict = dataclasses.field(default_factory=dict)   # name -> MoleculeDef
    system_name: str | None = None

    # -- convenience lookups ------------------------------------------------
    def bondtype(self, t1: str, t2: str):
        return self.bondtypes.get((t1, t2))

    def angletype(self, t1: str, t2: str, t3: str):
        return self.angletypes.get((t1, t2, t3))

    def dihedraltype(self, t1: str, t2: str, t3: str, t4: str):
        return self.dihedraltypes.get((t1, t2, t3, t4))


def _parse_defaults(top: TopologyFile, fields: list[str]) -> None:
    # nbfunc combination-rule [gen-pairs fudgeLJ fudgeQQ]  (ref: files_io.py:613-626)
    top.defaults = {
        "nbfunc": 1,
        "func": int(fields[0]),
        "combinationrule": int(fields[1]),
        "gen-pairs": len(fields) > 2 and fields[2] == "yes",
        "fudgeLJ": float(fields[3]) if len(fields) > 3 else 1.0,
        "fudgeQQ": float(fields[4]) if len(fields) > 4 else 1.0,
    }


def _parse_atomtypes(top: TopologyFile, fields: list[str]) -> None:
    # Accept the same column layouts as the reference (ref: files_io.py:628-669):
    #   6 cols: name mass charge ptype c6/sigma c12/epsilon
    #   7 cols: name at.num mass charge ptype c6/sigma c12/epsilon
    #   8 cols (opls): name bond_type at.num mass charge ptype sigma epsilon
    if len(fields) == 7:
        name, mass, charge, ptype, sig, eps = fields[0], fields[2], fields[3], fields[4], fields[5], fields[6]
    elif len(fields) == 6:
        name, mass, charge, ptype, sig, eps = fields[0], fields[1], fields[2], fields[3], fields[4], fields[5]
    elif len(fields) == 8 and fields[0].startswith("opls"):
        name, mass, charge, ptype, sig, eps = fields[0], fields[3], fields[4], fields[5], fields[6], fields[7]
    else:
        logger.warning("skipping atomtype line: %s", fields)
        return
    top.atomtypes[name] = {
        "name": name,
        "mass": float(mass),
        "charge": float(charge),
        "type": ptype,
        "sigma": float(sig),
        "epsilon": float(eps),
    }
    if name in top.atomstate:
        top.atomtypes[name]["state"] = top.atomstate[name]


def _parse_atomstate(top: TopologyFile, fields: list[str]) -> None:
    name, state = fields[0], int(fields[1])
    top.atomstate[name] = state
    if name in top.atomtypes:
        top.atomtypes[name]["state"] = state


def _parse_nonbond_params(top: TopologyFile, fields: list[str]) -> None:
    key = tuple(sorted(fields[:2]))
    if key in top.nonbond_params:
        raise ValueError("duplicate nonbond_params entry for %s" % (key,))
    if len(fields) < 3:
        logger.warning("malformed [ nonbond_params ] entry %s (skipped)", fields)
        return
    top.nonbond_params[key] = {"func": int(fields[2]), "params": list(fields[3:])}


def _parse_bondtypes(top: TopologyFile, fields: list[str]) -> None:
    i, j = fields[0], fields[1]
    rec = {"func": int(fields[2]), "params": list(fields[3:])}
    top.bondtypes[(i, j)] = rec
    top.bondtypes[(j, i)] = rec


def _parse_angletypes(top: TopologyFile, fields: list[str]) -> None:
    i, j, k = fields[0], fields[1], fields[2]
    rec = {"func": int(fields[3]), "params": list(fields[4:])}
    top.angletypes[(i, j, k)] = rec
    top.angletypes[(k, j, i)] = rec


def _parse_dihedraltypes(top: TopologyFile, fields: list[str]) -> None:
    i, j, k, l = fields[0], fields[1], fields[2], fields[3]
    try:
        rec = {"func": int(fields[4]), "params": list(fields[5:])}
    except (ValueError, IndexError):
        logger.warning("skipping dihedraltype line: %s", fields)
        return
    top.dihedraltypes[(i, j, k, l)] = rec
    top.dihedraltypes[(l, k, j, i)] = rec


class _Parser:
    """Stateful section-driven parser."""

    def __init__(self, top: TopologyFile):
        self.top = top
        self.current_mol: MoleculeDef | None = None
        self.section = None
        self.prev_section = None

    def feed(self, line: str) -> None:
        line = line.split(";")[0].strip()
        if not line or line.startswith("#"):
            return
        if line.startswith("["):
            name = line.strip("[] \t")
            # A [dihedrals] block immediately following another [dihedrals]
            # holds improper dihedrals (ref: files_io.py:519-521).
            if self.section == "dihedrals" and name == "dihedrals":
                name = "improper_dihedrals"
            self.prev_section, self.section = self.section, name
            return
        fields = line.split()
        if not fields:
            return
        handler = getattr(self, "_sec_%s" % self.section, None) if self.section else None
        if handler is not None:
            handler(fields)

    # -- type-level sections --
    def _sec_defaults(self, f):
        _parse_defaults(self.top, f)

    def _sec_atomtypes(self, f):
        _parse_atomtypes(self.top, f)

    def _sec_atomstate(self, f):
        _parse_atomstate(self.top, f)

    def _sec_nonbond_params(self, f):
        _parse_nonbond_params(self.top, f)

    def _sec_bondtypes(self, f):
        _parse_bondtypes(self.top, f)

    def _sec_angletypes(self, f):
        _parse_angletypes(self.top, f)

    def _sec_dihedraltypes(self, f):
        _parse_dihedraltypes(self.top, f)

    # -- molecule-level sections --
    def _require_mol(self) -> MoleculeDef:
        if self.current_mol is None:
            raise ValueError("molecule section before [ moleculetype ]")
        return self.current_mol

    def _sec_moleculetype(self, f):
        mol = MoleculeDef(name=f[0], nrexcl=int(f[1]))
        self.top.molecule_defs[mol.name] = mol
        self.current_mol = mol

    def _sec_atoms(self, f):
        mol = self._require_mol()
        atom = {
            "type": f[1],
            "res_idx": int(f[2]),
            "res_name": f[3],
            "name": f[4],
            "cgnr": int(f[5]),
            "charge": float(f[6]) if len(f) > 6 else None,
            "mass": float(f[7]) if len(f) > 7 else None,
        }
        mol.atoms[int(f[0])] = atom

    def _sec_bonds(self, f):
        self._require_mol().bonds[(int(f[0]), int(f[1]))] = f[2:]

    def _sec_angles(self, f):
        self._require_mol().angles[(int(f[0]), int(f[1]), int(f[2]))] = f[3:]

    def _sec_dihedrals(self, f):
        self._require_mol().dihedrals[(int(f[0]), int(f[1]), int(f[2]), int(f[3]))] = f[4:]

    def _sec_improper_dihedrals(self, f):
        self._require_mol().improper_dihedrals[(int(f[0]), int(f[1]), int(f[2]), int(f[3]))] = f[4:]

    def _sec_pairs(self, f):
        self._require_mol().pairs[(int(f[0]), int(f[1]))] = f[2:]

    # -- system sections --
    def _sec_system(self, f):
        self.top.system_name = f[0]

    def _sec_molecules(self, f):
        self.top.molecules.append((f[0], int(f[1])))


def parse_lines(lines, file_name: str = "") -> TopologyFile:
    top = TopologyFile(file_name=file_name)
    p = _Parser(top)
    for line in lines:
        p.feed(line)
    return top


def read_topology_file(file_name: str, expand_includes: bool = True) -> TopologyFile:
    """Read a topology file.

    With ``expand_includes=True`` the preprocessor inlines #include files and
    applies #define substitutions; with ``False`` only the file's own content
    is parsed (the reference's "master topology" read used to register
    reaction-product atom types; ref: gromacs_topology.py:164-166, 257-267).
    """
    if expand_includes:
        lines = preprocess(file_name)
    else:
        with open(file_name) as f:
            lines = [l.rstrip("\n") for l in f]
    return parse_lines(lines, file_name)


def write_topology_file(file_name: str, top: TopologyFile, backup: bool = True) -> None:
    """Write a topology file (used for the reacted output topology;
    ref: start_simulation.py:834-994)."""
    out = []

    def section(name):
        out.append("")
        out.append("[ %s ]" % name)

    if top.defaults:
        section("defaults")
        d = top.defaults
        out.append(
            "%d %d %s %s %s"
            % (d.get("nbfunc", 1), d["combinationrule"], "yes" if d.get("gen-pairs") else "no",
               d.get("fudgeLJ", 1.0), d.get("fudgeQQ", 1.0))
        )
    if top.atomtypes:
        section("atomtypes")
        for name, v in top.atomtypes.items():
            out.append("%s %s %s %s %s %s" % (name, v["mass"], v["charge"], v["type"], v["sigma"], v["epsilon"]))
    if top.atomstate:
        section("atomstate")
        for name, st in top.atomstate.items():
            out.append("%s %d" % (name, st))
    if top.bondtypes:
        section("bondtypes")
        seen = set()
        for (i, j), v in top.bondtypes.items():
            if (j, i) in seen:
                continue
            seen.add((i, j))
            out.append("%s %s %d %s" % (i, j, v["func"], " ".join(map(str, v["params"]))))
    if top.angletypes:
        section("angletypes")
        seen = set()
        for (i, j, k), v in top.angletypes.items():
            if (k, j, i) in seen:
                continue
            seen.add((i, j, k))
            out.append("%s %s %s %d %s" % (i, j, k, v["func"], " ".join(map(str, v["params"]))))
    if top.dihedraltypes:
        section("dihedraltypes")
        seen = set()
        for key, v in top.dihedraltypes.items():
            if tuple(reversed(key)) in seen:
                continue
            seen.add(key)
            out.append("%s %s %s %s %d %s" % (key + (v["func"], " ".join(map(str, v["params"])))))
    if top.nonbond_params:
        section("nonbond_params")
        for (i, j), v in top.nonbond_params.items():
            out.append("%s %s %d %s" % (i, j, v["func"], " ".join(map(str, v["params"]))))
    for mol_name, mol in top.molecule_defs.items():
        section("moleculetype")
        out.append("%s %d" % (mol_name, mol.nrexcl))
        section("atoms")
        for aid in sorted(mol.atoms):
            a = mol.atoms[aid]
            out.append(
                "%d %s %d %s %s %d %s %s"
                % (aid, a["type"], a["res_idx"], a["res_name"], a["name"], a["cgnr"],
                   a["charge"] if a["charge"] is not None else 0.0,
                   a["mass"] if a["mass"] is not None else "")
            )
        for sec_name, data in (
            ("bonds", mol.bonds),
            ("angles", mol.angles),
            ("dihedrals", mol.dihedrals),
            ("dihedrals", mol.improper_dihedrals),   # second [dihedrals] block
            ("pairs", mol.pairs),
        ):
            if data:
                section(sec_name)
                for key in sorted(data):
                    out.append("%s %s" % (" ".join(map(str, key)), " ".join(map(str, data[key]))))
    section("system")
    out.append(top.system_name or "system")
    section("molecules")
    for name, count in top.molecules:
        out.append("%s %d" % (name, count))
    path = prepare_path(file_name) if backup else file_name
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")
