"""LAMMPS data/input readers.

The port's own copy of ``chemlab_tpu/lammps_io.py``, unchanged, so that
the port imports nothing of the JAX package.

Behavioral port of the reference's ``LammpsReader`` (ref: src/chemlab/
files_io.py:979-1236), used for cross-validating against LAMMPS twins of the
examples (examples/rim135/epoxy.in).  Parses a data file's header + sections
(Masses, Atoms, Velocities, Bonds, Angles, Dihedrals, Impropers) and the
subset of input-script commands that carry force-field content
(*_style, pair_coeff, bond_coeff, angle_coeff, dihedral_coeff, units).
With ``units real`` distances scale by 0.1 (A -> nm), as in the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_SECTIONS = ("Masses", "Atoms", "Velocities", "Bonds", "Angles", "Dihedrals",
             "Impropers", "Pair Coeffs", "Bond Coeffs", "Angle Coeffs",
             "Dihedral Coeffs", "Improper Coeffs")


@dataclasses.dataclass
class LammpsSystem:
    units: str = "lj"
    scale: float = 1.0
    box: np.ndarray | None = None            # (3,)
    masses: dict = dataclasses.field(default_factory=dict)   # type -> mass
    atoms: dict = dataclasses.field(default_factory=dict)    # id -> record
    velocities: dict = dataclasses.field(default_factory=dict)
    bonds: dict = dataclasses.field(default_factory=dict)    # id -> (type,i,j)
    angles: dict = dataclasses.field(default_factory=dict)
    dihedrals: dict = dataclasses.field(default_factory=dict)
    impropers: dict = dataclasses.field(default_factory=dict)
    styles: dict = dataclasses.field(default_factory=dict)   # kind -> style
    coeffs: dict = dataclasses.field(default_factory=dict)   # (kind, type) -> params

    @property
    def n_atoms(self) -> int:
        return len(self.atoms)


def read_data_file(path: str, units: str = "lj",
                   atom_style: str = "full") -> LammpsSystem:
    sys_ = LammpsSystem(units=units, scale=0.1 if units == "real" else 1.0)
    s = sys_.scale
    lines = open(path).read().splitlines()
    box = np.zeros((3, 2))
    section = None
    for raw in lines[1:]:
        line = raw.split("#")[0].strip()
        if not line:
            continue
        named = next((name for name in _SECTIONS
                      if line == name or line.startswith(name + " ")), None)
        if named:
            section = named
            continue
        fields = line.split()
        if section is None:  # header
            if line.endswith(("xlo xhi", "ylo yhi", "zlo zhi")):
                ax = "xyz".index(line.split()[-2][0])
                box[ax] = [float(fields[0]), float(fields[1])]
            continue
        if section == "Masses":
            sys_.masses[int(fields[0])] = float(fields[1])
        elif section == "Atoms":
            aid = int(fields[0])
            if atom_style == "full":   # id mol type q x y z
                rec = {"mol": int(fields[1]), "type": int(fields[2]),
                       "q": float(fields[3]),
                       "pos": np.array([float(x) for x in fields[4:7]]) * s}
            else:                      # atomic: id type x y z
                rec = {"mol": 0, "type": int(fields[1]), "q": 0.0,
                       "pos": np.array([float(x) for x in fields[2:5]]) * s}
            sys_.atoms[aid] = rec
        elif section == "Velocities":
            sys_.velocities[int(fields[0])] = \
                np.array([float(x) for x in fields[1:4]]) * s
        elif section == "Bonds":
            sys_.bonds[int(fields[0])] = tuple(int(x) for x in fields[1:4])
        elif section == "Angles":
            sys_.angles[int(fields[0])] = tuple(int(x) for x in fields[1:5])
        elif section == "Dihedrals":
            sys_.dihedrals[int(fields[0])] = tuple(int(x) for x in fields[1:6])
        elif section == "Impropers":
            sys_.impropers[int(fields[0])] = tuple(int(x) for x in fields[1:6])
        elif section.endswith("Coeffs"):
            kind = section.split()[0].lower()
            sys_.coeffs[(kind, int(fields[0]))] = [float(x) for x in fields[1:]]
    sys_.box = (box[:, 1] - box[:, 0]) * s
    return sys_


def read_input_file(path: str, system: LammpsSystem | None = None) -> LammpsSystem:
    """Parse force-field content from a LAMMPS input script; reads the data
    file referenced by ``read_data`` when present."""
    import os

    sys_ = system
    units = "lj"
    pending = []
    cwd = os.path.dirname(os.path.abspath(path))
    for raw in open(path):
        line = raw.split("#")[0].strip()
        if not line:
            continue
        fields = line.split()
        cmd = fields[0]
        if cmd == "units":
            units = fields[1]
        elif cmd == "read_data":
            data_path = os.path.join(cwd, fields[1])
            if os.path.exists(data_path):
                sys_ = read_data_file(data_path, units=units)
        elif cmd.endswith("_style"):
            pending.append(("style", cmd[: -len("_style")], fields[1:]))
        elif cmd.endswith("_coeff"):
            pending.append(("coeff", cmd[: -len("_coeff")], fields[1:]))
    if sys_ is None:
        sys_ = LammpsSystem(units=units, scale=0.1 if units == "real" else 1.0)
    for what, kind, fields in pending:
        if what == "style":
            sys_.styles[kind] = " ".join(fields)
        else:
            key = fields[0]
            try:
                key = int(key)
            except ValueError:
                pass
            sys_.coeffs[(kind, key)] = fields[1:]
    return sys_
