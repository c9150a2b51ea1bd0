"""Coordinate-file and potential-table I/O.

The port's own copy of ``chemlab_tpu/files_io.py``, unchanged, so that the
port imports nothing of the JAX package.  ``read_gro_native`` reads a .gro
through the port's host library (``native.py``), and ``read_coordinates``
tries it first for a .gro, falling back to ``read_gro``, as the reference
does.

Coordinate formats (ref: src/chemlab/files_io.py:158-398):
  - .gro  fixed-column GROMACS coordinates, optional velocities, box on the
          last line
  - .pdb  ATOM/HETATM + CRYST1, 0.1 A->nm scaling

Table formats (ref: tools/convert_gromacs2espp.py:28-110):
  - .xvg  GROMACS tables: bonded 3-col (r, E, F; degrees for
          angles/dihedrals), nonbonded 7-col (r, f, f', g, g', h, h')
  - .pot  espressopp-style 3-col table (r, E, F)
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import re

import numpy as np

logger = logging.getLogger(__name__)


def prepare_path(file_path: str) -> str:
    """Back up an existing file as ``_<name>.<n>_`` before overwriting.

    Matches the reference's output-protection behavior
    (ref: src/chemlab/files_io.py:71-96).
    """
    if os.path.exists(file_path):
        file_name = os.path.basename(file_path)
        dir_name = os.path.dirname(file_path) or "."
        copies = [x for x in os.listdir(dir_name) if x.startswith("_%s" % file_name)]
        max_copy = 0
        for x in copies:
            try:
                max_copy = max(max_copy, int(x.strip("_").split(".")[-1]))
            except ValueError:
                continue
        new_path = os.path.join(dir_name, "_%s.%d_" % (file_name, max_copy + 1))
        logger.warning("found %s, moved to backup %s", file_path, new_path)
        os.rename(file_path, new_path)
    return file_path


@dataclasses.dataclass
class Coordinates:
    """Parsed coordinate file as flat arrays sorted by atom id."""

    title: str
    atom_ids: np.ndarray      # (N,) int
    res_idx: np.ndarray       # (N,) int   residue / chain index column
    res_names: list           # (N,) str
    atom_names: list          # (N,) str
    pos: np.ndarray           # (N, 3) float, nm
    vel: np.ndarray | None    # (N, 3) float or None
    box: np.ndarray           # (3,) float, nm

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[0]


def read_gro(file_name: str) -> Coordinates:
    """Read a .gro file (fixed columns; ref: files_io.py:161-214)."""
    with open(file_name) as f:
        lines = f.readlines()
    title = lines[0].rstrip("\r\n")
    n = int(lines[1])
    ids = np.empty(n, dtype=np.int64)
    res_idx = np.empty(n, dtype=np.int64)
    res_names, atom_names = [], []
    pos = np.empty((n, 3), dtype=np.float64)
    vel = np.zeros((n, 3), dtype=np.float64)
    has_vel = False
    for k, line in enumerate(lines[2 : n + 2]):
        res_idx[k] = int(line[0:5])
        res_names.append(line[5:10].strip())
        atom_names.append(line[10:15].strip())
        ids[k] = int(line[15:20])
        pos[k, 0] = float(line[20:28])
        pos[k, 1] = float(line[28:36])
        pos[k, 2] = float(line[36:44])
        if len(line.rstrip()) > 45:
            has_vel = True
            vel[k, 0] = float(line[44:52])
            vel[k, 1] = float(line[52:60])
            vel[k, 2] = float(line[60:68])
    box = np.array([float(x) for x in lines[n + 2].split()[:3]], dtype=np.float64)
    # Sort by atom id so row index == id - min_id; ids wrap at 100000 in the
    # fixed-column format, so only sort when they are a genuine permutation.
    if len(np.unique(ids)) == n:
        order = np.argsort(ids, kind="stable")
    else:
        order = np.arange(n)
    return Coordinates(
        title=title,
        atom_ids=ids[order],
        res_idx=res_idx[order],
        res_names=[res_names[i] for i in order],
        atom_names=[atom_names[i] for i in order],
        pos=pos[order],
        vel=vel[order] if has_vel else None,
        box=box,
    )


def read_gro_native(file_name: str):
    """Native-accelerated .gro read; returns None when the library is absent
    or declines the file (falls back to :func:`read_gro`)."""
    from . import native

    if not native.available():
        return None
    with open(file_name, "rb") as f:
        r = native.parse_gro(f.read())
    if r is None:
        return None
    ids = r["atom_ids"]
    n = r["n_atoms"]
    order = np.argsort(ids, kind="stable") if len(np.unique(ids)) == n \
        else np.arange(n)
    return Coordinates(
        title="",
        atom_ids=ids[order],
        res_idx=r["res_idx"][order],
        res_names=[r["res_names"][i] for i in order],
        atom_names=[r["atom_names"][i] for i in order],
        pos=r["pos"][order],
        vel=r["vel"][order] if r["vel"] is not None else None,
        box=r["box"],
    )


def write_gro(file_name: str, coords: Coordinates, backup: bool = True,
              append: bool = False) -> None:
    """Write a .gro file in the reference's fixed format (ref: files_io.py:216-259).

    ``append`` adds the frame to an existing trajectory file (DumpGRO append
    mode; ref: start_simulation.py:686-696).
    """
    out = [coords.title or "generated by chemlab_tpu", "%d" % coords.n_atoms]
    fmt = "%5d%-5s%5s%5d%8.3f%8.3f%8.3f"
    fmt_v = fmt + "%8.3f%8.3f%8.3f"
    for k in range(coords.n_atoms):
        fields = (
            int(coords.res_idx[k]) % 100000,
            coords.res_names[k],
            coords.atom_names[k],
            int(coords.atom_ids[k]) % 100000,
            coords.pos[k, 0],
            coords.pos[k, 1],
            coords.pos[k, 2],
        )
        if coords.vel is not None:
            out.append(fmt_v % (fields + tuple(coords.vel[k])))
        else:
            out.append(fmt % fields)
    out.append("%f %f %f\n" % tuple(coords.box))
    if append:
        with open(file_name, "a") as f:
            f.write("\n".join(out))
        return
    path = prepare_path(file_name) if backup else file_name
    with open(path, "w") as f:
        f.write("\n".join(out))


def read_pdb(file_name: str) -> Coordinates:
    """Read a .pdb file; positions scaled 0.1 A->nm (ref: files_io.py:311-349)."""
    scale = 0.1
    ids, res_idx, res_names, atom_names, pos = [], [], [], [], []
    box = None
    with open(file_name) as f:
        for line in f:
            if line.startswith("CRYST1"):
                box = np.array([float(x) for x in line.split()[1:4]]) * scale
            elif line.startswith(("ATOM", "HETATM")):
                ids.append(int(line[6:11]))
                atom_names.append(line[12:16].strip())
                res_names.append(line[17:20].strip())
                ri = line[22:26].strip()
                res_idx.append(int(ri) if ri else 0)
                pos.append(
                    [float(line[30:38]) * scale, float(line[38:46]) * scale, float(line[46:54]) * scale]
                )
    if box is None:
        raise ValueError("PDB file %s has no CRYST1 box" % file_name)
    if not np.allclose(box, box[0]):
        raise ValueError("only cubic PDB boxes are supported")
    ids_a = np.asarray(ids, dtype=np.int64)
    order = np.argsort(ids_a, kind="stable")
    return Coordinates(
        title=os.path.basename(file_name),
        atom_ids=ids_a[order],
        res_idx=np.asarray(res_idx, dtype=np.int64)[order],
        res_names=[res_names[i] for i in order],
        atom_names=[atom_names[i] for i in order],
        pos=np.asarray(pos, dtype=np.float64)[order],
        vel=None,
        box=box,
    )


def write_pdb(file_name: str, coords: Coordinates, backup: bool = True) -> None:
    """Write a .pdb file; positions scaled nm -> 0.1 A (ref:
    files_io.py:352-398 PDBFile.write).

    Emits standards-conforming records (CRYST1 / ATOM / TER / ENDMDL).
    Deviation from the reference: its writer inserts a bare atom-count
    line after CRYST1, which standard PDB parsers reject — omitted here
    (read_pdb on either side skips unknown lines, so round-trips work
    both ways).
    """
    scale = 0.1
    out = ["REMARK generated by chemlab_tpu", "MODEL 1"]
    out.append("%-6s%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f %-11s%4d" % (
        "CRYST1", coords.box[0] / scale, coords.box[1] / scale,
        coords.box[2] / scale, 90.0, 90.0, 90.0, "P 1", 1))
    fmt = "%-6s%5d %-4s %-3s  %4d    %8.3f%8.3f%8.3f                      %2s"
    for k in range(coords.n_atoms):
        name = coords.atom_names[k]
        out.append(fmt % (
            "ATOM", int(coords.atom_ids[k]) % 100000, name[:4],
            coords.res_names[k][:3], int(coords.res_idx[k]) % 10000,
            coords.pos[k, 0] / scale, coords.pos[k, 1] / scale,
            coords.pos[k, 2] / scale, name[:2]))
    out.append("TER")
    out.append("ENDMDL\n")
    path = prepare_path(file_name) if backup else file_name
    with open(path, "w") as f:
        f.write("\n".join(out))


def read_coordinates(file_name: str) -> Coordinates:
    """Dispatch on file suffix (ref: files_io.py:1239-1245)."""
    suffix = file_name.rsplit(".", 1)[-1]
    if suffix == "gro":
        coords = read_gro_native(file_name)
        return coords if coords is not None else read_gro(file_name)
    if suffix == "pdb":
        return read_pdb(file_name)
    raise ValueError("unsupported coordinate format: %s" % file_name)


def write_coordinates(file_name: str, coords: Coordinates, **kw) -> None:
    """Dispatch on file suffix, mirroring read_coordinates."""
    suffix = file_name.rsplit(".", 1)[-1]
    if suffix == "gro":
        return write_gro(file_name, coords, **kw)
    if suffix == "pdb":
        return write_pdb(file_name, coords, **kw)
    raise ValueError("unsupported coordinate format: %s" % file_name)


_RE_BOND_TAB = re.compile(r".*_b[0-9]+.*")
_RE_ANGLE_TAB = re.compile(r".*_a[0-9]+.*")
_RE_DIHEDRAL_TAB = re.compile(r".*_d[0-9]+.*")


def table_kind_from_name(file_name: str) -> str:
    """Classify a table file by name: nonbonded / bond / angle / dihedral.

    Same filename convention as the reference converter
    (ref: tools/convert_gromacs2espp.py:44-57).
    """
    base = os.path.basename(file_name)
    if _RE_BOND_TAB.match(base):
        return "bond"
    if _RE_ANGLE_TAB.match(base):
        return "angle"
    if _RE_DIHEDRAL_TAB.match(base):
        return "dihedral"
    return "nonbonded"


def read_table(file_name: str, kind: str | None = None, c6: float = 1.0, c12: float = 1.0):
    """Read a potential table into (r, E, F) float64 arrays.

    - ``.pot`` files are 3 columns (r, E, F) in engine units.
    - ``.xvg`` bonded files are 3 columns; angle/dihedral tables use degrees
      and are converted to radians (F scaled by 180/pi).
    - ``.xvg`` nonbonded files are 7 columns; E = c6*g + c12*h, F likewise
      (ref: tools/convert_gromacs2espp.py:62-107).

    Returns (r, E, F, kind).
    """
    if kind is None:
        kind = table_kind_from_name(file_name)
    data = np.loadtxt(file_name, comments=["#", "@", ";"])
    if data.ndim == 1:
        data = data[None, :]
    is_pot = file_name.endswith(".pot")
    if is_pot or data.shape[1] == 3:
        r, e, f = data[:, 0], data[:, 1], data[:, 2]
        if not is_pot and kind in ("angle", "dihedral"):
            # .xvg angle/dihedral tables are in degrees.
            r = np.radians(r)
            f = f * 180.0 / math.pi
    elif data.shape[1] >= 7:
        r = data[:, 0]
        e = c6 * data[:, 3] + c12 * data[:, 5]
        f = c6 * data[:, 4] + c12 * data[:, 6]
        kind = "nonbonded"
    else:
        raise ValueError("unrecognized table layout in %s (%d columns)" % (file_name, data.shape[1]))
    if kind == "bond" or kind == "nonbonded":
        keep = r > 0.0
    elif kind == "angle":
        keep = (r > 0.0) & (r <= math.pi + 1e-9)
    else:  # dihedral
        keep = (r >= -math.pi - 1e-9) & (r <= math.pi + 1e-9)
    return r[keep], e[keep], f[keep], kind


def convert_table(xvg_name: str, pot_name: str | None = None) -> str:
    """Convert a GROMACS .xvg table to a 3-column .pot file on disk.

    Mirrors the on-demand conversion the reference performs during setup
    (ref: src/chemlab/gromacs_topology.py:124-129).
    """
    if pot_name is None:
        pot_name = "%s.pot" % xvg_name.replace(".xvg", "").replace(".pot", "")
    if os.path.exists(pot_name):
        return pot_name
    r, e, f, _ = read_table(xvg_name)
    with open(pot_name, "w") as out:
        for ri, ei, fi in zip(r, e, f):
            out.write("%15.8g %15.8g %15.8g\n" % (ri, ei, fi))
    return pot_name


def resolve_table(name: str, search_dirs=(".",)) -> str:
    """Find a table file by name, preferring .pot next to the .xvg."""
    candidates = []
    base = name.replace(".xvg", "").replace(".pot", "")
    for d in search_dirs:
        candidates.append(os.path.join(d, base + ".pot"))
        candidates.append(os.path.join(d, base + ".xvg"))
    for c in candidates:
        if os.path.exists(c):
            return c
    raise FileNotFoundError("table %s not found in %s" % (name, list(search_dirs)))
