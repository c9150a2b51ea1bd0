"""Coordinate container and potential-table I/O.

The port's own copy of the parts of ``chemlab_tpu/files_io.py`` that it
needs (``prepare_path``, ``Coordinates``, ``table_kind_from_name``,
``read_table``, ``resolve_table``), unchanged, so that the port imports
nothing of the JAX package.

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
