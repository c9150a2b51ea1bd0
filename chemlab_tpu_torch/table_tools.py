"""Table manipulation CLIs: convert / fix / mix.

The port's own copy of ``chemlab_tpu/table_tools.py``, over the port's
``files_io``, so that the port imports nothing of the JAX package.  Run
it as ``python -m chemlab_tpu_torch.table_tools {convert,fix,mix} ...``.

Behavioral ports of the reference's tools/ scripts:
  - convert: GROMACS .xvg -> espp-style .pot 3-column (r, E, F); bonded
    tables keep 3 columns with degree->radian conversion for angles and
    dihedrals, nonbonded 7-column tables combine c6*g + c12*h
    (ref: tools/convert_gromacs2espp.py:28-110)
  - fix: repair zero endpoint forces by copying the adjacent value
    (ref: tools/fix_table.py)
  - mix: arithmetic x*T1 + (1-x)*T2 or geometric T1^x * T2^(1-x) blends of
    two tables on a shared grid (ref: tools/mix_table.py)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from . import files_io


def convert(in_file: str, out_file: str | None = None, sigma: float = 1.0,
            epsilon: float = 1.0, c6: float = 1.0, c12: float = 1.0) -> str:
    r, e, f, kind = files_io.read_table(in_file, c6=c6, c12=c12)
    if kind in ("bond", "nonbonded"):
        # sigma scales distances only — angle/dihedral grids are radians
        # (ref: tools/convert_gromacs2espp.py:73-79)
        r = r / sigma
        f = f * sigma
    e = e / epsilon
    f = f / epsilon
    out_file = out_file or in_file.replace(".xvg", ".pot")
    if out_file == in_file:
        raise ValueError("output would overwrite the input %s — pass an "
                         "explicit out_file" % in_file)
    with open(out_file, "w") as out:
        for ri, ei, fi in zip(r, e, f):
            out.write("%15.8g %15.8g %15.8g\n" % (ri, ei, fi))
    return out_file


def fix(table_file: str) -> None:
    d = np.loadtxt(table_file)
    if d[0][2] == 0.0:
        d[0][2] = d[1][2]
    if d[-1][2] == 0.0:
        d[-1][2] = d[-2][2]
    np.savetxt(table_file, d)


def mix(table1: str, table2: str, out_file: str, coupling: float = 0.5,
        mix_type: str = "arithmetic", constant: float = 0.0) -> str:
    t1 = np.loadtxt(table1)
    t2 = np.loadtxt(table2)
    m = min(t1.shape[0], t2.shape[0])
    if not np.allclose(t1[:m, 0], t2[:m, 0]):
        raise RuntimeError("both r columns must match")
    out = np.array(t1[:m])
    x = coupling
    if mix_type == "arithmetic":
        out[:, 1] = x * t1[:m, 1] + (1.0 - x) * t2[:m, 1]
        out[:, 2] = x * t1[:m, 2] + (1.0 - x) * t2[:m, 2]
    else:  # geometric: U = sign-preserving |U1|^x |U2|^(1-x) + constant
        u = np.abs(t1[:m, 1]) ** x * np.abs(t2[:m, 1]) ** (1.0 - x)
        out[:, 1] = np.sign(t1[:m, 1]) * u + constant
        out[:, 2] = -np.gradient(out[:, 1], out[:, 0])
    np.savetxt(out_file, out)
    return out_file


def main(argv=None):
    p = argparse.ArgumentParser(prog="chemlab-tables")
    sub = p.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("convert", help=".xvg -> .pot")
    pc.add_argument("in_file")
    pc.add_argument("out_file", nargs="?")
    pc.add_argument("--sigma", type=float, default=1.0)
    pc.add_argument("--epsilon", type=float, default=1.0)
    pc.add_argument("--c6", type=float, default=1.0)
    pc.add_argument("--c12", type=float, default=1.0)
    pf = sub.add_parser("fix", help="repair zero endpoint forces")
    pf.add_argument("table_file")
    pm = sub.add_parser("mix", help="blend two tables")
    pm.add_argument("table1")
    pm.add_argument("table2")
    pm.add_argument("out_file")
    pm.add_argument("--coupling", type=float, default=0.5)
    pm.add_argument("--mix_type", choices=("arithmetic", "geometric"),
                    default="arithmetic")
    pm.add_argument("--constant", type=float, default=0.0)
    a = p.parse_args(argv)
    if a.cmd == "convert":
        print(convert(a.in_file, a.out_file, a.sigma, a.epsilon, a.c6, a.c12))
    elif a.cmd == "fix":
        fix(a.table_file)
    else:
        print(mix(a.table1, a.table2, a.out_file, a.coupling, a.mix_type,
                  a.constant))
    return 0


if __name__ == "__main__":
    sys.exit(main())
