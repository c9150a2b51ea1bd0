"""Post-run trajectory analysis.

The port's own copy of ``chemlab_tpu/analysis.py``, unchanged, so that
the port imports nothing of the JAX package.  The library functions take
any mapping of arrays laid out as H5MD (an open ``h5py.File`` or nested
dicts); ``main`` (``python -m chemlab_tpu_torch.analysis traj.h5``)
imports ``h5py`` when it runs.

The reference ships per-example analysis scripts over its H5MD output
(e.g. examples/atrp_activator/analyze_structure.py — species census from
``/particles/atoms/species``; examples/mf/*/analyze.py — bond counts from
the padded ``/connectivity`` tables).  This module provides the same
capabilities over chemlab-tpu trajectories as a library + CLI:

  - species/state census time series
  - reacted-bond counts per connectivity list
  - polymer statistics from the final connectivity: degree distribution,
    chain/molecule size distribution, number/weight-average degree of
    polymerization
"""

from __future__ import annotations

import argparse
import collections
import sys

import numpy as np


def load_species_series(h5, group="atoms"):
    """(steps, species array (T, N)) from /particles/<group>/species."""
    g = h5["particles"][group]["species"]
    return np.asarray(g["step"]), np.asarray(g["value"])


def species_census(h5, group="atoms"):
    """Per-frame counts of each species id -> dict[type_id] = (T,) array."""
    steps, vals = load_species_series(h5, group)
    out = {}
    for t in np.unique(vals):
        out[int(t)] = (vals == t).sum(axis=1)
    return steps, out


def state_census(h5, group="atoms"):
    g = h5["particles"][group]["state"]
    steps = np.asarray(g["step"])
    vals = np.asarray(g["value"])
    out = {}
    for s in np.unique(vals):
        out[int(s)] = (vals == s).sum(axis=1)
    return steps, out


def bond_count_series(h5, name="chem_bonds_0"):
    """Valid-bond counts per frame from a padded connectivity table."""
    g = h5["connectivity"][name]
    steps = np.asarray(g["step"])
    vals = np.asarray(g["value"])          # (T, cap, 2), -1 padded
    return steps, (vals[..., 0] >= 0).sum(axis=1)


def molecule_statistics(h5, frame=-1, names=None):
    """Connected-component statistics over all connectivity lists at a frame.

    Returns dict with size histogram, number-average (DPn) and
    weight-average (DPw) degrees of polymerization.
    """
    conn = h5["connectivity"]
    # only pair lists define molecule connectivity (skip angles_0/dihedrals_0)
    names = names or [k for k in conn.keys()
                      if conn[k]["value"].shape[-1] == 2]
    parent = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    for name in names:
        vals = np.asarray(conn[name]["value"])
        rows = vals[frame]
        for a, b in rows:
            if a >= 0 and b >= 0:
                union(int(a), int(b))
    sizes = collections.Counter()
    comp = collections.Counter(find(x) for x in list(parent))
    for root, n in comp.items():
        sizes[n] += 1
    if not sizes:
        return {"sizes": {}, "DPn": 0.0, "DPw": 0.0, "n_molecules": 0}
    ns = np.array(sorted(sizes))
    counts = np.array([sizes[int(n)] for n in ns], float)
    dpn = float((ns * counts).sum() / counts.sum())
    dpw = float((ns * ns * counts).sum() / (ns * counts).sum())
    return {"sizes": dict(zip(ns.tolist(), counts.astype(int).tolist())),
            "DPn": dpn, "DPw": dpw, "n_molecules": int(counts.sum())}


def branching_census(h5, frame=-1, names=None):
    """Terminal/linear/dendritic unit counts by node degree over the bond
    graph at a frame (the hyperbranched-structure census of
    examples/atrp_activator/analyze_structure.py, computed from connectivity
    instead of species bookkeeping)."""
    conn = h5["connectivity"]
    names = names or [k for k in conn.keys()
                      if conn[k]["value"].shape[-1] == 2]
    deg = collections.Counter()
    for name in names:
        rows = np.asarray(conn[name]["value"])[frame]
        for a, b in rows:
            if a >= 0 and b >= 0:
                deg[int(a)] += 1
                deg[int(b)] += 1
    by_degree = collections.Counter(deg.values())
    return {
        "terminal": by_degree.get(1, 0),
        "linear": by_degree.get(2, 0),
        "dendritic": sum(c for d, c in by_degree.items() if d >= 3),
        "degree_histogram": dict(sorted(by_degree.items())),
    }


def main(argv=None):
    import h5py

    p = argparse.ArgumentParser(prog="chemlab-analyze")
    p.add_argument("trajectory", help="H5MD file")
    p.add_argument("--what", default="species",
                   choices=("species", "state", "bonds", "molecules",
                            "branching"))
    p.add_argument("--name", default="chem_bonds_0",
                   help="connectivity list for --what bonds")
    p.add_argument("--frame", default=-1, type=int)
    a = p.parse_args(argv)
    with h5py.File(a.trajectory, "r") as f:
        if a.what == "species":
            steps, census = species_census(f)
            print("step " + " ".join("t%d" % t for t in census))
            for k, s in enumerate(steps):
                print(s, " ".join(str(census[t][k]) for t in census))
        elif a.what == "state":
            steps, census = state_census(f)
            print("step " + " ".join("s%d" % t for t in census))
            for k, s in enumerate(steps):
                print(s, " ".join(str(census[t][k]) for t in census))
        elif a.what == "bonds":
            steps, counts = bond_count_series(f, a.name)
            for s, c in zip(steps, counts):
                print(s, c)
        elif a.what == "branching":
            c = branching_census(f, a.frame)
            print("terminal %d linear %d dendritic %d" % (
                c["terminal"], c["linear"], c["dendritic"]))
            for d, n in c["degree_histogram"].items():
                print("degree %d: %d" % (d, n))
        else:
            stats = molecule_statistics(f, a.frame)
            print("molecules: %d  DPn: %.2f  DPw: %.2f" % (
                stats["n_molecules"], stats["DPn"], stats["DPw"]))
            for size, cnt in sorted(stats["sizes"].items()):
                print("size %d: %d" % (size, cnt))
    return 0


if __name__ == "__main__":
    sys.exit(main())
