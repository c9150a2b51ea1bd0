"""Output writers: H5MD trajectory, connectivity dumps, energy CSV, topology.

Port of ``chemlab_tpu/writers.py``: the same groups, attributes, columns
and text; the state's tensors are read on the host (``.cpu().numpy()``).
Format-compatible with the reference's io layer (SURVEY.md §2.4):

  - :class:`H5MDWriter` — DumpH5MD equivalent: ``/particles/atoms/*`` time
    series (species/state/position/velocity/force/mass/charge/res_id/lambda),
    ``/parameters`` attrs + ``/parameters/force_field/atomtypes``, H5MD
    metadata group (ref: start_simulation.py:574-591, 810-832)
  - connectivity time series under ``/connectivity/<name>/{step,time,value}``
    as fixed-shape bond tables padded with -1 — the reference ships the same
    padded representation (DumpTopology; ref: start_simulation.py:594-657)
  - :class:`SystemMonitorCSV` — energy/observable CSV
    (ref: start_simulation.py:446-478)
  - :func:`write_topology` — regenerated output .top with all reacted bonds
    (ref: start_simulation.py:834-994)
  - :func:`state_to_coordinates` — bridge to files_io.write_gro (DumpGRO)
"""

from __future__ import annotations

import getpass

import numpy as np
import torch

from . import files_io


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class H5MDWriter:
    """Minimal-but-compatible H5MD trajectory writer."""

    def __init__(self, path, n_particles, box, store=None, author=None,
                 email=None, single_precision=True, backup=True,
                 chunk_size=256):
        try:
            import h5py
        except ImportError as exc:
            raise ImportError("H5MDWriter needs h5py, which is not "
                              "installed") from exc

        if backup:
            files_io.prepare_path(path)
        self.f = h5py.File(path, "w")
        self.n = n_particles
        self.store = store or {"position", "species", "state", "mass", "res_id"}
        self.fdtype = np.float32 if single_precision else np.float64
        # frame-chunked storage along the particle axis (ref DumpH5MD's
        # chunk_size=256, start_simulation.py:574-591)
        self.chunk = max(int(chunk_size), 1) if chunk_size else None

        h5md = self.f.create_group("h5md")
        h5md.attrs["version"] = [1, 1]
        auth = h5md.create_group("author")
        auth.attrs["name"] = author or getpass.getuser()
        if email:
            auth.attrs["email"] = email
        creator = h5md.create_group("creator")
        creator.attrs["name"] = "chemlab_tpu_torch"
        creator.attrs["version"] = "0.1"

        self.atoms = self.f.create_group("particles/atoms")
        boxg = self.atoms.create_group("box")
        boxg.attrs["dimension"] = 3
        boxg.attrs["boundary"] = ["periodic"] * 3
        boxg.create_dataset("edges", data=_host(box).astype(np.float64))

        self._series = {}
        self.f.create_group("parameters")
        self.f.create_group("connectivity")

    def _get_series(self, group, name, shape, dtype, grow_rows=False,
                    fill=None):
        key = (group.name, name)
        if key not in self._series:
            g = group.create_group(name)
            g.create_dataset("step", shape=(0,), maxshape=(None,), dtype="i8")
            g.create_dataset("time", shape=(0,), maxshape=(None,), dtype="f8")
            chunks = None
            if self.chunk and shape:
                chunks = (1, min(self.chunk, shape[0])) + shape[1:]
            # grow_rows: the row axis stays resizable — term-table
            # capacities legitimately grow mid-run (reactive appends), and
            # the series must follow (earlier frames backfill with `fill`)
            maxshape = ((None, None) + shape[1:]) if grow_rows \
                else ((None,) + shape)
            g.create_dataset("value", shape=(0,) + shape,
                             maxshape=maxshape, dtype=dtype,
                             chunks=chunks, fillvalue=fill)
            self._series[key] = g
        return self._series[key]

    def _append(self, g, step, t, value):
        n = g["step"].shape[0]
        for name, val in (("step", step), ("time", t), ("value", value)):
            ds = g[name]
            ds.resize(n + 1, axis=0)
            ds[n] = val

    def dump(self, step, t, *, position=None, image=None, species=None,
             state=None, mass=None, charge=None, res_id=None, lam=None,
             velocity=None, force=None):
        """Append one frame (arrays sized n_particles)."""
        fields = {
            "position": (position, self.fdtype, (self.n, 3)),
            "image": (image, "i4", (self.n, 3)),
            "species": (species, "i4", (self.n,)),
            "state": (state, "i4", (self.n,)),
            "mass": (mass, self.fdtype, (self.n,)),
            "charge": (charge, self.fdtype, (self.n,)),
            "res_id": (res_id, "i4", (self.n,)),
            "lambda_adr": (lam, self.fdtype, (self.n,)),
            "velocity": (velocity, self.fdtype, (self.n, 3)),
            "force": (force, self.fdtype, (self.n, 3)),
        }
        for name, (val, dtype, shape) in fields.items():
            if val is None:
                continue
            if self.store and name not in self.store and name != "image":
                continue
            g = self._get_series(self.atoms, name, shape, dtype)
            self._append(g, step, t, _host(val)[: self.n])

    def dump_connectivity(self, name, step, t, table):
        """Append a -1-padded index table under /connectivity.

        The row count follows the term table's CURRENT capacity: growth
        (grow/presize_term_caps) widens the series in place (old frames
        backfill with -1 padding), a shrink pads the incoming frame up —
        readers see a consistent -1-padded series either way."""
        table = _host(table).astype(np.int32)
        g = self._get_series(self.f["connectivity"], name, table.shape,
                             "i4", grow_rows=True, fill=-1)
        ds = g["value"]
        rows = ds.shape[1]
        if table.shape[0] > rows:
            ds.resize(table.shape[0], axis=1)
        elif table.shape[0] < rows:
            pad = np.full((rows - table.shape[0],) + table.shape[1:], -1,
                          np.int32)
            table = np.concatenate([table, pad])
        self._append(g, step, t, table)

    def write_parameters(self, args_namespace=None, force_field=None):
        """/parameters attrs + /parameters/force_field/atomtypes
        (ref: start_simulation.py:810-832; tools.py:28-48)."""
        p = self.f["parameters"]
        if args_namespace is not None:
            for k, v in sorted(vars(args_namespace).items()):
                if v is not None:
                    p.attrs[k] = str(v)
        if force_field is not None:
            ff = p.require_group("force_field")
            rows = [(sym, rec.get("mass", 0.0), rec.get("charge", 0.0),
                     rec.get("sigma", 0.0), rec.get("epsilon", 0.0),
                     rec.get("state", -1))
                    for sym, rec in sorted(force_field.items())]
            dt = np.dtype([("name", "S16"), ("mass", "f8"), ("charge", "f8"),
                           ("sigma", "f8"), ("epsilon", "f8"), ("state", "i4")])
            arr = np.array([(r[0].encode(), r[1], r[2], r[3], r[4], r[5])
                            for r in rows], dtype=dt)
            if "atomtypes" in ff:
                del ff["atomtypes"]
            ff.create_dataset("atomtypes", data=arr)

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


class SystemMonitorCSV:
    """Energy/observable CSV, one row per measurement
    (ref: SystemMonitorOutputCSV; start_simulation.py:446-452)."""

    def __init__(self, path, backup=True):
        if backup:
            files_io.prepare_path(path)
        self.path = path
        self.header = None
        self.f = open(path, "w")

    def row(self, values: dict):
        if self.header is None:
            self.header = list(values.keys())
            self.f.write(",".join(self.header) + "\n")
        self.f.write(",".join("%g" % float(values.get(k, float("nan")))
                              for k in self.header) + "\n")

    def flush(self):
        self.f.flush()

    def close(self):
        self.f.close()


def state_to_coordinates(state, systop, coords_in, unfolded=False):
    """A Coordinates record from the live state (DumpGRO path)."""
    import dataclasses as dc

    n = systop.n_atoms
    pos = _host(state.pos)[:n]
    if unfolded:
        pos = pos + _host(state.image)[:n] * _host(state.box)
    vel = _host(state.vel)[:n]
    tid = _host(state.type_id)[:n]
    names = [systop.atomtype_atomsym.get(int(t), "X")[:5] for t in tid]
    return dc.replace(coords_in, pos=pos, vel=vel, atom_names=names,
                      box=_host(state.box))


def _system_nrexcl(systop) -> int:
    vals = [mol.nrexcl for mol in systop.top.molecule_defs.values()]
    return max(vals) if vals else 3


def write_topology(path, systop, state, group_names=(), backup=True):
    """Regenerate an output .top from live state: current types/charges/masses,
    all bonds (static + reaction-created), angles, dihedrals
    (ref: start_simulation.py:834-994)."""
    if backup:
        files_io.prepare_path(path)
    n = systop.n_atoms
    tid = _host(state.type_id)[:n]
    mass = _host(state.mass)[:n]
    q = _host(state.q)[:n]
    chem = _host(state.chem_state)[:n]
    res = _host(state.res_id)[:n]

    lines = []
    lines.append("; regenerated by chemlab_tpu_torch\n")
    if systop.defaults:
        d = systop.defaults
        lines.append("[ defaults ]\n%s %s\n\n" % (d.get("nbfunc", 1),
                                                  d.get("combinationrule", 1)))
    lines.append("[ atomtypes ]\n")
    for sym in sorted(systop.atomsym_atomtype, key=systop.atomsym_atomtype.get):
        rec = systop.top.atomtypes.get(sym, {})
        lines.append("%s %s %s A %s %s\n" % (
            sym, rec.get("mass", 1.0), rec.get("charge", 0.0),
            rec.get("sigma", 1.0), rec.get("epsilon", 0.0)))
    # carry bonded type tables so type-looked-up params survive a reload
    if systop.top.bondtypes:
        lines.append("\n[ bondtypes ]\n")
        for key, rec in systop.top.bondtypes.items():
            lines.append("%s %d %s\n" % (" ".join(key), rec["func"],
                                         " ".join(map(str, rec["params"]))))
    if systop.top.angletypes:
        lines.append("\n[ angletypes ]\n")
        for key, rec in systop.top.angletypes.items():
            lines.append("%s %d %s\n" % (" ".join(key), rec["func"],
                                         " ".join(map(str, rec["params"]))))
    if systop.top.dihedraltypes:
        lines.append("\n[ dihedraltypes ]\n")
        for key, rec in systop.top.dihedraltypes.items():
            lines.append("%s %d %s\n" % (" ".join(key), rec["func"],
                                         " ".join(map(str, rec["params"]))))
    lines.append("\n[ moleculetype ]\nMOL %d\n\n[ atoms ]\n"
                 % _system_nrexcl(systop))
    for i in range(n):
        sym = systop.atomtype_atomsym.get(int(tid[i]), "X")
        name = systop.atom_names[i] if i < len(systop.atom_names) else sym
        lines.append("%d %s %d %s %s %d %.6f %.6f ; state=%d\n" % (
            i + 1, sym, res[i], systop.chain_names[i] if i < len(systop.chain_names)
            else "RES", name, i + 1, q[i], mass[i], chem[i]))

    def dump_terms(title, table, arity):
        idx = _host(table.idx)
        func = _host(table.func)
        grp = _host(table.group)
        valid = idx[:, 0] >= 0
        lines.append("\n[ %s ]\n" % title)
        for r in np.where(valid)[0]:
            ids = " ".join(str(int(x) + 1) for x in idx[r, :arity])
            tag = " ; chem group=%d" % grp[r] if grp[r] >= 0 else ""
            lines.append("%s %d%s\n" % (ids, int(func[r]), tag))

    dump_terms("bonds", state.bonds, 2)
    dump_terms("angles", state.angles, 3)
    if state.dihedrals.capacity > 1:
        dump_terms("dihedrals", state.dihedrals, 4)

    lines.append("\n[ system ]\nchemlab_tpu_torch\n\n[ molecules ]\nMOL 1\n")
    with open(path, "w") as f:
        f.writelines(lines)
