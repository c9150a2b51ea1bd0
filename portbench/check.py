"""The comparison that decides ``correct``.

A run's trajectory cannot be followed from its start by a second program:
the melt is chaotic.  So the reference follows the program from the
program's own state, one stage at a time, at the timed sizes:

- ``start_mismatch``: the built topology (bonds, angles, exclusions,
  types, states, molecules, residues, parameters) against the one the
  reference works out from the configuration file.  Exact: limit 0.
- ``reaction_mismatch``: the window's last reaction step.  From the
  topology the program held before that step (the state it handed to the
  window's last block) and the positions at the step, the reference
  finds the events and the topology that results; the program's events
  (its event log), bonds, angles, exclusions, adjacency, types, states,
  molecules, counters and parameters after the window must equal them.
  Exact: limit 0.
- ``force_gap``, ``drift_gap``, ``vel_gap``: one more step of the
  program from the window's end state, the Langevin noise given by the
  benchmark, against the reference's step from the same state and noise
  (``reference.forces.langevin_step``): the force on each particle at
  the program's new positions (pairs with the excluded pairs left out,
  bonds, angles, friction and noise), the drift, and the new velocities.
  A pair at the cutoff counts either way (``cutoff_band``), and an angle
  folded flat or stretched straight is judged to within what float32
  can resolve of its force there (``angle_slack``).
- ``pressure_gap``, ``box_gap``: only under a barostat (the configuration's
  ``system.barostat``).  The same step ends with the barostat, which
  reads the pressure and scales the positions and the box by mu.  The
  reference (``reference.barostat``) works out the virial pressure of the
  state the program's barostat read, and its own mu from it; the
  program's pressure of that state and its box after the step are held to
  them.  The force is then judged at the positions before the scaling,
  and the drift at the scaled positions against the reference's drift
  scaled by the reference's mu, so it covers the whole step.

Everything here is NumPy or plain PyTorch; the program's state arrives
as arrays (``snapshot_*``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference import barostat as ref_baro
from .reference import forces as ref_forces
from .reference import reactions as ref_rx
from .reference.system import (Topology, canon_angles, start_topology,
                               unique_rows)

# pairs at the cutoff that one particle may hold, beyond which none of
# them is left to rounding (2^k choices are tried)
MAX_AMBIGUOUS = 6
# an angle whose 1 - |cos theta| is under ANGLE_BAND, at an end of
# [0, pi] where its theta0 is not, has a force that float32 resolves only
# to ANGLE_ULPS roundings of the cosine (2**-24 each) over 1 - |cos theta|
ANGLE_BAND = 1e-3
ANGLE_ULPS = 16.0

NAMES = ("start_mismatch", "reaction_mismatch", "force_gap", "drift_gap",
         "vel_gap")
BAROSTAT_NAMES = ("pressure_gap", "box_gap")


def names(sys_) -> tuple:
    """The numbers compared for the configuration ``sys_``, in order."""
    return NAMES + (BAROSTAT_NAMES if sys_.barostat is not None else ())


def _np(t):
    return t.detach().cpu().numpy()


def _table_rows(table):
    valid = _np(table.idx[:, 0] >= 0)
    return (_np(table.idx)[valid].astype(np.int64), _np(table.func)[valid],
            _np(table.params)[valid])


def active_count(state) -> int:
    """The number of particles: the active rows, which come first (the
    rest is padding)."""
    active = _np(state.active)
    n = int(active.sum())
    if not active[:n].all():
        raise RuntimeError("the active particles are not the first rows")
    return n


def snapshot_topology(state) -> dict:
    """The program's topology as arrays (CPU), with the term tables'
    functions and parameters; per-particle arrays cut to the active
    rows."""
    n = active_count(state)
    b_idx, b_func, b_par = _table_rows(state.bonds)
    a_idx, a_func, a_par = _table_rows(state.angles)
    d_idx, _, _ = _table_rows(state.dihedrals)
    excl = _np(state.excl).astype(np.int64)
    excl = excl[(excl[:, 0] >= 0) & (excl[:, 1] >= 0)]
    topo = Topology(
        type_id=_np(state.type_id)[:n].astype(np.int64),
        chem=_np(state.chem_state)[:n].astype(np.int64),
        mol=_np(state.mol_id)[:n].astype(np.int64),
        res=_np(state.res_id)[:n].astype(np.int64),
        bonds=np.sort(b_idx, axis=1), angles=canon_angles(a_idx),
        excl=np.sort(excl, axis=1))
    return {"topo": topo, "bond_func": b_func, "bond_par": b_par,
            "angle_func": a_func, "angle_par": a_par,
            "n_dihedrals": len(d_idx), "adj": _np(state.adj)[:n],
            "counts": _np(state.reaction_counts).astype(np.int64),
            "ev": (_np(state.ev_log_a), _np(state.ev_log_b),
                   _np(state.ev_log_r)),
            "ev_step": int(state.ev_log_step)}


def _canon_labels(lab):
    """Labels renamed to the first index that carries each: two
    partitions are equal when these are."""
    _, first, inv = np.unique(lab, return_index=True, return_inverse=True)
    return first[inv]


def _set_diff(a_keys, b_keys) -> int:
    return len(np.setxor1d(np.unique(a_keys), np.unique(b_keys)))


def _triple_keys(t, n):
    t = np.asarray(t, dtype=np.int64).reshape(-1, 3)
    return (t[:, 0] * n + t[:, 1]) * n + t[:, 2]


def _param_mismatch(sys_, snap) -> int:
    """Term rows whose function or parameters are not the configuration's
    (U = K (x - x0)^2 as the system stores them)."""
    bad = np.sum(snap["bond_func"] != 1)
    bad += np.sum(~np.isclose(snap["bond_par"][:, 0], sys_.bond_k,
                              rtol=1e-6))
    bad += np.sum(~np.isclose(snap["bond_par"][:, 1], sys_.bond_r0,
                              rtol=1e-6))
    bad += np.sum(snap["angle_func"] != 1)
    bad += np.sum(~np.isclose(snap["angle_par"][:, 0], sys_.angle_k,
                              rtol=1e-6))
    bad += np.sum(~np.isclose(snap["angle_par"][:, 1], sys_.angle_theta0,
                              rtol=1e-6))
    return int(bad) + snap["n_dihedrals"]


def _topology_mismatch(n, got: Topology, want_tid, want_chem, want_mol,
                       want_bonds, want_angles, want_excl) -> int:
    bad = int(np.sum(got.type_id != want_tid))
    bad += int(np.sum(got.chem != want_chem))
    bad += int(np.sum(_canon_labels(got.mol) != _canon_labels(want_mol)))
    bad += _set_diff(ref_rx.pair_keys(got.bonds, n),
                     ref_rx.pair_keys(want_bonds, n))
    bad += len(got.bonds) - len(np.unique(ref_rx.pair_keys(got.bonds, n)))
    bad += _set_diff(_triple_keys(got.angles, n),
                     _triple_keys(want_angles, n))
    bad += _set_diff(ref_rx.pair_keys(got.excl, n),
                     ref_rx.pair_keys(want_excl, n))
    return bad


def start_mismatch(sys_, n_mols: int, snap, want=None) -> int:
    """Mismatches of the built topology against the configuration's
    (``want``, ``start_topology`` where not given)."""
    if want is None:
        want = start_topology(sys_, n_mols)
    got = snap["topo"]
    n = len(want.type_id)
    if len(got.type_id) != n:
        return n
    bad = _topology_mismatch(n, got, want.type_id, want.chem, want.mol,
                             want.bonds, want.angles, want.excl)
    bad += int(np.sum(_canon_labels(got.res) != _canon_labels(want.res)))
    return bad + _param_mismatch(sys_, snap)


def _adj_mismatch(adj_rows, bonds, n) -> int:
    """Particles whose adjacency row (partners in any order, -1 padding)
    is not the set of their bonded partners."""
    e = np.asarray(bonds, dtype=np.int64).reshape(-1, 2)
    e = unique_rows(np.concatenate([e, e[:, ::-1]]))   # by row, then partner
    deg = np.bincount(e[:, 0], minlength=n)
    width = max(adj_rows.shape[1], int(deg.max(initial=0)))
    want = np.full((n, width), n, dtype=np.int64)
    first = np.concatenate([[0], np.cumsum(deg)[:-1]])
    want[e[:, 0], np.arange(len(e)) - first[e[:, 0]]] = e[:, 1]
    got = np.full((n, width), n, dtype=np.int64)
    got[:, :adj_rows.shape[1]] = np.where(adj_rows >= 0, adj_rows, n)
    return int(np.sum(np.any(np.sort(got, axis=1) != want, axis=1)))


def reaction_mismatch(sys_, pre, post, pos, box, step: int, seed: int,
                      start_res, device="cpu"):
    """Mismatches of the program's reaction step (``pre`` -> ``post``
    snapshots, positions ``pos`` at the step) against the reference's;
    also returns the reference's topology after the step."""
    n = len(pre["topo"].type_id)
    topo = Topology(type_id=pre["topo"].type_id, chem=pre["topo"].chem,
                    mol=pre["topo"].mol, res=start_res,
                    bonds=pre["topo"].bonds, angles=pre["topo"].angles,
                    excl=pre["topo"].excl)
    adj = ref_rx.adjacency(topo.bonds, n)
    events = ref_rx.match(sys_, topo, adj, pos.astype(np.float32),
                          box.astype(np.float32), step, seed, device)
    tid, chem, mol, bonds, angles, excl, counts = ref_rx.apply(
        sys_, topo, events)
    ev_a, ev_b, ev_r = post["ev"]
    ok = ev_a >= 0
    got_ev = {(int(a), int(b), int(r))
              for a, b, r in zip(ev_a[ok], ev_b[ok], ev_r[ok])}
    bad = len(got_ev ^ set(events))
    bad += 0 if post["ev_step"] == step else 1
    bad += int(np.sum(np.abs((post["counts"] - pre["counts"])[:len(counts)]
                             - counts)))
    bad += _topology_mismatch(n, post["topo"], tid, chem, mol, bonds,
                              angles, excl)
    bad += _adj_mismatch(post["adj"], bonds, n)
    bad += _param_mismatch(sys_, post)
    want = {"type_id": tid, "bonds": bonds, "angles": angles,
            "excl": excl, "events": events}
    return bad, want


def cutoff_band(box, rc: float) -> float:
    """The r^2 band around the cutoff's inside which float32 rounding
    decides whether a pair is summed: a coordinate of the box's largest
    edge carries half an ulp, a displacement two such, so r^2 is off by
    up to 2 r |dr| < 2 rc sqrt(3) ulp; the band is twice that."""
    ulp = float(np.spacing(np.float32(np.max(np.asarray(box)))))
    return 4.0 * rc * math.sqrt(3.0) * ulp


def angle_slack(sys_, x, box, angles) -> torch.Tensor:
    """(N,) float64: per particle, the force by which float32 rounding may
    move the harmonic angles it is in that lie folded flat or stretched
    straight, 1 - |cos theta| under ``ANGLE_BAND``, at an end of [0, pi]
    where theta0 does not lie; 0 elsewhere.  There the force goes through
    1 / sin(theta) = 1 / sqrt(1 - c^2) of a float32 cosine c, so a
    rounding of c moves it by 2**-24 / (1 - |c|), relative, and near the
    end its direction is lost (the system drops the term past a clamp of
    c).  Each such angle gives its ends min(2, ANGLE_ULPS 2**-24 /
    (1 - |c|)) times their force in the reference, and its apex that
    times the sum of its ends'.  At theta0's own end the force goes to
    nought with sin(theta), and rounding moves it by no more than it moves
    any other term."""
    n = x.shape[0]
    f64 = torch.float64
    slack = torch.zeros(n, dtype=f64, device=x.device)
    a = torch.as_tensor(np.asarray(angles), dtype=torch.long,
                        device=x.device).reshape(-1, 3)
    if not a.numel():
        return slack
    fi, fk, c = ref_forces.angle_end_forces(
        x.to(f64), box.to(f64), a, sys_.angle_k, sys_.angle_theta0)
    end = torch.where(c > 0, 1.0, -1.0).to(f64)
    near = ((1.0 - c * end < ANGLE_BAND)
            & (1.0 - math.cos(sys_.angle_theta0) * end >= ANGLE_BAND))
    kappa = torch.clamp(ANGLE_ULPS * 2.0 ** -24 / (1.0 - c * end), max=2.0)
    kappa = torch.where(near, kappa, torch.zeros_like(kappa))
    si = kappa * torch.linalg.vector_norm(fi, dim=-1)
    sk = kappa * torch.linalg.vector_norm(fk, dim=-1)
    slack.index_add_(0, a[:, 0], si)
    slack.index_add_(0, a[:, 2], sk)
    slack.index_add_(0, a[:, 1], si + sk)
    return torch.nan_to_num(slack, nan=0.0)


def _settle(diff, rows, amb):
    """Per particle, the pairs at the cutoff taken in or left out,
    whichever brings ``diff`` (program minus reference) nearest 0:
    returns the reference's force correction (N, 3)."""
    fix = torch.zeros_like(diff)
    if rows.numel() == 0:
        return fix
    for i in torch.unique(rows).tolist():
        a = amb[rows == i]
        if a.shape[0] > MAX_AMBIGUOUS:
            continue
        best, best_c = float(torch.linalg.norm(diff[i])), None
        for mask in range(1, 1 << a.shape[0]):
            pick = torch.tensor([(mask >> k) & 1 for k in range(a.shape[0])],
                                dtype=a.dtype, device=a.device)
            c = (pick[:, None] * a).sum(0)
            gap = float(torch.linalg.norm(diff[i] - c))
            if gap < best:
                best, best_c = gap, c
        if best_c is not None:
            fix[i] = best_c
    return fix


def step_gaps(sys_, x0, v0, f0, mass, box, noise, x1, v1, f1, type_id,
              bonds, angles, excl, tables, device, dtype=torch.float64,
              scaled=None):
    """(force_gap, drift_gap, vel_gap) of one step's outputs (x1, v1, f1)
    against the reference's step in ``dtype`` from (x0, v0, f0):

    - force_gap: the largest |F - F_ref| over the particles, over the RMS
      of the reference's conservative force;
    - drift_gap: the largest minimum-image |x1 - x1_ref|, over the largest
      displacement dt |v_half| of the step;
    - vel_gap: the largest |v1 - v1_ref| over the largest |v1_ref|.

    A pair within float32 rounding of the cutoff (``cutoff_band``) counts
    as inside or outside, whichever the program's force agrees with: the
    potential is not shifted, so it steps there by |F(rc)|.  A particle in
    an angle folded flat or stretched straight has its force and its
    velocity judged to within ``angle_slack`` (and 0.5 dt / m of it): the
    gap is what lies beyond.

    Under a barostat ``x1`` are the positions before its scaling (where
    the force was taken) and ``scaled`` is (the positions after it, the
    reference's mu): the drift compares those with the reference's drift
    scaled by mu."""
    dev = torch.device(device)
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in dict(
        x0=x0, v0=v0, f0=f0, mass=mass, box=box, noise=noise, x1=x1, v1=v1,
        f1=f1, tid=type_id).items()}
    band = cutoff_band(box, float(sys_.pair["cutoff"]))
    held = {}

    def force_fn(x):
        f, held["rows"], held["amb"] = ref_forces.forces(
            sys_, x, t["box"], t["tid"], bonds, angles, excl, dtype, tables,
            band)
        return f

    rx1, rv1, rf1, rfc, v_half = ref_forces.langevin_step(
        sys_, t["x0"], t["v0"], t["f0"], t["mass"], t["box"], t["noise"],
        t["x1"], force_fn, dtype)
    f64 = torch.float64
    rx1, rv1, rf1, rfc, v_half = (a.to(f64) for a in
                                  (rx1, rv1, rf1, rfc, v_half))
    fix = _settle(t["f1"].to(f64) - rf1, held["rows"],
                  held["amb"].to(f64))
    rf1 = rf1 + fix
    rfc = rfc + fix
    rv1 = rv1 + 0.5 * sys_.dt * fix / t["mass"].to(f64)[:, None]
    box64 = t["box"].to(f64)

    def norm(a):
        return torch.sqrt(torch.sum(a * a, dim=-1))

    if scaled is None:
        dx = t["x1"].to(f64) - rx1
    else:
        x1s, mu = scaled
        box64 = box64 * mu
        dx = torch.as_tensor(np.asarray(x1s), device=dev).to(f64) - rx1 * mu
    dx = dx - box64 * torch.round(dx / box64)
    slack = angle_slack(sys_, t["x1"], t["box"], angles)
    df = torch.clamp(norm(t["f1"].to(f64) - rf1) - slack, min=0.0)
    dv = torch.clamp(norm(t["v1"].to(f64) - rv1)
                     - 0.5 * sys_.dt * slack / t["mass"].to(f64), min=0.0)
    force_gap = float(df.max() / torch.sqrt(torch.mean(norm(rfc) ** 2)))
    drift_gap = float(norm(dx).max() / (sys_.dt * norm(v_half).max()))
    vel_gap = float(dv.max() / norm(rv1).max())
    return force_gap, drift_gap, vel_gap


def reference_step(sys_, x0, v0, f0, mass, box, noise, type_id, bonds,
                   angles, excl, tables, device, dtype):
    """The reference's own step outputs (x1, v1, f1) in ``dtype``, as
    NumPy float32: the control puts these in the program's place."""
    dev = torch.device(device)
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in dict(
        x0=x0, v0=v0, f0=f0, mass=mass, box=box, noise=noise,
        tid=type_id).items()}

    def force_fn(x):
        return ref_forces.forces(sys_, x, t["box"], t["tid"], bonds, angles,
                                 excl, dtype, tables)

    # the control's force is taken at its own drifted positions
    x0d, v0d, f0d = (t[k].to(dtype) for k in ("x0", "v0", "f0"))
    v_half = v0d + 0.5 * sys_.dt * f0d / t["mass"].to(dtype)[:, None]
    bx = t["box"].to(dtype)
    x1 = x0d + sys_.dt * v_half
    x1 = x1 - torch.floor(x1 / bx) * bx
    rx1, rv1, rf1, _, _ = ref_forces.langevin_step(
        sys_, t["x0"], t["v0"], t["f0"], t["mass"], t["box"], t["noise"],
        x1, force_fn, dtype)
    return tuple(a.to(torch.float32).cpu().numpy() for a in (rx1, rv1, rf1))


def _preimage(pos1, mu):
    """(x, coordinates with none): per coordinate the float32 x whose
    float32 product with ``mu`` is ``pos1``, the nearest to pos1 / mu,
    or pos1 / mu rounded where there is none."""
    x = (pos1.astype(np.float64) / float(mu)).astype(np.float32)
    for toward in (np.inf, -np.inf):
        y = np.nextafter(x, np.float32(toward))
        x = np.where((x * mu != pos1) & (y * mu == pos1), y, x)
    return x, int(np.count_nonzero(x * mu != pos1))


def unscale(pos1, box0, box1):
    """(positions before the barostat's scaling, its mu), float32, from
    the positions ``pos1`` and the box ``box1`` after it and the box
    ``box0`` before it.  The barostat multiplies the positions and the box
    by one float32 mu, each product rounded to nearest.  Of the float32
    values near box1 / box0 whose product with box0 is box1 (below 1 there
    may be two), mu is the one under which the most coordinates have such
    a source, then the nearest; each coordinate is its source
    (``_preimage``).  So the positions are those the barostat read, or
    within an ulp of them where two sources give one product."""
    f32 = np.float32
    b0 = np.asarray(box0, dtype=f32)
    b1 = np.asarray(box1, dtype=f32)
    p = np.asarray(pos1, dtype=f32)
    ratio = float(np.mean(b1.astype(np.float64) / b0))
    near = [f32(ratio)]
    for toward in (f32(0.0), f32(2.0)):
        c = f32(ratio)
        for _ in range(4):
            c = np.nextafter(c, toward)
            near.append(c)
    fits = [c for c in near if np.array_equal(b0 * c, b1)] or near[:1]
    best = None
    for c in fits:
        x, missing = _preimage(p, c)
        key = (missing, abs(float(c) - ratio))
        if best is None or key < best[0]:
            best = (key, x, c)
    return best[1], best[2]


def barostat_gaps(sys_, x1, v1, mass, box0, box1, p1, baro_v0, xi, type_id,
                  bonds, excl, tables, device):
    """(pressure_gap, box_gap, the reference's mu) of one barostat step:
    the program's pressure ``p1`` of the state it read (positions ``x1``
    before the scaling, velocities ``v1``, box ``box0``) and its box
    ``box1`` after the step, against the reference's in float64:

    - pressure_gap: |P - P_ref| over (2 E_kin + |W_pair| + |W_bonded|)
      / 3V of the reference;
    - box_gap: the largest |L1 - mu_ref L0| / L0 over the axes, mu_ref
      from the reference's pressure, the piston's velocity ``baro_v0``
      before the step and its draw ``xi``.

    A pair within float32 rounding of the cutoff counts as inside or
    outside, whichever brings P_ref nearest the program's."""
    dev = torch.device(device)
    f64 = torch.float64
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in dict(
        x1=x1, v1=v1, mass=mass, box0=box0, tid=type_id).items()}
    ref = ref_baro.pressure(sys_, t["x1"], t["v1"], t["mass"], t["box0"],
                            t["tid"], bonds, excl, f64, tables,
                            cutoff_band(box0, float(sys_.pair["cutoff"])))
    three_v = 3.0 * ref["vol"]
    lo = ref["p"] + torch.sum(torch.clamp(ref["w_band"], max=0.0)) / three_v
    hi = ref["p"] + torch.sum(torch.clamp(ref["w_band"], min=0.0)) / three_v
    p_ref = torch.clamp(torch.tensor(float(p1), dtype=f64, device=dev),
                        lo, hi)
    scale = (2.0 * ref["ekin"] + torch.abs(ref["w_pair"])
             + torch.abs(ref["w_bonded"])) / three_v
    pressure_gap = float(torch.abs(float(p1) - p_ref) / scale)
    mu = ref_baro.box_scale(sys_.barostat, p_ref, ref["vol"],
                            float(baro_v0), float(xi), sys_.dt, sys_.kT)
    b0 = np.asarray(box0, dtype=np.float64)
    box_gap = float(np.max(np.abs(np.asarray(box1, dtype=np.float64)
                                  - float(mu) * b0) / b0))
    return pressure_gap, box_gap, float(mu)


def reference_barostat(sys_, x1, v1, mass, box0, baro_v0, xi, type_id,
                       bonds, excl, tables, device, dtype):
    """The reference's own barostat step in ``dtype`` from its step's
    outputs (x1, v1): (scaled positions, box, pressure), as NumPy float32
    and a float: the control puts these in the program's place."""
    dev = torch.device(device)
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in dict(
        x1=x1, v1=v1, mass=mass, box0=box0, tid=type_id).items()}
    ref = ref_baro.pressure(sys_, t["x1"], t["v1"], t["mass"], t["box0"],
                            t["tid"], bonds, excl, dtype, tables)
    x1s, box1 = ref_baro.barostat_step(
        sys_.barostat, t["x1"].to(dtype), t["box0"].to(dtype), ref["p"],
        ref["vol"], float(baro_v0), float(xi), sys_.dt, sys_.kT)
    return (x1s.to(torch.float32).cpu().numpy(),
            box1.to(torch.float32).cpu().numpy(), float(ref["p"]))


def judge(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a number with no limit fails)."""
    return all(name in limits and numbers[name] <= limits[name]
               for name in numbers)
