"""Bonded forces: bonds, angles, dihedrals and 1-4 pairs.

Port of ``chemlab_tpu/engine/bonded_forces.py`` (parameters arrive
pre-converted by the build: GROMACS K values halved where the potential is
U = K (x - x0)^2, degrees in radians):

  bonds      func 1 harmonic  U = K (r - r0)^2
             func 7 FENE      U = -K/2 rMax^2 ln(1 - ((r-r0)/rMax)^2)
             func 8 tabulated
             func 9 FENE + WCA-shifted LJ(sigma, epsilon)
  angles     func 1 harmonic  U = K (theta - theta0)^2
             func 8 tabulated
             func 11 cosine   U = K (1 + cos(theta - theta0))
  dihedrals  func 1 harmonic n-cos  U = K (1 + cos(n phi - phi0))
             func 3 Ryckaert-Bellemans  U = sum_n Cn cos(psi)^n, psi = phi - pi
             func 8 tabulated
             func 12 harmonic  U = K wrap(phi - phi0)^2
  pairs14    LJ with fudged epsilon (+ truncated Coulomb, zero while the
             build refuses charges)

Per-entry lambda scales each term (not the 1-4 pairs).  The reference
takes every force as ``jax.value_and_grad`` of the total energy.  Here
bonds and angles take theirs from ``bond_angle_forces``: each term's
endpoint forces in closed form, in the autograd chain's float32
intermediates, each particle's sum in one fixed order (the CUDA kernel
``csrc/bonded.cu`` for CUDA tensors, its plain twin for CPU tensors).
Dihedrals and 1-4 pairs take ``-torch.autograd.grad`` of their energy,
their endpoints from one gather of packed [x, y, z, type] rows (one
``index_put_`` in the backward pass); the bonded virial is the strain
derivative of every family's energy by autograd.  Tabulated terms are
straight-through: their gradient is the table's force column, not the
derivative of the interpolant.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _kernels, perf, tables
from .cell_pair import _check
from .bonded_dense import roll_rows
from .state import N_BOND_PARAMS, TermTable


def table_energy_st(ef, r0, dr, par0, r):
    """Table energy whose gradient with respect to ``r`` is -F from the
    force column.  ``par0`` is the row's table id as a float parameter; it
    is clamped into the stack before the int cast, as jax clamps a gather
    index (rows of other functions carry any value there and are masked
    afterwards)."""
    ti = torch.clamp(par0, 0.0, float(ef.shape[0] - 1)).to(torch.int32)
    e, f = tables.interpolate(ef, r0, dr, ti, r)
    return e.detach() + f.detach() * (r.detach() - r)


def _min_image(dr, box):
    return dr - box * torch.round(dr / box)


def _safe_vec(dr, valid, axis_unit: int):
    """Replace invalid rows' displacement with a unit vector, so padding
    rows (zero-length) give finite gradients; the three axes of a
    dihedral keep its cross products nonzero too."""
    unit = torch.zeros((1, 3), dtype=dr.dtype, device=dr.device)
    unit[0, axis_unit] = 1.0
    return torch.where(valid[:, None], dr, unit)


def _types(*rows):
    """Type ids from channel 3 of packed [x, y, z, type] rows."""
    return tuple(r[:, 3].detach().long() for r in rows)


def _resolve(table: TermTable, gathered_func, gathered_par):
    """typelookup rows re-resolve by the current type signature; a lookup
    miss (func 0) keeps the row's static potential."""
    use_lut = table.typelookup & (gathered_func > 0)
    func = torch.where(use_lut, gathered_func, table.func)
    par = torch.where(use_lut[:, None], gathered_par, table.params)
    return func, par


def bond_energies(spec, bond_funcs, rows4, box, bonds: TermTable):
    valid = bonds.idx[:, 0] >= 0
    pi, pj = rows4[:, 0], rows4[:, 1]
    ti, tj = _types(pi, pj)
    func, par = _resolve(bonds, spec.bond_func_tt[ti, tj],
                         spec.bond_par_tt[ti, tj])
    dr = _safe_vec(_min_image(pi[:, :3] - pj[:, :3], box), valid, 0)
    r = torch.sqrt(torch.sum(dr * dr, dim=-1))

    out = {}
    for f in bond_funcs:
        m = valid & (func == f)
        if f == 1:
            e = par[:, 0] * (r - par[:, 1]) ** 2
        elif f in (7, 9):
            x = (r - par[:, 1]) / torch.clamp(par[:, 2], min=1e-30)
            arg = torch.clamp(1.0 - x * x, 1e-6, 1.0)
            e = -0.5 * par[:, 0] * par[:, 2] ** 2 * torch.log(arg)
            if f == 9:
                sig, eps = par[:, 3], par[:, 4]
                rc_wca = 2.0 ** (1.0 / 6.0) * sig
                s6 = (sig / torch.minimum(r, rc_wca)) ** 6
                lj = 4.0 * eps * (s6 * s6 - s6) + eps
                e = e + torch.where(r < rc_wca, lj, 0.0)
        elif f == 8:
            e = table_energy_st(spec.bond_ef, spec.bond_r0, spec.bond_dr,
                                par[:, 0], r)
        else:
            raise NotImplementedError("bond func %d" % f)
        out["bond_f%d" % f] = torch.sum(torch.where(m, e * bonds.lam, 0.0))
    return out


def angle_energies(spec, angle_funcs, rows4, box, angles: TermTable):
    valid = angles.idx[:, 0] >= 0
    pi, pj, pk = rows4[:, 0], rows4[:, 1], rows4[:, 2]
    ti, tj, tk = _types(pi, pj, pk)
    func, par = _resolve(angles, spec.angle_func_tt[ti, tj, tk],
                         spec.angle_par_tt[ti, tj, tk])
    rij = _safe_vec(_min_image(pi[:, :3] - pj[:, :3], box), valid, 0)
    rkj = _safe_vec(_min_image(pk[:, :3] - pj[:, :3], box), valid, 1)
    nij = torch.sqrt(torch.sum(rij * rij, -1))
    nkj = torch.sqrt(torch.sum(rkj * rkj, -1))
    c = torch.clamp(torch.sum(rij * rkj, -1) / (nij * nkj),
                    -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(c)

    out = {}
    for f in angle_funcs:
        m = valid & (func == f)
        if f == 1:
            e = par[:, 0] * (theta - par[:, 1]) ** 2
        elif f == 8:
            e = table_energy_st(spec.angle_ef, spec.angle_r0, spec.angle_dr,
                                par[:, 0], theta)
        elif f == 11:
            e = par[:, 0] * (1.0 + torch.cos(theta - par[:, 1]))
        else:
            raise NotImplementedError("angle func %d" % f)
        out["angle_f%d" % f] = torch.sum(torch.where(m, e * angles.lam, 0.0))
    return out


def dihedral_energies(spec, dih_funcs, rows4, box, dihedrals: TermTable):
    valid = dihedrals.idx[:, 0] >= 0
    pi, pj, pk, pl = rows4[:, 0], rows4[:, 1], rows4[:, 2], rows4[:, 3]
    ti, tj, tk, tl = _types(pi, pj, pk, pl)
    func, par = _resolve(dihedrals, spec.dih_func_tt[ti, tj, tk, tl],
                         spec.dih_par_tt[ti, tj, tk, tl])
    b1 = _safe_vec(_min_image(pj[:, :3] - pi[:, :3], box), valid, 0)
    b2 = _safe_vec(_min_image(pk[:, :3] - pj[:, :3], box), valid, 1)
    b3 = _safe_vec(_min_image(pl[:, :3] - pk[:, :3], box), valid, 2)
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    b2n = b2 / torch.sqrt(torch.sum(b2 * b2, -1, keepdim=True) + 1e-30)
    sin_phi = torch.sum(torch.linalg.cross(n1, n2, dim=-1) * b2n, -1)
    cos_phi = torch.sum(n1 * n2, -1)
    phi = torch.atan2(sin_phi, cos_phi + 1e-30)

    out = {}
    for f in dih_funcs:
        m = valid & (func == f)
        if f == 1:
            e = par[:, 0] * (1.0 + torch.cos(par[:, 2] * phi - par[:, 1]))
        elif f == 3:
            cpsi = torch.cos(phi - math.pi)
            e = torch.zeros_like(phi)
            acc = torch.ones_like(phi)
            for n in range(6):
                e = e + par[:, n] * acc
                acc = acc * cpsi
        elif f == 8:
            e = table_energy_st(spec.dih_ef, spec.dih_r0, spec.dih_dr,
                                par[:, 0], phi)
        elif f == 12:
            dphi = phi - par[:, 1]
            dphi = dphi - 2.0 * math.pi * torch.round(dphi / (2.0 * math.pi))
            e = par[:, 0] * dphi ** 2
        else:
            raise NotImplementedError("dihedral func %d" % f)
        out["dihedral_f%d" % f] = torch.sum(torch.where(m, e * dihedrals.lam,
                                                        0.0))
    return out


def pair14_energies(spec, rows4, box, q, pairs14: TermTable):
    """1-4 LJ (fudged) and truncated Coulomb pairs.  Entry params:
    [sigma, epsilon * fudgeLJ, cutoff^2, shift]."""
    i, j = pairs14.idx[:, 0], pairs14.idx[:, 1]
    valid = i >= 0
    i, j = torch.clamp(i, min=0).long(), torch.clamp(j, min=0).long()
    par = pairs14.params
    dr = _safe_vec(_min_image(rows4[:, 0, :3] - rows4[:, 1, :3], box),
                   valid, 0)
    r2 = torch.sum(dr * dr, -1)
    m = valid & (r2 < par[:, 2])
    s2 = par[:, 0] ** 2 / r2
    s6 = s2 * s2 * s2
    e_lj = torch.where(m, 4.0 * par[:, 1] * (s6 * s6 - s6) - par[:, 3], 0.0)
    qq_m = valid & (r2 < spec.qq_cutoff2) & (spec.qq_prefactor > 0.0)
    e_qq = torch.where(qq_m, spec.qq_prefactor * q[i] * q[j]
                       / torch.sqrt(r2), 0.0)
    return {"lj14": torch.sum(e_lj), "coulomb14": torch.sum(e_qq)}


def _merge_add(out, terms):
    for k, v in terms.items():
        out[k] = out[k] + v if k in out else v
    return out


def _gathered_terms(spec, cfg, pos4, box, q, segs):
    """Energy terms of the tables ``segs`` ([(name, table)]), whose endpoint
    rows come from one gather of the packed [x, y, z, type] rows ``pos4``.
    Each padding slot (first index < 0) reads a zero row of its own past
    the particles: one shared row would be a run of equal indices, which
    the gather's backward sums serially on the card.  A live slot's index
    < 0 reads particle 0."""
    if not segs:
        return {}
    n = pos4.shape[0]
    dest = torch.cat([torch.where(t.idx[:, :1] >= 0,
                                  torch.clamp(t.idx, min=0), -1).reshape(-1)
                      for _, t in segs]).long()
    spare = n + torch.arange(dest.shape[0], device=dest.device)
    rows_all = torch.cat([pos4, pos4.new_zeros((dest.shape[0], 4))])[
        torch.where(dest >= 0, dest, spare)]
    tables, rows = dict(segs), {}
    off = 0
    for name, t in segs:
        m, k = t.idx.shape
        rows[name] = rows_all[off:off + m * k].reshape(m, k, 4)
        off += m * k
    out = {}
    if "bonds" in rows:
        _merge_add(out, bond_energies(spec, cfg.bond_funcs, rows["bonds"],
                                      box, tables["bonds"]))
    if "angles" in rows:
        _merge_add(out, angle_energies(spec, cfg.angle_funcs, rows["angles"],
                                       box, tables["angles"]))
    if "dihedrals" in rows:
        out.update(dihedral_energies(spec, cfg.dihedral_funcs,
                                     rows["dihedrals"], box,
                                     tables["dihedrals"]))
    if "pairs14" in rows:
        out.update(pair14_energies(spec, rows["pairs14"], box, q,
                                   tables["pairs14"]))
    return out


def _pack(pos, type_id):
    return torch.cat([pos, type_id.to(pos.dtype)[:, None]], dim=-1)


def bonded_energy_terms(spec, cfg, pos, box, type_id, q, bonds, angles,
                        dihedrals, pairs14, dense=None):
    """All bonded energy terms as a dict of 0-d tensors.

    ``dense``: (bonds_dense, bonds_irr, angles_dense, angles_irr) when
    ``cfg.bonded_dense``; the chain bonds and angles then evaluate on
    rolled planes, and the irregular tables, the dihedrals and the 1-4
    pairs share one gather."""
    out = {}
    pos4 = _pack(pos, type_id)
    if cfg.bonded_dense and dense is not None:
        bonds_dense, bonds_irr, angles_dense, angles_irr = dense
        if cfg.bond_funcs:
            _merge_add(out, bond_energies(spec, cfg.bond_funcs,
                                          roll_rows(pos4, 2), box,
                                          bonds_dense))
        if cfg.angle_funcs:
            _merge_add(out, angle_energies(spec, cfg.angle_funcs,
                                           roll_rows(pos4, 3), box,
                                           angles_dense))
        bonds, angles = bonds_irr, angles_irr
    segs = []
    if cfg.bond_funcs:
        segs.append(("bonds", bonds))
    if cfg.angle_funcs:
        segs.append(("angles", angles))
    segs += _other_segments(cfg, dihedrals, pairs14)
    return _merge_add(out, _gathered_terms(spec, cfg, pos4, box, q, segs))


def _other_segments(cfg, dihedrals, pairs14):
    """The dihedral and 1-4 tables the configuration evaluates."""
    segs = []
    if cfg.dihedral_funcs:
        segs.append(("dihedrals", dihedrals))
    if cfg.pair14_cap:
        segs.append(("pairs14", pairs14))
    return segs


def _total(terms, like):
    total = torch.zeros((), dtype=like.dtype, device=like.device)
    for v in terms.values():
        total = total + v
    return total


# ---- bonds and angles: the CUDA kernel (csrc/bonded.cu) and its plain twin --

# the functions the kernel evaluates, each with its energy channel
BOND_CHANNELS = {1: 0, 7: 1, 8: 2, 9: 3}
ANGLE_CHANNELS = {1: 4, 8: 5, 11: 6}
N_CHANNELS = 7
THREADS = 256      # bonded.cu's kThreads
PARTIAL = 8        # bonded.cu's kPartial

_TABLE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int]
_STACK_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
# one launch count a call (the call is a memset and three kernels)
BOND_ANGLE = _kernels.CudaKernel(
    "bonded.cu", "bonded_bond_angle",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + _TABLE_ARGS * 4
    + [ctypes.c_void_p] * 4 + _STACK_ARGS * 2 + [ctypes.c_uint] * 2
    + [ctypes.c_void_p] * 7)


def bond_angle_tables(cfg, bonds, angles, dense=None):
    """(dense bonds, dense angles, listed bonds, listed angles): the rolled
    planes and the irregular tables under ``cfg.bonded_dense``, else no
    dense leg and the flat tables; None for a family the configuration
    does not evaluate."""
    if cfg.bonded_dense and dense is not None:
        bd, bl, ad, al = dense
    else:
        bd = ad = None
        bl, al = bonds, angles
    if not cfg.bond_funcs:
        bd = bl = None
    if not cfg.angle_funcs:
        ad = al = None
    return bd, ad, bl, al


def _func_mask(funcs, channels, family: str) -> int:
    mask = 0
    for f in funcs:
        if f not in channels:
            raise NotImplementedError("%s func %d" % (family, f))
        mask |= 1 << f
    return mask


def _energy_terms(cfg, channel):
    """The energy dict's bond and angle entries from ``channel(c)``."""
    out = {"bond_f%d" % f: channel(BOND_CHANNELS[f]) for f in cfg.bond_funcs}
    out.update({"angle_f%d" % f: channel(ANGLE_CHANNELS[f])
                for f in cfg.angle_funcs})
    return out


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _lookup(ef, r0, dr, par0, x):
    ti = torch.clamp(par0, 0.0, float(ef.shape[0] - 1)).to(torch.int32)
    return tables.interpolate(ef, r0, dr, ti, x)


def _bond_slots(spec, funcs, pos, box, type_id, table, i, j):
    """Each slot of a bond table between particles ``i`` and ``j``:
    (live, resolved func, energy x lambda, force on i); a slot that is
    padding or whose function is not in ``funcs`` is not live and adds
    nothing (its force row is 0)."""
    ti, tj = type_id[i].long(), type_id[j].long()
    func, par = _resolve(table, spec.bond_func_tt[ti, tj],
                         spec.bond_par_tt[ti, tj])
    valid = table.idx[:, 0] >= 0
    live = valid & torch.isin(
        func, torch.tensor(funcs, dtype=func.dtype, device=func.device))
    d = _safe_vec(_min_image(pos[i] - pos[j], box), valid, 0)
    r = torch.sqrt(_dot(d, d))
    en = torch.zeros_like(r)
    dedr = torch.zeros_like(r)
    for f in funcs:
        if f == 1:
            x = r - par[:, 1]
            e_f, g_f = par[:, 0] * (x * x), par[:, 0] * (2.0 * x)
        elif f == 8:
            e_f, col = _lookup(spec.bond_ef, spec.bond_r0, spec.bond_dr,
                               par[:, 0], r)
            g_f = -col
        else:                           # 7 and 9: FENE
            rm = torch.clamp(par[:, 2], min=1e-30)
            x = (r - par[:, 1]) / rm
            a0 = 1.0 - x * x
            arg = torch.clamp(a0, 1e-6, 1.0)
            c = (-0.5 * par[:, 0]) * (par[:, 2] * par[:, 2])
            e_f = c * torch.log(arg)
            garg = torch.where((a0 >= 1e-6) & (a0 <= 1.0), c / arg, 0.0)
            g_f = (-garg * (2.0 * x)) / rm
            if f == 9:                  # + WCA below 2^(1/6) sigma
                sig, eps = par[:, 3], par[:, 4]
                wca = r < 2.0 ** (1.0 / 6.0) * sig
                u = sig / r
                s6 = u ** 6
                e_f = torch.where(wca, e_f + ((4.0 * eps) * (s6 * s6 - s6)
                                              + eps), e_f)
                g_f = torch.where(wca, g_f + ((4.0 * eps) * (2.0 * s6 - 1.0))
                                  * (6.0 * u ** 5) * (-u / r), g_f)
        en = torch.where(func == f, e_f, en)
        dedr = torch.where(func == f, g_f, dedr)
    s = (dedr * table.lam) / r
    fi = torch.where(live[:, None], -(s[:, None] * d), 0.0)
    return live, func, en * table.lam, fi


def _angle_slots(spec, funcs, pos, box, type_id, table, i, j, k):
    """Each slot of an angle table at vertex ``j`` between ``i`` and ``k``:
    (live, resolved func, energy x lambda, forces on i, j, k)."""
    ti, tj, tk = type_id[i].long(), type_id[j].long(), type_id[k].long()
    func, par = _resolve(table, spec.angle_func_tt[ti, tj, tk],
                         spec.angle_par_tt[ti, tj, tk])
    valid = table.idx[:, 0] >= 0
    live = valid & torch.isin(
        func, torch.tensor(funcs, dtype=func.dtype, device=func.device))
    pj = pos[j]
    rij = _safe_vec(_min_image(pos[i] - pj, box), valid, 0)
    rkj = _safe_vec(_min_image(pos[k] - pj, box), valid, 1)
    nij = torch.sqrt(_dot(rij, rij))
    nkj = torch.sqrt(_dot(rkj, rkj))
    dot = _dot(rij, rkj)
    den = nij * nkj
    c0 = dot / den
    c = torch.clamp(c0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(c)
    en = torch.zeros_like(theta)
    dedt = torch.zeros_like(theta)
    for f in funcs:
        if f == 1:
            x = theta - par[:, 1]
            e_f, g_f = par[:, 0] * (x * x), par[:, 0] * (2.0 * x)
        elif f == 8:
            e_f, col = _lookup(spec.angle_ef, spec.angle_r0, spec.angle_dr,
                               par[:, 0], theta)
            g_f = -col
        else:                           # 11: cosine
            x = theta - par[:, 1]
            e_f = par[:, 0] * (1.0 + torch.cos(x))
            g_f = par[:, 0] * (-torch.sin(x))
        en = torch.where(func == f, e_f, en)
        dedt = torch.where(func == f, g_f, dedt)
    inside = (c0 >= -1.0 + 1e-7) & (c0 <= 1.0 - 1e-7)
    gc = torch.where(inside, (dedt * table.lam)
                     * -(1.0 / torch.sqrt(1.0 - c * c)), 0.0)
    gdot = (gc / den)[:, None]
    gden = -gc * ((dot / den) / den)
    sij = ((gden * nkj) / nij)[:, None]
    skj = ((gden * nij) / nkj)[:, None]
    fi = -(gdot * rkj + sij * rij)
    fk = -(gdot * rij + skj * rkj)
    forces = torch.stack([fi, -(fi + fk), fk], dim=1)
    return (live, func, en * table.lam,
            torch.where(live[:, None, None], forces, 0.0))


def bond_angle_forces_plain(spec, cfg, pos, box, type_id, bonds, angles,
                            dense=None, parts=None):
    """The kernel's plain twin, for CPU tensors: the same analytic
    arithmetic, and each particle's sum in the kernel's order: from 0,
    dense bond row p (endpoint 0), row p-1 (endpoint 1), dense angle rows
    p, p-1, p-2 (endpoints 0, 1, 2), then the listed tables' entries in
    ascending entry id (bond slot s endpoint k: 2 s + k; angle slot s:
    2 rows_b + 3 s + k).  Returns (force, energy dict).  ``parts``, a dict,
    receives each leg's endpoint force rows ("bonds_dense", "angles_dense":
    (n, arity, 3); "listed": (entries, 3)) and the listed entries'
    particles ("keys"; n for an entry that adds nothing)."""
    bd, ad, bl, al = bond_angle_tables(cfg, bonds, angles, dense)
    _func_mask(cfg.bond_funcs, BOND_CHANNELS, "bond")
    _func_mask(cfg.angle_funcs, ANGLE_CHANNELS, "angle")
    parts = {} if parts is None else parts
    n = pos.shape[0]
    ids = torch.arange(n, device=pos.device)
    ech = [torch.zeros((), dtype=pos.dtype, device=pos.device)] * N_CHANNELS

    def slots(table, arity, ends, channels):
        """(live, (rows, arity, 3) endpoint forces) of a bond or angle
        table with endpoint particles ``ends``; its energies summed."""
        if arity == 2:
            live, func, e, fi = _bond_slots(spec, cfg.bond_funcs, pos, box,
                                            type_id, table, ends[:, 0],
                                            ends[:, 1])
            f = torch.stack([fi, -fi], dim=1)
        else:
            live, func, e, f = _angle_slots(spec, cfg.angle_funcs, pos, box,
                                            type_id, table, ends[:, 0],
                                            ends[:, 1], ends[:, 2])
        for fn, c in channels.items():
            ech[c] = ech[c] + torch.sum(torch.where(live & (func == fn), e,
                                                    0.0))
        return live, f

    acc = torch.zeros_like(pos)
    for name, table, arity, channels in (("bonds_dense", bd, 2,
                                          BOND_CHANNELS),
                                         ("angles_dense", ad, 3,
                                          ANGLE_CHANNELS)):
        if table is None:
            continue
        ends = torch.stack([(ids + k) % n for k in range(arity)], dim=1)
        _, f = slots(table, arity, ends, channels)
        parts[name] = f
        for k in range(arity):
            acc = acc + torch.roll(f[:, k], k, 0)
    keys, rows = [], []
    for table, arity, channels in ((bl, 2, BOND_CHANNELS),
                                   (al, 3, ANGLE_CHANNELS)):
        if table is None:
            continue
        ends = torch.clamp(table.idx, min=0).long()
        live, f = slots(table, arity, ends, channels)
        keys.append(torch.where(live[:, None], ends, n).reshape(-1))
        rows.append(f.reshape(-1, 3))
    if keys:
        keys, rows = torch.cat(keys), torch.cat(rows)
        parts["keys"], parts["listed"] = keys, rows
        order = torch.sort(keys, stable=True).indices
        rows = rows[order]
        start = torch.searchsorted(keys[order], torch.arange(
            n + 1, dtype=keys.dtype, device=keys.device))
        count = start[1:] - start[:-1]
        for q in range(int(count.max())):
            take = q < count
            acc = acc + torch.where(take[:, None],
                                    rows[torch.where(take, start[:-1] + q,
                                                     0)], 0.0)
    return acc, _energy_terms(cfg, lambda c: ech[c])


def _table_args(table, name, arity, rows=None):
    """The kernel's six arguments of a term table (null and 0 rows where
    it is absent), after checking its layout."""
    if table is None:
        return (None,) * 5 + (0,)
    m = table.capacity if rows is None else rows
    for field, dtype, shape in (("idx", torch.int32, (m, arity)),
                                ("func", torch.int32, (m,)),
                                ("params", torch.float32,
                                 (m, N_BOND_PARAMS)),
                                ("typelookup", torch.bool, (m,)),
                                ("lam", torch.float32, (m,))):
        _check(getattr(table, field), "%s.%s" % (name, field), dtype, shape)
    return (table.idx.data_ptr(), table.func.data_ptr(),
            table.params.data_ptr(), table.typelookup.data_ptr(),
            table.lam.data_ptr(), m)


def _stack_args(ef, r0, dr, name):
    n_tab, n_bins = ef.shape[0], ef.shape[1]
    _check(ef, name + "_ef", torch.float32, (n_tab, n_bins, 2))
    _check(r0, name + "_r0", torch.float32, (n_tab,))
    _check(dr, name + "_dr", torch.float32, (n_tab,))
    return ef.data_ptr(), r0.data_ptr(), dr.data_ptr(), n_tab, n_bins


def kernel_operands(spec, cfg, pos, box, type_id, bonds, angles,
                    dense=None):
    """The kernel's arguments before the stream, on the operands' device,
    after checking them; returns (arguments, force, energy, scratch): the
    outputs allocated and unwritten, and the scratch tensors, which the
    caller holds until the launch is queued."""
    bd, ad, bl, al = bond_angle_tables(cfg, bonds, angles, dense)
    bond_mask = _func_mask(cfg.bond_funcs, BOND_CHANNELS, "bond")
    angle_mask = _func_mask(cfg.angle_funcs, ANGLE_CHANNELS, "angle")
    n, dev = pos.shape[0], pos.device
    _check(pos, "pos", torch.float32, (n, 3))
    _check(type_id, "type_id", torch.int32, (n,))
    _check(box, "box", torch.float32, (3,))
    n_types = spec.bond_func_tt.shape[0]
    _check(spec.bond_func_tt, "bond_func_tt", torch.int32, (n_types,) * 2)
    _check(spec.bond_par_tt, "bond_par_tt", torch.float32,
           (n_types,) * 2 + (N_BOND_PARAMS,))
    _check(spec.angle_func_tt, "angle_func_tt", torch.int32, (n_types,) * 3)
    _check(spec.angle_par_tt, "angle_par_tt", torch.float32,
           (n_types,) * 3 + (N_BOND_PARAMS,))
    tabs = (_table_args(bd, "bonds_dense", 2, n)
            + _table_args(ad, "angles_dense", 3, n)
            + _table_args(bl, "bonds", 2) + _table_args(al, "angles", 3))
    for t in (type_id, box, spec.bond_func_tt, spec.bond_ef,
              spec.angle_ef) + tuple(t.idx for t in (bd, ad, bl, al)
                                     if t is not None):
        if t.device != dev:
            raise ValueError("bonded operands on %s and %s" % (t.device,
                                                               dev))
    listed = tabs[17] + tabs[23]
    entries = 2 * tabs[17] + 3 * tabs[23]
    blocks = (listed + THREADS - 1) // THREADS + (n + THREADS - 1) // THREADS
    force = torch.empty((n, 3), dtype=torch.float32, device=dev)
    energy = torch.empty(N_CHANNELS, dtype=torch.float32, device=dev)
    entry_f = torch.empty((max(entries, 1), 3), dtype=torch.float32,
                          device=dev)
    head = torch.empty(n, dtype=torch.int32, device=dev)
    nxt = torch.empty(max(entries, 1), dtype=torch.int32, device=dev)
    partial = torch.empty((blocks, PARTIAL), dtype=torch.float32, device=dev)
    args = (pos.data_ptr(), type_id.data_ptr(), box.data_ptr(), n, n_types,
            *tabs, spec.bond_func_tt.data_ptr(), spec.bond_par_tt.data_ptr(),
            spec.angle_func_tt.data_ptr(), spec.angle_par_tt.data_ptr(),
            *_stack_args(spec.bond_ef, spec.bond_r0, spec.bond_dr, "bond"),
            *_stack_args(spec.angle_ef, spec.angle_r0, spec.angle_dr,
                         "angle"),
            bond_mask, angle_mask, force.data_ptr(), energy.data_ptr(),
            entry_f.data_ptr(), head.data_ptr(), nxt.data_ptr(),
            partial.data_ptr())
    return args, force, energy, (entry_f, head, nxt, partial)


def bond_angle_forces_kernel(spec, cfg, pos, box, type_id, bonds, angles,
                             dense=None):
    """Launch ``csrc/bonded.cu`` on the current stream (CUDA tensors only):
    a memset and three kernels, no host read; returns (force, energy dict),
    the energies views of one 7-channel tensor."""
    if pos.device.type != "cuda":
        raise ValueError("the bonded kernel takes CUDA tensors, not %s"
                         % pos.device)
    args, force, energy, _scratch = kernel_operands(
        spec, cfg, pos, box, type_id, bonds, angles, dense)
    BOND_ANGLE.launch(*args, torch.cuda.current_stream(pos.device)
                      .cuda_stream)
    return force, _energy_terms(cfg, lambda c: energy[c])


def bond_angle_forces(spec, cfg, pos, box, type_id, bonds, angles,
                      dense=None):
    """Bond and angle forces, each particle's sum in one fixed order, and
    their energy terms: the CUDA kernel for CUDA tensors, the plain twin
    for CPU tensors."""
    if pos.device.type == "cpu":
        return bond_angle_forces_plain(spec, cfg, pos, box, type_id, bonds,
                                       angles, dense)
    return bond_angle_forces_kernel(spec, cfg, pos, box, type_id, bonds,
                                    angles, dense)


def bonded_forces(spec, cfg, pos, box, type_id, q, bonds, angles, dihedrals,
                  pairs14, dense=None):
    """Forces and energy terms of every bonded family; returns (force,
    energy dict).  Bonds and angles: ``bond_angle_forces`` (the CUDA kernel
    on the card, its plain twin on the CPU); dihedrals and 1-4 pairs:
    ``-grad`` of their energy by autograd, added to those forces."""
    with perf.span(perf.BONDED):
        if cfg.bond_funcs or cfg.angle_funcs:
            force, terms = bond_angle_forces(spec, cfg, pos, box, type_id,
                                             bonds, angles, dense)
        else:
            force, terms = torch.zeros_like(pos), {}
        segs = _other_segments(cfg, dihedrals, pairs14)
        if segs:
            with torch.enable_grad():
                p = pos.detach().requires_grad_(True)
                more = _gathered_terms(spec, cfg, _pack(p, type_id), box, q,
                                       segs)
                (grad,) = torch.autograd.grad(_total(more, pos), p)
            force = force - grad
            terms.update({k: v.detach() for k, v in more.items()})
    return force, terms


def bonded_strain_derivative(spec, cfg, pos, box, type_id, q, bonds, angles,
                             dihedrals, pairs14, dense=None):
    """dU_bonded/ds at s = 1, with positions and box scaled by s (the
    bonded half of the virial W = -dU/ds; reference ``integrate.py:184-192``
    under ``jax.grad``).  The minimum image's ``round`` has zero gradient,
    so the box enters through ``box * round(d / box)`` alone; with no
    bonded term the derivative is 0 (not the ``None`` of a graph that does
    not reach ``s``)."""
    with torch.enable_grad():
        s = torch.ones((), dtype=pos.dtype, device=pos.device,
                       requires_grad=True)
        terms = bonded_energy_terms(spec, cfg, pos.detach() * s,
                                    box.detach() * s, type_id, q, bonds,
                                    angles, dihedrals, pairs14, dense=dense)
        total = _total(terms, pos)
        if not total.requires_grad:     # no bonded term: total is 0
            return total
        (grad,) = torch.autograd.grad(total, s)
    return grad
