"""Bonded forces: bonds, angles, dihedrals and 1-4 pairs, by autograd.

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

Per-entry lambda scales each term (not the 1-4 pairs).  Forces are
``-torch.autograd.grad`` of the total energy, where the reference uses
``jax.value_and_grad``; the bonded virial is the strain derivative of the
same energy.  Tabulated terms are straight-through: their gradient is the
table's force column, not the derivative of the interpolant.  Every
family's endpoints come from one gather of packed [x, y, z, type] rows, so
the backward pass accumulates through one ``index_put_``.
"""

from __future__ import annotations

import math

import torch

from . import perf, tables
from .bonded_dense import roll_rows
from .state import TermTable


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


def bonded_energy_terms(spec, cfg, pos, box, type_id, q, bonds, angles,
                        dihedrals, pairs14, dense=None):
    """All bonded energy terms as a dict of 0-d tensors.

    ``dense``: (bonds_dense, bonds_irr, angles_dense, angles_irr) when
    ``cfg.bonded_dense``; the chain bonds and angles then evaluate on
    rolled planes, and the irregular tables, the dihedrals and the 1-4
    pairs share one gather."""
    out = {}
    pos4 = torch.cat([pos, type_id.to(pos.dtype)[:, None]], dim=-1)
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
        segs.append(("bonds", bonds.idx))
    if cfg.angle_funcs:
        segs.append(("angles", angles.idx))
    if cfg.dihedral_funcs:
        segs.append(("dihedrals", dihedrals.idx))
    if cfg.pair14_cap:
        segs.append(("pairs14", pairs14.idx))
    if not segs:
        return out
    idx_all = torch.cat([torch.clamp(idx, min=0).reshape(-1)
                         for _, idx in segs]).long()
    rows_all = pos4[idx_all]
    parts = {}
    off = 0
    for name, idx in segs:
        t, k = idx.shape
        parts[name] = rows_all[off:off + t * k].reshape(t, k, 4)
        off += t * k
    if cfg.bond_funcs:
        _merge_add(out, bond_energies(spec, cfg.bond_funcs, parts["bonds"],
                                      box, bonds))
    if cfg.angle_funcs:
        _merge_add(out, angle_energies(spec, cfg.angle_funcs,
                                       parts["angles"], box, angles))
    if cfg.dihedral_funcs:
        out.update(dihedral_energies(spec, cfg.dihedral_funcs,
                                     parts["dihedrals"], box, dihedrals))
    if cfg.pair14_cap:
        out.update(pair14_energies(spec, parts["pairs14"], box, q, pairs14))
    return out


def _total(terms, like):
    total = torch.zeros((), dtype=like.dtype, device=like.device)
    for v in terms.values():
        total = total + v
    return total


def bonded_forces(spec, cfg, pos, box, type_id, q, bonds, angles, dihedrals,
                  pairs14, dense=None):
    """Forces = -grad(total bonded energy); returns (force, energy dict)."""
    with perf.span(perf.BONDED), torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        terms = bonded_energy_terms(spec, cfg, p, box, type_id, q, bonds,
                                    angles, dihedrals, pairs14, dense=dense)
        if not terms:
            return torch.zeros_like(pos), {}
        (grad,) = torch.autograd.grad(_total(terms, pos), p)
    return -grad, {k: v.detach() for k, v in terms.items()}


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
