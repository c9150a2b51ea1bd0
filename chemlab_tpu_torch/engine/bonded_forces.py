"""Bonded forces: bonds and angles, forces by autograd.

Port of ``chemlab_tpu/engine/bonded_forces.py`` for the slice's functional
forms (parameters arrive pre-converted by the build):

  bonds   func 1 harmonic  U = K (r - r0)^2
          func 7 FENE      U = -K/2 rMax^2 ln(1 - ((r-r0)/rMax)^2)
          func 9 FENE + WCA-shifted LJ(sigma, epsilon)
  angles  func 1 harmonic  U = K (theta - theta0)^2
          func 11 cosine   U = K (1 + cos(theta - theta0))

Per-entry lambda scales each term.  Forces are ``-torch.autograd.grad`` of
the total energy, where the reference uses ``jax.value_and_grad``; the
bonded virial is the strain derivative of the same energy.
Tabulated terms, dihedrals and 1-4 pairs are later ROADMAP items (M4, M9).
"""

from __future__ import annotations

import torch

from .bonded_dense import roll_rows
from .state import TermTable


def _min_image(dr, box):
    return dr - box * torch.round(dr / box)


def _safe_vec(dr, valid, axis_unit: int):
    """Replace invalid rows' displacement with a unit vector, so padding
    rows (zero-length) give finite gradients."""
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
        else:
            raise NotImplementedError("bond func %d (ROADMAP M9)" % f)
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
        elif f == 11:
            e = par[:, 0] * (1.0 + torch.cos(theta - par[:, 1]))
        else:
            raise NotImplementedError("angle func %d (ROADMAP M9)" % f)
        out["angle_f%d" % f] = torch.sum(torch.where(m, e * angles.lam, 0.0))
    return out


def _merge_add(out, terms):
    for k, v in terms.items():
        out[k] = out[k] + v if k in out else v
    return out


def bonded_energy_terms(spec, cfg, pos, box, type_id, bonds, angles,
                        dense=None):
    """All bonded energy terms as a dict of 0-d tensors.

    ``dense``: (bonds_dense, bonds_irr, angles_dense, angles_irr) when
    ``cfg.bonded_dense``; the chain terms then evaluate on rolled planes and
    only the irregular tables are gathered."""
    if cfg.dihedral_funcs or cfg.pair14_cap:
        raise NotImplementedError("dihedrals and 1-4 pairs (ROADMAP M4)")
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
    if cfg.bond_funcs:
        rows = pos4[torch.clamp(bonds.idx, min=0).long()]
        _merge_add(out, bond_energies(spec, cfg.bond_funcs, rows, box, bonds))
    if cfg.angle_funcs:
        rows = pos4[torch.clamp(angles.idx, min=0).long()]
        _merge_add(out, angle_energies(spec, cfg.angle_funcs, rows, box,
                                       angles))
    return out


def bonded_forces(spec, cfg, pos, box, type_id, bonds, angles, dense=None):
    """Forces = -grad(total bonded energy); returns (force, energy dict)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        terms = bonded_energy_terms(spec, cfg, p, box, type_id, bonds,
                                    angles, dense=dense)
        if not terms:
            return torch.zeros_like(pos), {}
        total = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for v in terms.values():
            total = total + v
        (grad,) = torch.autograd.grad(total, p)
    return -grad, {k: v.detach() for k, v in terms.items()}


def bonded_strain_derivative(spec, cfg, pos, box, type_id, bonds, angles,
                             dense=None):
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
                                    box.detach() * s, type_id, bonds, angles,
                                    dense=dense)
        total = torch.zeros((), dtype=pos.dtype, device=pos.device)
        for v in terms.values():
            total = total + v
        if not total.requires_grad:     # no bonded term: total is 0
            return total
        (grad,) = torch.autograd.grad(total, s)
    return grad
