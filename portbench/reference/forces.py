"""Plain forces of a melt: the nonbonded pairs inside the cutoff (LJ with
its soft core, or a func-8 table interpolated linearly), minus nothing
(the excluded pairs are never summed), plus harmonic bonds and angles.

Every pair is found here from the positions, on a cell grid of the
reference's own; each particle sums its own row of pairs.  ``dtype`` is
the precision the forces are computed in: float64 for the reference,
bfloat16 for the control.  Plain PyTorch, on any device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ROWS_PER_BLOCK = 8192


def _min_image(d, box):
    return d - box * torch.round(d / box)


def _grid(pos, box, rc):
    """(dims, cell of each particle (N, 3)) of the grid with cells of at
    least ``rc`` on each axis."""
    dims = [max(int(math.floor(float(box[k]) / rc)), 1) for k in range(3)]
    dims_t = torch.tensor(dims, device=pos.device)
    frac = pos / box
    frac = frac - torch.floor(frac)
    cell = torch.minimum((frac * dims_t).long(), dims_t - 1)
    return dims, cell


def _candidates(pos, box, rc):
    """A function of a block of rows giving (rows, cand) with every
    particle within ``rc`` of each row among ``cand`` (-1 padding): the
    27 neighbouring cells' particles, or every particle where the grid
    has fewer than 3 cells on an axis."""
    n = pos.shape[0]
    dev = pos.device
    dims, cell = _grid(pos, box, rc)
    if min(dims) < 3:
        everyone = torch.arange(n, device=dev)

        def brute(lo, hi):
            return everyone[None, :].expand(hi - lo, n)
        return brute
    cid = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    n_cells = dims[0] * dims[1] * dims[2]
    order = torch.argsort(cid, stable=True)
    counts = torch.bincount(cid, minlength=n_cells)
    start = torch.cumsum(counts, 0) - counts
    cap = int(counts.max())
    slot = torch.arange(n, device=dev) - start[cid[order]]
    buckets = torch.full((n_cells, cap), -1, dtype=torch.long, device=dev)
    buckets[cid[order], slot] = order
    off = torch.tensor([(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                        for c in (-1, 0, 1)], device=dev)
    dims_t = torch.tensor(dims, device=dev)

    def cells(lo, hi):
        nc = torch.remainder(cell[lo:hi, None, :] + off[None], dims_t)
        ncid = (nc[..., 0] * dims[1] + nc[..., 1]) * dims[2] + nc[..., 2]
        return buckets[ncid].reshape(hi - lo, -1)
    return cells


def _excluded(keys_sorted, i, j, n):
    """Whether each (i, j) is an excluded pair; ``keys_sorted`` holds
    i * n + j for both orders of every excluded pair."""
    if keys_sorted.numel() == 0:
        return torch.zeros_like(i, dtype=torch.bool)
    k = i * n + j
    at = torch.clamp(torch.searchsorted(keys_sorted, k), max=keys_sorted.numel() - 1)
    return keys_sorted[at] == k


def _pair_blocks(pos, box, type_id, excl, pair: dict, dtype, tables=None,
                 band: float = 0.0):
    """The nonbonded pairs of each block of rows, in ``dtype``: yields
    (lo, hi, rows, d, r2, fs, near), the pair force of (rows, candidate)
    being fs * d (0 where the pair is not summed), and ``near`` the pairs
    within ``band`` of the cutoff (all False where ``band`` is 0)."""
    n = pos.shape[0]
    dev = pos.device
    rc = float(pair["cutoff"])
    x = pos.to(dtype)
    bx = box.to(dtype)
    tid = type_id.long().to(dev)
    ex = torch.as_tensor(np.asarray(excl), dtype=torch.long, device=dev)
    keys = torch.cat([ex[:, 0] * n + ex[:, 1], ex[:, 1] * n + ex[:, 0]])
    keys = torch.sort(keys).values
    find = _candidates(pos.to(torch.float64), box.to(torch.float64),
                       math.sqrt(rc * rc + band))
    rc2 = torch.tensor(rc * rc, dtype=dtype, device=dev)
    if pair["kind"] == "table":
        r_grid, ftab = tables
        r0 = float(r_grid[0])
        dr = float(r_grid[1] - r_grid[0])
        n_bins = len(r_grid)
        ft = torch.as_tensor(ftab, dtype=dtype, device=dev)
    for lo in range(0, n, ROWS_PER_BLOCK):
        hi = min(lo + ROWS_PER_BLOCK, n)
        cand = find(lo, hi)
        rows = torch.arange(lo, hi, device=dev)[:, None].expand_as(cand)
        ok = (cand >= 0) & (cand != rows)
        j = torch.clamp(cand, min=0)
        d = _min_image(x[rows] - x[j], bx)
        r2 = torch.sum(d * d, dim=-1)
        ok = ok & ~_excluded(keys, rows, j, n)
        near = ok & (torch.abs(r2 - rc2) <= band) if band > 0.0 \
            else torch.zeros_like(ok)
        ok = ok & ((r2 < rc2) | near)
        r2s = torch.where(ok, r2, torch.ones_like(r2))
        if pair["kind"] == "lj":
            sig = float(pair["sigma"])
            eps = float(pair["epsilon"])
            core2 = (float(pair["core"]) * sig) ** 2
            r2c = torch.clamp(r2s, min=core2)
            s2 = (sig * sig) / r2c
            s6 = s2 * s2 * s2
            fs = 48.0 * eps * (s6 * s6 - 0.5 * s6) / r2c
        elif pair["kind"] == "table":
            r = torch.sqrt(r2s)
            u = torch.clamp((r - r0) / dr, 0.0, n_bins - 1.000001)
            i0 = torch.floor(u).long()
            frac = u - i0.to(dtype)
            ti, tj = tid[rows], tid[j]
            f = ft[ti, tj, i0] * (1.0 - frac) + ft[ti, tj, i0 + 1] * frac
            fs = f / r
        else:
            raise NotImplementedError("pair kind %r" % pair["kind"])
        fs = torch.where(ok, fs, torch.zeros_like(fs))
        yield lo, hi, rows, d, r2, fs, near


def pair_forces(pos, box, type_id, excl, pair: dict, dtype, tables=None,
                band: float = 0.0):
    """(N, 3) nonbonded forces in ``dtype``.  ``excl`` (X, 2) are the
    excluded pairs; ``pair`` the configuration's pair block; ``tables``
    (r grid (P,), F (T, T, P)) for a tabulated pair.  With ``band`` > 0,
    the pairs whose r^2 lies within ``band`` of the cutoff's, on either
    side of it, are left out of the sum and returned apart: (forces, rows
    (M,), their pair forces (M, 3)); whether such a pair is inside is
    rounding's choice."""
    out = torch.zeros((pos.shape[0], 3), dtype=dtype, device=pos.device)
    amb_rows, amb_f = [], []
    for lo, hi, rows, d, _, fs, near in _pair_blocks(
            pos, box, type_id, excl, pair, dtype, tables, band):
        if band > 0.0:
            amb_rows.append(rows[near])
            amb_f.append(fs[near][:, None] * d[near])
            fs = torch.where(near, torch.zeros_like(fs), fs)
        out[lo:hi] = torch.sum(fs[..., None] * d, dim=1)
    if band > 0.0:
        return out, torch.cat(amb_rows), torch.cat(amb_f)
    return out


def bonded_forces(pos, box, bonds, angles, k_bond, r0, k_angle, theta0,
                  dtype):
    """(N, 3) forces of U = k_bond (r - r0)^2 on each bond and
    U = k_angle (theta - theta0)^2 on each angle (i, j, k), j the apex."""
    n = pos.shape[0]
    dev = pos.device
    x = pos.to(dtype)
    bx = box.to(dtype)
    out = torch.zeros((n, 3), dtype=dtype, device=dev)
    b = torch.as_tensor(np.asarray(bonds), dtype=torch.long, device=dev)
    if b.numel():
        d = _min_image(x[b[:, 0]] - x[b[:, 1]], bx)
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        fs = (-2.0 * k_bond) * (r - r0) / r
        f = fs[:, None] * d
        out.index_add_(0, b[:, 0], f)
        out.index_add_(0, b[:, 1], -f)
    a = torch.as_tensor(np.asarray(angles), dtype=torch.long, device=dev)
    if a.numel():
        fi, fk, _ = angle_end_forces(x, bx, a, k_angle, theta0)
        out.index_add_(0, a[:, 0], fi)
        out.index_add_(0, a[:, 2], fk)
        out.index_add_(0, a[:, 1], -(fi + fk))
    return out


def angle_end_forces(x, bx, a, k_angle, theta0):
    """(F_i, F_k, cos theta) of U = k_angle (theta - theta0)^2 on each
    angle (i, j, k) of ``a`` (A, 3), j the apex, in the dtype of ``x``;
    the apex takes -(F_i + F_k)."""
    rij = _min_image(x[a[:, 0]] - x[a[:, 1]], bx)
    rkj = _min_image(x[a[:, 2]] - x[a[:, 1]], bx)
    nij = torch.sqrt(torch.sum(rij * rij, dim=-1))
    nkj = torch.sqrt(torch.sum(rkj * rkj, dim=-1))
    dot = torch.sum(rij * rkj, dim=-1)
    cross = torch.linalg.cross(rij, rkj)
    sin_nn = torch.sqrt(torch.sum(cross * cross, dim=-1))
    theta = torch.atan2(sin_nn, dot)
    c = dot / (nij * nkj)
    sin_t = torch.clamp(sin_nn / (nij * nkj), min=1e-12)
    # F_i = dU/dtheta / sin(theta) * dcos(theta)/dx_i
    g = (2.0 * k_angle) * (theta - theta0) / sin_t
    fi = g[:, None] * (rkj / (nij * nkj)[:, None]
                       - (c / (nij * nij))[:, None] * rij)
    fk = g[:, None] * (rij / (nij * nkj)[:, None]
                       - (c / (nkj * nkj))[:, None] * rkj)
    return fi, fk, c


def forces(sys_, pos, box, type_id, bonds, angles, excl, dtype,
           tables=None, band: float = 0.0):
    """The conservative force on each particle: pairs plus bonds plus
    angles, in ``dtype``; with ``band`` > 0 also the pairs at the cutoff,
    apart (``pair_forces``)."""
    f = pair_forces(pos, box, type_id, excl, sys_.pair, dtype, tables, band)
    amb = None
    if band > 0.0:
        f, *amb = f
    f = f + bonded_forces(pos, box, bonds, angles, sys_.bond_k,
                          sys_.bond_r0, sys_.angle_k, sys_.angle_theta0,
                          dtype)
    return f if amb is None else (f, *amb)


def langevin_step(sys_, x0, v0, f0, mass, box, noise, x1_given, force_fn,
                  dtype):
    """One velocity-Verlet step with Langevin friction and noise from
    (x0, v0, f0): returns (x1, v1, F1, F_cons).  The force at the end of
    the step is taken at ``x1_given`` (the positions being checked), so
    that the drift and the force are judged apart; the friction acts on
    the half-kicked velocity, as in the system's integrator."""
    dt, kT, gamma = sys_.dt, sys_.kT, sys_.gamma
    x0, v0, f0 = (t.to(dtype) for t in (x0, v0, f0))
    m = mass.to(dtype)[:, None]
    bx = box.to(dtype)
    v_half = v0 + 0.5 * dt * f0 / m
    x1 = x0 + dt * v_half
    x1 = x1 - torch.floor(x1 / bx) * bx
    f_cons = force_fn(x1_given).to(dtype)
    amp = torch.sqrt(2.0 * kT * gamma * m / dt)
    f1 = f_cons - gamma * m * v_half + amp * noise.to(dtype)
    v1 = v_half + 0.5 * dt * f1 / m
    return x1, v1, f1, f_cons, v_half


def count_pairs(pos, box, rc: float) -> int:
    """Unordered pairs closer than ``rc`` (minimum image), counted on the
    reference's own grid from the positions."""
    n = pos.shape[0]
    x = pos.to(torch.float64)
    bx = box.to(torch.float64)
    find = _candidates(x, bx, rc)
    total = 0
    for lo in range(0, n, ROWS_PER_BLOCK):
        hi = min(lo + ROWS_PER_BLOCK, n)
        cand = find(lo, hi)
        rows = torch.arange(lo, hi, device=pos.device)[:, None]
        j = torch.clamp(cand, min=0)
        d = _min_image(x[rows] - x[j], bx)
        ok = (cand > rows) & (torch.sum(d * d, dim=-1) < rc * rc)
        total += int(ok.sum())
    return total
