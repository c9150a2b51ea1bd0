"""Chebyshev-compressed tabulated pair potentials (K1c/K1d/K1e operands).

Port of ``chemlab_tpu/engine/tab_cheb.py``.  Each nonbonded table is fit
once on the host (float64, numpy: ``fit_table``, ``fit_stack``,
``pack_table_scalars``, copied unchanged) in two pieces:

  wall  (r2 < rs2):  G(r) = F/r and E as Chebyshev in y = 1/max(r2, rcap2)
  well  (r2 >= rs2): G and E as Chebyshev in x = r

and a system takes the cell-tile kernel's Chebyshev modes only if every
used table passes validation against the engine's 4096-bin table.

``eval_planes`` is the per-pair op sequence that the CUDA kernel
(``csrc/cell_pair_cheb.cu``), the kernel's plain torch version and the
excluded-pair correction (``eval_pairs``) all run, in the same order, so
that the all-pairs sum minus the exclusion list cancels bit for bit.  One
deliberate change from the reference: the well piece's ``r`` is
``sqrt(r2)`` (correctly rounded in torch on the CPU and in ``sqrtf`` on the
card) where the reference computes ``r2 * rsqrt(r2)``; CUDA's ``rsqrtf`` is
approximate and would break the cancellation on the card.  Against the
reference this costs up to an ulp of ``r`` in the well piece.
"""

from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

logger = logging.getLogger(__name__)

# wall clamp: first bin where |F| drops below this (absolute, table units)
FCAP_DEFAULT = 5.0e3
DEFAULT_TOL = 5.0e-4
# candidate degrees (multiples of 8 keep the kernel's matrix count aligned)
WALL_DEGREES = (8, 16, 24)
WELL_DEGREES = (16, 24, 32, 40)


@dataclasses.dataclass
class ChebTabFit:
    """Per-table fit arrays, zero-padded to the stack-wide (kw, ko)."""

    wall_g: np.ndarray   # (T, kw) Chebyshev coeffs of F/r in y01
    wall_e: np.ndarray   # (T, kw)
    well_g: np.ndarray   # (T, ko) Chebyshev coeffs of F/r in x01 (ko may be 0)
    well_e: np.ndarray   # (T, ko)
    ay: np.ndarray       # (T,) y01 = ay / max(r2, rcap2) + by
    by: np.ndarray
    ax: np.ndarray       # (T,) x01 = ax * r + bx
    bx: np.ndarray
    rs2: np.ndarray      # (T,) wall/well switch on r2 (wall iff r2 < rs2)
    rcap2: np.ndarray    # (T,) wall clamp radius^2
    err: np.ndarray      # (T,) validation metric (max pointwise relative)
    ok: np.ndarray       # (T,) bool — err <= tol

    @property
    def kw(self) -> int:
        return self.wall_g.shape[1]

    @property
    def ko(self) -> int:
        return self.well_g.shape[1]


def _cheb_fit(x01: np.ndarray, vals: np.ndarray, deg: int,
              weights: np.ndarray) -> np.ndarray:
    """Weighted least-squares Chebyshev fit (float64)."""
    V = np.polynomial.chebyshev.chebvander(x01, deg - 1)
    W = weights[:, None]
    c, *_ = np.linalg.lstsq(V * W, vals * weights, rcond=None)
    return c


def _cheb_eval_np(x01: np.ndarray, c: np.ndarray) -> np.ndarray:
    return np.polynomial.chebyshev.chebval(x01, c)


def _rel_metric(fit: np.ndarray, ref: np.ndarray, scale: float) -> float:
    """Max pointwise |fit-ref| / (|ref| + 0.05*scale)."""
    return float(np.max(np.abs(fit - ref) / (np.abs(ref) + 0.05 * scale)))


def _fit_piece(x: np.ndarray, g: np.ndarray, e: np.ndarray, degrees,
               tol: float):
    """Fit one piece; returns (deg, cg, ce, err, lo, hi) or None."""
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        # degenerate piece: constant
        cg = np.zeros(degrees[0])
        ce = np.zeros(degrees[0])
        cg[0], ce[0] = g[0], e[0]
        return degrees[0], cg, ce, 0.0, lo, hi
    x01 = 2.0 * (x - lo) / (hi - lo) - 1.0
    g_scale = max(np.abs(g).max(), 1e-30)
    e_scale = max(np.abs(e).max(), 1e-30)
    wg = 1.0 / (np.abs(g) + 0.05 * g_scale)
    we = 1.0 / (np.abs(e) + 0.05 * e_scale)
    best = None
    for deg in degrees:
        if deg > len(x):
            break
        cg = _cheb_fit(x01, g, deg, wg)
        ce = _cheb_fit(x01, e, deg, we)
        err = max(_rel_metric(_cheb_eval_np(x01, cg), g, g_scale),
                  _rel_metric(_cheb_eval_np(x01, ce), e, e_scale))
        best = (deg, cg, ce, err, lo, hi)
        if err <= tol:
            break
    return best


def fit_table(r: np.ndarray, e: np.ndarray, f: np.ndarray, tol: float,
              fcap: float = FCAP_DEFAULT):
    """Fit one resampled table.  Returns a dict of per-table scalars/coeffs.

    r, e, f: the engine's uniform 4096-bin grid (what the XLA path serves).
    """
    g = np.divide(f, np.maximum(r, 1e-12))
    f_abs = np.abs(f)
    if f_abs.max() < 1e-12:
        # zero table (degraded inputs): exactly representable
        return dict(wall_g=np.zeros(1), wall_e=np.zeros(1),
                    well_g=None, well_e=None,
                    ay=0.0, by=0.0, ax=0.0, bx=0.0,
                    rs2=float(r[-1] ** 2 * 4.0), rcap2=float(max(r[0], 0.05) ** 2),
                    err=0.0, ok=True)
    # wall clamp: first bin whose |F| is below both the absolute cap and
    # 50x the outer-half force scale (physically unreachable core above it)
    f_well = max(np.abs(f[len(f) // 2:]).max(), 1e-30)
    reachable = (f_abs <= max(fcap, 50.0 * f_well)) & (r > 1e-3)
    if not reachable.any():
        return None
    i_cap = int(np.argmax(reachable))
    rcap = float(r[i_cap])

    # candidate splits: single-piece (all wall, in y) first — LJ-class tables
    # are low-degree exactly in 1/r^2 — then two-piece with the split where
    # |F| first decays to k x the well scale
    y_all = 1.0 / np.maximum(r[i_cap:], rcap) ** 2
    cand = [len(r)]  # single piece: everything in y
    for k_split in (8.0, 4.0, 16.0):
        below = f_abs[i_cap:] <= k_split * f_well
        if below.any():
            i_s = i_cap + int(np.argmax(below))
            if i_s - i_cap >= 8 and len(r) - i_s >= 8:
                cand.append(i_s)
    best = None
    for i_s in cand:
        wall_r = r[i_cap:i_s]
        if len(wall_r) < 2:
            continue
        y = 1.0 / np.maximum(wall_r, rcap) ** 2
        wall = _fit_piece(y, g[i_cap:i_s], e[i_cap:i_s], WALL_DEGREES, tol)
        if wall is None:
            continue
        if i_s >= len(r):
            err = wall[3]
            entry = (err, wall, None, i_s)
        else:
            well = _fit_piece(r[i_s:], g[i_s:], e[i_s:], WELL_DEGREES, tol)
            if well is None:
                continue
            err = max(wall[3], well[3])
            entry = (err, wall, well, i_s)
        if best is None or err < best[0]:
            best = entry
        if err <= tol:
            break
    if best is None:
        return None
    err, wall, well, i_s = best
    _, cwg, cwe, _, ylo, yhi = wall
    out = dict(wall_g=cwg, wall_e=cwe,
               ay=(2.0 / (yhi - ylo) if yhi > ylo else 0.0),
               by=(-(yhi + ylo) / (yhi - ylo) if yhi > ylo else 0.0),
               rcap2=rcap * rcap, err=float(err), ok=bool(err <= tol))
    if well is None:
        out.update(well_g=None, well_e=None, ax=0.0, bx=0.0,
                   rs2=float(r[-1] ** 2 * 4.0))
    else:
        _, cog, coe, _, xlo, xhi = well
        out.update(well_g=cog, well_e=coe,
                   ax=2.0 / (xhi - xlo), bx=-(xhi + xlo) / (xhi - xlo),
                   rs2=float(r[i_s] ** 2))
    return out


def fit_stack(nb_ef4: np.ndarray, nb_r0: np.ndarray, nb_dr: np.ndarray,
              used: np.ndarray, tol: float | None = None):
    """Fit every USED table in the stack.  Returns ChebTabFit, or None if
    any used table fails validation (the system then stays on the XLA path).

    used: (T,) bool — tables referenced by pair_tab_a/pair_tab_b.  Unused
    slots (bonded tables ride their own path) are zero-filled.
    """
    if tol is None:
        tol = float(os.environ.get("CHEMLAB_TAB_FIT_TOL", DEFAULT_TOL))
    n_t, n_bins, _ = nb_ef4.shape
    fits: list[dict | None] = [None] * n_t
    for t in range(n_t):
        if not used[t]:
            continue
        r = np.asarray(nb_r0[t], np.float64) + nb_dr[t] * np.arange(n_bins)
        e = np.asarray(nb_ef4[t, :, 0], np.float64)
        f = np.asarray(nb_ef4[t, :, 1], np.float64)
        ft = fit_table(r, e, f, tol)
        if ft is None or not ft["ok"]:
            logger.info("tab_cheb: table %d fit failed (err=%s) — system "
                        "stays on the exact XLA path",
                        t, None if ft is None else "%.2e" % ft["err"])
            return None
        fits[t] = ft
    kw = max((len(f["wall_g"]) for f in fits if f), default=0)
    ko = max((0 if f["well_g"] is None else len(f["well_g"])
              for f in fits if f), default=0)
    if kw == 0:
        return None
    # eval_planes unconditionally reads coefficients 0 and 1 of each piece
    kw = max(kw, 2)
    if ko == 1:
        ko = 2

    def _col(key, k):
        out = np.zeros((n_t, k), np.float32)
        for t, f in enumerate(fits):
            if f is not None and f.get(key) is not None:
                out[t, :len(f[key])] = f[key]
        return out

    def _sc(key, default=0.0):
        return np.array([f[key] if f is not None else default
                         for f in (fits[t] for t in range(n_t))],
                        np.float32)

    return ChebTabFit(
        wall_g=_col("wall_g", kw), wall_e=_col("wall_e", kw),
        well_g=_col("well_g", ko), well_e=_col("well_e", ko),
        ay=_sc("ay"), by=_sc("by"), ax=_sc("ax"), bx=_sc("bx"),
        rs2=_sc("rs2"), rcap2=_sc("rcap2", 1.0),
        err=_sc("err"), ok=np.array([f is not None and f["ok"]
                                     for f in fits]))


def pack_table_scalars(fit: ChebTabFit, used_ids) -> np.ndarray:
    """(n_tab, 2*kw + 2*ko + 6) scalar pack for the kernel's table-scalar
    mode: row s holds table used_ids[s]'s fit as plain scalars in the
    layout [wall_g(kw), wall_e(kw), well_g(ko), well_e(ko), ay, by, ax,
    bx, rs2, rcap2].  The kernel reads these from SMEM and evaluates one
    Clenshaw chain per table, selecting by a one-hot table-id plane —
    values are the SAME f32 scalars the coefficient-plane mode serves via
    MXU lookups, so the excluded-pair correction (eval_pairs) cancels the
    result identically in either mode."""
    kw, ko = fit.kw, fit.ko
    out = np.zeros((len(used_ids), 2 * kw + 2 * ko + 6), np.float32)
    for s, t in enumerate(used_ids):
        cols = [fit.wall_g[t], fit.wall_e[t]]
        if ko:
            cols += [fit.well_g[t], fit.well_e[t]]
        cols.append(np.array([fit.ay[t], fit.by[t], fit.ax[t], fit.bx[t],
                              fit.rs2[t], fit.rcap2[t]], np.float32))
        out[s] = np.concatenate([np.asarray(c, np.float32).ravel()
                                 for c in cols])
    return out


# ---------------------------------------------------------------------------
# Device-side evaluation (the op sequence the kernel runs)
# ---------------------------------------------------------------------------

def eval_planes(r2, wall_g, wall_e, well_g, well_e, ay, by, ax, bx, rs2,
                rcap2, kw: int, ko: int, want_e: bool = True):
    """Evaluate (G, E) = (F/r, energy) elementwise on tensors shaped like
    ``r2``; every coefficient operand is a tensor broadcastable to it (a
    sequence of them for the series).  The op sequence is the contract:
    the kernel and the correction run exactly these ops in this order.
    ``want_e=False`` skips the energy series (E returns zeros)."""
    r2w = torch.maximum(r2, rcap2)
    yw = torch.clamp(ay / r2w + by, -1.0, 1.0)
    g = wall_g[0] + wall_g[1] * yw
    e = wall_e[0] + wall_e[1] * yw if want_e else None
    tkm1, tk = torch.ones_like(yw), yw
    for k in range(2, kw):
        tn = 2.0 * yw * tk - tkm1
        g = g + wall_g[k] * tn
        if want_e:
            e = e + wall_e[k] * tn
        tkm1, tk = tk, tn
    if ko > 0:
        r = torch.sqrt(r2)
        xo = torch.clamp(ax * r + bx, -1.0, 1.0)
        go = well_g[0] + well_g[1] * xo
        eo = well_e[0] + well_e[1] * xo if want_e else None
        ukm1, uk = torch.ones_like(xo), xo
        for k in range(2, ko):
            un = 2.0 * xo * uk - ukm1
            go = go + well_g[k] * un
            if want_e:
                eo = eo + well_e[k] * un
            ukm1, uk = uk, un
        in_wall = r2 < rs2
        g = torch.where(in_wall, g, go)
        if want_e:
            e = torch.where(in_wall, e, eo)
    return g, (e if want_e else torch.zeros_like(g))


def split_rows(rows, kw: int, ko: int):
    """The coefficient operands of ``eval_planes`` from (..., P) rows in
    ``pack_table_scalars``' layout [wall_g(kw), wall_e(kw), well_g(ko),
    well_e(ko), ay, by, ax, bx, rs2, rcap2]."""
    col = [rows[..., k] for k in range(rows.shape[-1])]
    o = 2 * kw + 2 * ko
    return dict(wall_g=col[:kw], wall_e=col[kw:2 * kw],
                well_g=col[2 * kw:2 * kw + ko] if ko else None,
                well_e=col[2 * kw + ko:o] if ko else None,
                ay=col[o], by=col[o + 1], ax=col[o + 2], bx=col[o + 3],
                rs2=col[o + 4], rcap2=col[o + 5])


def table_rows(spec, ko: int):
    """(n_tables, 2kw + 2ko + 6) float32 fit rows of every table in the
    stack, in ``pack_table_scalars``' layout (the plane-mode coefficient
    pack; with ``ko == 0`` the well columns are absent)."""
    cols = [spec.cheb_wall_g, spec.cheb_wall_e]
    if ko:
        cols += [spec.cheb_well_g, spec.cheb_well_e]
    cols += [getattr(spec, "cheb_" + k)[:, None]
             for k in ("ay", "by", "ax", "bx", "rs2", "rcap2")]
    return torch.cat(cols, dim=1).to(torch.float32).contiguous()


def eval_pairs(rows, tab_idx, r2, kw: int, ko: int):
    """Per-pair evaluation for the excluded-pair correction: the fit row of
    table ``tab_idx`` (integer tensor shaped like ``r2``) among ``rows``
    (``table_rows``), then ``eval_planes``."""
    c = split_rows(rows[tab_idx.long()], kw, ko)
    return eval_planes(r2, c["wall_g"], c["wall_e"], c["well_g"],
                       c["well_e"], c["ay"], c["by"], c["ax"], c["bx"],
                       c["rs2"], c["rcap2"], kw, ko)
