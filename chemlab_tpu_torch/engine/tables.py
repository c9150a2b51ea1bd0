"""Potential table stacks (host side).

Port of ``chemlab_tpu/engine/tables.py``: the builder, the resamplers and
``interleave4`` are the reference's numpy code, copied because the
reference module imports jax at its top; the device lookups
(``interpolate``, ``interpolate4``) serve the tabulated bonded terms (bond,
angle and dihedral func 8) in the reference's f32 operation order.

The reference engine interpolates each tabulated potential from its own
(r, E, F) file at runtime (espressopp ``Tabulated`` with itype 1/2/3 =
linear/Akima/cubic; ref: gromacs_topology.py:705-706).  On TPU we want one
dense gatherable array, so every table is resampled once on the host onto a
uniform grid and stacked:

    stack.ef : (n_tables, n_bins, 2) float32   [:, :, 0]=E, [:, :, 1]=F
    stack.r0 : (n_tables,)  grid start
    stack.dr : (n_tables,)  grid spacing

Device-side lookup is then a fused gather + linear blend (`interpolate`).
Resampling honors the source table's declared itype: 1 = linear (the
reference passes itype=1 for every topology-driven table,
ref: gromacs_topology.py:694,706,925,1080,1198), 2 = Akima (used by
reaction-group potentials, ref: examples/atrp_activator/atrp.cfg:34),
3 = natural cubic spline. ``fidelity_report`` quantifies the residual
resample-then-linear-lookup error per table at float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_BINS = 4096


def _pchip_resample(x: np.ndarray, y: np.ndarray, xq: np.ndarray) -> np.ndarray:
    """Monotone-friendly cubic resampling with linear fallback for tiny tables."""
    if len(x) < 4:
        return np.interp(xq, x, y)
    # Fritsch-Carlson monotone cubic (PCHIP) without scipy.
    h = np.diff(x)
    m = np.diff(y) / h
    d = np.empty_like(y)
    d[0] = m[0]
    d[-1] = m[-1]
    w1 = 2 * h[1:] + h[:-1]
    w2 = h[1:] + 2 * h[:-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        dm = (w1 + w2) / (w1 / m[:-1] + w2 / m[1:])
    dm[np.sign(m[:-1]) * np.sign(m[1:]) <= 0] = 0.0
    d[1:-1] = dm
    idx = np.clip(np.searchsorted(x, xq) - 1, 0, len(x) - 2)
    t = (xq - x[idx]) / h[idx]
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t**2 * (3 - 2 * t)
    h11 = t**2 * (t - 1)
    out = h00 * y[idx] + h10 * h[idx] * d[idx] + h01 * y[idx + 1] + h11 * h[idx] * d[idx + 1]
    # clamp extrapolation
    out = np.where(xq <= x[0], y[0], out)
    out = np.where(xq >= x[-1], y[-1], out)
    return out


def _akima_slopes(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Akima (1970) slopes: weighted by |segment-slope differences|."""
    h = np.diff(x)
    m = np.diff(y) / h
    # extend slopes at both ends (Akima's quadratic extrapolation)
    m_ext = np.concatenate([[3 * m[0] - 2 * m[1], 2 * m[0] - m[1]], m,
                            [2 * m[-1] - m[-2], 3 * m[-1] - 2 * m[-2]]])
    w1 = np.abs(m_ext[3:] - m_ext[2:-1])    # |m_{i+1} - m_i|
    w2 = np.abs(m_ext[1:-2] - m_ext[:-3])   # |m_{i-1} - m_{i-2}|
    denom = w1 + w2
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w1 * m_ext[1:-2] + w2 * m_ext[2:-1]) / denom
    flat = denom < 1e-12 * np.maximum(np.abs(m_ext[1:-2]) + np.abs(m_ext[2:-1]), 1.0)
    t = np.where(flat, 0.5 * (m_ext[1:-2] + m_ext[2:-1]), t)
    return t


def _hermite_eval(x, y, d, xq):
    h = np.diff(x)
    idx = np.clip(np.searchsorted(x, xq) - 1, 0, len(x) - 2)
    t = (xq - x[idx]) / h[idx]
    h00 = (1 + 2 * t) * (1 - t) ** 2
    h10 = t * (1 - t) ** 2
    h01 = t**2 * (3 - 2 * t)
    h11 = t**2 * (t - 1)
    out = (h00 * y[idx] + h10 * h[idx] * d[idx]
           + h01 * y[idx + 1] + h11 * h[idx] * d[idx + 1])
    out = np.where(xq <= x[0], y[0], out)
    out = np.where(xq >= x[-1], y[-1], out)
    return out


def _akima_resample(x, y, xq):
    if len(x) < 5:
        return np.interp(xq, x, y)
    return _hermite_eval(x, y, _akima_slopes(x, y), xq)


def _cubic_spline_resample(x, y, xq):
    """Natural cubic spline (espressopp itype 3)."""
    n = len(x)
    if n < 4:
        return np.interp(xq, x, y)
    h = np.diff(x)
    # solve tridiagonal system for second derivatives (natural BCs)
    a = np.zeros(n)
    b = np.ones(n)
    c = np.zeros(n)
    d = np.zeros(n)
    b[1:-1] = 2 * (h[:-1] + h[1:])
    a[1:-1] = h[:-1]
    c[1:-1] = h[1:]
    d[1:-1] = 6 * ((y[2:] - y[1:-1]) / h[1:] - (y[1:-1] - y[:-2]) / h[:-1])
    # Thomas algorithm
    cp = np.zeros(n)
    dp = np.zeros(n)
    cp[0] = c[0] / b[0]
    dp[0] = d[0] / b[0]
    for i in range(1, n):
        mlt = b[i] - a[i] * cp[i - 1]
        cp[i] = c[i] / mlt
        dp[i] = (d[i] - a[i] * dp[i - 1]) / mlt
    m2 = np.zeros(n)
    m2[-1] = dp[-1]
    for i in range(n - 2, -1, -1):
        m2[i] = dp[i] - cp[i] * m2[i + 1]
    idx = np.clip(np.searchsorted(x, xq) - 1, 0, n - 2)
    dx = xq - x[idx]
    hh = h[idx]
    out = (m2[idx] * (x[idx + 1] - xq) ** 3 / (6 * hh)
           + m2[idx + 1] * dx**3 / (6 * hh)
           + (y[idx] / hh - m2[idx] * hh / 6) * (x[idx + 1] - xq)
           + (y[idx + 1] / hh - m2[idx + 1] * hh / 6) * dx)
    out = np.where(xq <= x[0], y[0], out)
    out = np.where(xq >= x[-1], y[-1], out)
    return out


def _linear_resample(x, y, xq):
    return np.interp(xq, x, y)


_RESAMPLERS = {
    1: _linear_resample,
    2: _akima_resample,
    3: _cubic_spline_resample,
}


def resample(itype: int, x, y, xq):
    """Resample y(x) at xq with the espressopp itype discipline
    (1 linear / 2 Akima / 3 cubic spline; anything else PCHIP)."""
    fn = _RESAMPLERS.get(itype, _pchip_resample)
    return fn(np.asarray(x, np.float64), np.asarray(y, np.float64),
              np.asarray(xq, np.float64))


@dataclasses.dataclass
class TableStack:
    """A stack of resampled potential tables (host-side numpy)."""

    ef: np.ndarray   # (n_tables, n_bins, 2)
    r0: np.ndarray   # (n_tables,)
    dr: np.ndarray   # (n_tables,)
    names: list      # n_tables source identifiers

    @property
    def n_tables(self) -> int:
        return self.ef.shape[0]

    @property
    def n_bins(self) -> int:
        return self.ef.shape[1]


class TableStackBuilder:
    """Accumulates (r, E, F) source tables, deduplicating by name."""

    def __init__(self, n_bins: int = DEFAULT_BINS):
        self.n_bins = n_bins
        self._tables = []
        self._index = {}

    def add(self, name: str, r: np.ndarray, e: np.ndarray, f: np.ndarray,
            itype: int = 1) -> int:
        """itype follows espressopp Tabulated: 1 linear (the reference's
        universal choice for topology tables), 2 Akima, 3 cubic spline."""
        key = (name, itype)
        if key in self._index:
            return self._index[key]
        idx = len(self._tables)
        self._tables.append((name, np.asarray(r, np.float64), np.asarray(e, np.float64),
                             np.asarray(f, np.float64), itype))
        self._index[key] = idx
        return idx

    def __contains__(self, key):
        if isinstance(key, tuple):
            return key in self._index
        return any(k[0] == key for k in self._index)

    def index(self, name: str, itype: int = 1) -> int:
        return self._index[(name, itype)]

    def build(self) -> TableStack:
        n = max(len(self._tables), 1)
        ef = np.zeros((n, self.n_bins, 2), dtype=np.float32)
        r0 = np.zeros(n, dtype=np.float32)
        dr = np.ones(n, dtype=np.float32)
        names = []
        for i, (name, r, e, f, itype) in enumerate(self._tables):
            order = np.argsort(r)
            r, e, f = r[order], e[order], f[order]
            lo, hi = float(r[0]), float(r[-1])
            h = np.diff(r)
            uniform = h.size > 0 and np.allclose(h, h[0], rtol=1e-5, atol=0.0)
            if itype == 1 and uniform and len(r) <= self.n_bins:
                # exact embed: published tables ship on uniform grids, so
                # linear lookup of the source values IS the reference's
                # itype-1 interpolation (zero resampling error); bins past
                # the table end repeat the boundary value (clamp semantics)
                n_src = len(r)
                ef[i, :n_src, 0] = e
                ef[i, :n_src, 1] = f
                ef[i, n_src:, 0] = e[-1]
                ef[i, n_src:, 1] = f[-1]
                r0[i] = lo
                dr[i] = float(h[0])
            else:
                grid = np.linspace(lo, hi, self.n_bins)
                ef[i, :, 0] = resample(itype, r, e, grid)
                ef[i, :, 1] = resample(itype, r, f, grid)
                r0[i] = lo
                dr[i] = (hi - lo) / (self.n_bins - 1)
            names.append(name)
        if not self._tables:
            names = ["<empty>"]
        return TableStack(ef=ef, r0=r0, dr=dr, names=names)

    def fidelity_report(self, n_queries: int = 20000) -> list:
        """Per-table error of the production path (resample -> float32 grid
        -> linear device lookup) against direct float64 itype interpolation
        of the source points, sampled at off-grid query points.

        Returns [(name, itype, max_abs_err_E, max_rel_err_E, max_abs_err_F)].
        """
        report = []
        stack = self.build()
        for i, (name, r, e, f, itype) in enumerate(self._tables):
            order = np.argsort(r)
            r, e, f = r[order], e[order], f[order]
            lo, hi = float(r[0]), float(r[-1])
            ge = stack.ef[i, :, 0]
            gf = stack.ef[i, :, 1]
            q = np.linspace(lo, hi, n_queries)[1:-1]
            # device lookup: linear blend on the float32 grid
            u = np.clip((q - float(stack.r0[i])) / float(stack.dr[i]),
                        0.0, self.n_bins - 1.000001)
            i0 = u.astype(np.int64)
            t = u - i0
            prod_e = ge[i0] * (1 - t) + ge[i0 + 1] * t
            prod_f = gf[i0] * (1 - t) + gf[i0 + 1] * t
            ref_e = resample(itype, r, e, q)
            ref_f = resample(itype, r, f, q)
            scale_e = np.maximum(np.abs(ref_e), np.abs(ref_e).max() * 1e-3 + 1e-30)
            report.append((name, itype,
                           float(np.abs(prod_e - ref_e).max()),
                           float((np.abs(prod_e - ref_e) / scale_e).max()),
                           float(np.abs(prod_f - ref_f).max())))
        return report


def interleave4(ef: np.ndarray) -> np.ndarray:
    """(nT, bins, 2) E/F stack -> (nT, bins, 4) [E_b, F_b, E_{b+1}, F_{b+1}].

    The device-side lookup then needs ONE gather per query instead of two
    (lo and hi rows): TPU random gathers cost ~11 cycles/element regardless
    of row width, so fetching both interpolation endpoints in a single
    16-byte row halves the dominant per-step cost of the tabulated path.
    """
    hi = np.concatenate([ef[:, 1:], ef[:, -1:]], axis=1)
    return np.concatenate([ef, hi], axis=2)



def _lookup(n_bins: int, stack_r0, stack_dr, table_idx, r):
    """(table rows, lower bin, blend weight) of the reference's lookup:
    ``u = (r - r0) / dr`` clipped to ``[0, n_bins - 1.000001]`` in f32 and
    truncated toward zero (``astype(int32)``) for the bin."""
    ti = table_idx.long()
    u = (r - stack_r0[ti]) / stack_dr[ti]
    u = torch.clamp(u, 0.0, n_bins - 1.000001)
    i0 = u.to(torch.int32)
    frac = (u - i0.to(u.dtype))[..., None]
    return ti, i0.long(), frac


def interpolate4(stack_ef4, stack_r0, stack_dr, table_idx, r):
    """Linear interpolation from the interleaved stack (one row gather);
    the same source values and blend as ``interpolate``."""
    ti, i0, frac = _lookup(stack_ef4.shape[1], stack_r0, stack_dr,
                           table_idx, r)
    v = stack_ef4[ti, i0]
    ef = v[..., :2] * (1.0 - frac) + v[..., 2:] * frac
    return ef[..., 0], ef[..., 1]


def interpolate(stack_ef, stack_r0, stack_dr, table_idx, r):
    """Linear interpolation of stacked tables on the tensors' device.

    ``stack_ef`` (n_tables, n_bins, 2) energies/forces, ``stack_r0`` and
    ``stack_dr`` (n_tables,) grid start and spacing, ``table_idx`` the
    table of each query ``r``.  Returns (E, F) shaped like ``r``; queries
    outside the grid clamp to the boundary values."""
    n_bins = stack_ef.shape[1]
    ti, i0, frac = _lookup(n_bins, stack_r0, stack_dr, table_idx, r)
    lo = stack_ef[ti, i0]
    hi = stack_ef[ti, torch.clamp(i0 + 1, max=n_bins - 1)]
    ef = lo * (1.0 - frac) + hi * frac
    return ef[..., 0], ef[..., 1]
