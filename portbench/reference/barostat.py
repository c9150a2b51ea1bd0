"""The plain virial pressure of a melt and the barostat's box step, as the
configuration's ``system.barostat`` block states them.

- Pressure: P = (2 E_kin + W) / 3V, with W = W_pair + W_bonded.  W_pair is
  the sum of r_ij . F_ij over the unexcluded pairs inside the cutoff, on
  the candidates, soft core and table of ``forces`` (the excluded pairs
  are never summed, so no correction is taken off).  W_bonded is
  -dU_bonded/ds at s = 1, positions and box scaled by s, written out
  (``bonded_virial``): the bonds' part, since an angle does not change
  under a uniform scaling.  E_kin is that of the given velocities at the
  configuration's mass.  Where ``band`` > 0 the pairs
  within it of the cutoff are left out of W_pair and their share is
  returned apart, each pair's r . F, as ``forces.pair_forces`` returns
  their forces.
- Box step: 'br' (Berendsen), mu = clip(1 - dt/tau (P0 - P), 0.9,
  1.1)^(1/3); 'lv' (Langevin piston), v_b += dt 3V (P - P0) / W -
  dt gammaP v_b + sqrt(2 kT gammaP dt / W) xi, mu = exp(dt v_b), W the
  piston's mass (at least 1e-6).  Both clip mu to [0.98, 1.02] and scale
  the positions and the box by it; the velocities are left as they are.

This is the definition of the system's ``integrate.virial_pressure`` and
``integrate._barostat_step``; it departs from it in nothing but the
precision (``dtype``).  Plain PyTorch, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import forces

MU_CLIP = (0.98, 1.02)
BERENDSEN_CLIP = (0.9, 1.1)
MIN_PISTON_MASS = 1e-6


def pair_virial(pos, box, type_id, excl, pair: dict, dtype, tables=None,
                band: float = 0.0):
    """(W_pair, r . F of each pair within ``band`` of the cutoff (M,)) in
    ``dtype``: each unordered pair once."""
    rows_w, amb = [], []
    for _, _, _, _, r2, fs, near in forces._pair_blocks(
            pos, box, type_id, excl, pair, dtype, tables, band):
        w = fs * r2
        if band > 0.0:
            # each pair sits in two rows: half its r . F in each
            amb.append(0.5 * w[near])
            w = torch.where(near, torch.zeros_like(w), w)
        rows_w.append(torch.sum(w, dim=1))
    w_pair = 0.5 * torch.sum(torch.cat(rows_w))
    if amb:
        return w_pair, torch.cat(amb)
    return w_pair, torch.zeros(0, dtype=dtype, device=pos.device)


def bonded_virial(pos, box, bonds, k_bond, r0, dtype):
    """W_bonded = -dU/ds at s = 1 of U = k_bond (r - r0)^2 on each bond,
    positions and box scaled by s (the minimum image taken at s = 1, so
    each bond's length scales by s): -sum 2 k_bond (r - r0) r.  An angle
    does not change under the scaling, so the angles add nothing.  The
    derivative is written out, not taken by autograd, so that a bond of
    length 0 (two ends on one bfloat16 position, in the control) gives 0
    and not NaN."""
    x = pos.to(dtype)
    b = torch.as_tensor(np.asarray(bonds), dtype=torch.long, device=pos.device)
    if not b.numel():
        return torch.zeros((), dtype=dtype, device=pos.device)
    d = forces._min_image(x[b[:, 0]] - x[b[:, 1]], box.to(dtype))
    r = torch.sqrt(torch.sum(d * d, dim=-1))
    return -torch.sum(2.0 * k_bond * (r - r0) * r)


def pressure(sys_, pos, vel, mass, box, type_id, bonds, excl, dtype,
             tables=None, band: float = 0.0) -> dict:
    """The virial pressure and its parts, in ``dtype``: ``p``, ``ekin``,
    ``w_pair``, ``w_bonded``, ``vol`` and ``w_band`` (the r . F of each
    pair at the cutoff, left out of ``w_pair``)."""
    w_pair, w_band = pair_virial(pos, box, type_id, excl, sys_.pair, dtype,
                                 tables, band)
    w_bonded = bonded_virial(pos, box, bonds, sys_.bond_k, sys_.bond_r0,
                             dtype)
    v = vel.to(dtype)
    ekin = 0.5 * torch.sum(mass.to(dtype) * torch.sum(v * v, dim=-1))
    vol = torch.prod(box.to(dtype))
    return {"p": (2.0 * ekin + w_pair + w_bonded) / (3.0 * vol),
            "ekin": ekin, "w_pair": w_pair, "w_bonded": w_bonded,
            "vol": vol, "w_band": w_band}


def box_scale(baro, p, vol, baro_v, xi, dt: float, kT: float):
    """mu of one step of the configuration's barostat ``baro``
    (``system.Barostat``) from the pressure ``p`` in the volume ``vol``;
    ``baro_v`` the piston's velocity before the step and ``xi`` its
    standard normal draw ('lv')."""
    if baro.form == "br":
        base = torch.clamp(1.0 - dt / baro.tau * (baro.pressure - p),
                           *BERENDSEN_CLIP)
        mu = base ** (1.0 / 3.0)
    else:
        w = max(baro.mass, MIN_PISTON_MASS)
        v_b = (baro_v + dt * 3.0 * vol * (p - baro.pressure) / w
               - dt * baro.gammaP * baro_v
               + (2.0 * kT * baro.gammaP * dt / w) ** 0.5 * xi)
        mu = torch.exp(dt * v_b)
    return torch.clamp(mu, *MU_CLIP)


def barostat_step(baro, pos, box, p, vol, baro_v, xi, dt: float,
                  kT: float):
    """(positions, box) after one barostat step: both scaled by
    ``box_scale``'s mu."""
    mu = box_scale(baro, p, vol, baro_v, xi, dt, kT)
    return pos * mu, box * mu
