"""System assembly: SystemTopology + Coordinates (+ reactions) -> tensors.

Port of ``chemlab_tpu/engine/build.py`` ``build_system``: every nonbonded
func the reference lowers (LJ, funcs 1 and 8-17, auto-tabulated
``table_groups``) with the reference's choice of force path
(``_pallas_enabled`` and the two fit fallbacks): the cell-tile kernels
where they admit the system (LJ on K1 on a colt2 grid, on the per-cell K2
on any other; tabulated-only systems, func 10/12 blends included, on the
Chebyshev modes K1c/K1d/K1e, colt2 grids only), the Verlet row path
(``pair_forces``, persistent rows) for everything else: ``use_pallas=
False``, Coulomb between charges, LJ beside tables, caps, λ-scaled,
multi-range and scaled pairs, a table that fails the fit, more than 8
blended fits, a tabulated system on a K2 grid.  Bonds (harmonic, FENE,
FENE + WCA, tabulated), angles (harmonic, tabulated, cosine), dihedrals
(funcs 1, 3, 8 and 12, static and by type lookup) and 1-4 pairs
(fudgeLJ, shifted at the LJ cutoff), the dense-static bonded and
exclusion operands, Langevin, the rescaling thermostats (CSVR, Berendsen,
isokinetic) or NVE, the Berendsen and Langevin barostats and the pressure
observable, and reaction channels matched on compacted rows or, when the
type_1 side spans the bulk, on full rows, with their extensions:
dissociation, RestrictReaction (the ``connectivity_map`` whitelist),
ChangeNeighboursProperty, RemoveNeighboursBonds, ReleaseMolecule (dummy
particles appended after the real ones) and JoinMolecule (FixDistances),
dynamic resolution, ATRPActivator, ChangeParticleType and FreezeRegion.
The lowering is the reference's numpy code; only the last step differs:
arrays become torch tensors on ``device`` (the card unless the caller asks
for another) through the bridge, and the build-time neighbor rows are made
by the port's ``neighbor.build_neighbor_state``.

One divergence is kept on purpose: Coulomb over all-zero charges (no
charged atom and no charged atomtype) builds on the kernel path with the
Coulomb term left out, where the reference takes its row path
(``refuse_charges`` guards it).  A configuration outside the port raises
``NotImplementedError`` naming the ROADMAP item that will bring it.

Capacity management (reference ``build.py:456-932``): the neighbor caps
regrow off the sticky overflow flag and shrink to the observed occupancy
(``grow_neighbor_caps``, ``shrink_neighbor_caps``); the term tables and
the exclusion pair list regrow before they fill, shrink to their cursors,
and are presized or laddered from a measured append rate
(``grow_term_caps``, ``shrink_term_caps``, ``presize_term_caps``,
``plan_cap_ladder``, all applied by ``apply_term_caps``).  A cap change is
a new ``EngineConfig`` plus tensors re-padded on the state's device; the
kernels take any cap (``cell_pair`` plans by cap), so nothing recompiles.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import warnings

import numpy as np
import torch

from .. import bridge, files_io
from ..units import COULOMB_PREFACTOR
from ..topology import SystemTopology, combine_lj
from . import (bonded_dense, excl_dense, neighbor, reaction_compile,
               tables, tab_cheb)
from .spec import (MIX_MULTIRANGE, MIX_OBS, MIX_STATIC, PAIR_LJ, PAIR_TAB,
                   EngineConfig, SimSpec)
from .state import N_BOND_PARAMS, MDState, TermTable

logger = logging.getLogger(__name__)

F32 = np.float32
I32 = np.int32


@dataclasses.dataclass
class SimOptions:
    """Engine-relevant simulation options (the reference's field set)."""

    lj_cutoff: float = 1.2
    cg_cutoff: float = 1.4
    coulomb_cutoff: float = 0.0
    skin: float = 0.16
    dt: float = 0.001
    kT: float = 1.0
    thermostat: str = "lv"
    thermostat_gamma: float = 5.0
    barostat: str = "no"
    pressure: float = 0.0
    barostat_tau: float = 5.0
    barostat_gammaP: float = 1.0
    barostat_mass: float = 50.0
    max_force: float = -1.0
    fudge_qq: float | None = None   # None = the topology's [ defaults ]
    table_groups: tuple = ()
    thermal_groups: tuple = ()
    rng_seed: int = 12345
    gen_velocity: bool = False
    mass_factor: float = 1.0
    store_pressure: bool = False
    t_hybrid_bond: int = 0
    t_hybrid_angle: int = 0
    t_hybrid_dihedral: int = 0
    exclude_new_bonds: bool = True
    table_dirs: tuple = (".",)
    output_prefix: str = "sim"
    n_bins: int = 4096
    max_neighbors: int | None = None
    cell_cap: int | None = None
    deg_cap: int = 8
    excl_cap: int | None = None
    extra_bonds: int | None = None
    extra_angles: int | None = None
    extra_dihedrals: int | None = None
    max_events: int = 128
    dtype: str = "float32"
    use_pallas: bool | None = None    # None = the cell kernels where they
                                      # admit the system, else the row path
    bonded_dense: bool | None = None  # None = on
    excl_dense: bool | None = None    # None = on
    slab_devices: int = 0  # >1: round the grid's x-layer count down to a
                           # multiple, for the slab path (cell_pair_halo)


@dataclasses.dataclass
class BuiltSystem:
    cfg: EngineConfig
    spec: SimSpec
    state: MDState
    obs: "ObsRegistry"
    reactions: reaction_compile.CompiledReactions | None
    systop: SystemTopology
    nb_names: list
    term_names: list
    extra_obs_idx: list = dataclasses.field(default_factory=list)


class ObsRegistry:
    """Conversion-observable registry (reference: build.ObsRegistry), keyed
    by ((type, state), ...), total); func 10 pairs register one each."""

    def __init__(self):
        self.keys = []
        self.entries = []   # (obs_idx, type_id, state)
        self.totals = []

    def register(self, type_states, total) -> int:
        """type_states: list of (type_id, state_or_None)."""
        key = (tuple(type_states), total)
        if key in self.keys:
            return self.keys.index(key)
        idx = len(self.keys)
        self.keys.append(key)
        self.totals.append(float(total))
        for tid, st in type_states:
            self.entries.append((idx, tid, -1 if st is None else st))
        return idx

    def label(self, idx: int) -> str:
        type_states, _ = self.keys[idx]
        parts = "_".join(str(t) for t, _ in type_states)
        states = [s for _, s in type_states if s is not None]
        return "cr_%s%s" % (parts, "_%d" % states[0] if states else "")

    def arrays(self):
        n = max(len(self.keys), 1)
        if not self.entries:
            return (np.zeros(1, I32), np.zeros(1, I32), np.full(1, -1, I32),
                    np.ones(n, F32))
        return (np.asarray([e[0] for e in self.entries], I32),
                np.asarray([e[1] for e in self.entries], I32),
                np.asarray([e[2] for e in self.entries], I32),
                np.asarray(self.totals, F32))


def _not_in_slice(what: str, item: str):
    raise NotImplementedError(
        "%s is outside the ported slice (ROADMAP %s)" % (what, item))


def _asarray(a, dtype=None):
    """numpy twin of ``jnp.asarray`` with 64-bit types disabled."""
    a = np.asarray(a, dtype=dtype)
    if a.dtype == np.int64:
        return a.astype(I32)
    if a.dtype == np.float64:
        return a.astype(F32)
    if a.dtype == np.uint64:
        return a.astype(np.uint32)
    return a


def _pack_bond_params(func, fields, bond_tb, table_dirs):
    """Raw .top bond fields -> engine params (reference:
    build._pack_bond_params); a func-8 bond's table goes into ``bond_tb``
    and its id into slot 0."""
    p = np.zeros(N_BOND_PARAMS, F32)
    f = [float(x) for x in fields] if func != 8 else fields
    if func == 1:
        p[0] = f[1] / 2.0   # GROMACS K -> U = K/2 (r-r0)^2
        p[1] = f[0]
    elif func == 7:
        p[0] = f[1]
        p[1] = 0.0
        p[2] = f[0]
    elif func == 8:
        name = files_io.resolve_table("table_b%d" % int(float(fields[0])),
                                      table_dirs)
        r, e, fr, _ = files_io.read_table(name, kind="bond")
        p[0] = bond_tb.add(name, r, e, fr)
    elif func == 9:
        p[0] = f[1]
        p[1] = 0.0
        p[2] = f[0]
        p[3] = f[2]
        p[4] = f[3]
    else:
        raise NotImplementedError("bond func %d" % func)
    return p


def _pack_angle_params(func, fields, angle_tb, table_dirs):
    p = np.zeros(N_BOND_PARAMS, F32)
    if func == 1:
        p[0] = float(fields[1]) / 2.0
        p[1] = math.radians(float(fields[0]))
    elif func == 8:
        name = files_io.resolve_table("table_a%d" % int(float(fields[0])),
                                      table_dirs)
        r, e, fr, _ = files_io.read_table(name, kind="angle")
        p[0] = angle_tb.add(name, r, e, fr)
    elif func == 11:
        p[0] = float(fields[1])
        p[1] = math.radians(float(fields[0]))
    else:
        raise NotImplementedError("angle func %d" % func)
    return p


def _pack_dihedral_params(func, fields, dih_tb, table_dirs):
    """(reference: build._pack_dihedral_params)"""
    p = np.zeros(N_BOND_PARAMS, F32)
    if func == 1:
        p[0] = float(fields[1])
        p[1] = math.radians(float(fields[0]))
        p[2] = float(fields[2]) if len(fields) > 2 else 1.0
    elif func == 3:
        vals = [float(x) for x in fields][-6:]
        p[: len(vals)] = vals
    elif func == 8:
        name = files_io.resolve_table("table_d%d" % int(float(fields[0])),
                                      table_dirs)
        r, e, fr, _ = files_io.read_table(name, kind="dihedral")
        p[0] = dih_tb.add(name, r, e, fr)
    elif func == 12:
        p[0] = float(fields[1])
        p[1] = math.radians(float(fields[0]))
    else:
        raise NotImplementedError("dihedral func %d" % func)
    return p


def _load_nb_table(name, nb_tb, table_dirs):
    path = files_io.resolve_table(name, table_dirs)
    r, e, f, _ = files_io.read_table(path, kind="nonbonded")
    return nb_tb.add(path, r, e, f)


def _load_auto_nb_table(s1, s2, nb_tb, table_dirs):
    """Auto filename table_T1_T2; published files may use either symbol
    order, so try both."""
    try:
        return _load_nb_table("table_%s_%s" % (s1, s2), nb_tb, table_dirs)
    except FileNotFoundError:
        return _load_nb_table("table_%s_%s" % (s2, s1), nb_tb, table_dirs)


def _build_pair_tables(systop: SystemTopology, opts: SimOptions, nb_tb,
                       obs: ObsRegistry):
    """Per-type-pair dispatch arrays and the multi-range mix entries
    (reference: build._build_pair_tables) for every nonbonded func: LJ
    (combination or func 1), tables (func 8 and auto-tabulated
    ``table_groups`` pairs), the MultiTabulated range switch (9), the
    two-table blends (10 by a conversion observable, 12 by a static
    factor), λ-scaled tables with a force cap (11), capped tables (13),
    ParticlePairScaling (14), λ-scaled LJ (15), energy-capped LJ (16) and
    multi-range blended tables (17).  Returns (arrays, mix_entries), each
    entry (pair_flat, lo, hi, tab_a, tab_b, obs, default)."""
    T = systop.next_type_id
    n2 = T * T
    out = {
        "pair_kind": np.zeros(n2, I32),
        "pair_sig": np.zeros(n2, F32),
        "pair_eps": np.zeros(n2, F32),
        "pair_cutoff2": np.zeros(n2, F32),
        "pair_shift": np.zeros(n2, F32),
        "pair_caprad": np.zeros(n2, F32),
        "pair_tab_a": np.zeros(n2, I32),
        "pair_tab_b": np.zeros(n2, I32),
        "pair_mix_mode": np.zeros(n2, I32),
        "pair_mix_x": np.ones(n2, F32),
        "pair_obs": np.zeros(n2, I32),
        "pair_lam_scale": np.zeros(n2, bool),
        "pair_max_force": np.full(n2, -1.0, F32),
        "pair_pps_incr": np.zeros(n2, F32),
    }
    mix_entries = []
    cr = systop.defaults["combinationrule"]
    atomtypes = systop.top.atomtypes
    sym2id = systop.atomsym_atomtype
    tab_groups = set(opts.table_groups or ())
    lj_cut, tab_cut = opts.lj_cutoff, opts.cg_cutoff

    def flat(t1, t2):
        return [t1 * T + t2, t2 * T + t1]

    def set_pair(t1, t2, **kw):
        for p in flat(t1, t2):
            for k, v in kw.items():
                out["pair_%s" % k][p] = v

    def lj_shift(sig, eps):
        if eps == 0.0 or sig <= 0.0:
            return 0.0
        sr6 = (sig / lj_cut) ** 6
        return 4.0 * eps * (sr6 * sr6 - sr6)

    def set_lj(t1, t2, sig, eps, **kw):
        set_pair(t1, t2, kind=PAIR_LJ, sig=sig, eps=eps, cutoff2=lj_cut**2,
                 shift=lj_shift(sig, eps), **kw)

    def set_tab(t1, t2, tab_a, tab_b=None, **kw):
        set_pair(t1, t2, kind=PAIR_TAB, tab_a=tab_a,
                 tab_b=tab_a if tab_b is None else tab_b,
                 cutoff2=tab_cut**2, **kw)

    def raw_combination(s1, s2):
        a, b = atomtypes.get(s1), atomtypes.get(s2)
        if a is None or b is None:
            return -1.0, -1.0
        return combine_lj(a["sigma"], a["epsilon"], b["sigma"], b["epsilon"],
                          cr)

    def table(name):
        return _load_nb_table(name, nb_tb, opts.table_dirs)

    def register_obs(type_sym, total):
        return obs.register([(sym2id[type_sym], None)], int(total))

    syms = sorted(sym2id, key=sym2id.get)
    for i1, s1 in enumerate(syms):
        for s2 in syms[i1:]:
            t1, t2 = sym2id[s1], sym2id[s2]
            param = systop.top.nonbond_params.get(tuple(sorted((s1, s2))))
            auto = (lambda: _load_auto_nb_table(s1, s2, nb_tb,
                                                opts.table_dirs))
            if param is None:
                if s1 in tab_groups and s2 in tab_groups:
                    set_tab(t1, t2, auto())
                else:
                    sig, eps = raw_combination(s1, s2)
                    if sig > 0.0:
                        set_lj(t1, t2, sig, eps)
                continue
            func, pp = param["func"], param["params"]
            if func == 1:
                sig, eps = ((float(pp[0]), float(pp[1])) if pp
                            else raw_combination(s1, s2))
                if sig > 0.0:
                    set_lj(t1, t2, sig, eps)
            elif func == 8:
                set_tab(t1, t2, table(pp[0]) if pp else auto())
            elif func == 9:
                # conversion-switched MultiTabulated: the table serves the
                # pair while the observable lies in [lo, hi)
                tab = table(pp[0])
                o = register_obs(pp[1], int(pp[2]))
                lo, hi = float(pp[3]), float(pp[4])
                default = bool(int(pp[5])) if len(pp) > 5 else False
                for p in flat(t1, t2):
                    mix_entries.append((p, lo, hi, tab, tab, o, default))
                base = tab if default else 0
                set_tab(t1, t2, base, mix_mode=MIX_MULTIRANGE)
            elif func == 10:
                o = register_obs(pp[2], int(pp[3]))
                set_tab(t1, t2, table(pp[0]), table(pp[1]), mix_mode=MIX_OBS,
                        obs=o)
            elif func == 11:
                mf = float(pp[1]) if len(pp) > 1 else -1.0
                set_tab(t1, t2, table(pp[0]) if pp else auto(),
                        lam_scale=True, max_force=mf)
            elif func == 12:
                set_tab(t1, t2, table(pp[0]), table(pp[1]),
                        mix_mode=MIX_STATIC, mix_x=float(pp[2]))
            elif func == 13:
                set_tab(t1, t2, table(pp[0]), caprad=float(pp[1]))
            elif func == 14:
                # ParticlePairScaling: a new neighbour pair fades in by
                # pps_incr a step
                mf = float(pp[2]) if len(pp) > 2 else -1.0
                set_tab(t1, t2, table(pp[0]), max_force=mf,
                        pps_incr=float(pp[1]))
            elif func == 15:
                mf = -1.0
                if pp and len(pp) == 1:
                    mf = float(pp[0])
                    sig, eps = raw_combination(s1, s2)
                elif pp:
                    sig, eps = float(pp[0]), float(pp[1])
                    if len(pp) == 3:
                        mf = float(pp[2])
                else:
                    sig, eps = raw_combination(s1, s2)
                set_lj(t1, t2, sig, eps, lam_scale=True, max_force=mf)
            elif func == 16:
                if len(pp) == 1:
                    cap = float(pp[0])
                    sig, eps = raw_combination(s1, s2)
                else:
                    sig, eps, cap = float(pp[0]), float(pp[1]), float(pp[2])
                set_lj(t1, t2, sig, eps, caprad=cap)
            elif func == 17:
                o = register_obs(pp[0], int(pp[1]))
                for spec_str in pp[2:]:
                    t = spec_str.split(":")
                    lo, hi = float(t[0]), float(t[1])
                    ta, tb_ = table(t[2]), table(t[3])
                    for p in flat(t1, t2):
                        mix_entries.append((p, lo, hi, ta, tb_, o, False))
                set_tab(t1, t2, 0, mix_mode=MIX_MULTIRANGE)
            elif func == 18:
                logger.warning("func 18 (connectivity-scaled) is a no-op, "
                               "as in the reference")
            else:
                raise ValueError("nonbonded func %d not supported" % func)
    return out, mix_entries


def supports_lj(pair_arrays) -> bool:
    """The reference's gate of the LJ kernels (``pallas_pair.supports``):
    no tables, caps, λ scaling, blends or pair-age ramps."""
    return not ((pair_arrays["pair_kind"] == PAIR_TAB).any()
                or (pair_arrays["pair_caprad"] > 0).any()
                or pair_arrays["pair_lam_scale"].any()
                or (pair_arrays["pair_mix_mode"] != 0).any()
                or (pair_arrays["pair_pps_incr"] > 0).any())


def supports_cheb(pair_arrays) -> bool:
    """The reference's gate of the kernel's Chebyshev modes
    (``pallas_pair.supports_cheb``): tabulated-only systems, no caps, force
    caps, lambda scaling, multi-range mixing or pair-age ramps; the func
    10/12 two-table blends are admitted."""
    kinds = pair_arrays["pair_kind"]
    if not (kinds == PAIR_TAB).any():
        return False
    return not ((kinds == PAIR_LJ).any()
                or (kinds > PAIR_TAB).any()
                or (pair_arrays["pair_caprad"] > 0).any()
                or (pair_arrays["pair_max_force"] > 0).any()
                or pair_arrays["pair_lam_scale"].any()
                or (pair_arrays["pair_mix_mode"] == MIX_MULTIRANGE).any()
                or (pair_arrays["pair_pps_incr"] > 0).any())


def _pallas_enabled(opts: SimOptions, pair_arrays, qq_pref: float,
                    charged: bool, cell_dims, n_mix: int = 0) -> tuple:
    """The reference's gate of the cell-tile kernels (``_pallas_enabled``):
    wanted (``use_pallas`` None or True) and the system's nonbonded physics
    in their scope.  Returns (use_pallas, cheb_candidate); a candidate
    keeps the kernel only if its tables pass the Chebyshev fit
    (``_cheb_tables``).  Coulomb sends the system to the row path only
    where a charge can be nonzero (``charged``): over all-zero charges the
    kernel runs with the term left out."""
    if opts.use_pallas is False:
        return False, False
    if qq_pref > 0 and charged:
        logger.warning("pallas pair kernel disabled: coulomb not supported")
        return False, False
    if supports_lj(pair_arrays):
        return True, False
    if (n_mix == 0 and supports_cheb(pair_arrays)
            and min(int(d) for d in cell_dims) >= 3
            and (opts.cell_cap is None or opts.cell_cap % 8 == 0)):
        return True, True
    logger.warning("pallas pair kernel disabled: unsupported pair variant "
                   "(mixing/caps/lambda/pps) or colt2-ineligible geometry")
    return False, False


def _cheb_tables(pair_arrays, nb_stack):
    """Fit every used table and choose the kernel mode (reference:
    build.py:1388-1466).  Returns (fit, ntab, slot, slot_b, sc, mix):
    table-scalar mode (K1c, K1d when mixed) when at most 8 distinct fits
    fill at most 128 coefficients, else coefficient-plane mode (K1e,
    ``ntab`` 0); or None where the reference falls back to its row path: a
    failed fit, or blended tables with more than 8 distinct fits."""
    is_tab_pair = pair_arrays["pair_kind"] == PAIR_TAB
    used_tabs = np.zeros(nb_stack.ef.shape[0], bool)
    used_tabs[pair_arrays["pair_tab_a"][is_tab_pair]] = True
    used_tabs[pair_arrays["pair_tab_b"][is_tab_pair]] = True
    fit = tab_cheb.fit_stack(tables.interleave4(nb_stack.ef), nb_stack.r0,
                             nb_stack.dr, used_tabs)
    if fit is None:
        logger.warning("tabulated fast path disabled: a pair table failed "
                       "Chebyshev fit validation; exact row path selected")
        return None
    logger.info("tabulated pairs: %d tables fit (kw=%d ko=%d, worst err "
                "%.2e)", int(used_tabs.sum()), fit.kw, fit.ko,
                float(fit.err[used_tabs].max()))
    is_mixed = is_tab_pair & (pair_arrays["pair_tab_b"]
                              != pair_arrays["pair_tab_a"])
    used_ids = np.unique(np.concatenate(
        [pair_arrays["pair_tab_a"][is_tab_pair],
         pair_arrays["pair_tab_b"][is_tab_pair]]))
    # dedupe by fit content: pairs that share a table's values share a slot
    pack_all = tab_cheb.pack_table_scalars(fit, used_ids)
    uniq_rows, inv = np.unique(pack_all, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    if len(uniq_rows) <= 8 and len(uniq_rows) * (fit.kw + fit.ko) <= 128:
        slot = np.zeros(pair_arrays["pair_tab_a"].shape, F32)
        slot_b = np.zeros_like(slot)
        for i, t in enumerate(used_ids):
            slot[is_tab_pair & (pair_arrays["pair_tab_a"] == t)] = inv[i] + 1
            # pure pairs keep slot_b = 0 (blend weight forced to 1)
            slot_b[is_mixed & (pair_arrays["pair_tab_b"] == t)] = inv[i] + 1
        mix = bool(is_mixed.any())
        return fit, int(len(uniq_rows)), slot, (slot_b if mix else None), \
            uniq_rows, mix
    if is_mixed.any():
        logger.warning("tabulated fast path disabled: mixed tables with >8 "
                       "distinct fits; exact row path selected")
        return None
    return fit, 0, None, None, None, False


def _host_components(n, bonds):
    """Connected components over bonds -> molecule ids (union-find)."""
    parent = np.arange(n, dtype=np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in bonds:
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    return np.asarray([find(i) for i in range(n)], dtype=I32)


def _round_up(x, m):
    return int(-(-x // m) * m)


NEIGHBOR_CAP_FIELDS = ("max_neighbors", "cell_cap", "excl_cap",
                       "rx_cell_cap", "rx_k", "rx_rows_cap")


def apply_neighbor_caps(cfg: EngineConfig, spec: SimSpec, state, caps: dict):
    """Re-derive the config with explicit neighbor caps and rebuild the
    neighbor scratch to match (a checkpoint restored into a fresh build
    whose caps differ from the run that wrote it)."""
    cfg = dataclasses.replace(cfg, **caps)
    return _rebuild_neighbor_scratch(cfg, spec, state)


def grow_neighbor_caps(cfg: EngineConfig, spec: SimSpec, state,
                       factor: float = 1.5):
    """Regrow every neighbor cap by ``factor`` (rounded up to 8) after the
    sticky overflow flag latched, and rebuild the neighbor state with the
    flag cleared.  Returns (cfg, state)."""
    cfg = dataclasses.replace(
        cfg,
        **{f: _round_up(int(getattr(cfg, f) * factor), 8)
           for f in NEIGHBOR_CAP_FIELDS})
    return _rebuild_neighbor_scratch(cfg, spec, state)


def _rc_skin(spec):
    """cutoff + skin as the f32 tensor the reference computes."""
    return torch.sqrt(torch.max(spec.pair_cutoff2)) + spec.skin


def shrink_neighbor_caps(cfg: EngineConfig, spec: SimSpec, state,
                         margin: float = 1.4):
    """Tighten the neighbor caps to the occupancy observed in ``state``.

    The build sizes ``cell_cap`` from the initial coordinates, which can be
    far denser locally than the equilibrated fluid; every kernel tile is
    ``cell_cap`` rows wide.  The caps come from a fresh binning and row
    build at the current state, never grow, and are rounded up to 8 (so a
    colt2 grid stays one); overflow and ``grow_neighbor_caps`` stay the
    backstop.  Returns (cfg, state), the same objects when nothing
    changed."""
    rc_skin = float(_rc_skin(spec))
    buckets, _, _, _ = neighbor.build_cell_buckets(
        state.pos, state.box, state.active, cfg.cell_dims, cfg.cell_cap)
    occ = int(torch.max((buckets[:-1] >= 0).sum(dim=1, dtype=torch.int32)))
    nbr = neighbor.build_neighbor_state(
        state.pos, state.box, state.active, state.excl, rc_skin,
        dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
        max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap)
    self_idx = torch.arange(state.pos.shape[0], dtype=torch.int32,
                            device=state.pos.device)[:, None]
    kmax = int(torch.max((nbr.idx != self_idx).sum(dim=1,
                                                   dtype=torch.int32)))

    caps = {}
    # the cell_cap margin is additive: every slot of margin widens each
    # kernel tile, and the maximum over all cells already holds the tail
    new_cell = _round_up(max(occ + max(4, (occ + 3) // 4), 8), 8)
    if new_cell < cfg.cell_cap and not bool(nbr.overflow):
        caps["cell_cap"] = new_cell
    # K saturated at the current cap: the true count is unknown, skip
    if kmax < cfg.max_neighbors:
        new_k = _round_up(max(int(kmax * margin) + 4, 16), 8)
        if new_k < cfg.max_neighbors:
            caps["max_neighbors"] = new_k
    if "cell_cap" in caps and cfg.rx_rc > 0:
        # the reaction grid's cap scales with the force grid's occupancy
        box = state.box.cpu().numpy()
        rx_vol = float(np.prod(box / np.asarray(cfg.rx_dims)))
        vol = float(np.prod(box / np.asarray(cfg.cell_dims)))
        new_rx = _round_up(max(int(caps["cell_cap"] * rx_vol / vol) + 4, 8),
                           8)
        if new_rx < cfg.rx_cell_cap:
            caps["rx_cell_cap"] = new_rx
    if not caps:
        return cfg, state
    cfg = dataclasses.replace(cfg, **caps)
    return _rebuild_neighbor_scratch(cfg, spec, state)


def _rebuild_neighbor_scratch(cfg: EngineConfig, spec: SimSpec, state):
    """Fresh rows at the new caps; every func-14 pair restarts its ramp at
    the current step (no previous rows, as in the reference)."""
    nbr = neighbor.build_neighbor_state(
        state.pos, state.box, state.active, state.excl, _rc_skin(spec),
        dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
        max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap,
        track_birth=cfg.has_pps, prev=None, step=state.step)
    nbr = dataclasses.replace(nbr, n_rebuilds=state.nbr.n_rebuilds + 1)
    return cfg, dataclasses.replace(state, nbr=nbr)


TERM_CAP_FIELDS = ("bond_cap", "angle_cap", "dihedral_cap")


def _repad_term_table(table: TermTable, new_cap: int) -> TermTable:
    """The table at ``new_cap`` rows, contents and cursor kept; a shrink
    may cut only padding."""
    cap = table.idx.shape[0]
    if new_cap == cap:
        return table
    if new_cap < cap:
        if bool((table.idx[new_cap:, 0] >= 0).any()):
            raise ValueError("term table shrink %d -> %d would drop valid "
                             "rows" % (cap, new_cap))
        return dataclasses.replace(table, **{
            f.name: getattr(table, f.name)[:new_cap]
            for f in dataclasses.fields(table)
            if getattr(table, f.name).ndim})
    pad = new_cap - cap

    def cat(a, fill):
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    return dataclasses.replace(
        table, idx=cat(table.idx, -1), func=cat(table.func, 0),
        params=cat(table.params, 0.0), typelookup=cat(table.typelookup, False),
        lam=cat(table.lam, 1.0), group=cat(table.group, -1))


def apply_term_caps(cfg: EngineConfig, state, caps: dict,
                    excl_pair_cap: int | None = None):
    """Re-pad the term tables (and, with ``excl_pair_cap``, the exclusion
    pair list) to explicit caps, clear the sticky overflow flag and
    re-derive the dense operands.  Used by regrowth, shrink, presizing,
    the cap ladder and checkpoint restore.  Returns (cfg, state)."""
    if cfg.bonded_dense:
        # lockstep: the irregular caps follow the canonical caps' deltas,
        # so irr_cap - (cap - n_aligned_static) never shrinks; a caller
        # that sized them from measured irregular counts passes them
        caps = dict(caps)
        if "bond_cap" in caps and "bond_irr_cap" not in caps:
            caps["bond_irr_cap"] = max(
                cfg.bond_irr_cap + caps["bond_cap"] - cfg.bond_cap, 128)
        if "angle_cap" in caps and "angle_irr_cap" not in caps:
            caps["angle_irr_cap"] = max(
                cfg.angle_irr_cap + caps["angle_cap"] - cfg.angle_cap, 128)
    if (cfg.excl_offsets and excl_pair_cap is not None
            and "excl_irr_cap" not in caps):
        # the same lockstep for the exclusions' irregular remainder
        caps = dict(caps)
        caps["excl_irr_cap"] = max(
            cfg.excl_irr_cap + excl_pair_cap - state.excl.shape[0], 128)
    cfg = dataclasses.replace(cfg, **caps)
    state = dataclasses.replace(
        state,
        bonds=_repad_term_table(state.bonds, cfg.bond_cap),
        angles=_repad_term_table(state.angles, cfg.angle_cap),
        dihedrals=_repad_term_table(state.dihedrals, cfg.dihedral_cap))
    state = bonded_dense.rederive(cfg, state)
    if excl_pair_cap is not None and excl_pair_cap != state.excl.shape[0]:
        if excl_pair_cap < state.excl.shape[0]:
            if bool((state.excl[excl_pair_cap:, 0] >= 0).any()):
                raise ValueError("exclusion list shrink would drop pairs")
            state = dataclasses.replace(state,
                                        excl=state.excl[:excl_pair_cap])
        else:
            pad = excl_pair_cap - state.excl.shape[0]
            state = dataclasses.replace(state, excl=torch.cat(
                [state.excl, torch.full((pad, 2), -1, dtype=state.excl.dtype,
                                        device=state.excl.device)]))
    state = dataclasses.replace(state, nbr=dataclasses.replace(
        state.nbr, overflow=torch.zeros_like(state.nbr.overflow)))
    # after the flag is cleared, so that a real irregular overflow at the
    # new caps survives
    return cfg, excl_dense.rederive(cfg, state)


def _term_headroom_floor(cap: int) -> int:
    """Free rows a term table keeps before it regrows: absolute, not a
    fraction (a large static topology sits near its cap by design), at
    most 512 (the build's own reactive slice), at least 8 (one event can
    append a bond and its angles)."""
    return max(min(512, cap // 8), cap // 64, 8)


def term_caps_near_full(cfg: EngineConfig, counts: dict,
                        prev_counts: dict | None = None) -> bool:
    """True when a term table, the exclusion pair list or an irregular
    table is within its headroom floor of its cap; with ``prev_counts``
    (the last block's) the floor is at least twice the last block's
    appends."""
    def low(key, cap):
        count = counts.get(key, 0)
        need = _term_headroom_floor(cap)
        if prev_counts is not None:
            need = max(need, 2 * (count - prev_counts.get(key, count)))
        return cap - count < need

    return (low("n_bonds", cfg.bond_cap)
            or low("n_angles", cfg.angle_cap)
            or low("n_dihedrals", cfg.dihedral_cap)
            or low("n_excl", counts.get("excl_pair_cap", 1 << 30))
            or ("n_bonds_irr" in counts and low("n_bonds_irr",
                                                cfg.bond_irr_cap))
            or ("n_angles_irr" in counts and low("n_angles_irr",
                                                 cfg.angle_irr_cap))
            or ("n_excl_irr" in counts and low("n_excl_irr",
                                               cfg.excl_irr_cap)))


def shrink_term_caps(cfg: EngineConfig, state, headroom: int | None = None):
    """Tighten the term tables and the exclusion pair list to their
    cursors plus headroom (never growing; a reacting system keeps at least
    half its free slice unless ``headroom`` is given).  Returns
    (cfg, state)."""
    def target(count, hr, cur_cap):
        # clear the regrowth trigger at the new cap with slack, or the
        # next block's check undoes the shrink
        t0 = max(count + (headroom if headroom is not None else hr), 128)
        t0 = max(t0, count + 2 * _term_headroom_floor(t0) + 256)
        if cfg.has_reactions and headroom is None:
            t0 = max(t0, count + (cur_cap - count) // 2)
        return _round_up(t0, 128)

    hr = max(2048, cfg.n_particles // 32)
    tabs = {"bond_cap": state.bonds, "angle_cap": state.angles,
            "dihedral_cap": state.dihedrals}
    caps = {}
    for f, table in tabs.items():
        # the cursor bounds the live rows
        tgt = target(int(table.count), hr, getattr(cfg, f))
        if tgt < getattr(cfg, f):
            caps[f] = tgt
    excl_new = None
    excl_tgt = target(int(state.n_excl), 2 * hr, state.excl.shape[0])
    if excl_tgt < state.excl.shape[0]:
        excl_new = excl_tgt
    if not caps and excl_new is None:
        return cfg, state
    return apply_term_caps(cfg, state, caps, excl_new)


_COUNT_KEY = {"bond_cap": "n_bonds", "angle_cap": "n_angles",
              "dihedral_cap": "n_dihedrals"}


def grow_term_caps(cfg: EngineConfig, state, factor: float = 1.5,
                   counts: dict | None = None,
                   prev_counts: dict | None = None):
    """Regrow the term tables and the exclusion pair list by ``factor``
    (rounded up to 128).  With ``counts`` (a ``measure_cheap`` dict) only
    the tables within twice their headroom floor grow, and the irregular
    caps are sized on their own counts.  Returns (cfg, state)."""
    def need(key, cap):
        n = 2 * _term_headroom_floor(cap)
        if prev_counts is not None and counts is not None:
            n = max(n, 4 * (counts.get(key, 0)
                            - prev_counts.get(key, counts.get(key, 0))))
        return n

    caps = {}
    for f in TERM_CAP_FIELDS:
        cur = getattr(cfg, f)
        if counts is None or cur - counts.get(_COUNT_KEY[f], 0) < \
                need(_COUNT_KEY[f], cur):
            caps[f] = _round_up(int(max(cur, 128) * factor), 128)
    if cfg.bonded_dense and counts is not None and "n_bonds_irr" in counts:
        for irr_f, key in (("bond_irr_cap", "n_bonds_irr"),
                           ("angle_irr_cap", "n_angles_irr")):
            cur = getattr(cfg, irr_f)
            grown = _round_up(int(max(cur, 128) * factor), 128) \
                if cur - counts.get(key, 0) < need(key, cur) else cur
            caps[irr_f] = grown
    excl_new = None
    excl_cap = state.excl.shape[0]
    if (counts is None or excl_cap - counts.get("n_excl", 0)
            < need("n_excl", excl_cap)):
        excl_new = _round_up(int(max(excl_cap, 128) * factor), 128)
    if cfg.excl_offsets and counts is not None and "n_excl_irr" in counts:
        cur = cfg.excl_irr_cap
        if cur - counts.get("n_excl_irr", 0) < need("n_excl_irr", cur):
            caps["excl_irr_cap"] = _round_up(int(max(cur, 128) * factor),
                                             128)
    return apply_term_caps(cfg, state, caps, excl_new)


def presize_term_caps(cfg: EngineConfig, state, counts: dict,
                      prev_counts: dict, block_steps: int,
                      plan_steps: int, safety: float = 1.6):
    """Grow the term tables once to cover ``plan_steps`` more steps at the
    append rate measured between ``prev_counts`` and ``counts`` (one block
    of ``block_steps`` apart), times ``safety``; tables nothing appended to
    stay as they are.  Returns (cfg, state)."""
    def tgt(key, cap):
        rate = max(0, counts.get(key, 0) - prev_counts.get(key, 0)) \
            / max(block_steps, 1)
        if rate == 0:
            return cap
        t = counts.get(key, 0) + int(rate * plan_steps * safety) \
            + 2 * _term_headroom_floor(cap) + 256
        return _round_up(t, 128)

    caps = {}
    for f in TERM_CAP_FIELDS:
        t = tgt(_COUNT_KEY[f], getattr(cfg, f))
        if t > getattr(cfg, f):
            caps[f] = t
    if cfg.bonded_dense and "n_bonds_irr" in counts:
        # the irregular caps from their own rate: every reaction-created
        # term is irregular
        for irr_f, key in (("bond_irr_cap", "n_bonds_irr"),
                           ("angle_irr_cap", "n_angles_irr")):
            caps[irr_f] = max(getattr(cfg, irr_f),
                              tgt(key, getattr(cfg, irr_f)))
    excl_new = None
    t = tgt("n_excl", state.excl.shape[0])
    if t > state.excl.shape[0]:
        excl_new = t
    if cfg.excl_offsets and "n_excl_irr" in counts:
        t = tgt("n_excl_irr", cfg.excl_irr_cap)
        if t > cfg.excl_irr_cap:
            caps["excl_irr_cap"] = t
    if not caps and excl_new is None:
        return cfg, state
    return apply_term_caps(cfg, state, caps, excl_new)


def plan_cap_ladder(cfg: EngineConfig, state, counts: dict,
                    rate_per_step: dict, plan_steps: int, rungs: int = 3,
                    safety: float = 1.35):
    """Term-cap rungs at horizons ``plan_steps * k / rungs`` from the
    appends per step ``rate_per_step`` (keyed like ``counts``): a list of
    ``(caps, excl_cap or None)``, strictly increasing and cumulative, for
    ``apply_term_caps`` whenever ``term_caps_near_full`` fires.  Tables
    with no appends stay as they are."""
    count_key = dict(_COUNT_KEY)
    if cfg.bonded_dense and "n_bonds_irr" in counts:
        count_key["bond_irr_cap"] = "n_bonds_irr"
        count_key["angle_irr_cap"] = "n_angles_irr"
    if cfg.excl_offsets and "n_excl_irr" in counts:
        count_key["excl_irr_cap"] = "n_excl_irr"

    def tgt(key, cap, horizon):
        rate = max(0.0, rate_per_step.get(key, 0.0))
        if rate == 0:
            return cap
        t = counts.get(key, 0) + int(rate * horizon * safety) \
            + 2 * _term_headroom_floor(cap) + 256
        return max(cap, _round_up(t, 128))

    ladder = []
    prev_caps = {f: getattr(cfg, f) for f in count_key}
    prev_excl = state.excl.shape[0]
    for k in range(1, rungs + 1):
        horizon = plan_steps * k // rungs
        caps = {f: tgt(key, prev_caps[f], horizon)
                for f, key in count_key.items()}
        excl = tgt("n_excl", prev_excl, horizon)
        if all(caps[f] <= prev_caps[f] for f in caps) and excl <= prev_excl:
            continue
        # cumulative targets, only the fields that move against cfg
        rung = {f: v for f, v in caps.items() if v != getattr(cfg, f)}
        if cfg.bonded_dense and "bond_irr_cap" in count_key and \
                ("bond_cap" in rung or "angle_cap" in rung):
            # explicit irregular caps, so apply_term_caps never inflates
            # them in lockstep
            rung.setdefault("bond_irr_cap", caps["bond_irr_cap"])
            rung.setdefault("angle_irr_cap", caps["angle_irr_cap"])
        ladder.append((rung, excl if excl > prev_excl else None))
        prev_caps.update(caps)
        prev_excl = max(prev_excl, excl)
    return ladder


def refuse_charges(spec: SimSpec, q):
    """Raise where ``q`` (host values written into the state's charges)
    holds a nonzero charge and the build left its Coulomb cutoff's term
    out: it chose the kernel path because every charge was zero."""
    if (np.any(np.asarray(q) != 0) and float(spec.qq_cutoff2) > 0
            and float(spec.qq_prefactor) == 0):
        raise NotImplementedError(
            "a nonzero charge in a build that left Coulomb out: the build "
            "chose the cell kernel (K1) because every charge was zero; a "
            "charged system runs with use_pallas=False (the row path)")


def _check_slice(opts: SimOptions, compiled):
    """Refuse every configuration the port does not run yet."""
    if opts.dtype != "float32":
        # the reference never enables JAX's 64-bit mode: its host arrays
        # of this dtype become float32 on the device, with one warning
        warnings.warn("dtype %s is not available: the state is float32, as "
                      "in the reference" % opts.dtype, UserWarning,
                      stacklevel=3)
    if compiled is None or opts.slab_devices <= 1:
        return
    if ((compiled.n_reactions and compiled.channels["r_is_diss"].any())
            or compiled.releases or compiled.joins or compiled.freeze
            or compiled.cpt or compiled.dyn_resolution or compiled.rb_rows
            or compiled.restrict_file
            or (compiled.atrp and compiled.atrp["entries"])):
        # the slab path's replicas need these extensions' host reads and
        # draws to agree rank by rank; not checked yet
        _not_in_slice("dissociation and the reaction extensions other than "
                      "ChangeNeighboursProperty under slab_devices > 1",
                      "M14")


def build_system(systop: SystemTopology, coords, opts: SimOptions,
                 reaction_config: dict | None = None,
                 extra_conversions=(), device="cuda") -> BuiltSystem:
    """Assemble the system on ``device`` (reference: build.build_system);
    the card by default, ``device="cpu"`` for the plain versions.
    ``extra_conversions`` are ``(((type, state or None), ...), total)``
    conversion observables the caller reads (stop criteria, counters);
    their indices are ``BuiltSystem.extra_obs_idx``."""
    T = systop.next_type_id
    n = systop.n_atoms
    if coords.n_atoms != n:
        raise ValueError("coordinate file has %d atoms, topology %d"
                         % (coords.n_atoms, n))
    box = np.asarray(coords.box, F32)

    obs = ObsRegistry()
    nb_tb = tables.TableStackBuilder(opts.n_bins)
    nb_tb.add("<zero>", np.array([1e-3, 10.0]), np.zeros(2), np.zeros(2))
    bond_tb = tables.TableStackBuilder(opts.n_bins)
    angle_tb = tables.TableStackBuilder(opts.n_bins)
    dih_tb = tables.TableStackBuilder(opts.n_bins)

    compiled = None
    if reaction_config is not None:
        compiled = reaction_compile.compile_reactions(
            reaction_config, systop, bond_tb, opts.table_dirs,
            opts.output_prefix)
        T = systop.next_type_id
    _check_slice(opts, compiled)
    dynamic_types = compiled.dynamic_types if compiled else set()
    change_bond_types = compiled.observed_bondtypes if compiled else set()

    # ---- ReleaseMolecule dummy particles (reference build.py:975-1026):
    #      `replicate` dummies per host particle, constrained at eq_length,
    #      appended after the real particles ----
    releases = compiled.releases if compiled else []
    joins = compiled.joins if compiled else []
    freeze_d = compiled.freeze if compiled else None
    # FixDistances definitions: releases first, then joins (the order
    # reaction_compile assigns r_join_def indices in)
    fd_defs = []
    for release in releases:
        fd_defs.append({
            "eq": release["eq_length"],
            "host_type": (release["host_type"]
                          if release["release_on"] == "type" else -1),
            "dummy_type": release["dummy_type"],
            "target_type": release["target_type"],
            "release_lam": 0.0,
            "capture_lam": 0.0,
            "capture_state": 0,
        })
    for join_d in joins:
        fd_defs.append({
            "eq": join_d["eq_length"],
            "host_type": join_d["host_type"],
            "dummy_type": join_d["dummy_type"],
            "target_type": join_d["target_type"],
            "release_lam": join_d["init_res"],
            "capture_lam": join_d["init_res"],
            "capture_state": join_d["state"],
        })
    n_real = n
    fix_pairs = np.zeros((0, 2), I32)
    dummies = []
    for release in releases:
        host_rows = np.where(systop.type_ids == release["host_type"])[0]
        n_dummy = len(host_rows) * release["replicate"]
        trec = systop.top.atomtypes.get(
            systop.atomtype_atomsym[release["target_type"]], {})
        dummy = {
            "rows": np.arange(n, n + n_dummy),
            "host_of": np.repeat(host_rows,
                                 release["replicate"]).astype(I32),
            "type": release["dummy_type"],
            "mass": float(trec.get("mass", 1.0)),
            "state": int(trec.get("state", 0)),
            "lam": release["init_res"],
            "eq": release["eq_length"],
        }
        dummies.append(dummy)
        pairs = np.stack([dummy["host_of"], dummy["rows"].astype(I32)],
                         axis=1)
        fix_pairs = np.concatenate([fix_pairs, pairs], axis=0).astype(I32)
        n = n + n_dummy
        logger.info("generated %d dummy particles (type %d) on %d hosts",
                    n_dummy, release["dummy_type"], len(host_rows))

    # ---- RestrictReaction connectivity whitelist: 1-based pairs read
    #      from connectivity_map, searched in table_dirs ----
    restrict_rows = np.zeros((0, 2), np.int64)
    if compiled and compiled.restrict_file:
        pairs = set()
        rf = compiled.restrict_file
        if not os.path.exists(rf):
            for d in opts.table_dirs:
                if os.path.exists(os.path.join(d, rf)):
                    rf = os.path.join(d, rf)
                    break
        with open(rf) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    a, b = int(parts[0]) - 1, int(parts[1]) - 1
                    pairs.add((min(a, b), max(a, b)))
        restrict_rows = np.asarray(sorted(pairs), np.int64)
        logger.info("restricted reactions to %d connections", len(pairs))

    extra_obs_idx = [obs.register(ts, total)
                     for ts, total in extra_conversions]

    # ---- nonbonded ----
    pair_arrays, mix_entries = _build_pair_tables(systop, opts, nb_tb, obs)

    # ---- bonded type-lookup tables ----
    bond_func_tt = np.zeros((T, T), I32)
    bond_par_tt = np.zeros((T, T, N_BOND_PARAMS), F32)
    for (a, b), rec in systop.bondparams.items():
        p = _pack_bond_params(rec["func"], rec["params"], bond_tb,
                              opts.table_dirs)
        for key in ((a, b), (b, a)):
            bond_func_tt[key] = rec["func"]
            bond_par_tt[key] = p
    angle_func_tt = np.zeros((T, T, T), I32)
    angle_par_tt = np.zeros((T, T, T, N_BOND_PARAMS), F32)
    for (a, b, c), rec in systop.angleparams.items():
        p = _pack_angle_params(rec["func"], rec["params"], angle_tb,
                               opts.table_dirs)
        for key in ((a, b, c), (c, b, a)):
            angle_func_tt[key] = rec["func"]
            angle_par_tt[key] = p
    dih_func_tt = np.zeros((T, T, T, T), I32)
    dih_par_tt = np.zeros((T, T, T, T, N_BOND_PARAMS), F32)
    for (a, b, c, d), rec in systop.dihedralparams.items():
        p = _pack_dihedral_params(rec["func"], rec["params"], dih_tb,
                                  opts.table_dirs)
        for key in ((a, b, c, d), (d, c, b, a)):
            dih_func_tt[key] = rec["func"]
            dih_par_tt[key] = p

    # ---- static bonded terms ----
    def term_entries(raw_terms, params_by_type, pack, canonical):
        idx, funcs, params, tl = [], [], [], []
        for key_ids, fields in raw_terms.items():
            rows = tuple(k - 1 for k in key_ids)
            tids = tuple(int(systop.type_ids[r]) for r in rows)
            ckey = canonical(tids)
            is_dynamic = (bool(set(tids) & dynamic_types)
                          or tuple(sorted(tids)) in change_bond_types) \
                and ckey in params_by_type
            if fields:
                f = int(fields[0])
                p = pack(f, fields[1:], opts.table_dirs)
            else:
                rec = params_by_type.get(ckey)
                if rec is None:
                    rec = params_by_type.get(tuple(reversed(ckey)))
                if rec is None:
                    raise ValueError("no parameters for term %s types %s"
                                     % (key_ids, tids))
                f = rec["func"]
                p = pack(f, rec["params"], opts.table_dirs)
            idx.append(rows)
            funcs.append(f)
            params.append(p)
            tl.append(is_dynamic)
        return idx, funcs, params, tl

    def pack_b(f, fields, dirs):
        return _pack_bond_params(f, fields, bond_tb, dirs)

    def pack_a(f, fields, dirs):
        return _pack_angle_params(f, fields, angle_tb, dirs)

    def pack_d(f, fields, dirs):
        return _pack_dihedral_params(f, fields, dih_tb, dirs)

    b_idx, b_func, b_par, b_tl = term_entries(
        systop.bonds, systop.bondparams, pack_b, lambda t: tuple(sorted(t)))
    a_idx, a_func, a_par, a_tl = term_entries(
        systop.angles, systop.angleparams, pack_a,
        lambda t: (t[2], t[1], t[0]) if t[0] > t[2] else t)
    d_idx, d_func, d_par, d_tl = term_entries(
        systop.dihedrals, systop.dihedralparams, pack_d,
        lambda t: (t[3], t[2], t[1], t[0]) if t[3] > t[0] else t)

    # 1-4 pairs: LJ with fudgeLJ, shifted at the LJ cutoff (reference
    # build.py:1124-1142)
    fudge_lj = systop.defaults.get("fudgeLJ", 1.0)
    p14_idx, p14_par = [], []
    for key_ids, fields in systop.pairs.items():
        rows = tuple(k - 1 for k in key_ids)
        if fields and len(fields) >= 3:
            sig, eps = float(fields[1]), float(fields[2])
        else:
            s1 = systop.atomtype_atomsym[int(systop.type_ids[rows[0]])]
            s2 = systop.atomtype_atomsym[int(systop.type_ids[rows[1]])]
            a_t, b_t = systop.top.atomtypes[s1], systop.top.atomtypes[s2]
            sig, eps = combine_lj(a_t["sigma"], a_t["epsilon"], b_t["sigma"],
                                  b_t["epsilon"],
                                  systop.defaults["combinationrule"])
        p = np.zeros(N_BOND_PARAMS, F32)
        p[0], p[1], p[2] = sig, fudge_lj * eps, opts.lj_cutoff**2
        sr6 = (sig / opts.lj_cutoff) ** 6 if sig > 0 else 0.0
        p[3] = 4.0 * fudge_lj * eps * (sr6 * sr6 - sr6)
        p14_idx.append(rows)
        p14_par.append(p)

    # ---- capacities ----
    n_pad = _round_up(max(n, 128), 128)
    has_reactions = compiled is not None and compiled.n_reactions > 0
    extra_default = _round_up(max(n // 32, 512), 128) if has_reactions else 0
    extra_b = opts.extra_bonds if opts.extra_bonds is not None \
        else extra_default
    extra_a = opts.extra_angles if opts.extra_angles is not None \
        else 4 * extra_b
    extra_d = opts.extra_dihedrals if opts.extra_dihedrals is not None else (
        6 * extra_b if systop.dihedralparams else 0)
    bond_cap = _round_up(max(len(b_idx) + extra_b, 8), 128)
    angle_cap = _round_up(max(len(a_idx) + extra_a, 8), 128)
    dih_cap = _round_up(max(len(d_idx) + extra_d, 8), 128)
    pair14_cap = _round_up(len(p14_idx), 128) if p14_idx else 0
    excl_cap_pairs = _round_up(max(len(systop.exclusions) + 8 * extra_b, 8),
                               128)
    if opts.excl_cap is None:
        deg = np.zeros(n_pad, I32)
        for a_, b_ in systop.exclusions:
            deg[a_ - 1] += 1
            deg[b_ - 1] += 1
        obs_deg = int(deg.max()) if len(systop.exclusions) else 0
        excl_cap = _round_up(max(2 * obs_deg + 8, 16), 8)
    else:
        excl_cap = opts.excl_cap

    max_cutoff = max(opts.lj_cutoff, opts.cg_cutoff, opts.coulomb_cutoff)
    rc_skin = max_cutoff + opts.skin
    density = n / float(np.prod(box))
    # under a barostat the box drifts: size cells with extra margin so the
    # static grid stays valid (cell edge >= cutoff + skin) as the box shrinks
    has_barostat = opts.barostat != "no" and opts.pressure > 0
    margin = 1.10 if has_barostat else 1.02
    cell_dims = neighbor.choose_cell_grid(box, rc_skin, margin=margin)
    if opts.slab_devices > 1:
        # the slab path needs an x-layer count the ranks divide: fewer,
        # wider layers stay legal (cell edge >= cutoff + skin), as long as
        # K1 keeps its full 27-cell stencil (reference build.py:1184-1192)
        nx_r = (cell_dims[0] // opts.slab_devices) * opts.slab_devices
        if nx_r >= 3:
            cell_dims = (nx_r,) + tuple(cell_dims[1:])
    fudge_qq = (opts.fudge_qq if opts.fudge_qq is not None
                else systop.defaults.get("fudgeQQ", 1.0))
    qq_pref = COULOMB_PREFACTOR * fudge_qq if opts.coulomb_cutoff > 0 else 0.0
    # a reaction sets an atom's charge to its new atomtype's, so a charged
    # atomtype counts as a charge
    charged = bool(np.any(np.asarray(systop.charges) != 0)
                   or any(float(t.get("charge", 0.0)) != 0
                          for t in systop.top.atomtypes.values()))
    use_pallas, cheb_candidate = _pallas_enabled(
        opts, pair_arrays, qq_pref, charged, cell_dims,
        n_mix=len(mix_entries))
    if use_pallas:
        # Coulomb over all-zero charges is zero pair by pair: the kernel
        # path leaves the term out
        qq_pref = 0.0
    elif opts.slab_devices > 1:
        _not_in_slice("the row path under slab_devices > 1 (the slab path "
                      "runs the cell kernels only)", "M14")

    # ---- dense-static bonded operands (bonded_dense.py) ----
    bd_enable = opts.bonded_dense if opts.bonded_dense is not None else True

    def _n_aligned(idx_list, arity):
        if not len(idx_list):
            return 0
        arr = np.asarray(idx_list, np.int64)
        if arity == 2:
            b_ = arr.min(1)
            al = arr.max(1) == b_ + 1
        else:
            b_ = arr[:, 0]
            al = np.all(arr == b_[:, None] + np.arange(arity)[None, :],
                        axis=1)
        al &= (b_ + arity - 1) < n_pad
        _, cnt = np.unique(b_[al], return_counts=True)
        return int(al.sum() - (cnt - 1).sum())

    bond_irr_cap = _round_up(max(bond_cap - _n_aligned(b_idx, 2), 128),
                             128) if bd_enable else 0
    angle_irr_cap = _round_up(max(angle_cap - _n_aligned(a_idx, 3), 128),
                              128) if bd_enable else 0
    frac = np.mod(coords.pos, box) / box
    ci = np.clip((frac * np.asarray(cell_dims)).astype(np.int64), 0,
                 np.asarray(cell_dims) - 1)
    cid = (ci[:, 0] * cell_dims[1] + ci[:, 1]) * cell_dims[2] + ci[:, 2]
    obs_cell_max = int(np.bincount(cid).max()) if n else 0
    if opts.max_neighbors is None:
        k_est = density * 4.0 / 3.0 * math.pi * rc_skin**3
        max_neighbors = _round_up(max(int(k_est * 2.2) + 16, 24), 8)
    else:
        max_neighbors = opts.max_neighbors
    cell_vol = float(np.prod(box / np.asarray(cell_dims)))

    def row_path_cell_cap():
        # the kernel's cost grows with cap^2 and runs tight (1.7x the mean
        # occupancy); the row rebuild's only linearly, with a 3x margin
        return _round_up(max(int(density * cell_vol * 3.0) + 8,
                             int(obs_cell_max * 1.3) + 4, 8), 8)

    if opts.cell_cap is not None:
        cell_cap = opts.cell_cap
    elif use_pallas:
        cell_cap = _round_up(max(int(density * cell_vol * 1.7) + 8,
                                 int(obs_cell_max * 1.3) + 4, 8), 8)
    else:
        cell_cap = row_path_cell_cap()

    # ---- lazy-row reaction geometry ----
    rc_rx = 0.0
    if compiled and compiled.n_reactions:
        ch = compiled.channels
        pair_ch = ~ch["r_is_diss"]
        if pair_ch.any():
            hard = np.sqrt(ch["r_cutoff2"][pair_ch])
            gauss = ch["r_eq"][pair_ch] + 4.0 * ch["r_sigma"][pair_ch]
            rc_rx = float(np.max(np.where(ch["r_sigma"][pair_ch] > 0.0,
                                          np.maximum(gauss, hard), hard)))
    rc_rx = min(max(rc_rx, 0.5), rc_skin)
    rx_dims = neighbor.choose_cell_grid(box, rc_rx, margin=margin)
    rx_cell_vol = float(np.prod(box / np.asarray(rx_dims)))
    cell_vol_f = float(np.prod(box / np.asarray(cell_dims)))
    rx_cell_cap = _round_up(
        max(int(cell_cap * rx_cell_vol / cell_vol_f) + 4,
            int(density * rx_cell_vol * 2.0) + 4, 8), 8)
    rx_k = _round_up(
        max(int(max_neighbors * (rc_rx / rc_skin) ** 3) + 8,
            int(density * 4.0 / 3.0 * math.pi * rc_rx**3 * 2.0) + 8, 16), 8)

    # ---- term tables ----
    bonds = TermTable.create_numpy(bond_cap, 2, b_idx, b_func, b_par, b_tl)
    angles = TermTable.create_numpy(angle_cap, 3, a_idx, a_func, a_par, a_tl)
    dihedrals = TermTable.create_numpy(dih_cap, 4, d_idx, d_func, d_par,
                                       d_tl)
    pairs14 = TermTable.create_numpy(max(pair14_cap, 1), 2, p14_idx,
                                     [1] * len(p14_idx), p14_par)

    # ---- exclusions / adjacency / molecules ----
    excl = np.full((excl_cap_pairs, 2), -1, I32)
    for i, (a, b) in enumerate(sorted(systop.exclusions)):
        excl[i] = (a - 1, b - 1)
    n_excl = len(systop.exclusions)

    ex_enable = opts.excl_dense if opts.excl_dense is not None else True
    excl_offsets = ()
    excl_irr_cap = 0
    if ex_enable and use_pallas:
        excl_offsets = excl_dense.detect_offsets(excl)
        if excl_offsets:
            dvals = np.abs(excl[:n_excl, 1] - excl[:n_excl, 0])
            n_cov = int(np.isin(dvals, excl_offsets).sum())
            excl_irr_cap = _round_up(max(excl_cap_pairs - n_cov, 128), 128)

    adj = np.full((n_pad, opts.deg_cap), -1, I32)
    deg = np.zeros(n_pad, I32)
    bonds0 = [(i - 1, j - 1) for (i, j) in systop.bonds]
    for i, j in bonds0:
        if deg[i] >= opts.deg_cap or deg[j] >= opts.deg_cap:
            raise ValueError("deg_cap=%d too small" % opts.deg_cap)
        adj[i, deg[i]] = j
        adj[j, deg[j]] = i
        deg[i] += 1
        deg[j] += 1
    mol_id = np.zeros(n_pad, I32)
    mol_id[:n] = _host_components(n, bonds0)

    # ---- per-particle arrays ----
    # (in the options' dtype on the host, as in the reference; float32 on
    # the device)
    dtype = F32 if opts.dtype == "float32" else np.float64
    pos = np.zeros((n_pad, 3), dtype)
    pos[:n_real] = np.mod(coords.pos, coords.box)
    vel = np.zeros((n_pad, 3), dtype)
    if coords.vel is not None:
        vel[:n_real] = coords.vel
    type_id = np.full(n_pad, 0, I32)
    type_id[:n_real] = systop.type_ids
    mass = np.ones(n_pad, dtype)
    mass[:n_real] = systop.masses
    q = np.zeros(n_pad, dtype)
    q[:n_real] = systop.charges
    chem_state = np.zeros(n_pad, I32)
    chem_state[:n_real] = systop.states
    res_id = np.zeros(n_pad, I32)
    res_id[:n_real] = coords.res_idx
    lam = np.ones(n_pad, dtype)
    active = np.zeros(n_pad, bool)
    active[:n] = True
    for dummy in dummies:
        rows = dummy["rows"]
        pos[rows] = np.mod(pos[dummy["host_of"]]
                           + np.asarray([dummy["eq"], 0.0, 0.0], dtype),
                           box)
        type_id[rows] = dummy["type"]
        mass[rows] = dummy["mass"]
        chem_state[rows] = dummy["state"]
        res_id[rows] = rows + 1     # a residue of its own per dummy
        lam[rows] = dummy["lam"]
    if opts.gen_velocity and coords.vel is None:
        # the reference's draw, bit for bit
        rng = np.random.RandomState(opts.rng_seed)
        m_eff = systop.masses * opts.mass_factor
        v = rng.normal(size=(n_real, 3)) * np.sqrt(opts.kT / m_eff)[:, None]
        v -= np.average(v, axis=0, weights=m_eff)
        vel[:n_real] = v
    pos, vel, mass, q, lam = (a.astype(F32) for a in (pos, vel, mass, q,
                                                        lam))

    nb_stack = nb_tb.build()
    cheb_fit = None
    cheb_ntab, cheb_mix = 0, False
    cheb_tab_slot = cheb_sc = cheb_tab_slot_b = None
    if use_pallas and cheb_candidate:
        cheb = _cheb_tables(pair_arrays, nb_stack)
        if cheb is None:
            # the row path; the reaction grid's caps stay as sized above
            use_pallas = False
            if opts.cell_cap is None:
                cell_cap = row_path_cell_cap()
        else:
            (cheb_fit, cheb_ntab, cheb_tab_slot, cheb_tab_slot_b, cheb_sc,
             cheb_mix) = cheb
    bond_stack = bond_tb.build()
    angle_stack = angle_tb.build()
    dih_stack = dih_tb.build()

    # ---- thermostat / thermal groups ----
    thermal_mask = np.ones(T, bool)
    if opts.thermal_groups:
        thermal_mask[:] = False
        for s in opts.thermal_groups:
            thermal_mask[systop.atomsym_atomtype[s]] = True
    for d in fd_defs:
        # dummy particles are not thermostatted
        thermal_mask[d["dummy_type"]] = False
    if freeze_d:
        thermal_mask[freeze_d["final_type"]] = False

    # ---- reaction arrays ----
    r_dtypes = [
        ("r_t1", I32), ("r_t2", I32), ("r_min1", I32), ("r_max1", I32),
        ("r_min2", I32), ("r_max2", I32), ("r_delta1", I32),
        ("r_delta2", I32), ("r_cutoff2", F32), ("r_min_cutoff2", F32),
        ("r_sigma", F32), ("r_eq", F32), ("r_intramolecular", bool),
        ("r_intraresidual", bool), ("r_virtual", bool), ("r_is_diss", bool),
        ("r_diss_fade", bool), ("r_diss_rate", F32), ("r_group", I32),
        ("r_new_type1", I32), ("r_new_type2", I32), ("r_cnb_type", I32),
        ("r_cnb_min", I32), ("r_cnb_max", I32), ("r_release_n", I32),
        ("r_release_side", I32), ("r_restricted", bool),
        ("r_join_def", I32)]
    if compiled and compiled.n_reactions:
        r_arrays = {k: _asarray(v) for k, v in compiled.channels.items()}
        n_r = compiled.n_reactions
    else:
        n_r = 0
        r_arrays = {k: np.zeros(0, dt_) for k, dt_ in r_dtypes}
    pp_names = ["ppnb_reaction", "ppnb_side", "ppnb_old_type", "ppnb_level",
                "ppnb_new_type", "ppnb_new_state", "ppnb_incr_state",
                "ppnb_min_state", "ppnb_max_state"]
    if compiled and compiled.ppnb:
        pp_arrays = {k: _asarray(v) for k, v in compiled.ppnb.items()}
        n_pp = len(compiled.ppnb["ppnb_reaction"])
    else:
        n_pp = 0
        pp_arrays = {k: np.zeros(0, I32) for k in pp_names}
    atrp = compiled.atrp if compiled else None
    if atrp and atrp["entries"]:
        ae = atrp["entries"]
        atrp_arrays = dict(
            atrp_type=np.asarray([e[0] for e in ae], I32),
            atrp_state=np.asarray([e[1] for e in ae], I32),
            atrp_is_activator=np.asarray([e[2] for e in ae], bool),
            atrp_new_type=np.asarray([e[3] for e in ae], I32),
            atrp_delta=np.asarray([e[4] for e in ae], I32),
            atrp_num=np.asarray(atrp["num_particles"], I32),
            atrp_k_activate=np.asarray(atrp["k_activate"], F32),
            atrp_k_deactivate=np.asarray(atrp["k_deactivate"], F32),
            atrp_delta_catalyst=np.asarray(atrp["delta_catalyst"], F32))
        n_atrp = len(ae)
    else:
        n_atrp = 0
        atrp_arrays = dict(
            atrp_type=np.zeros(0, I32), atrp_state=np.zeros(0, I32),
            atrp_is_activator=np.zeros(0, bool),
            atrp_new_type=np.zeros(0, I32), atrp_delta=np.zeros(0, I32),
            atrp_num=np.asarray(0, I32),
            atrp_k_activate=np.asarray(0.0, F32),
            atrp_k_deactivate=np.asarray(0.0, F32),
            atrp_delta_catalyst=np.asarray(0.0, F32))
    rb_rows_ = compiled.rb_rows if compiled else []

    obs_e_obs, obs_e_type, obs_e_state, obs_totals = obs.arrays()

    bond_funcs = sorted(set(b_func) | set(bond_func_tt.flatten())
                        | (set(compiled.g_func.tolist()) if compiled
                           else set()))
    bond_funcs = tuple(int(f) for f in bond_funcs if f > 0)
    angle_funcs = tuple(int(f) for f in sorted(set(a_func)
                                                | set(angle_func_tt.flatten()))
                        if f > 0)
    dih_funcs = tuple(int(f) for f in sorted(set(d_func)
                                              | set(dih_func_tt.flatten()))
                      if f > 0)

    # ---- compacted reaction matching gate ----
    rx_compact = False
    rx_rows_cap = 0
    if compiled and compiled.n_reactions:
        ch = compiled.channels
        t1_types = sorted({int(t) for t, d in zip(ch["r_t1"], ch["r_is_diss"])
                           if not d})
        if t1_types:
            t1_pop = int(np.isin(type_id[active], t1_types).sum())
            if t1_pop <= max(n_real // 3, 1):
                rx_compact = True
                rx_rows_cap = min(_round_up(max(4 * t1_pop, 1024), 128),
                                  _round_up(n_pad, 128))

    cfg = EngineConfig(
        n_types=T, n_particles=n, n_pad=n_pad, max_neighbors=max_neighbors,
        cell_cap=cell_cap, cell_dims=cell_dims, deg_cap=opts.deg_cap,
        bond_cap=bond_cap, angle_cap=angle_cap, dihedral_cap=dih_cap,
        pair14_cap=pair14_cap, excl_cap=excl_cap, bonded_dense=bd_enable,
        bond_irr_cap=bond_irr_cap, angle_irr_cap=angle_irr_cap,
        excl_offsets=excl_offsets, excl_irr_cap=excl_irr_cap,
        max_events=opts.max_events, n_reactions=n_r,
        n_groups=compiled.n_groups if compiled else 0,
        n_obs=max(len(obs.keys), 1),
        bond_funcs=bond_funcs, angle_funcs=angle_funcs,
        dihedral_funcs=dih_funcs,
        thermostat=opts.thermostat,
        iso_coupling=(max(int(opts.thermostat_gamma), 1)
                      if opts.thermostat == "iso" else 1),
        store_pressure=opts.store_pressure,
        barostat=opts.barostat if opts.pressure > 0 else "no",
        has_coulomb=qq_pref > 0, has_reactions=has_reactions,
        reaction_interval=compiled.interval if compiled else 0,
        nearest_mode=compiled.nearest if compiled else False,
        max_per_interval=compiled.max_per_interval if compiled else -1,
        exclude_new_bonds=opts.exclude_new_bonds,
        n_mix_entries=len(mix_entries),
        has_mixed_tables=bool(
            mix_entries
            or (pair_arrays["pair_mix_mode"] != 0).any()
            or (pair_arrays["pair_tab_b"] != pair_arrays["pair_tab_a"]).any()),
        needs_conversions=bool(
            mix_entries or (pair_arrays["pair_mix_mode"] == MIX_OBS).any()),
        use_pallas=use_pallas, lazy_rows=use_pallas,
        tab_cheb=cheb_fit is not None,
        cheb_kw=cheb_fit.kw if cheb_fit is not None else 0,
        cheb_ko=cheb_fit.ko if cheb_fit is not None else 0,
        cheb_ntab=cheb_ntab, cheb_mix=cheb_mix,
        uniform_lj=bool(
            (pair_arrays["pair_kind"] == PAIR_LJ).all()
            and all(np.unique(pair_arrays[k]).size == 1
                    for k in ("pair_sig", "pair_eps", "pair_cutoff2",
                              "pair_shift"))),
        all_lj=bool((pair_arrays["pair_kind"] == PAIR_LJ).all()),
        rx_dims=rx_dims, rx_cell_cap=rx_cell_cap, rx_k=rx_k, rx_rc=rc_rx,
        rx_compact=rx_compact, rx_rows_cap=rx_rows_cap,
        has_lj=bool((pair_arrays["pair_kind"] == PAIR_LJ).any()),
        has_tabulated=bool((pair_arrays["pair_kind"] == PAIR_TAB).any()),
        has_caps=bool((pair_arrays["pair_caprad"] > 0).any()
                      or (pair_arrays["pair_max_force"] > 0).any()),
        has_pps=bool((pair_arrays["pair_pps_incr"] > 0).any()),
        has_lambda_pairs=bool(pair_arrays["pair_lam_scale"].any()),
        use_thermal_group=bool(opts.thermal_groups),
        nb_bins=opts.n_bins, max_ppnb=n_pp,
        max_nb_level=compiled.max_nb_level if compiled else 0,
        has_atrp=n_atrp > 0, n_atrp=n_atrp,
        atrp_interval=atrp["interval"] if atrp else 0,
        atrp_num=atrp["num_particles"] if atrp else 0,
        atrp_select_from_all=bool(atrp["select_from_all"]) if atrp else True,
        has_dissociation=bool(compiled and compiled.n_reactions
                              and any(compiled.channels["r_is_diss"])),
        has_fixd=bool(fix_pairs.shape[0] > 0 or joins),
        fixd_cap=max(_round_up(
            fix_pairs.shape[0]
            + sum(int(np.sum(systop.type_ids == jd["target_type"]))
                  + int(np.sum(systop.type_ids == jd["final_type"]))
                  for jd in joins), 128), 1),
        n_fd=max(len(fd_defs), 1),
        has_dyn_resolution=bool(compiled and compiled.dyn_resolution),
        restrict_scan=(int(np.bincount(restrict_rows[:, 0]).max())
                       if restrict_rows.size else 1),
        n_rb=len(rb_rows_),
        has_cpt=bool(compiled and compiled.cpt),
        cpt_interval=compiled.cpt["interval"] if compiled and compiled.cpt
        else 0,
        cpt_num=compiled.cpt["num"] if compiled and compiled.cpt else 0,
        has_freeze=bool(freeze_d),
        freeze_mode=("num" if freeze_d and freeze_d["p_num"] else
                     "pct" if freeze_d and freeze_d["p_pct"] else "prob"))

    def _type_prop(key, default):
        return [systop.top.atomtypes.get(systop.atomtype_atomsym.get(t, ""),
                                         {}).get(key, default)
                for t in range(T)]

    def _rate(t):
        return 1.0 / t if t > 0 else 0.0

    dr = compiled.dyn_resolution if compiled else {}
    cpt = compiled.cpt if compiled else None

    spec_np = dict(
        dt=_asarray(opts.dt, F32), kT=_asarray(opts.kT, F32),
        gamma=_asarray(opts.thermostat_gamma, F32),
        max_force=_asarray(opts.max_force, F32),
        pressure=_asarray(opts.pressure, F32),
        barostat_tau=_asarray(opts.barostat_tau, F32),
        barostat_gammaP=_asarray(opts.barostat_gammaP, F32),
        barostat_mass=_asarray(opts.barostat_mass, F32),
        skin=_asarray(opts.skin, F32),
        thermal_type_mask=thermal_mask,
        type_mass=_asarray(_type_prop("mass", 1.0), F32),
        type_q=_asarray(_type_prop("charge", 0.0), F32),
        type_state=_asarray(_type_prop("state", 0), I32),
        **pair_arrays,
        qq_prefactor=_asarray(qq_pref, F32),
        qq_cutoff2=_asarray(opts.coulomb_cutoff**2, F32),
        **{"mix_" + k: np.asarray([m[c] for m in mix_entries], dt_)
           for c, (k, dt_) in enumerate((("pair", I32), ("lo", F32),
                                         ("hi", F32), ("tab_a", I32),
                                         ("tab_b", I32), ("obs", I32)))},
        nb_ef=nb_stack.ef, nb_ef4=tables.interleave4(nb_stack.ef),
        nb_r0=nb_stack.r0, nb_dr=nb_stack.dr,
        **({} if cheb_fit is None else dict(
            cheb_wall_g=cheb_fit.wall_g, cheb_wall_e=cheb_fit.wall_e,
            cheb_well_g=cheb_fit.well_g, cheb_well_e=cheb_fit.well_e,
            cheb_ay=cheb_fit.ay, cheb_by=cheb_fit.by, cheb_ax=cheb_fit.ax,
            cheb_bx=cheb_fit.bx, cheb_rs2=cheb_fit.rs2,
            cheb_rcap2=cheb_fit.rcap2,
            **({} if cheb_ntab == 0 else dict(
                cheb_tab_slot=cheb_tab_slot, cheb_sc=cheb_sc)),
            **({} if not cheb_mix else dict(
                cheb_tab_slot_b=cheb_tab_slot_b)))),
        bond_ef=bond_stack.ef, bond_r0=bond_stack.r0, bond_dr=bond_stack.dr,
        angle_ef=angle_stack.ef, angle_r0=angle_stack.r0,
        angle_dr=angle_stack.dr,
        dih_ef=dih_stack.ef, dih_r0=dih_stack.r0, dih_dr=dih_stack.dr,
        bond_func_tt=bond_func_tt, bond_par_tt=bond_par_tt,
        angle_func_tt=angle_func_tt, angle_par_tt=angle_par_tt,
        dih_func_tt=dih_func_tt, dih_par_tt=dih_par_tt,
        obs_entry_obs=obs_e_obs, obs_entry_type=obs_e_type,
        obs_entry_state=obs_e_state, obs_total=obs_totals,
        **r_arrays,
        g_func=_asarray(compiled.g_func) if compiled else np.zeros(0, I32),
        g_params=(_asarray(compiled.g_params) if compiled
                  else np.zeros((0, N_BOND_PARAMS), F32)),
        **pp_arrays, **atrp_arrays,
        hybrid_bond_rate=_asarray(_rate(opts.t_hybrid_bond), F32),
        hybrid_angle_rate=_asarray(_rate(opts.t_hybrid_angle), F32),
        hybrid_dihedral_rate=_asarray(_rate(opts.t_hybrid_dihedral), F32),
        dr_alpha=np.asarray([dr.get(t, (0.0, -1, False))[0]
                             for t in range(T)], F32),
        dr_final_type=np.asarray([dr.get(t, (0.0, -1, False))[1]
                                  for t in range(T)], I32),
        dr_set_state=np.asarray([dr.get(t, (0.0, -1, False))[2]
                                 for t in range(T)], bool),
        **{"fd_" + k: np.asarray([d[k] for d in fd_defs] or [v], dt_)
           for k, v, dt_ in (("eq", 0.0, F32), ("host_type", -1, I32),
                             ("dummy_type", -1, I32),
                             ("target_type", -1, I32),
                             ("release_lam", 0.0, F32),
                             ("capture_lam", 0.0, F32),
                             ("capture_state", 0, I32))},
        restrict_lo=restrict_rows[:, 0].astype(I32),
        restrict_hi=restrict_rows[:, 1].astype(I32),
        **{"rb_" + k: np.asarray([e[k] for e in rb_rows_], I32)
           for k in ("reaction", "side", "anchor_type", "level", "t1",
                     "t2")},
        cpt_old=np.asarray(cpt["old"] if cpt else -1, I32),
        cpt_new=np.asarray(cpt["new"] if cpt else -1, I32),
        fr_target_type=np.asarray(freeze_d["target_type"] if freeze_d
                                  else -1, I32),
        fr_final_type=np.asarray(freeze_d["final_type"] if freeze_d else -1,
                                 I32),
        fr_width=np.asarray(
            (np.asarray(box) * freeze_d["width"] if freeze_d
             and freeze_d["width_is_ratio"] else
             np.full(3, freeze_d["width"] if freeze_d else 0.0)), F32),
        fr_dirs=np.asarray([(freeze_d is not None and d in freeze_d["dirs"])
                            for d in ("-x", "x", "-y", "y", "-z", "z")]),
        fr_prob=np.asarray(freeze_d["prob"] if freeze_d else 0.0, F32),
        fr_p_num=np.asarray(freeze_d["p_num"] if freeze_d else 0, I32),
        fr_p_pct=np.asarray(freeze_d["p_pct"] if freeze_d else 0.0, F32),
        fr_remove=np.asarray(bool(freeze_d and freeze_d["remove"])),
    )

    me = opts.max_events
    fix_pad = (0, cfg.fixd_cap - fix_pairs.shape[0])
    state_np = dict(
        step=np.asarray(0, I32), pos=pos, vel=vel,
        force=np.zeros((n_pad, 3), F32), image=np.zeros((n_pad, 3), I32),
        type_id=type_id, mass=mass, q=q, chem_state=chem_state,
        res_id=res_id, mol_id=mol_id, lam=lam, active=active,
        bonds=bonds, angles=angles, dihedrals=dihedrals, pairs14=pairs14,
        fixd_host=np.pad(fix_pairs[:, 0], fix_pad, constant_values=-1),
        fixd_dummy=np.pad(fix_pairs[:, 1], fix_pad, constant_values=-1),
        excl=excl, n_excl=np.asarray(n_excl, I32), adj=adj,
        box=box, baro_v=np.asarray(0.0, F32),
        reactions_on=np.asarray(False),
        reaction_rates=(_asarray(compiled.rates) if compiled
                        else np.zeros(0, F32)),
        reaction_active=np.ones(n_r, bool),
        reaction_counts=np.zeros(n_r, I32), intra_counts=np.zeros(2, I32),
        freeze_count=np.zeros((), I32), ev_log_step=np.full((), -1, I32),
        ev_log_a=np.full(me, -1, I32), ev_log_b=np.full(me, -1, I32),
        ev_log_r=np.full(me, -1, I32), ev_log_dist=np.full(me, -1.0, F32),
        atrp_ratios=np.asarray(
            [atrp["ratio_activator"] if atrp else 0.0,
             atrp["ratio_deactivator"] if atrp else 0.0], F32),
        atrp_stats=np.zeros(2, I32),
    )
    state_np["nbr"] = neighbor.build_neighbor_state(
        *(torch.from_numpy(a).to(device) for a in (pos, box, active, excl)),
        rc_skin, dims=cell_dims, cell_cap=cell_cap,
        max_neighbors=max_neighbors, excl_cap=excl_cap,
        track_birth=cfg.has_pps)
    spec = bridge.dataclass_from_numpy(SimSpec, spec_np, device)
    state = bridge.dataclass_from_numpy(MDState, state_np, device)
    if cfg.bonded_dense:
        state = bonded_dense.rederive(cfg, state)
    if cfg.excl_offsets:
        state = excl_dense.rederive(cfg, state, create=True)

    term_names = (["bond_f%d" % f for f in bond_funcs]
                  + ["angle_f%d" % f for f in angle_funcs]
                  + ["dihedral_f%d" % f for f in dih_funcs])
    return BuiltSystem(cfg=cfg, spec=spec, state=state, obs=obs,
                       reactions=compiled, systop=systop,
                       nb_names=nb_stack.names, term_names=term_names,
                       extra_obs_idx=extra_obs_idx)
