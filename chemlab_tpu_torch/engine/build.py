"""System assembly: SystemTopology + Coordinates (+ reactions) -> tensors.

Port of ``chemlab_tpu/engine/build.py`` ``build_system`` for the slice the
port runs: LJ nonbonded pairs on the cell-tile kernel path (K1 on a colt2
grid, the per-cell K2 on any other), or tabulated pairs (func 8, the func
10/12 two-table blends, auto-tabulated ``table_groups``) on the kernel's
Chebyshev modes (K1c/K1d/K1e, colt2 grids only), harmonic (and FENE)
bonds, harmonic and cosine angles, the dense-static bonded and exclusion
operands, Langevin or NVE, the Berendsen and Langevin barostats and the
pressure observable, and normal reaction channels on the batched event
path.  The lowering is the reference's numpy code; only the
last step differs: arrays become torch tensors on ``device`` (the card
unless the caller asks for another) through the bridge, and the build-time
neighbor rows are made by the port's ``neighbor.build_neighbor_state``.

A configuration outside the slice raises ``NotImplementedError`` naming
the ROADMAP item that will bring it; nothing falls back to another path.
Capacity regrowth (``shrink_*``/``grow_*``, ROADMAP M7) is not ported: the
port runs at the build-time caps and the sticky overflow flag reports a
cap that was too small.
"""

from __future__ import annotations

import dataclasses
import logging
import math

import numpy as np
import torch

from .. import bridge, files_io
from ..topology import SystemTopology, combine_lj
from . import (bonded_dense, cell_pair, excl_dense, neighbor,
               reaction_compile, tables, tab_cheb)
from .spec import (MIX_MULTIRANGE, MIX_OBS, PAIR_LJ, PAIR_TAB, EngineConfig,
                   SimSpec)
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
    use_pallas: bool | None = None    # None = on: the port's only force path
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


def _pack_bond_params(func, fields):
    """Raw .top bond fields -> engine params (reference:
    build._pack_bond_params); tabulated bonds are not in the slice."""
    p = np.zeros(N_BOND_PARAMS, F32)
    if func == 8:
        _not_in_slice("tabulated bonds (func 8)", "M9")
    f = [float(x) for x in fields]
    if func == 1:
        p[0] = f[1] / 2.0   # GROMACS K -> U = K/2 (r-r0)^2
        p[1] = f[0]
    elif func == 7:
        p[0] = f[1]
        p[1] = 0.0
        p[2] = f[0]
    elif func == 9:
        p[0] = f[1]
        p[1] = 0.0
        p[2] = f[0]
        p[3] = f[2]
        p[4] = f[3]
    else:
        raise NotImplementedError("bond func %d" % func)
    return p


def _pack_angle_params(func, fields):
    p = np.zeros(N_BOND_PARAMS, F32)
    if func == 1:
        p[0] = float(fields[1]) / 2.0
        p[1] = math.radians(float(fields[0]))
    elif func == 11:
        p[0] = float(fields[1])
        p[1] = math.radians(float(fields[0]))
    elif func == 8:
        _not_in_slice("tabulated angles (func 8)", "M9")
    else:
        raise NotImplementedError("angle func %d" % func)
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
    """Per-type-pair dispatch arrays (reference: build._build_pair_tables)
    for the nonbonded funcs of the slice: LJ (combination or func 1),
    tables (func 8 and auto-tabulated ``table_groups`` pairs) and the
    two-table blends (func 10 by a conversion observable, func 12 by a
    static factor).  The other funcs need the row path (M10)."""
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
    cr = systop.defaults["combinationrule"]
    atomtypes = systop.top.atomtypes
    sym2id = systop.atomsym_atomtype
    tab_groups = set(opts.table_groups or ())
    lj_cut, tab_cut = opts.lj_cutoff, opts.cg_cutoff

    def set_pair(t1, t2, **kw):
        for p in (t1 * T + t2, t2 * T + t1):
            for k, v in kw.items():
                out["pair_%s" % k][p] = v

    def set_lj(t1, t2, sig, eps):
        shift = 0.0
        if eps != 0.0 and sig > 0.0:
            sr6 = (sig / lj_cut) ** 6
            shift = 4.0 * eps * (sr6 * sr6 - sr6)
        set_pair(t1, t2, kind=PAIR_LJ, sig=sig, eps=eps, cutoff2=lj_cut**2,
                 shift=shift)

    def raw_combination(s1, s2):
        a, b = atomtypes.get(s1), atomtypes.get(s2)
        if a is None or b is None:
            return -1.0, -1.0
        return combine_lj(a["sigma"], a["epsilon"], b["sigma"], b["epsilon"],
                          cr)

    syms = sorted(sym2id, key=sym2id.get)
    for i1, s1 in enumerate(syms):
        for s2 in syms[i1:]:
            t1, t2 = sym2id[s1], sym2id[s2]
            param = systop.top.nonbond_params.get(tuple(sorted((s1, s2))))
            if param is None:
                if s1 in tab_groups and s2 in tab_groups:
                    tab = _load_auto_nb_table(s1, s2, nb_tb, opts.table_dirs)
                    set_pair(t1, t2, kind=PAIR_TAB, tab_a=tab, tab_b=tab,
                             cutoff2=tab_cut**2)
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
                tab = (_load_nb_table(pp[0], nb_tb, opts.table_dirs) if pp
                       else _load_auto_nb_table(s1, s2, nb_tb,
                                                opts.table_dirs))
                set_pair(t1, t2, kind=PAIR_TAB, tab_a=tab, tab_b=tab,
                         cutoff2=tab_cut**2)
            elif func == 10:
                ta = _load_nb_table(pp[0], nb_tb, opts.table_dirs)
                tb_ = _load_nb_table(pp[1], nb_tb, opts.table_dirs)
                o = obs.register([(sym2id[pp[2]], None)], int(pp[3]))
                set_pair(t1, t2, kind=PAIR_TAB, tab_a=ta, tab_b=tb_,
                         cutoff2=tab_cut**2, mix_mode=MIX_OBS, obs=o)
            elif func == 12:
                ta = _load_nb_table(pp[0], nb_tb, opts.table_dirs)
                tb_ = _load_nb_table(pp[1], nb_tb, opts.table_dirs)
                set_pair(t1, t2, kind=PAIR_TAB, tab_a=ta, tab_b=tb_,
                         cutoff2=tab_cut**2, mix_x=float(pp[2]))
            elif func == 18:
                logger.warning("func 18 (connectivity-scaled) is a no-op, "
                               "as in the reference")
            else:
                _not_in_slice("nonbonded func %d" % func, "M10 (row path)")
    return out


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


def _cheb_tables(pair_arrays, nb_stack):
    """Fit every used table and choose the kernel mode (reference:
    build.py:1388-1466).  Returns (fit, ntab, slot, slot_b, sc, mix):
    table-scalar mode (K1c, K1d when mixed) when at most 8 distinct fits
    fill at most 128 coefficients, else coefficient-plane mode (K1e,
    ``ntab`` 0).  A failed fit, or mixed tables with more than 8 distinct
    fits, sends the reference to its row path; here it raises."""
    is_tab_pair = pair_arrays["pair_kind"] == PAIR_TAB
    used_tabs = np.zeros(nb_stack.ef.shape[0], bool)
    used_tabs[pair_arrays["pair_tab_a"][is_tab_pair]] = True
    used_tabs[pair_arrays["pair_tab_b"][is_tab_pair]] = True
    fit = tab_cheb.fit_stack(tables.interleave4(nb_stack.ef), nb_stack.r0,
                             nb_stack.dr, used_tabs)
    if fit is None:
        _not_in_slice("a pair table that fails the Chebyshev fit (the exact "
                      "row path)", "M10")
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
        _not_in_slice("mixed tables with more than 8 distinct fits (the "
                      "row path)", "M10")
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


def _check_slice(opts: SimOptions, systop: SystemTopology, compiled):
    """Refuse every configuration the port does not run yet."""
    if opts.dtype != "float32":
        _not_in_slice("dtype %s" % opts.dtype, "M13")
    if opts.use_pallas is False:
        _not_in_slice("the Verlet row force path", "M10")
    if opts.coulomb_cutoff > 0:
        _not_in_slice("Coulomb", "M10")
    if opts.thermostat not in ("lv", "no"):
        _not_in_slice("thermostat %r" % opts.thermostat, "M12")
    if systop.dihedrals or systop.dihedralparams:
        _not_in_slice("dihedrals", "M4")
    if systop.pairs:
        _not_in_slice("1-4 pairs", "M4")
    if compiled is None:
        return
    if compiled.n_reactions and compiled.channels["r_is_diss"].any():
        _not_in_slice("dissociation channels", "M12")
    if (compiled.releases or compiled.joins or compiled.freeze
            or compiled.cpt or compiled.dyn_resolution or compiled.rb_rows
            or compiled.restrict_file
            or (compiled.atrp and compiled.atrp["entries"])):
        _not_in_slice("reaction extensions other than "
                      "ChangeNeighboursProperty", "M12")


def build_system(systop: SystemTopology, coords, opts: SimOptions,
                 reaction_config: dict | None = None,
                 device="cuda") -> BuiltSystem:
    """Assemble the system on ``device`` (reference: build.build_system);
    the card by default, ``device="cpu"`` for the plain versions."""
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
    _check_slice(opts, systop, compiled)
    dynamic_types = compiled.dynamic_types if compiled else set()
    change_bond_types = compiled.observed_bondtypes if compiled else set()
    n_real = n

    # ---- nonbonded ----
    pair_arrays = _build_pair_tables(systop, opts, nb_tb, obs)

    # ---- bonded type-lookup tables ----
    bond_func_tt = np.zeros((T, T), I32)
    bond_par_tt = np.zeros((T, T, N_BOND_PARAMS), F32)
    for (a, b), rec in systop.bondparams.items():
        p = _pack_bond_params(rec["func"], rec["params"])
        for key in ((a, b), (b, a)):
            bond_func_tt[key] = rec["func"]
            bond_par_tt[key] = p
    angle_func_tt = np.zeros((T, T, T), I32)
    angle_par_tt = np.zeros((T, T, T, N_BOND_PARAMS), F32)
    for (a, b, c), rec in systop.angleparams.items():
        p = _pack_angle_params(rec["func"], rec["params"])
        for key in ((a, b, c), (c, b, a)):
            angle_func_tt[key] = rec["func"]
            angle_par_tt[key] = p
    dih_func_tt = np.zeros((T, T, T, T), I32)
    dih_par_tt = np.zeros((T, T, T, T, N_BOND_PARAMS), F32)

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
                p = pack(f, fields[1:])
            else:
                rec = params_by_type.get(ckey)
                if rec is None:
                    rec = params_by_type.get(tuple(reversed(ckey)))
                if rec is None:
                    raise ValueError("no parameters for term %s types %s"
                                     % (key_ids, tids))
                f = rec["func"]
                p = pack(f, rec["params"])
            idx.append(rows)
            funcs.append(f)
            params.append(p)
            tl.append(is_dynamic)
        return idx, funcs, params, tl

    b_idx, b_func, b_par, b_tl = term_entries(
        systop.bonds, systop.bondparams, _pack_bond_params,
        lambda t: tuple(sorted(t)))
    a_idx, a_func, a_par, a_tl = term_entries(
        systop.angles, systop.angleparams, _pack_angle_params,
        lambda t: (t[2], t[1], t[0]) if t[0] > t[2] else t)

    # ---- capacities ----
    n_pad = _round_up(max(n, 128), 128)
    has_reactions = compiled is not None and compiled.n_reactions > 0
    extra_default = _round_up(max(n // 32, 512), 128) if has_reactions else 0
    extra_b = opts.extra_bonds if opts.extra_bonds is not None \
        else extra_default
    extra_a = opts.extra_angles if opts.extra_angles is not None \
        else 4 * extra_b
    extra_d = opts.extra_dihedrals if opts.extra_dihedrals is not None else 0
    bond_cap = _round_up(max(len(b_idx) + extra_b, 8), 128)
    angle_cap = _round_up(max(len(a_idx) + extra_a, 8), 128)
    dih_cap = _round_up(max(extra_d, 8), 128)
    pair14_cap = 0
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
    has_tab = bool((pair_arrays["pair_kind"] == PAIR_TAB).any())
    if has_tab and not supports_cheb(pair_arrays):
        _not_in_slice("tabulated pairs beside LJ pairs, or capped / lambda "
                      "/ multi-range / scaled tabulated pairs", "M10")
    if not has_tab and ((pair_arrays["pair_caprad"] > 0).any()
                        or pair_arrays["pair_lam_scale"].any()
                        or (pair_arrays["pair_mix_mode"] != 0).any()
                        or (pair_arrays["pair_pps_incr"] > 0).any()):
        _not_in_slice("capped / lambda / mixed / scaled pairs", "M10")
    use_pallas = True

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
    if opts.cell_cap is None:
        cell_vol = float(np.prod(box / np.asarray(cell_dims)))
        cell_cap = _round_up(max(int(density * cell_vol * 1.7) + 8,
                                 int(obs_cell_max * 1.3) + 4, 8), 8)
    else:
        cell_cap = opts.cell_cap
    if has_tab and not cell_pair.colt_legal(cell_cap, cell_dims):
        # the Chebyshev modes exist only in colt2; the reference sends such
        # a system to its row path (build.py:428-434), K2 takes LJ only
        _not_in_slice("a tabulated system on cell grid %s with cap %d (the "
                      "Chebyshev modes need min dim >= 3 and cap %% 8 == 0; "
                      "the row path)" % (cell_dims, cell_cap), "M10")

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
    dihedrals = TermTable.create_numpy(dih_cap, 4)
    pairs14 = TermTable.create_numpy(1, 2, [], [], [])

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
    pos = np.zeros((n_pad, 3), F32)
    pos[:n_real] = np.mod(coords.pos, coords.box)
    vel = np.zeros((n_pad, 3), F32)
    if coords.vel is not None:
        vel[:n_real] = coords.vel
    type_id = np.full(n_pad, 0, I32)
    type_id[:n_real] = systop.type_ids
    mass = np.ones(n_pad, F32)
    mass[:n_real] = systop.masses
    q = np.zeros(n_pad, F32)
    q[:n_real] = systop.charges
    chem_state = np.zeros(n_pad, I32)
    chem_state[:n_real] = systop.states
    res_id = np.zeros(n_pad, I32)
    res_id[:n_real] = coords.res_idx
    lam = np.ones(n_pad, F32)
    active = np.zeros(n_pad, bool)
    active[:n] = True
    if opts.gen_velocity and coords.vel is None:
        # the reference's draw, bit for bit
        rng = np.random.RandomState(opts.rng_seed)
        m_eff = systop.masses * opts.mass_factor
        v = rng.normal(size=(n_real, 3)) * np.sqrt(opts.kT / m_eff)[:, None]
        v -= np.average(v, axis=0, weights=m_eff)
        vel[:n_real] = v

    nb_stack = nb_tb.build()
    cheb_fit = None
    cheb_ntab, cheb_mix = 0, False
    cheb_tab_slot = cheb_sc = cheb_tab_slot_b = None
    if has_tab:
        (cheb_fit, cheb_ntab, cheb_tab_slot, cheb_tab_slot_b, cheb_sc,
         cheb_mix) = _cheb_tables(pair_arrays, nb_stack)
    bond_stack = bond_tb.build()
    angle_stack = angle_tb.build()
    dih_stack = dih_tb.build()

    # ---- thermostat / thermal groups ----
    thermal_mask = np.ones(T, bool)
    if opts.thermal_groups:
        thermal_mask[:] = False
        for s in opts.thermal_groups:
            thermal_mask[systop.atomsym_atomtype[s]] = True

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
    atrp_arrays = dict(
        atrp_type=np.zeros(0, I32), atrp_state=np.zeros(0, I32),
        atrp_is_activator=np.zeros(0, bool), atrp_new_type=np.zeros(0, I32),
        atrp_delta=np.zeros(0, I32), atrp_num=np.asarray(0, I32),
        atrp_k_activate=np.asarray(0.0, F32),
        atrp_k_deactivate=np.asarray(0.0, F32),
        atrp_delta_catalyst=np.asarray(0.0, F32))

    obs_e_obs, obs_e_type, obs_e_state, obs_totals = obs.arrays()

    bond_funcs = sorted(set(b_func) | set(bond_func_tt.flatten())
                        | (set(compiled.g_func.tolist()) if compiled
                           else set()))
    bond_funcs = tuple(int(f) for f in bond_funcs if f > 0)
    angle_funcs = tuple(int(f) for f in sorted(set(a_func)
                                                | set(angle_func_tt.flatten()))
                        if f > 0)
    for f in bond_funcs:
        if f not in (1, 7, 9):
            _not_in_slice("bond func %d" % f, "M9")

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
        if not rx_compact:
            _not_in_slice("full-row reaction matching (type_1 side spans "
                          "the bulk)", "M6")

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
        bond_funcs=bond_funcs, angle_funcs=angle_funcs, dihedral_funcs=(),
        thermostat=opts.thermostat, iso_coupling=1,
        store_pressure=opts.store_pressure,
        barostat=opts.barostat if opts.pressure > 0 else "no",
        has_coulomb=False, has_reactions=has_reactions,
        reaction_interval=compiled.interval if compiled else 0,
        nearest_mode=compiled.nearest if compiled else False,
        max_per_interval=compiled.max_per_interval if compiled else -1,
        exclude_new_bonds=opts.exclude_new_bonds, n_mix_entries=0,
        has_mixed_tables=bool(
            (pair_arrays["pair_mix_mode"] != 0).any()
            or (pair_arrays["pair_tab_b"] != pair_arrays["pair_tab_a"]).any()),
        needs_conversions=bool(
            (pair_arrays["pair_mix_mode"] == MIX_OBS).any()),
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
        has_tabulated=has_tab, has_caps=False, has_pps=False,
        has_lambda_pairs=False, use_thermal_group=bool(opts.thermal_groups),
        nb_bins=opts.n_bins, max_ppnb=n_pp,
        max_nb_level=compiled.max_nb_level if compiled else 0,
        has_atrp=False, n_atrp=0,
        atrp_interval=atrp["interval"] if atrp else 0,
        atrp_num=atrp["num_particles"] if atrp else 0,
        atrp_select_from_all=bool(atrp["select_from_all"]) if atrp else True,
        has_dissociation=False, has_fixd=False, fixd_cap=1, n_fd=1,
        has_dyn_resolution=False, restrict_scan=1, n_rb=0, has_cpt=False,
        cpt_interval=0, cpt_num=0, has_freeze=False, freeze_mode="prob")

    def _type_prop(key, default):
        return [systop.top.atomtypes.get(systop.atomtype_atomsym.get(t, ""),
                                         {}).get(key, default)
                for t in range(T)]

    def _rate(t):
        return 1.0 / t if t > 0 else 0.0

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
        qq_prefactor=_asarray(0.0, F32),
        qq_cutoff2=_asarray(opts.coulomb_cutoff**2, F32),
        mix_pair=np.zeros(0, I32), mix_lo=np.zeros(0, F32),
        mix_hi=np.zeros(0, F32), mix_tab_a=np.zeros(0, I32),
        mix_tab_b=np.zeros(0, I32), mix_obs=np.zeros(0, I32),
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
        dr_alpha=np.zeros(T, F32), dr_final_type=np.full(T, -1, I32),
        dr_set_state=np.zeros(T, bool),
        fd_eq=np.zeros(1, F32), fd_host_type=np.full(1, -1, I32),
        fd_dummy_type=np.full(1, -1, I32), fd_target_type=np.full(1, -1, I32),
        fd_release_lam=np.zeros(1, F32), fd_capture_lam=np.zeros(1, F32),
        fd_capture_state=np.zeros(1, I32),
        restrict_lo=np.zeros(0, I32), restrict_hi=np.zeros(0, I32),
        rb_reaction=np.zeros(0, I32), rb_side=np.zeros(0, I32),
        rb_anchor_type=np.zeros(0, I32), rb_level=np.zeros(0, I32),
        rb_t1=np.zeros(0, I32), rb_t2=np.zeros(0, I32),
        cpt_old=np.asarray(-1, I32), cpt_new=np.asarray(-1, I32),
        fr_target_type=np.asarray(-1, I32), fr_final_type=np.asarray(-1, I32),
        fr_width=np.zeros(3, F32), fr_dirs=np.zeros(6, bool),
        fr_prob=np.asarray(0.0, F32), fr_p_num=np.asarray(0, I32),
        fr_p_pct=np.asarray(0.0, F32), fr_remove=np.asarray(False),
    )

    me = opts.max_events
    state_np = dict(
        step=np.asarray(0, I32), pos=pos, vel=vel,
        force=np.zeros((n_pad, 3), F32), image=np.zeros((n_pad, 3), I32),
        type_id=type_id, mass=mass, q=q, chem_state=chem_state,
        res_id=res_id, mol_id=mol_id, lam=lam, active=active,
        bonds=bonds, angles=angles, dihedrals=dihedrals, pairs14=pairs14,
        fixd_host=np.full(1, -1, I32), fixd_dummy=np.full(1, -1, I32),
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
        max_neighbors=max_neighbors, excl_cap=excl_cap)
    spec = bridge.dataclass_from_numpy(SimSpec, spec_np, device)
    state = bridge.dataclass_from_numpy(MDState, state_np, device)
    if cfg.bonded_dense:
        state = bonded_dense.rederive(cfg, state)
    if cfg.excl_offsets:
        state = excl_dense.rederive(cfg, state, create=True)

    term_names = (["bond_f%d" % f for f in bond_funcs]
                  + ["angle_f%d" % f for f in angle_funcs])
    return BuiltSystem(cfg=cfg, spec=spec, state=state, obs=obs,
                       reactions=compiled, systop=systop,
                       nb_names=nb_stack.names, term_names=term_names)
