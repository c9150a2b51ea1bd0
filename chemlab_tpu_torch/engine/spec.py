"""EngineConfig and SimSpec.

Port of ``chemlab_tpu/engine/spec.py``.  ``EngineConfig`` keeps the
reference's static fields (frozen, hashable); its ``mesh`` is the port's
own, a ``parallel.sharding.SlabMesh`` (the rank's process group) in place
of the reference's JAX mesh.  ``SimSpec`` is a dataclass of torch tensors
with the reference's field names, dtypes and shapes; the port's build fills
every field so a spec can be compared with the reference leaf for leaf,
although the slice reads only the fields of the reactive LJ melt.
"""

from __future__ import annotations

import dataclasses

import torch

from .state import TensorDataclass

# ---- nonbonded pair kinds --------------------------------------------------
PAIR_NONE = 0
PAIR_LJ = 1
PAIR_TAB = 2

# ---- pair mixing modes -----------------------------------------------------
MIX_STATIC = 0
MIX_OBS = 1
MIX_MULTIRANGE = 2

# ---- reaction post-process sides -------------------------------------------
SIDE_T1 = 0
SIDE_T2 = 1
SIDE_BOTH = 2


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration; see the reference for each field's meaning."""

    n_types: int
    n_particles: int
    n_pad: int
    max_neighbors: int
    cell_cap: int
    cell_dims: tuple
    deg_cap: int
    bond_cap: int
    angle_cap: int
    dihedral_cap: int
    pair14_cap: int
    excl_cap: int
    max_events: int
    n_reactions: int
    n_groups: int
    n_obs: int
    bond_funcs: tuple
    angle_funcs: tuple
    dihedral_funcs: tuple
    thermostat: str
    barostat: str
    has_coulomb: bool
    has_reactions: bool
    reaction_interval: int
    nearest_mode: bool
    max_per_interval: int
    exclude_new_bonds: bool
    n_mix_entries: int
    needs_conversions: bool
    use_pallas: bool          # cell-tile pair kernel path (K1 in the port)
    has_lj: bool
    has_tabulated: bool
    has_caps: bool
    has_pps: bool
    has_lambda_pairs: bool
    use_thermal_group: bool
    nb_bins: int
    max_ppnb: int
    max_nb_level: int
    has_atrp: bool
    n_atrp: int
    atrp_interval: int
    atrp_num: int
    atrp_select_from_all: bool
    has_dissociation: bool
    has_fixd: bool
    fixd_cap: int
    n_fd: int
    has_dyn_resolution: bool
    restrict_scan: int
    n_rb: int
    has_cpt: bool
    cpt_interval: int
    cpt_num: int
    has_freeze: bool
    freeze_mode: str = "prob"
    iso_coupling: int = 1
    store_pressure: bool = False
    lazy_rows: bool = False
    uniform_lj: bool = False
    all_lj: bool = False
    tab_cheb: bool = False
    cheb_kw: int = 0
    cheb_ko: int = 0
    cheb_ntab: int = 0
    cheb_mix: bool = False
    rx_dims: tuple = (1, 1, 1)
    rx_cell_cap: int = 8
    rx_k: int = 8
    rx_rc: float = 0.0
    rx_compact: bool = False
    rx_rows_cap: int = 0
    has_mixed_tables: bool = False
    bonded_dense: bool = False
    bond_irr_cap: int = 0
    angle_irr_cap: int = 0
    excl_offsets: tuple = ()
    excl_irr_cap: int = 0
    # the rank's SlabMesh (parallel.sharding.meshed_cfg) or None: with two
    # or more ranks the pair sum is split by x-slab (engine.cell_pair_halo)
    mesh: object = None


T = torch.Tensor


@dataclasses.dataclass
class SimSpec(TensorDataclass):
    """Tensor description of the system (field meanings: reference spec)."""

    # integration scalars
    dt: T
    kT: T
    gamma: T
    max_force: T
    pressure: T
    barostat_tau: T
    barostat_gammaP: T
    barostat_mass: T
    skin: T
    thermal_type_mask: T
    # per-type properties
    type_mass: T
    type_q: T
    type_state: T
    # nonbonded pair dispatch, flattened (T*T,)
    pair_kind: T
    pair_sig: T
    pair_eps: T
    pair_cutoff2: T
    pair_shift: T
    pair_caprad: T
    pair_tab_a: T
    pair_tab_b: T
    pair_mix_mode: T
    pair_mix_x: T
    pair_obs: T
    pair_lam_scale: T
    pair_max_force: T
    pair_pps_incr: T
    qq_prefactor: T
    qq_cutoff2: T
    # func 9 / 17 range entries
    mix_pair: T
    mix_lo: T
    mix_hi: T
    mix_tab_a: T
    mix_tab_b: T
    mix_obs: T
    # table stacks
    nb_ef: T
    nb_ef4: T
    nb_r0: T
    nb_dr: T
    bond_ef: T
    bond_r0: T
    bond_dr: T
    angle_ef: T
    angle_r0: T
    angle_dr: T
    dih_ef: T
    dih_r0: T
    dih_dr: T
    # per-type bonded parameter lookup
    bond_func_tt: T
    bond_par_tt: T
    angle_func_tt: T
    angle_par_tt: T
    dih_func_tt: T
    dih_par_tt: T
    # conversion observables
    obs_entry_obs: T
    obs_entry_type: T
    obs_entry_state: T
    obs_total: T
    # reaction channels (R,)
    r_t1: T
    r_t2: T
    r_min1: T
    r_max1: T
    r_min2: T
    r_max2: T
    r_delta1: T
    r_delta2: T
    r_cutoff2: T
    r_min_cutoff2: T
    r_sigma: T
    r_eq: T
    r_intramolecular: T
    r_intraresidual: T
    r_virtual: T
    r_is_diss: T
    r_diss_fade: T
    r_diss_rate: T
    r_group: T
    r_new_type1: T
    r_new_type2: T
    r_cnb_type: T
    r_cnb_min: T
    r_cnb_max: T
    # reaction groups
    g_func: T
    g_params: T
    # ChangeNeighboursProperty entries
    ppnb_reaction: T
    ppnb_side: T
    ppnb_old_type: T
    ppnb_level: T
    ppnb_new_type: T
    ppnb_new_state: T
    ppnb_incr_state: T
    ppnb_min_state: T
    ppnb_max_state: T
    # ATRPActivator
    atrp_type: T
    atrp_state: T
    atrp_is_activator: T
    atrp_new_type: T
    atrp_delta: T
    atrp_num: T
    atrp_k_activate: T
    atrp_k_deactivate: T
    atrp_delta_catalyst: T
    # hybrid-bond lambda ramps
    hybrid_bond_rate: T
    hybrid_angle_rate: T
    hybrid_dihedral_rate: T
    # BasicDynamicResolution
    dr_alpha: T
    dr_final_type: T
    dr_set_state: T
    # FixDistances definitions
    fd_eq: T
    fd_host_type: T
    fd_dummy_type: T
    fd_target_type: T
    fd_release_lam: T
    fd_capture_lam: T
    fd_capture_state: T
    r_release_n: T
    r_release_side: T
    r_join_def: T
    # RestrictReaction whitelist
    restrict_lo: T
    restrict_hi: T
    r_restricted: T
    # RemoveNeighboursBonds rows
    rb_reaction: T
    rb_side: T
    rb_anchor_type: T
    rb_level: T
    rb_t1: T
    rb_t2: T
    # ChangeParticleType
    cpt_old: T
    cpt_new: T
    # FreezeRegion
    fr_target_type: T
    fr_final_type: T
    fr_width: T
    fr_dirs: T
    fr_prob: T
    fr_p_num: T
    fr_p_pct: T
    fr_remove: T
    # Chebyshev-compressed tabulated pairs (None: not used by the slice)
    cheb_wall_g: T | None = None
    cheb_wall_e: T | None = None
    cheb_well_g: T | None = None
    cheb_well_e: T | None = None
    cheb_ay: T | None = None
    cheb_by: T | None = None
    cheb_ax: T | None = None
    cheb_bx: T | None = None
    cheb_rs2: T | None = None
    cheb_rcap2: T | None = None
    cheb_tab_slot: T | None = None
    cheb_sc: T | None = None
    cheb_tab_slot_b: T | None = None
