"""Lower a parsed reaction .cfg into flat channel/extension tables.

Port of ``chemlab_tpu/engine/reaction_compile.py``, copied because the
reference module reaches jax through its ``.state`` import.  The changes:
``N_BOND_PARAMS`` comes from the port's ``state``, and the parser, topology
and table reader are the port's own copies.

Host-side equivalent of the reference's SetupReactions + PostProcessSetup
(ref: src/chemlab/reaction_setup.py, src/chemlab/reaction_post_process.py):
instead of instantiating engine extension objects, every reaction channel and
post-process becomes a row in numpy arrays that the device reaction kernel
consumes (SURVEY.md §7.1 "reaction channel table").

Everything the reference's reaction layer supports is lowered:
  - normal reactions (type/state windows, rate, hard or Gaussian cutoff,
    min_cutoff, intramolecular/intraresidual/virtual flags, per-side type
    changes), exchange reactions (virtual channel + neighbour-state
    constraint + neighbour transfer; ref: reaction_setup.py:167-255), and
    dissociation channels (distance-triggered + spontaneous breaks, product
    lambda fade via BasicDynamicResolution)
  - extensions: ChangeNeighboursProperty, RemoveNeighboursBonds,
    ReleaseMolecule, JoinMolecule, FreezeRegion, ChangeParticleType,
    ATRPActivator; RestrictReaction connectivity maps.
"""

from __future__ import annotations

import dataclasses
import logging
import re

import numpy as np

from .. import files_io
from .. import reaction_parser as rp
from ..topology import SystemTopology
from .state import N_BOND_PARAMS

logger = logging.getLogger(__name__)

_RE_PPNB_OPT = re.compile(r"(?P<type_name>\w+)\(?(?P<options>[a-zA-Z0-9_=,]*)\)?")
_RE_ATRP_REACTANT = re.compile(r"(?P<name>\w+)\((?P<state>\d+),\s*(?P<flag>[AD]{1,2})\)")
_RE_ATRP_PRODUCT = re.compile(r"(?P<new_type>\w+)\((?P<delta>[0-9-]+)\)")


@dataclasses.dataclass
class CompiledReactions:
    """Flat reaction tables + metadata consumed by the spec builder."""

    n_reactions: int
    n_groups: int
    rates: np.ndarray         # (R,) initial rates (runtime-mutable state)
    channels: dict            # name -> (R,) numpy array, the r_* fields
    g_func: np.ndarray        # (G,)
    g_params: np.ndarray      # (G, P)
    group_names: list
    ppnb: dict                # name -> (PB,) arrays, the ppnb_* fields
    max_nb_level: int
    atrp: dict | None         # scalar/entry arrays for ATRPActivator
    releases: list            # ReleaseMolecule descriptors (dummy particles);
                              # FixDistances defs are ordered releases-then-
                              # joins, so release k has fd def index k
    restrict_file: str | None # RestrictReaction connectivity map path
    restricted_reactions: list  # channel ids with connectivity whitelist
    dyn_resolution: dict      # type_id -> (alpha, final_type_id, set_state)
    rb_rows: list             # RemoveNeighboursBonds entries
    cpt: dict | None          # ChangeParticleType descriptor
    joins: list               # JoinMolecule descriptors; join k has fd def
                              # index len(releases) + k
    freeze: dict | None       # FreezeRegion descriptor
    dynamic_types: set        # type ids that change during the run
    observed_bondtypes: set
    interval: int
    nearest: bool
    max_per_interval: int
    reaction_index: dict      # channel idx -> equation string
    use_thermal_group: bool
    extra_tables: list        # (name, kind) bond tables needed by groups


def _pack_group_potential(group, table_builder, table_dirs):
    """Map a group 'potential' + options to (func, params)
    (ref: reaction_setup.py:444-467)."""
    pot = group["potential"]
    opts = {k: v for k, v in group["potential_options"].items()}
    params = np.zeros(N_BOND_PARAMS, dtype=np.float32)
    if pot == "Harmonic":
        func = 1
        params[0] = float(opts["K"])
        params[1] = float(opts["r0"])
    elif pot == "FENE":
        func = 7
        params[0] = float(opts["K"])
        params[1] = float(opts.get("r0", 0.0))
        params[2] = float(opts["rMax"])
    elif pot == "FENELennardJones":
        func = 9
        params[0] = float(opts["K"])
        params[1] = float(opts.get("r0", 0.0))
        params[2] = float(opts["rMax"])
        params[3] = float(opts.get("sigma", 1.0))
        params[4] = float(opts.get("epsilon", 1.0))
    elif pot == "Tabulated":
        func = 8
        fname = files_io.resolve_table(opts["filename"], table_dirs)
        r, e, f, _ = files_io.read_table(fname, kind="bond")
        # reaction groups declare the interpolation discipline
        # (itype=2 Akima, e.g. ref: examples/atrp_activator/atrp.cfg:34)
        params[0] = table_builder.add(fname, r, e, f,
                                      itype=int(opts.get("itype", 1)))
    else:
        raise NotImplementedError("reaction group potential %s" % pot)
    return func, params


def compile_reactions(config: dict, systop: SystemTopology, bond_table_builder,
                      table_dirs=(".",), output_prefix: str = "sim") -> CompiledReactions:
    name2type = systop.atomsym_atomtype
    atomtypes = systop.top.atomtypes

    general = config["general"]
    channels: list[dict] = []
    groups: list[tuple] = []
    ppnb_rows: list[dict] = []
    dynamic_types: set = set()
    observed_bondtypes: set = set()
    reaction_index: dict = {}
    atrp = None
    releases: list = []
    restrict_file = None
    restricted_reactions: list = []
    dyn_resolution: dict = {}
    rb_rows: list = []
    cpt = None
    joins: list = []
    freeze = None
    use_thermal_group = False

    def type_change(reactant) -> tuple:
        """(-1) or the new type id for a reacting side."""
        old = name2type[reactant["name"]]
        new = name2type[reactant["new_type"]]
        dynamic_types.add(old)
        dynamic_types.add(new)
        return new if new != old else -1

    def lower_ppnb(reaction_idx, options, invoke_on):
        """ChangeNeighboursProperty rows (ref: reaction_post_process.py:76-115)."""
        side = {"type_1": 0, "type_2": 1, "both": 2, None: 2}[invoke_on]
        for transfer in options["type_transfers"].split(","):
            old_part, new_part = transfer.split("->")
            old_name, nb_level = old_part.split(":")
            m = _RE_PPNB_OPT.match(new_part.strip())
            new_name, opt_str = m.group("type_name"), m.group("options")
            t_old = name2type[old_name.strip()]
            t_new = name2type[new_name]
            dynamic_types.add(t_old)
            dynamic_types.add(t_new)
            new_def = atomtypes[new_name]
            if "state" not in new_def:
                raise ValueError(
                    "atom type %s needs an [ atomstate ] entry for "
                    "ChangeNeighboursProperty" % new_name)
            new_state = new_def["state"]
            if opt_str:
                for kv in opt_str.split(","):
                    k, v = kv.split("=")
                    if k.strip() == "state":
                        new_state = int(v)
            ppnb_rows.append({
                "reaction": reaction_idx,
                "side": side,
                "old_type": t_old,
                "level": int(nb_level),
                "new_type": t_new,
                "new_state": new_state,
                "incr_state": 0,
                "min_state": 0,
                "max_state": 2**30,
            })

    def lower_atrp(options):
        """ATRPActivator entries (ref: reaction_post_process.py:380-426)."""
        nonlocal atrp
        entries = []
        for to_proc, after in (x.split("->") for x in options["options"].split(";")):
            reac = _RE_ATRP_REACTANT.match(to_proc.strip()).groupdict()
            prod = _RE_ATRP_PRODUCT.match(after.strip()).groupdict()
            if reac["flag"] not in ("A", "DA"):
                raise ValueError("ATRP flag must be A or DA")
            entries.append((
                name2type[reac["name"]],
                int(reac["state"]),
                reac["flag"] == "A",   # A = activation, DA = deactivation
                name2type[prod["new_type"]],
                int(prod["delta"]),
            ))
            dynamic_types.add(name2type[reac["name"]])
            dynamic_types.add(name2type[prod["new_type"]])
        atrp = {
            "interval": int(options["interval"]),
            "num_particles": int(options["num_particles"]),
            "select_from_all": int(options.get("select_from_all", 1)),
            "ratio_activator": float(options["ratio_activator"]),
            "ratio_deactivator": float(options["ratio_deactivator"]),
            "delta_catalyst": float(options["delta_catalyst"]),
            "k_activate": float(options["k_activate"]),
            "k_deactivate": float(options["k_deactivate"]),
            "entries": entries,
            "stats_file": options.get("stats_file", "%s_atrp_stats.dat" % output_prefix),
        }

    def lower_release(options):
        """ReleaseMolecule (ref: reaction_post_process.py:203-320): dummy
        particles held at eq_length from each host, released on host type
        change or on reaction, lambda fade-in to final_type."""
        nonlocal use_thermal_group
        host_type = options["host_type"]
        target_type = options["target_type"]
        dummy_tid = systop.add_new_atomtype("DUMMY_%d" % systop.next_type_id)
        target_tid = name2type[target_type]
        release_on = options.get("release_on", "type")
        if release_on not in ("bond", "type"):
            raise ValueError("release_on must be bond or type")
        final_type = options.get("final_type", target_type)
        release = {
            "host_type": name2type[host_type],
            "target_type": target_tid,
            "dummy_type": dummy_tid,
            "final_type": name2type[final_type],
            "eq_length": float(options["eq_length"]),
            "alpha": float(options["alpha"]),
            "init_res": float(options["init_res"]),
            "replicate": int(options.get("replicate", 1)),
            "release_on": release_on,
            "release_count": int(options.get("release_count", 1)),
            "release_host": options.get("invoke_on",
                                        options.get("release_host", "both")),
        }
        # (alpha, final_type, set_state): ReleaseMolecule's final change
        # includes the atomtype's default state
        # (ref: reaction_post_process.py:296-306)
        dyn_resolution[target_tid] = (release["alpha"],
                                      release["final_type"]
                                      if release["final_type"] != target_tid else -1,
                                      True)
        dynamic_types.update((release["host_type"], target_tid, dummy_tid,
                              release["final_type"]))
        use_thermal_group = True
        releases.append(release)
        return release

    def lower_join(options):
        """JoinMolecule (ref: reaction_post_process.py:322-362): the type_2
        particle of a reaction is captured into a FixDistances constraint as
        an invisible dummy; released back to target_type when the host's
        type changes."""
        nonlocal use_thermal_group
        target_type = options["target_type"]
        final_type = options.get("final_type", target_type)
        dummy_tid = systop.add_new_atomtype("DUMMY_%d" % systop.next_type_id)
        target_rec = atomtypes.get(target_type, {})
        join = {
            "host_type": name2type[options["host_type"]],
            "target_type": name2type[target_type],
            "final_type": name2type[final_type],
            "dummy_type": dummy_tid,
            "eq_length": float(options["eq_length"]),
            "init_res": float(options["init_res"]),
            "state": int(target_rec.get("state", 0)),
            "local_idx": len(joins),
        }
        dynamic_types.update((join["host_type"], join["target_type"],
                              dummy_tid, join["final_type"]))
        use_thermal_group = True
        joins.append(join)
        return join

    for group_name, group in config["reactions"].items():
        gid = len(groups)
        func, gparams = _pack_group_potential(group, bond_table_builder, table_dirs)
        groups.append((group_name, func, gparams))

        group_restricted = bool(group.get("connectivity_map"))
        if group_restricted:
            restrict_file = group["connectivity_map"]

        # extensions: split into per-reaction post-processes and integrator exts
        group_pp = []  # (ext_name, kind, payload)
        for ext_name, ext in group["extensions"].items():
            cls = ext["class"]
            if cls == "ChangeNeighboursProperty":
                group_pp.append((ext_name, "ppnb", ext["options"]))
            elif cls == "ATRPActivator":
                lower_atrp(ext["options"])
            elif cls == "ReleaseMolecule":
                rel = lower_release(ext["options"])
                if rel["release_on"] == "bond":
                    group_pp.append((ext_name, "release", rel))
            elif cls == "RemoveNeighboursBonds":
                # bonds_to_remove=anchor->t1:t2:level,... (ref: :117-137)
                entries = []
                for item in ext["options"]["bonds_to_remove"].split(","):
                    anchor, rest = item.split("->")
                    t1n, t2n, level = rest.split(":")
                    tp = (name2type[t1n.strip()], name2type[t2n.strip()])
                    observed_bondtypes.add(tuple(sorted(tp)))
                    entries.append({
                        "anchor_type": name2type[anchor.strip()],
                        "level": int(level), "t1": tp[0], "t2": tp[1],
                        "side": {"type_1": 0, "type_2": 1, "both": 2}[
                            ext["options"].get("invoke_on", "both")],
                    })
                group_pp.append((ext_name, "rb", entries))
            elif cls == "ChangeParticleType":
                o = ext["options"]
                cpt = {"interval": int(o["interval"]),
                       "num": int(o["num_particles"]),
                       "old": int(o["type_id"]), "new": int(o["new_type_id"])}
            elif cls == "JoinMolecule":
                group_pp.append((ext_name, "join", lower_join(ext["options"])))
            elif cls == "FreezeRegion":
                # box-edge freeze regions (ref: reaction_post_process.py:139-201)
                o = ext["options"]
                freeze_tid = systop.add_new_atomtype(
                    "FREEZE_%d" % systop.next_type_id)
                dirs = o.get("directions", "-x,x,-y,y,-z,z").split(",")
                freeze = {
                    "target_type": name2type[o["target_type"]],
                    "final_type": freeze_tid,
                    "width": float(o["width"]),
                    "width_is_ratio": o.get("width_type", "static") == "ratio",
                    "dirs": [d.strip() for d in dirs],
                    "prob": float(o["prob"]) if o.get("prob") else 1.0,
                    # per-invocation count / percentage modes + stats file
                    # (ref: reaction_post_process.py:160-199)
                    "p_num": int(o["p_num"]) if o.get("p_num") else 0,
                    "p_pct": float(o.get("p_percentage")
                                   or o.get("p_num_percentage") or 0.0),
                    "stats_file": o.get("stats_file", ""),
                    "remove": o.get("remove_particles", "False") in
                              ("True", "true", "1"),
                }
                if not (0.0 <= freeze["p_pct"] <= 1.0):
                    raise RuntimeError(
                        "p_percentage not in the range (0.0, 1.0)")
                dynamic_types.update((freeze["target_type"], freeze_tid))
            else:
                raise ValueError("unknown extension class %s" % cls)

        for chem in group["reaction_list"]:
            if not chem["active"]:
                continue
            ridx = len(channels)
            rl = chem["reactant_list"]
            is_diss = chem["reaction_type"] == rp.REACTION_DISSOCATION
            is_exch = chem["reaction_type"] == rp.REACTION_EXCHANGE
            t1 = rl["type_1"]
            # exchange pairs type_1 with type_3; type_2 is the constraint side
            t2 = rl["type_3"] if is_exch else rl["type_2"]
            row = {
                "t1": name2type[t1["name"]],
                "t2": name2type[t2["name"]],
                "min1": t1["min"], "max1": t1["max"],
                "min2": t2["min"], "max2": t2["max"],
                "delta1": t1["delta"], "delta2": t2["delta"],
                "rate": chem["rate"],
                "cutoff2": chem.get("cutoff", 0.0) ** 2,
                "min_cutoff2": chem.get("min_cutoff", 0.0) ** 2,
                "sigma": chem.get("sigma", 0.0),
                "eq": chem.get("eq_distance", 0.0),
                "intramolecular": chem["intramolecular"],
                "intraresidual": chem["intraresidual"],
                "virtual": chem["virtual"] or is_exch,
                "is_diss": is_diss,
                "diss_rate": chem.get("diss_rate", 0.0),
                "group": gid,
                "new_type1": type_change(t1),
                "new_type2": type_change(t2),
                "cnb_type": -1, "cnb_min": 0, "cnb_max": 0,
                "release_n": 0, "release_side": 2, "join_local": -1,
                "diss_fade": False,
                "restricted": group_restricted,
            }
            if group_restricted:
                restricted_reactions.append(ridx)
            dynamic_types.add(row["t1"])
            dynamic_types.add(row["t2"])
            if is_diss:
                observed_bondtypes.add(tuple(sorted((row["t1"], row["t2"]))))
                if "alpha" in chem and chem["alpha"]:
                    # Reference fade-out: on break the particle keeps its OLD
                    # type with lambda reset to 0; BasicDynamicResolution on
                    # the old type ramps lambda back at alpha/step and the
                    # new type fires (type/mass/q only, no state) at
                    # lambda >= 1 (ref: reaction_setup.py:320-354).
                    row["diss_fade"] = True
                    for nt, base in ((row["new_type1"], row["t1"]),
                                     (row["new_type2"], row["t2"])):
                        dyn_resolution.setdefault(
                            base,
                            (float(chem["alpha"]),
                             nt if (nt >= 0 and nt != base) else -1,
                             False))
            if is_exch:
                c = rl["type_2"]
                row["cnb_type"] = name2type[c["name"]]
                row["cnb_min"] = c["min"]
                row["cnb_max"] = c["max"]
                # neighbour property transfer at level 1 with the state window
                new_def = atomtypes[c["new_type"]]
                ppnb_rows.append({
                    "reaction": ridx,
                    "side": 0,
                    "old_type": name2type[c["name"]],
                    "level": 1,
                    "new_type": name2type[c["new_type"]],
                    "new_state": -1,
                    "incr_state": c["delta"],
                    "min_state": c["min"],
                    "max_state": c["max"],
                })
                dynamic_types.add(name2type[c["new_type"]])
            channels.append(row)
            reaction_index[ridx] = chem["equation"]
            # attach group extensions (minus excluded)
            for ext_name, kind, payload in group_pp:
                if ext_name in chem["exclude_extensions"]:
                    continue
                if kind == "ppnb":
                    lower_ppnb(ridx, payload, payload.get("invoke_on"))
                elif kind == "release":
                    row["release_n"] = payload["release_count"]
                    row["release_side"] = {"type_1": 0, "type_2": 1,
                                           "both": 2}[payload["release_host"]]
                elif kind == "rb":
                    for e in payload:
                        rb_rows.append({"reaction": ridx, **e})
                elif kind == "join":
                    # JoinMolecule owns the type_2-side change
                    row["join_local"] = payload["local_idx"]
                    row["new_type2"] = -1

    r = len(channels)

    def col(name, dtype=np.float32):
        return np.asarray([c[name] for c in channels], dtype=dtype)

    channel_arrays = {
        "r_t1": col("t1", np.int32), "r_t2": col("t2", np.int32),
        "r_min1": col("min1", np.int32), "r_max1": col("max1", np.int32),
        "r_min2": col("min2", np.int32), "r_max2": col("max2", np.int32),
        "r_delta1": col("delta1", np.int32), "r_delta2": col("delta2", np.int32),
        "r_cutoff2": col("cutoff2"), "r_min_cutoff2": col("min_cutoff2"),
        "r_sigma": col("sigma"), "r_eq": col("eq"),
        "r_intramolecular": col("intramolecular", bool),
        "r_intraresidual": col("intraresidual", bool),
        "r_virtual": col("virtual", bool),
        "r_is_diss": col("is_diss", bool),
        "r_diss_fade": col("diss_fade", bool),
        "r_diss_rate": col("diss_rate"),
        "r_group": col("group", np.int32),
        "r_new_type1": col("new_type1", np.int32),
        "r_new_type2": col("new_type2", np.int32),
        "r_cnb_type": col("cnb_type", np.int32),
        "r_cnb_min": col("cnb_min", np.int32),
        "r_cnb_max": col("cnb_max", np.int32),
        "r_release_n": col("release_n", np.int32),
        "r_release_side": col("release_side", np.int32),
        "r_restricted": col("restricted", bool),
        # fd def index of the reaction's JoinMolecule (-1 = none); defs are
        # ordered releases-then-joins, fixed only now that all groups lowered
        "r_join_def": np.asarray(
            [len(releases) + c["join_local"] if c["join_local"] >= 0 else -1
             for c in channels], np.int32),
    } if r else {}

    pb = len(ppnb_rows)
    ppnb_arrays = {
        "ppnb_reaction": np.asarray([p["reaction"] for p in ppnb_rows], np.int32),
        "ppnb_side": np.asarray([p["side"] for p in ppnb_rows], np.int32),
        "ppnb_old_type": np.asarray([p["old_type"] for p in ppnb_rows], np.int32),
        "ppnb_level": np.asarray([p["level"] for p in ppnb_rows], np.int32),
        "ppnb_new_type": np.asarray([p["new_type"] for p in ppnb_rows], np.int32),
        "ppnb_new_state": np.asarray([p["new_state"] for p in ppnb_rows], np.int32),
        "ppnb_incr_state": np.asarray([p["incr_state"] for p in ppnb_rows], np.int32),
        "ppnb_min_state": np.asarray([p["min_state"] for p in ppnb_rows], np.int32),
        "ppnb_max_state": np.asarray([p["max_state"] for p in ppnb_rows], np.int32),
    } if pb else {}

    return CompiledReactions(
        n_reactions=r,
        n_groups=len(groups),
        rates=np.asarray([c["rate"] for c in channels], np.float32),
        channels=channel_arrays,
        g_func=np.asarray([g[1] for g in groups], np.int32) if groups else np.zeros(0, np.int32),
        g_params=np.stack([g[2] for g in groups]) if groups else np.zeros((0, N_BOND_PARAMS), np.float32),
        group_names=[g[0] for g in groups],
        ppnb=ppnb_arrays,
        # BFS depth must cover RemoveNeighboursBonds levels too, or the
        # unreachable sentinel (max_level+1) could equal an rb_level and
        # match every bond in the system
        max_nb_level=max([p["level"] for p in ppnb_rows]
                         + [e["level"] for e in rb_rows], default=0),
        atrp=atrp,
        releases=releases,
        restrict_file=restrict_file,
        restricted_reactions=restricted_reactions,
        dyn_resolution=dyn_resolution,
        rb_rows=rb_rows,
        cpt=cpt,
        joins=joins,
        freeze=freeze,
        dynamic_types=dynamic_types,
        observed_bondtypes=observed_bondtypes,
        interval=general["interval"],
        nearest=general["nearest"],
        max_per_interval=general["max_per_interval"],
        reaction_index=reaction_index,
        use_thermal_group=use_thermal_group,
        extra_tables=[],
    )
