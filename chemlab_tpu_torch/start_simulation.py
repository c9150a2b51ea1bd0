"""Simulation orchestration: the chemlab CLI on PyTorch.

Port of ``chemlab_tpu/start_simulation.py`` ``main()``, block for block:
parse the ``@params`` flags, read the topology and coordinates, build the
system on the card, wire reactions and observables, run the stepped main
loop (capacity decisions, dumps, the ``--retune_caps`` latch, reactions
enabled at ``start_ar``, conversion stop criteria, ``run_block``,
checkpoints, hooks, Arrhenius rate updates), and write the output set
(H5MD trajectory + connectivity, energy CSV, final and unfolded .gro,
regenerated .top, reaction counters, the FreezeRegion and ATRPActivator
stats, benchmark row and timers).

``main(argv, device="cuda")``: the CLI runs on the card and raises without
one; tests pass ``device="cpu"``.  One ``torch.Generator`` carries the
run's noise (``runner.make_generator(rng_seed)``) and is checkpointed with
the state.  Hooks see a host view of the state (``SimulationContext``);
their edits are written back to the state on its device.

``--node_grid x,y,z`` with a product D > 1 runs the CLI on D ranks of a
``torch.distributed`` group (``parallel.launch``, the ``cli`` job): every
rank builds the same system with ``slab_devices = D``, draws from the same
seed, runs the hooks and changes its caps at the same steps, so the
replicas stay equal, and only the pair sum is split by x-slab.  Rank 0
alone writes the output files; its standard output is printed by the
calling process when the ranks are done.  ``device="cuda"`` puts rank r on
``cuda:r`` over NCCL, ``device="cuda:k"`` every rank on that card and
``device="cpu"`` every rank on the CPU, both over gloo.  Without the flag,
or with a product of 1, the CLI runs in the calling process (the
reference instead spreads over every local device).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from . import app_args, files_io, reaction_parser, tools, writers
from .engine import build
from .topology import build_system_topology

logger = logging.getLogger(__name__)


class _ConversionCollector:
    """Collects conversion requests before the engine ObsRegistry exists."""

    def __init__(self):
        self.items = []

    def register(self, entries, total):
        self.items.append((tuple(entries), total))
        return len(self.items) - 1


class HostView:
    """Read-only host view of a state tree: each tensor field reads as a
    numpy array (``.cpu().numpy()``), nested tables as views."""

    def __init__(self, tree):
        self._tree = tree

    def __getattr__(self, name):
        v = getattr(self._tree, name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        if dataclasses.is_dataclass(v):
            return HostView(v)
        return v


class SimulationContext:
    """What hook functions receive (the reference passes the espressopp
    system/integrator; ref: start_simulation.py:220-228).

    ``state`` is a host view of the state (numpy arrays, so that a hook's
    ``np.asarray(ctx.state.type_id)`` works whatever the device);
    ``device_state`` is the MDState itself, which ``modify_particle`` and
    the espressopp adapters write to.  Assigning ``state`` sets
    ``device_state``."""

    def __init__(self, args, systop, built, state, step: int = 0):
        self.args = args
        self.systop = systop
        self.built = built
        self.device_state = state
        self.step = step

    @property
    def state(self) -> HostView:
        return HostView(self.device_state)

    @state.setter
    def state(self, st):
        self.device_state = st

    def modify_particle(self, pid, **props):
        """storage.modifyParticle equivalent; pid is the 1-based atom id."""
        row = pid - 1
        st = self.device_state
        mapping = {"type": "type_id", "state": "chem_state", "mass": "mass",
                   "q": "q", "lambda_adr": "lam", "res_id": "res_id"}
        for k, v in props.items():
            field = mapping.get(k, k)
            if field == "q":
                build.refuse_charges(self.built.spec, v)
            arr = getattr(st, field).clone()
            arr[row] = v
            st = dataclasses.replace(st, **{field: arr})
        self.device_state = st

    def type_id_of(self, symbol):
        return self.systop.atomsym_atomtype[symbol]


def _load_hooks(path):
    hooks = {}
    if path and os.path.exists(path):
        from . import hooks_compat

        with open(path) as f:
            code = f.read()
        # reference example hooks are Python-2 sources importing espressopp
        # (ref: examples/atrp_lj/hooks.py): translate + shim so they run
        # unchanged; a hooks file that still fails to compile is skipped
        # with a warning instead of killing the run
        code = hooks_compat.py2_to_py3(code, path)
        if code is None:
            return hooks
        hooks_compat.install_espp_shim()
        ns = {}
        exec(compile(code, path, "exec"), ns)  # hooks are user code
        hooks_compat.patch_namespace(ns)
        hooks = {k: v for k, v in ns.items() if k.startswith("hook_")}
        logger.info("loaded hooks from %s: %s", path, sorted(hooks))
    return hooks


def _call_hook(hooks, name, ctx, *extra):
    fn = hooks.get(name)
    if fn is None:
        return True
    import inspect

    try:
        n_params = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_params = 1
    if n_params > 2:
        # reference espressopp signature (system, integrator, ar, topol, args)
        from . import hooks_compat

        session = hooks_compat.HookSession(ctx)
        ret = fn(*session.argv(name, *extra))
        session.commit()
    else:
        ret = fn(ctx, *extra)
    return True if ret is None else bool(ret)


def build_sim_options(args, table_dirs):
    from .engine.build import SimOptions

    return SimOptions(
        lj_cutoff=args.lj_cutoff,
        cg_cutoff=args.cg_cutoff,
        coulomb_cutoff=args.coulomb_cutoff if args.coulomb_cutoff else 0.0,
        skin=args.skin,
        dt=args.dt,
        kT=args.kb * args.temperature,
        thermostat=args.thermostat,
        thermostat_gamma=args.thermostat_gamma,
        barostat=args.barostat if args.pressure else "no",
        # --pressure is in bar; engine units are kJ/mol/nm^3 (ref:
        # start_simulation.py:361 "pressure = args.pressure * 0.060221374")
        pressure=(args.pressure or 0.0) * 0.060221374,
        barostat_tau=args.barostat_tau,
        barostat_gammaP=args.barostat_gammaP,
        barostat_mass=args.barostat_mass,
        max_force=args.max_force,
        table_groups=tuple((args.table_groups or "").split(","))
        if args.table_groups else (),
        thermal_groups=tuple((args.thermal_groups or "").split(","))
        if args.thermal_groups else (),
        rng_seed=args.rng_seed,
        gen_velocity=args.gen_velocity,
        mass_factor=args.mass_factor,
        store_pressure=bool(args.store_pressure or args.pressure),
        t_hybrid_bond=args.t_hybrid_bond,
        t_hybrid_angle=args.t_hybrid_angle,
        t_hybrid_dihedral=args.t_hybrid_dihedral,
        exclude_new_bonds=not args.do_not_exclude_bonds,
        table_dirs=table_dirs,
        output_prefix=args.output_prefix,
    )


def check_topology(state, verbose=True):
    """Host-side topology consistency validation (--check_topology; the
    reference elevates the TopologyManager logger, ref: :74-75).

    Returns a list of problem strings (empty = consistent)."""
    problems = []
    idx = state.bonds.idx.cpu().numpy()
    valid = idx[:, 0] >= 0
    adj = state.adj.cpu().numpy()
    # every valid bond must appear in the adjacency, both directions
    for i, j in idx[valid]:
        if j not in adj[i] or i not in adj[j]:
            problems.append("bond (%d,%d) missing from adjacency" % (i, j))
    # adjacency edge count matches 2x bond count
    n_adj = int((adj >= 0).sum())
    n_bonds = int(valid.sum())
    if n_adj != 2 * n_bonds:
        problems.append("adjacency has %d entries for %d bonds"
                        % (n_adj, n_bonds))
    # no duplicate valid bonds
    key = idx[valid].min(1).astype(np.int64) * adj.shape[0] \
        + idx[valid].max(1)
    if len(np.unique(key)) != n_bonds:
        problems.append("duplicate bond rows")
    # angles/dihedrals reference only active particles
    act = state.active.cpu().numpy()
    for name, table in (("angle", state.angles),
                        ("dihedral", state.dihedrals)):
        t_idx = table.idx.cpu().numpy()
        t_valid = t_idx[:, 0] >= 0
        if t_valid.any() and not act[t_idx[t_valid]].all():
            problems.append("%s rows reference inactive particles" % name)
    if verbose and problems:
        for p in problems:
            print("TOPOLOGY CHECK: %s" % p)
    return problems


def _bond_type_counts(state, n_types):
    """Host-side bond count per unordered type pair (stop criteria T1-T2)."""
    idx = state.bonds.idx.cpu().numpy()
    valid = idx[:, 0] >= 0
    tid = state.type_id.cpu().numpy()
    out = {}
    for i, j in idx[valid]:
        key = tuple(sorted((int(tid[i]), int(tid[j]))))
        out[key] = out.get(key, 0) + 1
    return out


def _host_dict(m: dict) -> dict:
    """A measure dict on the host: one read of the device per block."""
    return {k: v.detach().cpu() for k, v in m.items()}


def node_grid_ranks(node_grid) -> int:
    """The rank count of ``--node_grid x,y,z``: the product (1 without the
    flag)."""
    if not node_grid:
        return 1
    return int(np.prod([int(x) for x in str(node_grid).split(",")]))


def run_ranks(argv, device, n_ranks: int, h5md_writer=None) -> int:
    """The CLI on ``n_ranks`` ranks placed by ``device`` (module
    docstring); prints rank 0's standard output and returns its exit
    code.  The group meets in a ``file://`` store in a new temporary
    directory, removed afterwards."""
    import shutil
    import tempfile

    from .parallel import launch

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if n_ranks > torch.cuda.device_count():
            raise ValueError("requested %d devices, only %d available"
                             % (n_ranks, torch.cuda.device_count()))
        backend, rank_device = "nccl", None
    else:
        backend, rank_device = "gloo", str(device)
    store = tempfile.mkdtemp(prefix="chemlab_ranks_")
    try:
        (res,) = launch.run_jobs(
            [("cli", dict(argv=list(argv or []), cwd=os.getcwd(),
                          h5md_writer=h5md_writer))], n_ranks, store,
            backend=backend, device=rank_device, timeout=None)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    sys.stdout.write(res[0]["stdout"])
    return res[0]["rc"]


class _NoOutput:
    """The H5MD and energy writers of a rank other than 0: every call
    writes nothing."""

    def __getattr__(self, name):
        return lambda *a, **kw: None


def _writer_class(h5md_writer):
    """``writers.H5MDWriter``, or the class that ``h5md_writer``
    ("module:attr") names."""
    if h5md_writer is None:
        return writers.H5MDWriter
    import importlib

    module, attr = h5md_writer.split(":")
    return getattr(importlib.import_module(module), attr)


def _write_final_files(out_prefix, state, systop, coords, cfg, built):
    """The output phase's files: the final and unfolded .gro, the
    regenerated .top, the ATRPActivator stats and the reaction counters."""
    files_io.write_gro("%s_confout.gro" % out_prefix,
                       writers.state_to_coordinates(state, systop, coords))
    files_io.write_gro("%s_confout_unfolded.gro" % out_prefix,
                       writers.state_to_coordinates(state, systop, coords,
                                                    unfolded=True))
    writers.write_topology("%s_topol.top" % out_prefix, systop, state)

    if cfg.has_atrp:
        # ATRPActivator stats file (ref: reaction_post_process.py:390-396)
        stats = state.atrp_stats.cpu().numpy()
        ratios = state.atrp_ratios.cpu().numpy()
        with open("%s_atrp_stats.dat" % out_prefix, "w") as f:
            f.write("activated %d\ndeactivated %d\n"
                    "ratio_activator %g\nratio_deactivator %g\n"
                    % (stats[0], stats[1], ratios[0], ratios[1]))

    if cfg.has_reactions:
        with open("%s_reaction_counters.csv" % out_prefix, "w") as f:
            counts = state.reaction_counts.cpu().numpy()
            for ridx, eq in (built.reactions.reaction_index.items()
                             if built.reactions else []):
                f.write("%d,%s,%d\n" % (ridx, eq, counts[ridx]))
            intra = state.intra_counts.cpu().numpy()
            f.write("intramolecular,,%d\ninter_molecular,,%d\n" %
                    (intra[0], intra[1]))


def main(argv=None, device="cuda", mesh=None, h5md_writer=None):
    """Run the CLI on ``device`` (the card unless the caller asks for
    another); with ``--node_grid`` of product D > 1, on D ranks
    (``run_ranks``).  ``mesh`` is the rank's ``parallel.SlabMesh`` when
    this call is one of those ranks.  ``h5md_writer`` ("module:attr")
    names a class to write the H5MD trajectory in ``writers.H5MDWriter``'s
    place."""
    from .engine import runner

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the CLI runs on the card and this machine has "
                           "no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    parser, args = app_args.parse_args(argv)
    n_ranks = node_grid_ranks(args.node_grid)
    if mesh is None and n_ranks > 1:
        return run_ranks(argv, device, n_ranks, h5md_writer)
    # only rank 0 of a mesh writes files
    writes = mesh is None or mesh.rank == 0
    t_wall = time.time()

    out_prefix = args.output_prefix
    out_dir = os.path.dirname(out_prefix)
    if writes and out_dir and not os.path.isdir(out_dir):
        os.makedirs(out_dir)
    if writes:
        parser.save_to_file("%s_params.out" % out_prefix, args)

    if args.debug:
        # "logger1:regex,logger2": raise each named logger to DEBUG and,
        # when a regex is given, filter its messages by message text or
        # function name (ref: start_simulation.py:65-72, app_args.py:60-68)
        for item in args.debug.split(","):
            name_filter = item.split(":", 1)
            lg = logging.getLogger(name_filter[0].strip())
            lg.setLevel(logging.DEBUG)
            if len(name_filter) == 2:
                lg.addFilter(tools.RegexpFilter(name_filter[1]))

    if args.coulomb_kappa:
        # accepted-but-unused in the reference as well (only declared,
        # ref: app_args.py:155); warn instead of silently ignoring
        print("WARNING: --coulomb_kappa is accepted but has no effect "
              "(truncated Coulomb only, as in the reference)")

    table_dirs = (os.path.dirname(os.path.abspath(args.top)) or ".", ".")

    logger.info("reading topology %s", args.top)
    excl_path = args.exclusion_list
    if excl_path and not os.path.exists(excl_path):
        alt = os.path.join(table_dirs[0], excl_path)
        if os.path.exists(alt):
            excl_path = alt
        else:
            print("WARNING: exclusion list %s not found; generating "
                  "exclusions from the topology instead" % excl_path)
            excl_path = None
    systop = build_system_topology(args.top, generate_excl=excl_path is None)
    if excl_path:
        excl = set()
        with open(excl_path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if len(parts) >= 2:
                    a, b = int(parts[0]), int(parts[1])
                    excl.add((min(a, b), max(a, b)))
        systop.exclusions = excl

    coords = files_io.read_coordinates(args.conf)
    print("Reads %d particles" % coords.n_atoms)
    vol = float(np.prod(coords.box))
    print("Density: %s kg/m^3" % (systop.masses.sum() * args.mass_factor
                                  / vol))
    print("Box: %s nm" % coords.box)

    rcfg = None
    if args.reactions:
        rcfg = reaction_parser.parse_config(args.reactions)

    collector = _ConversionCollector()
    criteria = []
    if args.maximum_conversion:
        criteria = tools.parse_maximum_conversion(args.maximum_conversion,
                                                  systop, collector)
    if args.count_types:
        for label, tid in tools.parse_count_types(args.count_types, systop):
            collector.register([(tid, None)], 1)
    if args.count_types_state:
        for label, tid, stt in tools.parse_count_types_state(
                args.count_types_state, systop):
            collector.register([(tid, stt)], 1)

    opts = build_sim_options(args, table_dirs)
    if mesh is not None:
        opts = dataclasses.replace(opts, slab_devices=mesh.world_size)
    built = build.build_system(systop, coords, opts, reaction_config=rcfg,
                               extra_conversions=collector.items,
                               device=device)
    cfg, spec = built.cfg, built.spec
    if mesh is not None:
        from .parallel import sharding

        cfg = sharding.meshed_cfg(cfg, mesh)
        print("Device mesh: %d x %s (the pair sum split by x-slab; every "
              "rank holds the whole state)" % (mesh.world_size, device.type))
    state = runner.initial_forces(spec, cfg, built.state)
    print("Particles: %d (padded %d), types: %d, reactions: %d" % (
        cfg.n_particles, cfg.n_pad, cfg.n_types, cfg.n_reactions))
    # type table + reaction wiring (the reference's startup echo)
    print("Type name    type id")
    for sym in sorted(systop.atomsym_atomtype,
                      key=systop.atomsym_atomtype.get):
        print("%-12s %d" % (sym, systop.atomsym_atomtype[sym]))
    if built.reactions:
        t2s = systop.atomtype_atomsym
        ch = built.reactions.channels
        for ridx, eq in built.reactions.reaction_index.items():
            kind = ("dissociation" if ch["r_is_diss"][ridx]
                    else "exchange" if ch["r_cnb_type"][ridx] >= 0
                    else "normal")
            print("Reaction_type: %s" % kind)
            print("Setup reaction: %s(%d)-%s(%d)  [%s]" % (
                t2s.get(int(ch["r_t1"][ridx]), "?"), ch["r_min1"][ridx],
                t2s.get(int(ch["r_t2"][ridx]), "?"), ch["r_min2"][ridx], eq))
            for side, nt in (("type_1", ch["r_new_type1"][ridx]),
                             ("type_2", ch["r_new_type2"][ridx])):
                if nt >= 0:
                    print("Reaction %d: %s change type -> %s" % (
                        ridx, side, t2s.get(int(nt), "?")))

    # remap collector indices -> engine observable ids
    for c in criteria:
        if c.kind == "conversion":
            c.obs_idx = built.extra_obs_idx[c.obs_idx]

    # the run's noise stream, checkpointed with the state
    gen = runner.make_generator(args.rng_seed, device)
    if args.restore:
        from . import checkpoint
        state, cfg = checkpoint.load_state(args.restore, state, cfg=cfg,
                                           spec=spec, gen=gen)
        print("Restored device state from %s (step %d)"
              % (args.restore, int(state.step)))
    else:
        # remove center-of-mass drift (ref: start_simulation.py:680-682)
        from .engine import observables as obs_mod
        state = dataclasses.replace(
            state,
            vel=obs_mod.reset_cm_velocity(state.mass, state.vel,
                                          state.active))

    # --hooks none disables the ./hooks.py auto-pickup without needing a
    # /dev/null workaround
    hooks_path = args.hooks or (
        "hooks.py" if os.path.exists("hooks.py") else None)
    if args.hooks in ("none", "off"):
        hooks_path = None
    hooks = _load_hooks(hooks_path)
    ctx = SimulationContext(args=args, systop=systop, built=built,
                            state=state)
    _call_hook(hooks, "hook_postsetup_reaction", ctx)
    state = ctx.device_state

    # ---- outputs ----
    store = {k for k, on in [
        ("position", args.store_position), ("species", args.store_species),
        ("state", args.store_state), ("mass", args.store_mass),
        ("res_id", args.store_res_id), ("charge", args.store_charge),
        ("velocity", args.store_velocity), ("force", args.store_force),
        ("lambda_adr", args.store_lambda)] if on}
    if writes:
        h5 = _writer_class(h5md_writer)(
            args.output_file, cfg.n_particles, state.box, store=store,
            single_precision=args.store_single_precision,
            chunk_size=256)  # ref: start_simulation.py:591
        emon = writers.SystemMonitorCSV("%s_energy.csv" % out_prefix)
    else:
        h5 = emon = _NoOutput()
    h5.write_parameters(args, force_field=systop.top.atomtypes)

    def dump_frame(st, step):
        kw = {}
        n = cfg.n_particles
        fields = [("position", "position", st.pos),
                  ("species", "species", st.type_id),
                  ("state", "state", st.chem_state),
                  ("mass", "mass", st.mass), ("res_id", "res_id", st.res_id),
                  ("charge", "charge", st.q),
                  ("velocity", "velocity", st.vel),
                  ("force", "force", st.force),
                  ("lambda_adr", "lam", st.lam)]
        for name, key, t in fields:
            if name in store:
                kw[key] = t[:n].cpu().numpy()
        if "position" in store:
            kw["image"] = st.image[:n].cpu().numpy()
        h5.dump(step, step * args.dt, **kw)

    def dump_topology(st, step):
        """DumpTopology analog: -1-padded connectivity tables per list
        (ref: start_simulation.py:594-657)."""
        t = step * args.dt
        grp = st.bonds.group.cpu().numpy()
        idx = st.bonds.idx.cpu().numpy()
        if cfg.has_reactions:
            for g in range(cfg.n_groups):
                h5.dump_connectivity("chem_bonds_%d" % g, step, t,
                                     np.where((grp == g)[:, None], idx, -1))
        h5.dump_connectivity("bonds_0", step, t,
                             np.where((grp < 0)[:, None], idx, -1))
        if args.store_angdih:
            h5.dump_connectivity("angles_0", step, t,
                                 st.angles.idx.cpu().numpy())
            if st.dihedrals.capacity > 1:
                h5.dump_connectivity("dihedrals_0", step, t,
                                     st.dihedrals.idx.cpu().numpy())

    # ---- reaction observability files ----
    # accepted-pair distance dump (ref: reaction_parser.py:198) + FreezeRegion
    # stats (ref: reaction_post_process.py:146-148) + per-interval running
    # reaction counters (ref: start_simulation.py:1027-1036)
    pair_dist_file = None
    freeze_stats_file = None
    counters_file = None
    last_ev_logged = -1
    if writes and rcfg and rcfg.get("general") and \
            rcfg["general"].get("pair_distances_filename"):
        pair_dist_file = rcfg["general"]["pair_distances_filename"]
        files_io.prepare_path(pair_dist_file)
        with open(pair_dist_file, "w") as f:
            f.write("# step reaction pid1 pid2 distance\n")
    if writes and cfg.has_freeze:
        freeze_stats_file = (built.reactions.freeze.get("stats_file")
                             or "%s_%d_freeze_stats.dat"
                             % (out_prefix, args.rng_seed))
        files_io.prepare_path(freeze_stats_file)
        with open(freeze_stats_file, "w") as f:
            f.write("# step frozen_total\n")
    if writes and cfg.has_reactions and built.reactions:
        # running per-interval series; the final-total file written in the
        # output phase keeps the reference's name
        counters_file = "%s_reaction_counters_series.csv" % out_prefix
        files_io.prepare_path(counters_file)
        with open(counters_file, "w") as f:
            f.write("step,intra,inter,%s\n" % ",".join(
                "r_%d" % i for i in sorted(built.reactions.reaction_index)))

    def dump_reaction_observables(st, step):
        nonlocal last_ev_logged
        if pair_dist_file is not None:
            fired = int(st.ev_log_step)
            if fired >= 0 and fired != last_ev_logged:
                last_ev_logged = fired
                va = st.ev_log_a.cpu().numpy()
                sel = va >= 0
                if sel.any():
                    vb = st.ev_log_b.cpu().numpy()[sel]
                    vr = st.ev_log_r.cpu().numpy()[sel]
                    vd = st.ev_log_dist.cpu().numpy()[sel]
                    with open(pair_dist_file, "a") as f:
                        for a_, b_, r_, d_ in zip(va[sel], vb, vr, vd):
                            f.write("%d %d %d %d %.6f\n"
                                    % (fired, r_, a_ + 1, b_ + 1, d_))
        if freeze_stats_file is not None:
            with open(freeze_stats_file, "a") as f:
                f.write("%d %d\n" % (step, int(st.freeze_count)))
        if counters_file is not None:
            counts = st.reaction_counts.cpu().numpy()
            intra = st.intra_counts.cpu().numpy()
            with open(counters_file, "a") as f:
                f.write("%d,%d,%d,%s\n" % (step, intra[0], intra[1],
                                           ",".join(str(c) for c in counts)))

    # ---- main loop (ref: start_simulation.py:728-797) ----
    # the block size must divide every collection interval, or frames would
    # silently stretch/skip (the reference clamps int_step to trj_collect
    # the same way, ref :102, :266-270)
    integrator_step = args.int_step
    if cfg.has_reactions:
        integrator_step = min(integrator_step, cfg.reaction_interval)
    for iv in (args.trj_collect, args.topol_collect, args.energy_collect,
               args.trj_flush, args.gro_trj_collect):
        if iv:
            integrator_step = min(integrator_step, iv)
    sim_steps = args.run // integrator_step
    print("Running %d blocks x %d steps" % (sim_steps, integrator_step))

    ctx.device_state = state
    if not _call_hook(hooks, "hook_before_sim", ctx):
        raise RuntimeError("hook_before_sim returned False")
    state = ctx.device_state

    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def on_device(flag: bool):
        return torch.tensor(flag, device=device)

    reactions_enabled = False
    reactions_started = False   # one-shot latch: start_ar fires exactly once
    caps_retuned = args.retune_caps < 0   # one-shot --retune_caps latch
    caps_presized = not (args.presize_caps or args.cap_ladder)
    cap_ladder_rungs = []    # planned (caps, excl) rungs, FIFO
    ladder_rate_w1 = None    # first append-rate window (burst; min'd away)
    conversion_reached = False
    eq_blocks_left = None
    need_bond_counts = any(c.kind == "bond_count" for c in criteria)
    rate_file = None
    if writes and args.rate_arrhenius:
        # "step new_rate" rows, one per block with new bonds (ref:
        # start_simulation.py:712-714,794)
        rate_file = open("%s_%d_new_rates.csv" % (out_prefix, args.rng_seed),
                         "w")
    t_loop = time.time()
    k = 0
    prev_counts = None   # last block's term counts (rate-aware cap growth)
    global_step = int(state.step)   # nonzero when resuming from a checkpoint
    energy_every = max(args.energy_collect // max(integrator_step, 1), 1)
    while k < sim_steps:
        # the full measure() reruns every force term; do it only when an
        # energy row is due (or Arrhenius rate updates need epot each block)
        # — per-block bookkeeping (stop criteria, overflow) is force-free
        full_due = (k % energy_every == 0) or args.rate_arrhenius
        if full_due:
            m = _host_dict(runner.measure(spec, cfg, state))
        else:
            m = _host_dict(runner.measure_cheap(spec, cfg, state))
        conv = m["conversions"].numpy()
        if full_due:
            row = {"step": global_step, "time": global_step * args.dt,
                   "T": float(m["T"]) / args.kb, "ekin": float(m["ekin"]),
                   "epot": float(m["epot"])}
            for name in built.term_names:
                if name in m:
                    row[name] = float(m[name])
            for kk in ("lj", "lj-tab", "coulomb", "lj14", "coulomb14"):
                if kk in m:
                    row[kk] = float(m[kk])
            for oi in range(len(built.obs.keys)):
                row[built.obs.label(oi)] = conv[oi]
            if cfg.n_groups:
                for gi, c in enumerate(m["group_bonds"].numpy()):
                    row["count_group_%d" % gi] = int(c)
            if args.count_tuples:
                row["n_bonds"] = int(m["n_bonds"])
                row["n_angles"] = int(m["n_angles"])
                row["n_dihedrals"] = int(m["n_dihedrals"])
                row["n_excl"] = int(m["n_excl"])
            if args.count_fix_distances and "num_fix_distances" in m:
                row["fd_count"] = int(m["num_fix_distances"])
            if "P" in m:
                row["P"] = float(m["P"])
                row["boxL"] = float(m["boxL"])
            if "res_fpl" in m:
                row["res_fpl"] = float(m["res_fpl"])
            if "pair_scale" in m:
                row["pair_scale_1"] = int(m["pair_scale"])
            emon.row(row)
        if k % energy_every == 0:
            shown = {kk: v for kk, v in row.items()
                     if not args.system_monitor_filter
                     or kk in args.system_monitor_filter.split(",")}
            print(" ".join("%s=%.4g" % kv for kv in shown.items()))
        # Capacity management: term tables (bonds/angles/dihedrals/exclusions)
        # grow PROACTIVELY near their cap so no reaction event is ever dropped
        # (the reference's FixedLists reallocate freely); the neighbor caps
        # grow reactively off the sticky overflow flag.  When both fire at
        # once, term growth clears the flag and a genuine neighbor overflow
        # re-fires on the next block.
        counts = {kk: int(m[kk]) for kk in
                  ("n_bonds", "n_angles", "n_dihedrals", "n_excl",
                   "n_bonds_irr", "n_angles_irr") if kk in m}
        counts["excl_pair_cap"] = state.excl.shape[0]
        if cfg.has_reactions and build.term_caps_near_full(
                cfg, counts, prev_counts=prev_counts):
            while cap_ladder_rungs and build.term_caps_near_full(
                    cfg, counts, prev_counts=prev_counts):
                # the next planned rung: a re-pad
                caps_r, excl_r = cap_ladder_rungs.pop(0)
                cfg, state = build.apply_term_caps(cfg, state, caps_r, excl_r)
                counts["excl_pair_cap"] = state.excl.shape[0]
                print("capacity: ladder rung to bonds=%d angles=%d excl=%d"
                      % (cfg.bond_cap, cfg.angle_cap, state.excl.shape[0]))
            if build.term_caps_near_full(cfg, counts,
                                         prev_counts=prev_counts):
                cfg, state = build.grow_term_caps(cfg, state, counts=counts,
                                                  prev_counts=prev_counts)
                print("capacity: term tables regrown to bonds=%d angles=%d "
                      "dihedrals=%d excl=%d" % (cfg.bond_cap, cfg.angle_cap,
                                                cfg.dihedral_cap,
                                                state.excl.shape[0]))
        elif bool(m["overflow"]):
            cfg, state = build.grow_neighbor_caps(cfg, spec, state)
            print("capacity overflow: neighbor caps regrown to K=%d cell=%d"
                  % (cfg.max_neighbors, cfg.cell_cap))
        elif (not caps_presized and cfg.has_reactions
                and reactions_enabled and prev_counts is not None
                and any(counts.get(kk, 0) > prev_counts.get(kk, 0)
                        for kk in ("n_bonds", "n_angles", "n_dihedrals",
                                   "n_excl"))):
            window = {kk: counts[kk] - prev_counts.get(kk, counts[kk])
                      for kk in counts if kk != "excl_pair_cap"}
            if args.cap_ladder and ladder_rate_w1 is None:
                # first reactive window rides the activation burst and
                # overstates the steady rate 2-3x: hold for a second window
                # and take the elementwise min
                ladder_rate_w1 = window
            elif args.cap_ladder:
                caps_presized = True
                rate = {kk: min(ladder_rate_w1.get(kk, v), v)
                        / max(integrator_step, 1)
                        for kk, v in window.items()}
                plan = max(sim_steps - k, 0) * integrator_step
                cap_ladder_rungs = build.plan_cap_ladder(
                    cfg, state, counts, rate, plan, rungs=args.cap_ladder)
                # nothing to precompile: a rung is applied when the
                # trigger fires
                print("capacity: %d ladder rung(s) planned for %d steps "
                      "(top: bonds=%d angles=%d)"
                      % (len(cap_ladder_rungs), plan,
                         cap_ladder_rungs[-1][0].get("bond_cap",
                                                     cfg.bond_cap)
                         if cap_ladder_rungs else cfg.bond_cap,
                         cap_ladder_rungs[-1][0].get("angle_cap",
                                                     cfg.angle_cap)
                         if cap_ladder_rungs else cfg.angle_cap))
            else:
                # one-shot: size the term tables for the whole remaining run
                # from the first reactive block's measured append rate
                # (rate-aware growth above stays the backstop)
                caps_presized = True
                plan = max(sim_steps - k, 0) * integrator_step
                cfg, state = build.presize_term_caps(
                    cfg, state, counts, prev_counts, integrator_step, plan)
                print("capacity: term tables presized for %d steps to "
                      "bonds=%d angles=%d dihedrals=%d excl=%d"
                      % (plan, cfg.bond_cap, cfg.angle_cap, cfg.dihedral_cap,
                         state.excl.shape[0]))
        prev_counts = counts

        if args.trj_collect and global_step % args.trj_collect == 0:
            dump_frame(state, global_step)
        if global_step % args.topol_collect == 0:
            dump_topology(state, global_step)
        if args.trj_flush and global_step % args.trj_flush == 0:
            h5.flush()
        if (writes and args.gro_trj_collect
                and global_step % args.gro_trj_collect == 0):
            files_io.write_gro("%s_traj.gro" % out_prefix,
                               writers.state_to_coordinates(state, systop,
                                                            coords),
                               backup=False, append=global_step > 0)

        if not caps_retuned and global_step >= args.retune_caps:
            caps_retuned = True
            old = (cfg.max_neighbors, cfg.cell_cap)
            old_t = (cfg.bond_cap, cfg.angle_cap)
            cfg, state = build.shrink_neighbor_caps(cfg, spec, state)
            cfg, state = build.shrink_term_caps(cfg, state)
            if (cfg.max_neighbors, cfg.cell_cap) != old or \
                    (cfg.bond_cap, cfg.angle_cap) != old_t:
                print("caps retuned at step %d: K %d->%d cell %d->%d "
                      "bonds %d->%d angles %d->%d"
                      % (global_step, old[0], cfg.max_neighbors,
                         old[1], cfg.cell_cap, old_t[0], cfg.bond_cap,
                         old_t[1], cfg.angle_cap))
            else:
                print("caps kept at step %d: K %d cell %d bonds %d angles %d "
                      "(the observed occupancy needs them)"
                      % ((global_step,) + old + old_t))

        # enable reactions at start_ar, exactly once (ref: :735-757)
        if (cfg.has_reactions and not reactions_started
                and global_step >= args.start_ar):
            if writes and args.save_before_reaction:
                files_io.write_gro("%s_before_reaction.gro" % out_prefix,
                                   writers.state_to_coordinates(state, systop,
                                                                coords))
            state = dataclasses.replace(state, reactions_on=on_device(True))
            ctx.device_state = state
            if not _call_hook(hooks, "hook_init_reaction", ctx):
                raise RuntimeError("hook_init_reaction returned False")
            state = ctx.device_state
            reactions_started = True
            reactions_enabled = True
            print("Chemical reactions enabled at step %d" % global_step)
        if (cfg.has_reactions and reactions_enabled and args.stop_ar >= 0
                and global_step >= args.stop_ar):
            state = dataclasses.replace(state, reactions_on=on_device(False))
            reactions_enabled = False

        # stop criteria: ANY satisfied criterion stops, checked only once
        # reactions run (ref: :759-770)
        if criteria and reactions_enabled and not conversion_reached:
            bond_counts = (_bond_type_counts(state, cfg.n_types)
                           if need_bond_counts else {})
            if tools.criteria_reached(criteria, conv, bond_counts):
                conversion_reached = True
                eq_blocks_left = args.eq_steps
                state = dataclasses.replace(state,
                                            reactions_on=on_device(False))
                print("Maximum conversion reached at step %d" % global_step)
        if conversion_reached:
            if eq_blocks_left <= 0 and not args.keep_simulation:
                break
            eq_blocks_left -= 1

        state = runner.run_block(spec, cfg, state, integrator_step,
                                 rng_seed=args.rng_seed, gen=gen)
        global_step += integrator_step
        k += 1
        if reactions_enabled or cfg.has_freeze:
            dump_reaction_observables(state, global_step)

        if (writes and args.checkpoint_interval
                and k % args.checkpoint_interval == 0):
            from . import checkpoint
            checkpoint.save_state("%s_checkpoint.npz" % out_prefix, state,
                                  cfg=cfg, gen=gen, rng_seed=args.rng_seed)

        if args.check_topology:
            problems = check_topology(state)
            if problems:
                raise RuntimeError("topology inconsistent at step %d: %s"
                                   % (global_step, problems[:3]))

        ctx.device_state, ctx.step = state, global_step
        if not _call_hook(hooks, "hook_at_step", ctx, global_step):
            break
        state = ctx.device_state

        if args.rate_arrhenius and cfg.has_reactions:
            # rate = exp(-deltaE / kT) per new bond (ref: :785-796)
            m2 = _host_dict(runner.measure(spec, cfg, state))
            d_epot = float(m2["epot"]) - float(m["epot"])
            n_new = int(m2["reaction_counts"].sum()
                        - m["reaction_counts"].sum())
            if n_new > 0:
                new_rate = math.exp(-(d_epot / n_new) /
                                    (args.kb * args.temperature))
                state = dataclasses.replace(
                    state, reaction_rates=torch.full_like(
                        state.reaction_rates, new_rate))
                if rate_file is not None:
                    rate_file.write("%d %e\n" % (global_step, new_rate))
                    rate_file.flush()

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_loop = time.time() - t_loop
    if rate_file is not None:
        rate_file.close()
    if prof is not None:
        prof.stop()
    if prof is not None and writes:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "trace.json"))
        print("profiler trace written to %s" % args.profile_dir)
    ctx.device_state = state
    _call_hook(hooks, "hook_end", ctx)
    state = ctx.device_state

    # ---- output phase (ref: start_simulation.py:800-1082) ----
    dump_frame(state, global_step)
    dump_topology(state, global_step)
    h5.flush()
    h5.close()
    emon.close()

    if writes:
        _write_final_files(out_prefix, state, systop, coords, cfg, built)

    if mesh is not None:
        n_devices = mesh.world_size
    else:
        n_devices = torch.cuda.device_count() if device.type == "cuda" else 1
    bench_path = args.benchmark_data or "%s_benchmark.csv" % out_prefix
    if writes:
        with open(bench_path, "a") as f:
            f.write("%d %d %.2f %.2f\n" % (n_devices, cfg.n_particles,
                                           time.time() - t_wall, t_loop))
    # timer breakdown pickle (ref: start_simulation.py:1040-1076)
    import pickle

    timers = {
        "total": time.time() - t_wall,
        "integrator_loop": t_loop,
        "steps": global_step,
        "n_devices": n_devices,
        "neighbor_rebuilds": int(state.nbr.n_rebuilds),
    }
    if args.timers:
        # per-phase breakdown (ref: start_simulation.py:1040-1076 prints the
        # espressopp per-interaction timer dict; here each phase runs on its
        # own against the final state)
        from .engine import perf

        phases = perf.phase_timers(spec, cfg, state)
        timers.update(phases)
        print(perf.format_timers(phases))
    if writes:
        with open("%s_benchmark.pck" % out_prefix, "wb") as f:
            pickle.dump(timers, f)
    pps = cfg.n_particles * global_step / max(t_loop, 1e-9)
    print("Total time: %.1fs, loop: %.1fs, particle-steps/s: %.3g" % (
        time.time() - t_wall, t_loop, pps))
    print("finished")
    return 0


if __name__ == "__main__":
    sys.exit(main())
