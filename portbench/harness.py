"""One run of a cell: set-up from the seed, the measured window, the
per-layer readers, the comparison that decides ``correct``, and the
result line.

The cell, its configuration, its traffic and its per-layer metrics are
files found by name (``portbench/workloads/<cell>.json``,
``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py``), so a cell, a configuration or a metric is added
by adding files.  The program under test is ``chemlab_tpu_torch``; what
this module takes from it is the system, its step and its state.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import check, roofline, trace
from .reference import system as ref_system

BANNED = ("jax", "jaxlib", "flax", "chemlab_tpu")
# the settings of each barostat form: the configuration's name, the
# program's field of its spec
BAROSTAT_FIELDS = {"br": {"tau": "barostat_tau"},
                   "lv": {"mass": "barostat_mass",
                          "gammaP": "barostat_gammaP"}}


def load_json(root: Path, kind: str, name: str) -> dict:
    path = Path(root) / "portbench" / kind / (name + ".json")
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str):
    """(cell, configuration, traffic) of the cell ``name``."""
    cell = load_json(root, "workloads", name)
    return (cell, load_json(root, "configs", cell["config"]),
            load_json(root, "traffic", cell["traffic"]))


def load_metric(root: Path, name: str):
    """The reader module ``portbench/metrics/<name>.py``: ``read(ctx)``
    returns the metric's value, or None where it finds nothing to read."""
    path = Path(root) / "portbench" / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    def mine(m):
        return "workloads" not in m or cell in m["workloads"]
    return ([m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (whole names: ``chemlab_tpu_torch`` is not ``chemlab_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def sub_seeds(seed: int) -> dict:
    """The run's streams, all drawn from ``--seed``: the coordinates, the
    velocities after the descent, the initiators, the Langevin noise, the
    reaction draws and the check's noise."""
    vals = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(6)
    names = ("coords", "velocity", "initiators", "langevin", "reactions",
             "check")
    return {k: int(v) for k, v in zip(names, vals)}


def process_seconds() -> float:
    """Seconds since this process started (Linux's process start time),
    or since this module was imported where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


@dataclasses.dataclass
class Program:
    """The program's modules, imported once the card is known to be
    there."""
    testsystems: object
    build: object
    runner: object
    integrate: object
    bonded_forces: object


def import_program() -> Program:
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import (bonded_forces, build, integrate,
                                          runner)
    return Program(testsystems, build, runner, integrate, bonded_forces)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _stage(name: str, device, t0: float) -> float:
    """Print the set-up stage's seconds (device synchronized) to standard
    error; returns the clock for the next stage."""
    _sync(device)
    t1 = time.perf_counter()
    print("portbench: %s %.3f s" % (name, t1 - t0), file=sys.stderr,
          flush=True)
    return t1


def cap_step(prog: Program, cfg, spec, state, prev_counts):
    """The CLI's decisions at a block's end: one ``measure_cheap``, the
    term tables regrown before they fill, the neighbour caps regrown
    after an overflow.  Returns (cfg, state, counts, flagged): flagged
    when the overflow had latched or the state held a non-finite
    value."""
    m = prog.runner.measure_cheap(spec, cfg, state)
    finite = torch.isfinite(state.pos).all() & torch.isfinite(state.vel).all()
    counts = {k: int(m[k]) for k in ("n_bonds", "n_angles", "n_dihedrals",
                                     "n_excl", "n_bonds_irr",
                                     "n_angles_irr") if k in m}
    counts["excl_pair_cap"] = state.excl.shape[0]
    overflow = bool(m["overflow"])
    flagged = overflow or not bool(finite)
    if cfg.has_reactions and prog.build.term_caps_near_full(
            cfg, counts, prev_counts=prev_counts):
        cfg, state = prog.build.grow_term_caps(cfg, state, counts=counts,
                                               prev_counts=prev_counts)
    elif overflow:
        cfg, state = prog.build.grow_neighbor_caps(cfg, spec, state)
    return cfg, state, counts, flagged


def check_barostat(sys_, cfg, spec):
    """Raise where the barostat the program built is not the
    configuration's ``system.barostat`` (its form, P0, and tau or the
    piston's mass and friction), or where it built one the configuration
    has not."""
    want = sys_.barostat
    if want is None:
        if cfg.barostat != "no":
            raise RuntimeError("the program runs the barostat %r, the "
                               "configuration none" % cfg.barostat)
        return
    got = {"form": cfg.barostat, "pressure": float(spec.pressure)}
    ref = {"form": want.form, "pressure": float(np.float32(want.pressure))}
    for mine, theirs in BAROSTAT_FIELDS[want.form].items():
        got[mine] = float(getattr(spec, theirs))
        ref[mine] = float(np.float32(getattr(want, mine)))
    if got != ref:
        raise RuntimeError("the program's barostat %s, the configuration's "
                           "%s" % (got, ref))


@dataclasses.dataclass
class Setup:
    spec: object
    cfg: object
    state: object
    gen: object
    start: dict
    n_mols: int
    tables: object
    table_dir: str


def set_up(prog: Program, conf: dict, traffic: dict, seeds: dict, device,
           sys_, overrides: dict) -> Setup:
    """Build from the seed, descend, retune the caps, activate the
    initiators, run the untimed blocks and regrow: everything before the
    window, with every shape the window uses warmed."""
    args = dict(conf["args"])
    args.update(overrides.get("args", {}))
    kw = dict(args, seed=seeds["coords"], device=device)
    table_dir, tables = None, None
    if sys_.pair["kind"] == "table":
        table_dir = tempfile.mkdtemp(prefix="portbench_tables_")
        ref_system.write_tables(table_dir, sys_.types, sys_.pair["table"])
        tables = ref_system.read_tables(table_dir, sys_.types)
        kw["table_dir"] = table_dir
    t = time.perf_counter()
    built, systop, _ = getattr(prog.testsystems, conf["builder"])(**kw)
    t = _stage("build", device, t)
    want = {name: k for k, name in enumerate(sys_.types)}
    if dict(systop.atomsym_atomtype) != want:
        raise RuntimeError("the program numbers the types %s, the "
                           "configuration %s" % (systop.atomsym_atomtype,
                                                 want))
    check_barostat(sys_, built.cfg, built.spec)
    start = check.snapshot_topology(built.state)
    spec, cfg = built.spec, built.cfg
    steps = overrides.get("descent_steps", traffic["descent_steps"])
    block = traffic["block_steps"]
    if not cfg.reaction_interval == traffic["reaction_interval"] == block:
        # one reaction step a block, at its end: the check reads the
        # state before it from the block's start
        raise RuntimeError("the traffic's reaction interval %d and block "
                           "of %d steps are not the build's interval %d"
                           % (traffic["reaction_interval"], block,
                              cfg.reaction_interval))
    state = prog.runner.initial_forces(spec, cfg, built.state)
    state = prog.testsystems.warmup(built, state, steps=steps,
                                    max_disp=traffic["descent_max_disp"],
                                    seed=seeds["velocity"])
    t = _stage("descent", device, t)
    cfg, state = prog.build.shrink_neighbor_caps(cfg, spec, state)
    cfg, state = prog.build.shrink_term_caps(cfg, state)
    t = _stage("retune", device, t)
    n_init = max(cfg.n_particles // traffic["particles_per_initiator"], 4)
    state = prog.testsystems.activate_initiators(built, systop, state,
                                                 n=n_init,
                                                 seed=seeds["initiators"])
    gen = prog.runner.make_generator(seeds["langevin"], device)
    for _ in range(traffic["untimed_blocks"]):
        state = prog.runner.run_block(spec, cfg, state, block,
                                      rng_seed=seeds["reactions"], gen=gen)
    t = _stage("untimed block", device, t)
    prev = None
    for _ in range(traffic["regrow_blocks"]):
        cap0 = (cfg.max_neighbors, cfg.cell_cap, cfg.bond_cap,
                cfg.angle_cap, state.excl.shape[0])
        cfg, state, prev, _ = cap_step(prog, cfg, spec, state, prev)
        if cap0 == (cfg.max_neighbors, cfg.cell_cap, cfg.bond_cap,
                    cfg.angle_cap, state.excl.shape[0]):
            break
        state = prog.runner.run_block(spec, cfg, state, block,
                                      rng_seed=seeds["reactions"], gen=gen)
    _stage("regrowth", device, t)
    return Setup(spec=spec, cfg=cfg, state=state, gen=gen, start=start,
                 n_mols=args["n_mols"], tables=tables, table_dir=table_dir)


@dataclasses.dataclass
class Window:
    blocks: int
    failed: int
    wall_s: float
    block_s: float        # median wall time of the untraced blocks
    prev_state: object
    state: object
    cfg: object
    trace: object


def run_window(prog: Program, su: Setup, traffic: dict, seeds: dict,
               seconds: float, device, traced: bool) -> Window:
    """Whole blocks until ``seconds`` have passed: the window closes at
    the end of the block in which they do.  Each block ends with the
    CLI's ``measure_cheap`` and cap decisions.  With ``traced`` the first
    block runs under the profiler, and the window holds at least one
    untraced block after it, whose wall time the profiler does not
    stretch."""
    block = traffic["block_steps"]
    cfg, state, spec = su.cfg, su.state, su.spec
    blocks = failed = 0
    prev_counts = None
    tr = None
    ends = []
    t0 = time.perf_counter()
    while True:
        prev_state = state
        if traced and blocks == 0:
            out = {}

            def one_block():
                out["s"] = prog.runner.run_block(
                    spec, cfg, state, block, rng_seed=seeds["reactions"],
                    gen=su.gen)
            tr = trace.capture(one_block, block, device)
            state = out["s"]
        else:
            state = prog.runner.run_block(spec, cfg, state, block,
                                          rng_seed=seeds["reactions"],
                                          gen=su.gen)
        cfg, state, prev_counts, flagged = cap_step(prog, cfg, spec, state,
                                                    prev_counts)
        failed += int(flagged)
        blocks += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds and blocks >= 1 + int(traced):
            break
    _sync(device)
    wall = time.perf_counter() - t0
    print("portbench: block ends (s) %s" % " ".join(
        "%.3f" % e for e in ends), file=sys.stderr, flush=True)
    walls = np.diff([0.0] + ends)[int(traced):]
    return Window(blocks=blocks, failed=failed, wall_s=wall,
                  block_s=float(np.median(walls)), prev_state=prev_state,
                  state=state, cfg=cfg, trace=tr)


def program_step(prog: Program, su: Setup, win: Window, seeds: dict,
                 device) -> dict:
    """The program's outputs for the check, as host arrays: one more step
    from the window's end state with noise from the seed, and the
    topology before and after the window's last reaction step.  Under a
    barostat also the box after the step, the piston's velocity before it
    and its draw, the positions before the scaling (``check.unscale``)
    and the program's pressure of the state its barostat read.  The
    program's state is freed here, before the reference runs."""
    t = time.perf_counter()
    state, spec, cfg = win.state, su.spec, win.cfg
    n = state.pos.shape[0]
    g = torch.Generator(device=device)
    g.manual_seed(seeds["check"])
    noise = torch.randn((n, 3), generator=g, dtype=torch.float32,
                        device=device)
    draws = None
    if cfg.barostat == "lv":
        draws = {"baro": torch.randn((), generator=g, dtype=torch.float32,
                                     device=device)}
    gates = {"reaction": False, "atrp": False, "cpt": False}
    s1 = prog.runner.step_with_extensions(spec, cfg, state,
                                          seeds["reactions"], gates=gates,
                                          noise=noise, draws=draws)
    n_act = check.active_count(state)
    arrays = {k: check._np(v)[:n_act] for k, v in dict(
        x0=state.pos, v0=state.vel, f0=state.force, mass=state.mass,
        noise=noise, x1=s1.pos, v1=s1.vel, f1=s1.force).items()}
    arrays["box"] = check._np(state.box)
    if cfg.barostat != "no":
        # the state the barostat read is the step's end state before the
        # scaling: the same but for the positions, the box and the
        # piston's velocity, which the barostat alone writes.  Its
        # positions are worked out from the scaled ones (float32 products
        # with one mu, so exactly, or within a rounding where the product
        # was taken otherwise); the program's own virial_pressure reads it.
        x1, _ = check.unscale(arrays["x1"], arrays["box"], check._np(s1.box))
        pos = s1.pos.clone()
        pos[:n_act] = torch.as_tensor(x1, device=pos.device)
        read = dataclasses.replace(s1, pos=pos, box=state.box,
                                   baro_v=state.baro_v)
        arrays.update(
            x1s=arrays["x1"], x1=x1, box1=check._np(s1.box),
            p1=float(prog.integrate.virial_pressure(spec, cfg, read)),
            baro_v0=float(state.baro_v),
            xi=float(draws["baro"]) if draws else 0.0)
        del read, pos
    out = {"pre": check.snapshot_topology(win.prev_state),
           "post": check.snapshot_topology(state), "arrays": arrays,
           "step": int(state.step)}
    del s1, state
    win.state = win.prev_state = None
    su.state = None
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    _stage("check: the program's step", device, t)
    return out


def compare(sys_, su: Setup, out: dict, seeds: dict, device,
            control_dtype=None):
    """(numbers compared, events of the checked reaction step).  With
    ``control_dtype`` the reference in that precision stands in the
    program's step (the control)."""
    t = time.perf_counter()
    start = ref_system.start_topology(sys_, su.n_mols)
    numbers = {"start_mismatch": float(check.start_mismatch(
        sys_, su.n_mols, su.start, start))}
    # the configuration's masses, not the program's
    a = dict(out["arrays"], mass=np.full_like(out["arrays"]["mass"],
                                              sys_.mass))
    bad, want = check.reaction_mismatch(sys_, out["pre"], out["post"],
                                        a["x0"], a["box"], out["step"],
                                        seeds["reactions"], start.res,
                                        device)
    numbers["reaction_mismatch"] = float(bad)
    topo = (want["type_id"], want["bonds"], want["angles"], want["excl"])
    # the pressure's: no angle term changes under a uniform scaling
    baro_topo = (want["type_id"], want["bonds"], want["excl"])
    if control_dtype is not None:
        a["x1"], a["v1"], a["f1"] = check.reference_step(
            sys_, a["x0"], a["v0"], a["f0"], a["mass"], a["box"],
            a["noise"], *topo, su.tables, device, control_dtype)
        if sys_.barostat is not None:
            a["x1s"], a["box1"], a["p1"] = check.reference_barostat(
                sys_, a["x1"], a["v1"], a["mass"], a["box"], a["baro_v0"],
                a["xi"], *baro_topo, su.tables, device, control_dtype)
    scaled = None
    if sys_.barostat is not None:
        pg, bg, mu = check.barostat_gaps(
            sys_, a["x1"], a["v1"], a["mass"], a["box"], a["box1"], a["p1"],
            a["baro_v0"], a["xi"], *baro_topo, su.tables, device)
        scaled = (a["x1s"], mu)
    fg, dg, vg = check.step_gaps(
        sys_, a["x0"], a["v0"], a["f0"], a["mass"], a["box"], a["noise"],
        a["x1"], a["v1"], a["f1"], *topo, su.tables, device, scaled=scaled)
    numbers.update(force_gap=fg, drift_gap=dg, vel_gap=vg)
    if scaled is not None:
        numbers.update(pressure_gap=pg, box_gap=bg)
    _stage("check: the reference", device, t)
    return numbers, len(want["events"])


def check_run(prog: Program, su: Setup, win: Window, sys_, seeds: dict,
              device, limits: dict):
    """(correct, the numbers compared each with its limit, events of the
    checked reaction step)."""
    out = program_step(prog, su, win, seeds, device)
    numbers, events = compare(sys_, su, out, seeds, device)
    checks = {k: {"value": numbers[k], "limit": limits.get(k)}
              for k in check.names(sys_)}
    return check.judge(numbers, limits), checks, events


class Context:
    """What a per-layer reader may read: the trace of the traced block,
    the median wall time of the window's untraced blocks, and the program
    and its end state for the readers that time a layer on it."""

    def __init__(self, prog, su, win, sys_, seeds, device):
        self.prog = prog
        self.spec = su.spec
        self.cfg = win.cfg
        self.state = win.state
        self.trace = win.trace
        self.block_s = win.block_s
        self.sys = sys_
        self.seeds = seeds
        self.device = device
        self.tables = su.tables
        self._pairs = None

    @property
    def pair_kind(self) -> str:
        return self.sys.pair["kind"]

    def pairs(self) -> int:
        """Unordered pairs inside the cutoff in the end state (the
        benchmark's own count)."""
        if self._pairs is None:
            self._pairs = roofline.count_pairs(
                self.state.pos, self.state.box, float(self.sys.pair["cutoff"]))
        return self._pairs

    def device_ms(self, fn, reps: int = 20) -> float:
        """Device-event milliseconds of one ``fn()`` over ``reps`` calls
        after a warm one; None off the card."""
        if torch.device(self.device).type != "cuda":
            return None
        fn()
        torch.cuda.synchronize(self.device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(self.device)
        return a.elapsed_time(b) / reps

    def host_ms(self, fn, min_s: float = 0.25, min_calls: int = 3) -> float:
        """Host-clock milliseconds of one synchronized ``fn()``, over as
        many calls as take ``min_s`` (at least ``min_calls``) after a warm
        one; None off the card."""
        if torch.device(self.device).type != "cuda":
            return None
        fn()
        torch.cuda.synchronize(self.device)
        calls = 0
        t0 = time.perf_counter()
        while calls < min_calls or time.perf_counter() - t0 < min_s:
            fn()
            torch.cuda.synchronize(self.device)
            calls += 1
        return 1e3 * (time.perf_counter() - t0) / calls


def read_per_layer(root, metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        value = load_metric(root, m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run(root, workload: str, seed: int, seconds: float, traced: bool,
        device="cuda", overrides=None, guard=None):
    """One run of ``workload``; returns (result dict, checks dict).
    ``guard(stage)`` is called after the set-up and after the window."""
    overrides = overrides or {}
    root = Path(root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell, conf, traffic = load_cell(root, workload)
    e2e, per_layer = cell_metrics(bench, workload)
    sys_ = ref_system.load_system(conf["system"])
    seeds = sub_seeds(seed)
    prog = import_program()
    su = set_up(prog, conf, traffic, seeds, device, sys_, overrides)
    setup_s = process_seconds()
    if guard is not None:
        guard("set-up")
    n = check.active_count(su.state)
    try:
        win = run_window(prog, su, traffic, seeds, seconds, device, traced)
        if guard is not None:
            guard("window")
        peak = (torch.cuda.max_memory_allocated(device)
                if torch.device(device).type == "cuda" else 0)
        metrics = {}
        breakdown = None
        if traced:
            metrics = read_per_layer(root, per_layer, Context(
                prog, su, win, sys_, seeds, device))
            breakdown = {"device_ops": win.trace.device_ops,
                         "idle_gaps": win.trace.idle_gaps}
        else:
            names = {m["name"] for m in e2e}
            if "particle_steps_per_s" in names:
                metrics["particle_steps_per_s"] = {
                    "value": n * win.blocks * traffic["block_steps"]
                    / win.wall_s, "unit": "particle-steps/s"}
            if "setup_s" in names:
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        correct, checks, _ = check_run(prog, su, win, sys_, seeds, device,
                                       cell.get("limits", {}))
    finally:
        if su.table_dir:
            shutil.rmtree(su.table_dir, ignore_errors=True)
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
    result = {"correct": bool(correct), "attempted": win.blocks,
              "failed": win.failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, checks
