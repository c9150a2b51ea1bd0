"""The port's kernel matrix: every LJ pair kernel timed side by side on the
warmed reactive melt, then a run of the default path.

Usage, on a machine with a CUDA card (it fails without one, and never falls
back to the CPU)::

    python -m chemlab_tpu_torch.kernel_matrix [n_mols]
        [--tab | --lj | --k2 | --ladder]

``n_mols`` trimers, 3334 by default (10 002 particles).  Port of
``scripts/kernel_matrix.py``: it builds the reactive melt on the card, warms
it (600 descent steps), activates ``N // 300`` initiators and prints three
JSON lines:

  - ``{"n", "cell_cap", "dims"}``;
  - ``{"kernel_<kind>_ms": ...}``: the whole pair call of each kind
    (operand packing, kernel, the ``slot_of`` gather and the sums), timed
    with CUDA events over 20 calls after one: ``cell`` (K2), ``colt2`` (K1),
    ``colt1`` (K1'), ``packet`` (K3a), ``column`` (K3d:
    ``cell_pair_forces_columns`` with ``z_unroll=False``, as the reference
    script calls it), ``colz`` (K3c) and ``resident`` (K3b);
  - ``{"pps_fused_auto", "events", "overflow"}``: particle-steps per second
    over three timed 200-step Langevin blocks (after one untimed) through
    the default kernel, the reaction events and the overflow flag.

With ``--tab`` it times the Chebyshev pair kernels instead, on the warmed
reactive tabulated melt (K1c), the blended melt (K1d) and, for the sweep,
the tabulated melt tiled 2 x 2 x 2 at cap 32 and 40 (``tiled_operands``):

  - ``{"kernel_cheb_ms", "kernel_cheb_cellwise_ms"}``: the whole tabulated
    pair call through the column-segment kernel (``cell_pair_forces``) and
    the same call through the cellwise kernel, CUDA events over 20 calls;
  - one ``{"melt", "seg", "rows", "threads", "depth", "device_ms"}`` line
    per launch plan of ``CHEB_SWEEP`` (the kernel's device time by
    ``torch.profiler``, 30 calls), the cellwise kernel's first, then the
    list depths at the fastest plan: the sweep behind ``cell_pair``'s
    ``CHEB_*`` choices.

With ``--lj`` it times the LJ pair kernel K1 (and its virial channel K1b)
instead, on the warmed reactive LJ melt (11^3 cells, cap 32), the warmed
NPT melt (10^3, cap 40) and the LJ melt tiled 2 x 2 x 2 at cap 32 and 40:

  - ``{"kernel_colt_ms", "kernel_colt_cellwise_ms"}``: the whole LJ pair
    call (energy channel) through the column-segment kernel
    (``cell_pair_forces``) and the same call through the cellwise kernel,
    CUDA events over 20 calls;
  - one ``{"melt", "ch3", "seg", "rows", "threads", "depth",
    "device_ms"}`` line per launch plan of ``COLT_SWEEP`` (device time by
    ``torch.profiler``, 30 calls), the cellwise kernel's first, in ch3 0
    (the LJ step's channel) and, on the NPT grid, ch3 2 (K1b, the pressure
    pass), then the list depths at the fastest plan;
  - one ``{"melt", "ch3", "rules_in_turns"}`` line per operand (and slab 0
    of the melt built for 2 slabs): device ms of the cellwise kernel and
    of each plan rule of ``COLT_RULES``, timed forward and then backward:
    with the sweep, the measurement behind ``cell_pair``'s ``COLT_*``
    choices.

With ``--k2`` it times K2 and K3b against their first designs:

  - one ``{"melt", "seg", "rows", "threads", "depth", "device_ms"}`` line
    per launch plan of ``COLT_SWEEP`` for K2 (device time by
    ``torch.profiler``, 30 calls), the cellwise K2's first, on the 10k melt
    at cap 36 (11^3, S = 27) and on the film (``film_operands``: 32 x 32 x
    2 cells, S = 18), then the list depths at the fastest plan;
  - one ``{"melt", "rows", "threads", "depth", "device_ms"}`` line
    per plan of ``RESIDENT_SWEEP`` for K3b on the 10k LJ melt (11^3, cap
    32), the baseline's first;
  - one ``{"melt", "rules_in_turns"}`` line per operand: device ms of the
    first design and of each rule of ``K2_RULES`` (K2) or
    ``RESIDENT_RULES`` (K3b), timed forward and then backward: with the
    sweeps, the measurement behind K2's plan (K1's ``COLT_*`` rule, the
    fastest on its main-path grid) and ``cell_pair_variants``'
    ``RESIDENT_*`` choices.

With ``--ladder`` it times K3a, K3c, K3d and K1' against their first
designs:

  - one ``{"melt", "rows", "threads", "depth", "device_ms"}`` line per
    plan of ``COLZ_SWEEP`` for K3c and one ``{"melt", "seg", "rows",
    "threads", "depth", "device_ms"}`` line per plan of ``COLT1_SWEEP`` for
    K1', on the 10k LJ melt (11^3, cap 32), the first design's first, then
    the list depths at the fastest plan, each followed by its
    ``{"melt", "rules_in_turns"}`` line (``COLZ_RULES``, ``COLT1_RULES``):
    the measurement behind ``cell_pair_variants``' ``COLZ_*`` and
    ``COLT1_*`` choices;
  - one ``{"melt", "threads", "depth", "device_ms"}`` line per plan of
    ``PACKET_SWEEP`` for K3a on the 10k LJ melt, the first design's
    first;
  - one ``{"melt", "rows", "threads", "depth", "device_ms"}`` line per
    plan of ``COLUMN_SWEEP`` for K3d on the 10k melt at cap 36 and on the
    film, the first design's first, then the list depths at the fastest
    plan;
  - one ``{"melt", "rules_in_turns"}`` line per operand: device ms of the
    first design and of each rule of ``PACKET_RULES`` (K3a) or
    ``COLUMN_RULES`` (K3d), timed forward and then backward: with the
    sweeps, the measurement behind ``cell_pair_variants``' ``PACKET_*``
    and ``COLUMN_*`` choices;
  - one ``{"melt", "sources_in_turns"}`` line per operand (the 10k LJ
    melt, the 10k melt at cap 36, the film): the warp-per-row body over
    each source of candidates that takes the operand, in turns: none
    staged (K3b), one stage per cell (K3a), whole columns (K3c), column
    windows (K3d), column segments (K2).

Left out: ``cell_scatter`` (the TPU's scatter epilogue, which the port does
not carry) and ``KM_RETUNE`` (it waits for capacity management's
``shrink_neighbor_caps``).
"""

from __future__ import annotations

import functools
import itertools
import json
import sys
import time

import torch

from . import testsystems
from .engine import cell_pair, neighbor, runner
from .engine import cell_pair_variants as variants

KINDS = ("cell", "colt2", "colt1", "packet", "column", "colz", "resident")
BLOCK_STEPS = 200


def pair_call(kind: str, built, state):
    """A no-argument function making the whole pair call of ``kind`` on
    ``state``; returns the forces."""
    cfg = built.cfg
    args = (state.pos, state.type_id, state.active, state.box,
            state.nbr.buckets, state.nbr.slot_of, cfg.cell_dims, built.spec,
            cfg.n_types)
    if kind in ("cell", "colt2", "colt1"):
        return lambda: cell_pair.cell_pair_forces(
            *args, uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj,
            kernel=kind)[0]
    if kind == "packet":
        return lambda: variants.cell_pair_forces_packets(
            *args, uniform_lj=cfg.uniform_lj)[0]
    if kind == "resident":
        return lambda: variants.cell_pair_forces_resident(
            *args, uniform_lj=cfg.uniform_lj)[0]
    if kind in ("column", "colz"):
        return lambda: variants.cell_pair_forces_columns(
            *args, uniform_lj=cfg.uniform_lj, z_unroll=kind == "colz")[0]
    raise ValueError("unknown kind %r: one of %s" % (kind, ", ".join(KINDS)))


def time_ms(fn, reps: int = 20) -> float:
    """Milliseconds per call on the card: CUDA events around ``reps`` calls
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_kernels(built, state, kinds=KINDS, reps: int = 20) -> dict:
    """``{"kernel_<kind>_ms": ms}`` of each kind's whole pair call."""
    return {"kernel_%s_ms" % kind: time_ms(pair_call(kind, built, state),
                                           reps)
            for kind in kinds}


def fused_run(built, state, seed: int = 1234) -> dict:
    """One untimed and three timed blocks through the default kernel:
    ``{"pps_fused_auto", "events", "overflow"}``."""
    cfg, spec = built.cfg, built.spec
    gen = runner.make_generator(seed, state.pos.device)
    state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = runner.measure_cheap(spec, cfg, state)
    return {"pps_fused_auto": cfg.n_particles * 3 * BLOCK_STEPS / wall,
            "events": int(m["reaction_counts"].sum()),
            "overflow": bool(m["overflow"])}


def device_ms(fn, reps: int, kernel_name: str, tries: int = 3):
    """Device time per launch of the CUDA kernel whose name holds
    ``kernel_name``, from ``torch.profiler`` over ``reps`` calls after one
    (the host's time between launches left out): the mean over the
    launches the profiler recorded, which may miss some.  A session that
    recorded fewer than half of them (or more than one a call) is run
    again, up to ``tries`` sessions; None if none did."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(tries):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel_name in e.name]
        if len(times) != reps:
            print("device_ms: %d kernels named %r in %d calls"
                  % (len(times), kernel_name, reps), file=sys.stderr)
        if reps // 2 <= len(times) <= reps:
            return sum(times) / 1e3 / len(times)
    return None


# the two Chebyshev kernels' device functions (neither name holds the other)
CHEB_NEW, CHEB_OLD = "cheb_packed_kernel", "cheb_cellwise_kernel"
# launch plans of the sweep: segment, rows of a warp's batch, threads a
# block (lists of 8 entries a thread), then list depths at the fastest
CHEB_SWEEP = [dict(seg=seg, rows=rows, threads=threads, depth=8)
              for seg in (1, 2, 3, 4) for rows in (1, 2, 4, 8)
              for threads in (64, 128, 256)]
CHEB_DEPTHS = (2, 4, 16)


def cheb_args(built, state, obs_x=None):
    """The Chebyshev kernels' operands on ``state`` in the melt's mode:
    (cells, counts, box, (cut2, tmap, tmap_b, xmat, coef))."""
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(state.pos, state.type_id, state.active),
        state.nbr.buckets, int(torch.tensor(cfg.cell_dims).prod()))
    ops = cell_pair.cheb_operands(built.spec, cfg.n_types, cfg.cheb_ko,
                                  cfg.cheb_ntab, cfg.cheb_mix, obs_x)
    return cells, counts, state.box.contiguous(), ops


def tiled_operands(built, state, cap: int):
    """The melt's positions tiled 2 x 2 x 2: the box doubled, twice the
    cells on each axis (the same cell size and occupancy), bucketed by the
    port's own bucketing at ``cap``: (cells, counts, box, dims)."""
    box = state.box
    shifts = torch.tensor(list(itertools.product((0, 1), repeat=3)),
                          dtype=box.dtype, device=box.device) * box
    pos = (state.pos[None] + shifts[:, None]).reshape(-1, 3)
    active = state.active.repeat(8)
    dims = tuple(2 * int(d) for d in built.cfg.cell_dims)
    buckets, _, ovf, _ = neighbor.build_cell_buckets(pos, 2 * box, active,
                                                     dims, cap)
    if bool(ovf):
        raise ValueError("the tiled melt overflows cap %d" % cap)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, state.type_id.repeat(8), active), buckets,
        dims[0] * dims[1] * dims[2])
    return cells, counts, (2 * box).contiguous(), dims


def _epilogue(out, state, cheb_kw: int):
    """``cell_pair_forces``' epilogue on a kernel's (C, cap, 4) rows: the
    ``slot_of`` gather and the spare channel's sum; returns the forces."""
    out = out.reshape(-1, 4)
    slot_of = state.nbr.slot_of
    in_grid = slot_of < out.shape[0]
    rows = out[torch.where(in_grid, slot_of, 0).long()]
    force = torch.where(in_grid[:, None], rows[:, :3], 0.0)
    return cell_pair.pair_result(force, torch.sum(out[:, 3]), False,
                                 cheb_kw)[0]


def cheb_cellwise_call(built, state, obs_x=None):
    """``cell_pair_forces``' tabulated call (operands, kernel, ``slot_of``
    gather, the energy sum) with the cellwise kernel in place of the
    column-segment kernel; returns the forces."""
    cfg = built.cfg
    cells, counts, box, ops = cheb_args(built, state, obs_x)
    return _epilogue(cell_pair.cell_pair_forces_cheb_cellwise(
        cells, counts, box, *ops, cfg.cell_dims, cfg.cheb_kw, cfg.cheb_ko,
        cell_pair.CH3_ENERGY), state, cfg.cheb_kw)


def cheb_calls(built, state, obs_x=None, reps: int = 20) -> dict:
    """The whole tabulated pair call through the column-segment kernel and
    through the cellwise kernel, ms by CUDA events."""
    cfg = built.cfg

    def new():
        return cell_pair.cell_pair_forces(
            state.pos, state.type_id, state.active, state.box,
            state.nbr.buckets, state.nbr.slot_of, cfg.cell_dims, built.spec,
            cfg.n_types, cheb_kw=cfg.cheb_kw, cheb_ko=cfg.cheb_ko,
            cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix, obs_x=obs_x)[0]
    return {"kernel_cheb_ms": time_ms(new, reps),
            "kernel_cheb_cellwise_ms": time_ms(
                lambda: cheb_cellwise_call(built, state, obs_x), reps)}


def _plan_sweep(old, new, make_plan, plans, old_name: str, new_name: str,
                reps: int) -> list:
    """[(None, the cellwise kernel's device ms), (plan, the column-segment
    kernel's device ms under it) for each of ``plans``]: ``old()`` launches
    the cellwise kernel, ``new(plan)`` the other, ``make_plan(**kw)`` turns
    a plan's overrides into its plan."""
    out = [(None, device_ms(old, reps, old_name))]
    for kw in plans:
        plan = make_plan(**kw)
        out.append((plan, device_ms(lambda: new(plan), reps, new_name)))
    return out


def cheb_sweep(built, state, plans, obs_x=None, reps: int = 30,
               operands=None) -> list:
    """Device ms of the column-segment kernel under each plan (dicts of
    ``cheb_launch_plan``'s overrides), the cellwise kernel's first (plan
    None), in ch3 mode 0, on the melt's operands or on ``operands``
    (cells, counts, box, dims)."""
    cfg = built.cfg
    cells, counts, box, ops = cheb_args(built, state, obs_x)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    args = (cells, counts, box, *ops, dims, cfg.cheb_kw, cfg.cheb_ko,
            cell_pair.CH3_NONE)
    return _plan_sweep(
        lambda: cell_pair.cell_pair_forces_cheb_cellwise(*args),
        lambda plan: cell_pair.cell_pair_forces_cheb_kernel(
            *args, ntab=cfg.cheb_ntab, plan=plan),
        lambda **kw: cell_pair.cheb_launch_plan(
            dims, cells.shape[1], cfg.n_types, ops[4].shape[0], cfg.cheb_kw,
            cfg.cheb_ko, cfg.cheb_mix, **kw),
        plans, CHEB_OLD, CHEB_NEW, reps)


# the two LJ kernels' device functions (neither name holds the other)
COLT_NEW, COLT_OLD = "colt_packed_kernel", "colt_cellwise_kernel"
# launch plans of the LJ sweep: segment, rows of a warp's batch, threads a
# block (lists of COLT_DEPTH entries a thread), then list depths at the
# fastest plan
COLT_SWEEP = [dict(seg=seg, rows=rows, threads=threads)
              for seg in (1, 2, 3, 4) for rows in (1, 2, 4, 8)
              for threads in (64, 128, 256)]
COLT_DEPTHS = (2, 4, 16)
# the second stage: plan rules (segment of at most L cells by
# ``cell_pair.plan_segment``, rows, threads, depth) timed in turns on every
# operand, the rule the plan takes among them
COLT_RULES = [(4, 4, 256, 8), (4, 4, 256, 4), (4, 2, 256, 8), (4, 2, 256, 4),
              (2, 4, 128, 8), (2, 2, 256, 8), (3, 2, 256, 4), (4, 1, 256, 4)]


def lj_args(built, state):
    """The LJ kernels' operands on ``state``: (cells, counts, box,
    params)."""
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(state.pos, state.type_id, state.active),
        state.nbr.buckets, int(torch.tensor(cfg.cell_dims).prod()))
    return (cells, counts, state.box.contiguous(),
            cell_pair.pair_params(built.spec, cfg.n_types))


def colt_calls(built, state, reps: int = 20) -> dict:
    """The whole LJ pair call (energy channel) through the column-segment
    kernel and through the cellwise kernel, ms by CUDA events."""
    cfg = built.cfg

    def new():
        return cell_pair.cell_pair_forces(
            state.pos, state.type_id, state.active, state.box,
            state.nbr.buckets, state.nbr.slot_of, cfg.cell_dims, built.spec,
            cfg.n_types, uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]

    def old():
        return _epilogue(cell_pair.cell_pair_forces_colt_cellwise(
            *lj_args(built, state), cfg.cell_dims, cfg.uniform_lj,
            cfg.all_lj, cell_pair.CH3_ENERGY), state, 0)
    return {"kernel_colt_ms": time_ms(new, reps),
            "kernel_colt_cellwise_ms": time_ms(old, reps)}


def colt_sweep(built, state, plans, ch3: int = cell_pair.CH3_NONE,
               reps: int = 30, operands=None) -> list:
    """Device ms of the LJ column-segment kernel under each plan (dicts of
    ``colt_launch_plan``'s overrides), the cellwise kernel's first (plan
    None), in channel ``ch3``, on the melt's operands or on ``operands``
    (cells, counts, box, dims)."""
    cfg = built.cfg
    cells, counts, box, params = lj_args(built, state)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    args = (cells, counts, box, params, dims, cfg.uniform_lj, cfg.all_lj,
            ch3)
    return _plan_sweep(
        lambda: cell_pair.cell_pair_forces_colt_cellwise(*args),
        lambda plan: cell_pair.cell_pair_forces_colt_kernel(*args,
                                                            plan=plan),
        lambda **kw: cell_pair.colt_launch_plan(dims, cells.shape[1],
                                                cfg.n_types, **kw),
        plans, COLT_OLD, COLT_NEW, reps)


# the NPT melt's barostat: the reference NPT test's settings
NPT = dict(barostat="br", pressure=0.15, barostat_tau=2.0)


def npt_melt(n_mols: int, steps: int = 200):
    """The reactive melt under the Berendsen barostat, warmed, then
    ``steps`` Langevin steps so that the box has moved: (built, state)."""
    built, state = _warm(functools.partial(testsystems.build_melt, **NPT),
                         n_mols, 600)
    box0 = state.box.clone()
    state = runner.run_block(built.spec, built.cfg, state, steps,
                             gen=runner.make_generator(11, "cuda"))
    if torch.equal(state.box, box0):
        raise AssertionError("the NPT melt's box did not move")
    return built, state


def colt_rules(built, state, rules, ch3: int = cell_pair.CH3_NONE,
               operands=None, x_halo: bool = False, reps: int = 50) -> dict:
    """Device ms of the cellwise kernel and of the LJ kernel under each
    rule of ``rules`` (``COLT_RULES``' form), in turns: the list forward,
    then backward; ``{"cellwise": [ms, ms], "<rule>": [ms, ms], ...}``."""
    cfg = built.cfg
    cells, counts, box, params = lj_args(built, state)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    args = (cells, counts, box, params, dims, cfg.uniform_lj, cfg.all_lj,
            ch3)
    runs = {"cellwise": lambda: cell_pair.cell_pair_forces_colt_cellwise(
        *args, x_halo=x_halo)}
    for seg_max, rows, threads, depth in rules:
        plan = cell_pair.colt_launch_plan(
            dims, cells.shape[1], cfg.n_types, x_halo,
            seg=cell_pair.plan_segment(dims, x_halo, seg_max), rows=rows,
            threads=threads, depth=depth)
        runs[str((seg_max, rows, threads, depth))] = (
            lambda plan=plan: cell_pair.cell_pair_forces_colt_kernel(
                *args, x_halo=x_halo, plan=plan))
    return in_turns({key: (fn, COLT_OLD if key == "cellwise" else COLT_NEW)
                     for key, fn in runs.items()}, reps)


def in_turns(runs, reps: int = 50) -> dict:
    """Device ms of each of ``runs`` ({key: (no-argument function, the
    name of the kernel it launches)}), the list forward, then backward:
    ``{key: [ms, ms]}``."""
    out = {key: [] for key in runs}
    for key in list(runs) + list(runs)[::-1]:
        fn, name = runs[key]
        out[key].append(device_ms(fn, reps, name))
    return out


# K2's and K3b's device functions, new and first design (no name holds
# another, nor K1's)
K2_NEW, K2_OLD = "cell_packed_kernel", "cell_cellwise_kernel"
K3B_NEW, K3B_OLD = "ladder_resident_kernel", "ladder_resident_packet_kernel"
# K3a's, K3d's, K3c's and K1''s: no name holds another, nor K3b's or K1's
K3A_NEW, K3A_OLD = "ladder_packet_kernel", "ladder_packet_cellwise_kernel"
K3D_NEW, K3D_OLD = "ladder_column_kernel", "ladder_column_cellwise_kernel"
K3C_NEW, K3C_OLD = "ladder_colz_kernel", "ladder_colz_cellwise_kernel"
K1P_NEW, K1P_OLD = "ladder_colt1_kernel", "ladder_colt1_cellwise_kernel"
# the device function of each ladder kind as the step launches it
LADDER_KERNEL_NAMES = {"packet": K3A_NEW, "resident": K3B_NEW,
                       "colz": K3C_NEW, "column": K3D_NEW,
                       "colt1": K1P_NEW}
# K3b's plans: slots a warp batch, threads a block, list depth
RESIDENT_SWEEP = [dict(rows=rows, threads=threads, depth=depth)
                  for rows in (1, 2, 4, 8, 32) for threads in (128, 256)
                  for depth in (2, 4, 8)]
# the second stage: K2's plan rules (segment of at most L cells, rows,
# threads, depth) and K3b's (rows, threads, depth), timed in turns
K2_RULES = [(3, 2, 256, 4), (3, 4, 256, 4), (2, 4, 256, 4), (4, 8, 256, 4)]
RESIDENT_RULES = [(2, 128, 4), (4, 128, 4), (2, 256, 4), (2, 128, 8)]
# K3a's plans (threads a block, list depth) and K3d's (slots a warp batch,
# threads a block, list depth 4; then the depths at the fastest)
PACKET_SWEEP = [dict(threads=threads, depth=depth)
                for threads in (32, 64, 128, 256) for depth in (2, 4, 8)]
COLUMN_SWEEP = [dict(rows=rows, threads=threads, depth=4)
                for rows in (1, 2, 4, 8) for threads in (64, 128, 256)]
COLUMN_DEPTHS = (2, 8)
# the second stage: K3a's rules (threads, depth) and K3d's (rows, threads,
# depth), timed in turns
PACKET_RULES = [(64, 4), (128, 4), (64, 8), (128, 8)]
COLUMN_RULES = [(2, 128, 4), (1, 256, 4), (1, 256, 2), (2, 256, 4),
                (4, 128, 4), (1, 128, 4)]
# K3c's plans (slots a warp batch, threads a block: its warps are the main
# axis, one block per xy column; list depth 4, then the depths at the
# fastest that fit beside its stage at 896 threads) and K1''s (segment, slots a warp batch, threads a block, list
# depth 4: the segment nz = 11 is the reference's one program per xy
# column, 3 is K1's rule at 10k), then their rules in turns
COLZ_SWEEP = [dict(rows=rows, threads=threads, depth=4)
              for rows in (1, 2, 4) for threads in (128, 256, 512, 768, 896)]
COLZ_DEPTHS = (2, 6)
COLT1_SWEEP = [dict(seg=seg, rows=rows, threads=threads, depth=4)
               for seg in (1, 2, 3, 4, 11) for rows in (1, 2, 4, 8)
               for threads in (128, 256)]
COLT1_DEPTHS = (2, 8)
COLZ_RULES = [(1, 896, 4), (2, 768, 4), (1, 768, 4), (2, 896, 4),
              (1, 896, 2), (1, 896, 6), (2, 512, 4)]
COLT1_RULES = [(3, 2, 256, 4), (4, 8, 256, 4), (2, 2, 256, 4),
               (3, 4, 256, 4), (11, 2, 256, 4), (3, 2, 128, 4)]
# the film: an LJ operand of 32 x 32 x 2 cells at the melt's density
FILM_DIMS = (32, 32, 2)
FILM_DENSITY = 0.27
FILM_CAP = 36


def film_operands(built, seed: int = 0, cap: int = FILM_CAP):
    """K2's operand with a deduplicated stencil (S = 18) at a real size:
    seeded uniform positions at the melt's density 0.27 in a box of
    ``FILM_DIMS`` cells of side cutoff + skin (2.9 on the melt), types
    drawn uniformly from the melt's, bucketed by
    ``neighbor.build_cell_buckets`` at ``cap`` on the melt's device:
    (cells, counts, box, dims); the melt's ``pair_params`` go with it."""
    import numpy as np

    spec = built.spec
    dev = spec.pair_cutoff2.device
    edge = float(spec.pair_cutoff2.max()) ** 0.5 + float(spec.skin)
    box_np = np.asarray(FILM_DIMS, np.float64) * edge
    n = int(round(FILM_DENSITY * float(np.prod(box_np))))
    rng = np.random.RandomState(seed)
    box = torch.tensor(box_np, dtype=torch.float32, device=dev)
    pos = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3)).astype(
        np.float32)).to(dev) * box
    type_id = torch.from_numpy(rng.randint(0, built.cfg.n_types, n).astype(
        np.int32)).to(dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    buckets, _, ovf, _ = neighbor.build_cell_buckets(pos, box, active,
                                                     FILM_DIMS, cap)
    if bool(ovf):
        raise ValueError("the film overflows cap %d" % cap)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, type_id, active), buckets,
        int(np.prod(FILM_DIMS)))
    return cells, counts, box.contiguous(), FILM_DIMS


def k2_sweep(built, state, plans, reps: int = 30, operands=None) -> list:
    """Device ms of K2 under each plan (dicts of ``k2_launch_plan``'s
    overrides), the cellwise K2's first (plan None), in ch3 mode 0, on the
    melt's operands or on ``operands`` (cells, counts, box, dims)."""
    cfg = built.cfg
    cells, counts, box, params = lj_args(built, state)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    args = (cells, counts, box, params, dims, cfg.uniform_lj, cfg.all_lj,
            cell_pair.CH3_NONE)
    return _plan_sweep(
        lambda: cell_pair.cell_pair_forces_cell_cellwise(*args),
        lambda plan: cell_pair.cell_pair_forces_cell_kernel(*args,
                                                            plan=plan),
        lambda **kw: cell_pair.k2_launch_plan(dims, cells.shape[1],
                                              cfg.n_types, **kw),
        plans, K2_OLD, K2_NEW, reps)


def k2_rules(built, state, rules, operands=None, reps: int = 50) -> dict:
    """Device ms of the cellwise K2 and of K2 under each rule of ``rules``
    (``K2_RULES``' form), in turns, in ch3 mode 0, on the melt's operands
    or on ``operands`` (cells, counts, box, dims)."""
    cfg = built.cfg
    cells, counts, box, params = lj_args(built, state)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    args = (cells, counts, box, params, dims, cfg.uniform_lj, cfg.all_lj,
            cell_pair.CH3_NONE)
    runs = {"cellwise": (lambda: cell_pair.cell_pair_forces_cell_cellwise(
        *args), K2_OLD)}
    for seg_max, rows, threads, depth in rules:
        plan = cell_pair.k2_launch_plan(
            dims, cells.shape[1], cfg.n_types,
            seg=cell_pair.plan_segment(dims, False, seg_max), rows=rows,
            threads=threads, depth=depth)
        runs[str((seg_max, rows, threads, depth))] = (
            lambda plan=plan: cell_pair.cell_pair_forces_cell_kernel(
                *args, plan=plan), K2_NEW)
    return in_turns(runs, reps)


def ladder_args(built, state, operands=None):
    """(cells, counts, box, params, dims, uniform_lj) of a ladder call on
    the melt's operands or on ``operands`` (cells, counts, box, dims)."""
    cfg = built.cfg
    cells, counts, box, params = lj_args(built, state)
    dims = cfg.cell_dims
    if operands is not None:
        cells, counts, box, dims = operands
    return cells, counts, box, params, dims, cfg.uniform_lj


# each planned ladder kernel: its first design's wrapper, its launch plan
# from (cap, dims, n_types, **overrides), the overrides a rule names in
# order, and its device functions' names, new and first design
LADDER_AB = {
    "packet": (variants.packet_baseline_kernel,
               lambda cap, dims, n_types, **kw: variants.packet_launch_plan(
                   cap, **kw),
               ("threads", "depth"), K3A_NEW, K3A_OLD),
    "resident": (variants.resident_packet_kernel,
                 lambda cap, dims, n_types, **kw:
                 variants.resident_launch_plan(cap, **kw),
                 ("rows", "threads", "depth"), K3B_NEW, K3B_OLD),
    "colz": (variants.colz_baseline_kernel,
             lambda cap, dims, n_types, **kw: variants.colz_launch_plan(
                 cap, dims, **kw),
             ("rows", "threads", "depth"), K3C_NEW, K3C_OLD),
    "column": (variants.column_baseline_kernel,
               lambda cap, dims, n_types, **kw: variants.column_launch_plan(
                   cap, dims, **kw),
               ("rows", "threads", "depth"), K3D_NEW, K3D_OLD),
    "colt1": (variants.colt1_baseline_kernel,
              lambda cap, dims, n_types, **kw: variants.colt1_launch_plan(
                  dims, cap, n_types, **kw),
              ("seg", "rows", "threads", "depth"), K1P_NEW, K1P_OLD)}


def ladder_sweep(kind: str, built, state, plans, reps: int = 30,
                 operands=None) -> list:
    """Device ms of the ladder kernel ``kind`` (a key of ``LADDER_AB``)
    under each plan (dicts of its launch plan's overrides), the first
    design's first (plan None), on the melt's operands or on ``operands``
    (cells, counts, box, dims)."""
    baseline, make_plan, _, new_name, old_name = LADDER_AB[kind]
    args = ladder_args(built, state, operands)
    cap, dims, n_types = args[0].shape[1], args[4], args[3].shape[1]
    return _plan_sweep(
        lambda: baseline(*args),
        lambda plan: variants.ladder_kernel(kind, *args, plan=plan),
        lambda **kw: make_plan(cap, dims, n_types, **kw),
        plans, old_name, new_name, reps)


def ladder_rules(kind: str, built, state, rules, operands=None,
                 reps: int = 50) -> dict:
    """Device ms of the first design of the ladder kernel ``kind`` (a key
    of ``LADDER_AB``) and of the kernel under each rule of ``rules``
    (``RESIDENT_RULES``', ``PACKET_RULES``' or ``COLUMN_RULES``' form), in
    turns, on the melt's operands or on ``operands``."""
    baseline, make_plan, fields, new_name, old_name = LADDER_AB[kind]
    args = ladder_args(built, state, operands)
    cap, dims, n_types = args[0].shape[1], args[4], args[3].shape[1]
    runs = {"baseline": (lambda: baseline(*args), old_name)}
    for rule in rules:
        plan = make_plan(cap, dims, n_types, **dict(zip(fields, rule)))
        runs[str(rule)] = (
            lambda plan=plan: variants.ladder_kernel(kind, *args, plan=plan),
            new_name)
    return in_turns(runs, reps)


def candidate_sources(built, state, operands=None, reps: int = 50) -> dict:
    """Device ms, in turns, of the one warp-per-row body over each source
    of candidates that takes these operands: none staged (K3b, a cap that
    is a multiple of 8), one stage per cell (K3a, the same caps), whole
    columns by bulk copies (K3c, the same caps), column windows by bulk
    copies (K3d), and column segments (K2, K1's body over the stencil
    mask), on the melt's operands or on ``operands``."""
    cells, counts, box, params, dims, uniform = ladder_args(built, state,
                                                            operands)
    args = (cells, counts, box, params, dims, uniform)
    runs = {}
    if cells.shape[1] % 8 == 0:
        runs["none (K3b)"] = (
            lambda: variants.ladder_kernel("resident", *args), K3B_NEW)
        runs["per cell (K3a)"] = (
            lambda: variants.ladder_kernel("packet", *args), K3A_NEW)
        runs["whole columns (K3c)"] = (
            lambda: variants.ladder_kernel("colz", *args), K3C_NEW)
    runs["column windows (K3d)"] = (
        lambda: variants.ladder_kernel("column", *args), K3D_NEW)
    runs["column segments (K2)"] = (
        lambda: cell_pair.cell_pair_forces_cell_kernel(
            *args, built.cfg.all_lj, cell_pair.CH3_ENERGY), K2_NEW)
    return in_turns(runs, reps)


def ladder_main(n_mols: int) -> int:
    """``--ladder``: K3a's, K3c's and K1''s plan sweeps on the 10k LJ melt,
    K3d's on the 10k melt at cap 36 and on the film, then the rules and the
    sources of candidates in turns."""
    lj = _warm(testsystems.build_melt, n_mols, 600)
    _print_melt("lj cap 32", lj[0])
    for kind, sweep, depths, rules in (
            ("colz", COLZ_SWEEP, COLZ_DEPTHS, COLZ_RULES),
            ("colt1", COLT1_SWEEP, COLT1_DEPTHS, COLT1_RULES)):
        label = "%s lj" % ("k3c" if kind == "colz" else "k1p")
        _sweep_with_depths(label, lambda plans, kind=kind: ladder_sweep(
            kind, *lj, plans), sweep, depths)
        print(json.dumps({"melt": label, "rules_in_turns": ladder_rules(
            kind, *lj, rules)}), flush=True)
    k3d = _warm(functools.partial(testsystems.build_melt, cell_cap=36),
                n_mols, 600)
    grids = [("k3d cap 36", None), ("k3d film", film_operands(k3d[0]))]
    _print_melt("k3d cap 36", k3d[0])
    _print_sweep("k3a lj", ladder_sweep("packet", *lj, PACKET_SWEEP))
    for label, operands in grids:
        _sweep_with_depths(
            label, lambda plans, operands=operands: ladder_sweep(
                "column", *k3d, plans, operands=operands),
            COLUMN_SWEEP, COLUMN_DEPTHS)
    print(json.dumps({"melt": "k3a lj", "rules_in_turns": ladder_rules(
        "packet", *lj, PACKET_RULES)}), flush=True)
    for label, operands in grids:
        print(json.dumps({"melt": label, "rules_in_turns": ladder_rules(
            "column", *k3d, COLUMN_RULES, operands)}), flush=True)
    for label, (built, state), operands in (
            ("lj cap 32", lj, None), ("k3d cap 36", k3d, None),
            ("k3d film", k3d, grids[1][1])):
        print(json.dumps({"melt": label, "sources_in_turns":
                          candidate_sources(built, state, operands)}),
              flush=True)
    return 0


def k2_main(n_mols: int) -> int:
    """``--k2``: K2's plan sweep on the 10k melt at cap 36 and on the film,
    K3b's on the 10k LJ melt."""
    k2 = _warm(functools.partial(testsystems.build_melt, cell_cap=36),
               n_mols, 600)
    built, state = k2
    grids = [("k2 cap 36", None), ("film", film_operands(built))]
    for label, operands in grids:
        cells = operands[0] if operands else lj_args(built, state)[0]
        print(json.dumps({"melt": label, "dims": list(
            operands[3] if operands else built.cfg.cell_dims),
            "particles": int((cells[..., 3] > 0.5).sum()),
            "device": torch.cuda.get_device_name(0)}), flush=True)
        _sweep_with_depths(
            label, lambda plans, operands=operands: k2_sweep(
                built, state, plans, operands=operands),
            COLT_SWEEP, COLT_DEPTHS)
    for label, operands in grids:
        print(json.dumps({"melt": label, "rules_in_turns": k2_rules(
            built, state, K2_RULES, operands)}), flush=True)
    lj = _warm(testsystems.build_melt, n_mols, 600)
    _print_sweep("k3b lj", ladder_sweep("resident", *lj, RESIDENT_SWEEP))
    print(json.dumps({"melt": "k3b lj", "rules_in_turns": ladder_rules(
        "resident", *lj, RESIDENT_RULES)}), flush=True)
    return 0


def slab_operands(cfg, pos, type_id, active, buckets, n_ranks: int,
                  rank: int):
    """Rank ``rank``'s haloed slab of the bucket table, as
    ``cell_pair_halo`` builds it: (cells, counts, slab dims)."""
    from .engine import cell_pair_halo

    nx, ny, nz = cfg.cell_dims
    ids = cell_pair_halo.slab_cells(tuple(cfg.cell_dims), n_ranks, rank,
                                    pos.device)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, type_id, active), buckets[ids], ids.numel())
    return cells, counts, (nx // n_ranks + 2, ny, nz)


def _warm(fn, n_mols: int, steps: int):
    built, _, _ = fn(n_mols=n_mols, reactive=True, device="cuda")
    state = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, testsystems.warmup(built, state, steps=steps)


def _print_melt(label: str, built):
    print(json.dumps({"melt": label, "n": built.cfg.n_particles,
                      "cell_cap": built.cfg.cell_cap,
                      "dims": list(built.cfg.cell_dims),
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def _print_sweep(label: str, res, **extra):
    for plan, ms in res:
        print(json.dumps({"melt": label, **extra,
                          **({"cellwise": True} if plan is None
                             else plan._asdict()),
                          "device_ms": ms}), flush=True)


def _sweep_with_depths(label: str, sweep, plans, depths, **extra):
    """Print ``sweep(plans)``, then ``sweep`` of the fastest plan (the
    overrides ``plans`` name) at each of ``depths``."""
    res = sweep(plans)
    _print_sweep(label, res, **extra)
    timed = [r for r in res if r[0] is not None and r[1] is not None]
    if timed:
        best = min(timed, key=lambda r: r[1])[0]
        keys = [k for k in plans[0] if k != "depth"]
        _print_sweep(label, sweep([
            dict({k: getattr(best, k) for k in keys}, depth=d)
            for d in depths])[1:], **extra)


def tab_main(n_mols: int) -> int:
    """``--tab``: the Chebyshev kernels' whole calls and plan sweep, on the
    10k melts and on the tabulated melt tiled 2 x 2 x 2 at cap 32 and 40."""
    from .engine import observables

    for melt, fn, steps in (("tab", testsystems.build_tabulated_melt, 600),
                            ("mixed", testsystems.build_mixed_tab_melt,
                             300)):
        built, state = _warm(fn, n_mols, steps)
        cfg = built.cfg
        x = (observables.conversions(built.spec, state.type_id,
                                     state.chem_state, state.active)
             if cfg.cheb_mix else None)
        print(json.dumps({"melt": melt, "n": cfg.n_particles,
                          "cell_cap": cfg.cell_cap,
                          "dims": list(cfg.cell_dims), "mix": cfg.cheb_mix,
                          "device": torch.cuda.get_device_name(0),
                          **cheb_calls(built, state, x)}), flush=True)
        grids = [(melt, None)]
        if melt == "tab":
            grids += [("tab tiled cap %d" % cap,
                       tiled_operands(built, state, cap)) for cap in (32, 40)]
        for label, operands in grids:
            _sweep_with_depths(
                label, lambda plans, operands=operands: cheb_sweep(
                    built, state, plans, x, operands=operands),
                CHEB_SWEEP, CHEB_DEPTHS)
    return 0


def lj_main(n_mols: int) -> int:
    """``--lj``: K1's whole calls and plan sweep, on the 10k LJ melt, the
    NPT melt (in K1b's virial channel too) and the LJ melt tiled 2 x 2 x 2
    at cap 32 and 40."""
    lj = _warm(testsystems.build_melt, n_mols, 600)
    npt = npt_melt(n_mols)
    for melt, (built, state) in (("lj", lj), ("npt", npt)):
        cfg = built.cfg
        print(json.dumps({"melt": melt, "n": cfg.n_particles,
                          "cell_cap": cfg.cell_cap,
                          "dims": list(cfg.cell_dims),
                          "device": torch.cuda.get_device_name(0),
                          **colt_calls(built, state)}), flush=True)
    built, state = lj
    grids = [("lj", lj, None, cell_pair.CH3_NONE),
             ("npt", npt, None, cell_pair.CH3_VIRIAL)]
    grids += [("lj tiled cap %d" % cap, lj,
               tiled_operands(built, state, cap), cell_pair.CH3_NONE)
              for cap in (32, 40)]
    for label, (b, st), operands, ch3 in grids:
        _sweep_with_depths(
            label, lambda plans, b=b, st=st, operands=operands, ch3=ch3:
            colt_sweep(b, st, plans, ch3, operands=operands),
            COLT_SWEEP, COLT_DEPTHS, ch3=ch3)
    slab = _warm(functools.partial(testsystems.build_melt, slab_devices=2),
                 n_mols, 300)
    b, st = slab
    cells, counts, dims = slab_operands(b.cfg, st.pos, st.type_id, st.active,
                                        st.nbr.buckets, 2, 0)
    grids.append(("slab 0 of 2", slab, (cells, counts, st.box.contiguous(),
                                         dims), cell_pair.CH3_NONE))
    for label, (b, st), operands, ch3 in grids:
        x_halo = label.startswith("slab")
        print(json.dumps({"melt": label, "ch3": ch3, "rules_in_turns":
                          colt_rules(b, st, COLT_RULES, ch3, operands,
                                     x_halo)}), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_matrix: no CUDA device", file=sys.stderr)
        return 2
    flags = {a for a in argv if a.startswith("--")}
    argv = [a for a in argv if not a.startswith("--")]
    n_mols = int(argv[0]) if argv else 3334
    if "--tab" in flags:
        return tab_main(n_mols)
    if "--lj" in flags:
        return lj_main(n_mols)
    if "--k2" in flags:
        return k2_main(n_mols)
    if "--ladder" in flags:
        return ladder_main(n_mols)
    built, systop, _ = testsystems.build_melt(n_mols=n_mols, reactive=True,
                                              device="cuda")
    cfg = built.cfg
    state = runner.initial_forces(built.spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=600)
    state = testsystems.activate_initiators(
        built, systop, state, n=max(cfg.n_particles // 300, 4))
    print(json.dumps({"n": cfg.n_particles, "cell_cap": cfg.cell_cap,
                      "dims": list(cfg.cell_dims),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    print(json.dumps(time_kernels(built, state)), flush=True)
    print(json.dumps(fused_run(built, state)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
