"""Per-phase timing breakdown (the reference's engine-timer analog), and
the engine's profiler spans.

Port of ``chemlab_tpu/engine/perf.py``.  The CLI prints and pickles one
time per phase after a run (``--timers``, on by default; ref:
start_simulation.py:1040-1076).  Each phase runs on its own over the
current state, once to warm up and then ``repeats`` times, each call
between two ``torch.cuda.synchronize()`` on the card, and the median wall
time is kept.

Phases (the reference's six):
  neighbor_rebuild  the rebuild the step makes when its trigger fires
                    (``integrate.maybe_rebuild_neighbors(force=True)``):
                    the cell-bucket refresh on the kernel path, cell
                    binning + the K-nearest rows + exclusion rows (with
                    the func-14 births) on the row path
  pair_forces       the pair kernel's all-pairs sum minus the excluded
                    pairs' correction, or ``pair_forces`` over the rows on
                    a row-path build
  bonded_forces     bonds, angles, dihedrals and 1-4 pairs
  integrate_step    one full md_step (kicks, drift, rebuild trigger,
                    thermostat)
  reaction_step     one reactive interval (matching + event application)
  observables       the measure() pass

Spans: ``span(name)`` opens a profiler range named ``"chemlab::" + name``
while a profiler records (the benchmark's traced runs, the CLI's
``--profile_dir``, ``step_profile``, ``kernel_matrix``), and is one shared
null context otherwise.  The range is an operator-scope record function
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): the profiler copies a user
annotation onto the device's timeline as an event that spans the kernels
launched inside it, which readers of launches and busy time would count
as device work.  The engine opens spans at its layer boundaries only,
never inside a per-event, per-row or per-particle loop; their names are
the constants below.  A span's count in a trace is its counter (the
``rebuild`` ranges are the rebuilds).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch._C._profiler import _RecordFunctionFast

SPAN_PREFIX = "chemlab::"

BLOCK = "block"                    # runner.run_block, check_replicas included
MD_STEP = "md_step"                # integrate.md_step
REBUILD_CHECK = "rebuild_check"    # the skin criterion and its host read
REBUILD = "rebuild"                # the bucket refresh or the row rebuild
PAIR_SUM = "pair_sum"              # integrate._pair_sum / row_pair_forces
EXCL_CORRECTION = "excl_correction"    # integrate._excl_correction
BONDED = "bonded"                  # bonded_forces, its backward included
BAROSTAT = "barostat"              # integrate._barostat_step
REACTION_STEP = "reaction_step"    # runner._fire_reactions
RX_MATCH = "rx_match"              # candidates and matching
RX_APPLY = "rx_apply"              # reactions.apply_reaction_events
RX_MERGE = "rx_merge"              # the batched path's merge_molecules loop
RX_DISSOCIATE = "rx_dissociate"    # matching and applying dissociations
REDERIVE = "rederive"              # bonded_dense / excl_dense.rederive
ATRP = "atrp"                      # reactions.atrp_step
FREEZE = "freeze"                  # reactions.freeze_region_step
CPT = "cpt"                        # reactions.change_particle_type_step
MEASURE = "measure"                # runner.measure_cheap / runner.measure

SPANS = (BLOCK, MD_STEP, REBUILD_CHECK, REBUILD, PAIR_SUM, EXCL_CORRECTION,
         BONDED, BAROSTAT, REACTION_STEP, RX_MATCH, RX_APPLY, RX_MERGE,
         RX_DISSOCIATE, REDERIVE, ATRP, FREEZE, CPT, MEASURE)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The profiler range ``chemlab::<name>`` while a profiler records,
    else a shared null context: a range opened with no profiler running
    costs 10-20 times the check."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(SPAN_PREFIX + name)
    return _OFF


def is_span(name: str) -> bool:
    """Whether a profiler event of this name is one of the engine's spans,
    which readers of kernels, launches and busy time leave out."""
    return name.startswith(SPAN_PREFIX)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, device, repeats: int = 3) -> float:
    """One warm-up call, then the median wall time of ``repeats`` calls,
    each ended by a synchronize on the card."""
    fn()
    _sync(device)
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def phase_timers(spec, cfg, state, repeats: int = 3) -> dict:
    """{phase: seconds per call} for the six engine phases, timed on the
    state's device; ``state`` should be a settled (post-warmup) state."""
    # imported here: the engine's modules import this one for its spans
    from . import bonded_forces, integrate, reactions, runner

    dev = state.device
    timers = {}
    timers["neighbor_rebuild"] = _time_fn(
        lambda: integrate.maybe_rebuild_neighbors(spec, cfg, state,
                                                  force=True),
        dev, repeats)

    obs_x = torch.zeros(spec.obs_total.shape[0], dtype=torch.float32,
                        device=dev)

    def pair():
        if not cfg.use_pallas:
            return integrate.row_pair_forces(spec, cfg, state, obs_x)[0]
        f_all = integrate._pair_sum(spec, cfg, state, want_energy=True,
                                    obs_x=obs_x, kernel="auto")[0]
        return f_all - integrate._excl_correction(spec, cfg, state, obs_x)[0]

    timers["pair_forces"] = _time_fn(pair, dev, repeats)
    timers["bonded_forces"] = _time_fn(
        lambda: bonded_forces.bonded_forces(
            spec, cfg, state.pos, state.box, state.type_id, state.q,
            state.bonds, state.angles, state.dihedrals, state.pairs14,
            dense=integrate._dense_of(cfg, state)),
        dev, repeats)
    gen = runner.make_generator(0, dev)
    timers["integrate_step"] = _time_fn(
        lambda: integrate.md_step(spec, cfg, state, gen=gen), dev, repeats)
    if cfg.has_reactions:
        timers["reaction_step"] = _time_fn(
            lambda: reactions.reaction_step(spec, cfg, state, 0), dev,
            repeats)
    else:
        timers["reaction_step"] = 0.0
    timers["observables"] = _time_fn(
        lambda: runner.measure(spec, cfg, state), dev, repeats)
    return timers


def format_timers(timers: dict, block_steps: int = 1) -> str:
    """Reference-style printout: per-phase seconds and the share of one
    step each phase would account for."""
    step_cost = timers.get("integrate_step", 0.0) or 1e-12
    lines = ["phase                 s/call     x step"]
    for k, v in sorted(timers.items(), key=lambda kv: -kv[1]):
        lines.append("%-20s %9.6f  %8.2fx" % (k, v, v / step_cost))
    return "\n".join(lines)
