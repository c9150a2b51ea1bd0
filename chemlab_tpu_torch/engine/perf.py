"""Per-phase timing breakdown (the reference's engine-timer analog).

Port of ``chemlab_tpu/engine/perf.py``.  The CLI prints and pickles one
time per phase after a run (``--timers``, on by default; ref:
start_simulation.py:1040-1076).  Each phase runs on its own over the
current state, once to warm up and then ``repeats`` times, each call
between two ``torch.cuda.synchronize()`` on the card, and the median wall
time is kept.

Phases (the reference's six):
  neighbor_rebuild  cell binning + the K-nearest rows + exclusion rows
                    (with the func-14 births on a row-path build)
  pair_forces       the pair kernel's all-pairs sum minus the excluded
                    pairs' correction, or ``pair_forces`` over the rows on
                    a row-path build
  bonded_forces     bonds, angles, dihedrals and 1-4 pairs
  integrate_step    one full md_step (kicks, drift, rebuild trigger,
                    thermostat)
  reaction_step     one reactive interval (matching + event application)
  observables       the measure() pass
"""

from __future__ import annotations

import time

import torch

from . import bonded_forces, integrate, neighbor, reactions, runner


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
    dev = state.device
    rc_skin = torch.sqrt(torch.max(spec.pair_cutoff2)) + spec.skin
    timers = {}
    timers["neighbor_rebuild"] = _time_fn(
        lambda: neighbor.build_neighbor_state(
            state.pos, state.box, state.active, state.excl, rc_skin,
            dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
            max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap,
            track_birth=cfg.has_pps,
            prev=state.nbr if cfg.has_pps else None, step=state.step),
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
