"""Where a step's time goes, layer by layer, on the card.

Usage (on a machine with an NVIDIA GPU):

    python -m chemlab_tpu_torch.step_profile [--melt lj|tab|npt|chain|row]

Builds the 10k melt (``lj``: ``build_melt``; ``tab``:
``build_tabulated_melt``; ``npt``: ``build_melt`` under the Berendsen
barostat at pressure 0.15, tau 2.0; ``chain``: ``build_chain_melt``, the
step-growth tetramers with dihedrals, 1-4 pairs, func-8 bonded terms and
full-row reaction matching; ``row``: ``build_row_melt``, every nonbonded
variant and Coulomb on the Verlet row path), warms it up, runs one
200-step reactive block,
then times each layer of the step ``CALLS`` times (the reaction step 5
times) with the host clock and with
CUDA events, each series ending in a synchronize, and records 40 steps
without a reaction step under ``torch.profiler`` for the device's busy
share, the launches per step and the device time by kernel.  It refuses to
run without a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import torch

from . import testsystems
from .engine import (bonded_dense, bonded_forces, cell_pair, excl_dense,
                     integrate, neighbor, perf, reactions, runner)

N_MOLS = 3334   # trimers: the 10 002-particle cells of PERF.md
CHAIN_MOLS = 2500   # tetramers: 10 000 particles
CALLS = 50      # timed calls per layer


def _timed(fn, calls: int):
    """(host ms, device-event ms) per call over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(calls):
        fn()
    e1.record()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / calls
    return host, e0.elapsed_time(e1) / calls


def row_layers(spec, cfg, st):
    """The row path's layers as (name, zero-argument callable, calls
    scale)."""
    obs_x = torch.zeros(spec.obs_total.shape[0], device=st.pos.device)
    gen = runner.make_generator(7, st.device)
    return [
        ("md_step", lambda: integrate.md_step(spec, cfg, st, gen=gen), 1),
        ("compute_forces", lambda: integrate.compute_forces(
            spec, cfg, st, want_energy=False), 1),
        ("bonded_forces", lambda: bonded_forces.bonded_forces(
            spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
            st.angles, st.dihedrals, st.pairs14,
            dense=integrate._dense_of(cfg, st)), 1),
        ("pair_forces over the rows", lambda: integrate.row_pair_forces(
            spec, cfg, st, obs_x), 1),
        ("row rebuild (with births)", lambda: integrate.
         maybe_rebuild_neighbors(spec, cfg, st, force=True), 0.2),
        ("needs_rebuild + host read", lambda: bool(neighbor.needs_rebuild(
            st.pos, st.nbr, st.box, spec.skin)), 1),
        ("virial_pressure (row path: autograd in s)",
         lambda: integrate.virial_pressure(spec, cfg, st), 0.2),
        ("reaction_step + re-derivation (1 per interval)",
         lambda: excl_dense.rederive(cfg, bonded_dense.rederive(
             cfg, reactions.reaction_step(spec, cfg, st, 0))), 0.1),
    ]


def layers(spec, cfg, st):
    """The step's layers as (name, zero-argument callable, calls scale)."""
    if not cfg.use_pallas:
        return row_layers(spec, cfg, st)
    obs_x = torch.zeros(spec.obs_total.shape[0], device=st.pos.device)
    cheb = dict(cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0,
                cheb_ko=cfg.cheb_ko, cheb_ntab=cfg.cheb_ntab,
                cheb_mix=cfg.cheb_mix, obs_x=obs_x)
    gen = runner.make_generator(7, st.device)
    return [
        ("md_step", lambda: integrate.md_step(spec, cfg, st, gen=gen), 1),
        ("compute_forces", lambda: integrate.compute_forces(
            spec, cfg, st, want_energy=False), 1),
        ("bonded_forces", lambda: bonded_forces.bonded_forces(
            spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
            st.angles, st.dihedrals, st.pairs14,
            dense=integrate._dense_of(cfg, st)), 1),
        ("excluded-pair correction", lambda: integrate._excl_correction(
            spec, cfg, st, obs_x), 1),
        ("refresh_buckets", lambda: neighbor.refresh_buckets(
            st.nbr, st.pos, st.box, st.active, dims=cfg.cell_dims,
            cell_cap=cfg.cell_cap), 1),
        ("cell_pair_forces (pack + kernel + gather)",
         lambda: cell_pair.cell_pair_forces(
             st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
             st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
             uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, want_energy=False,
             **cheb), 1),
        ("needs_rebuild + host read", lambda: bool(neighbor.needs_rebuild(
            st.pos, st.nbr, st.box, spec.skin)), 1),
        ("virial_pressure", lambda: integrate.virial_pressure(spec, cfg, st),
         1),
        ("  kernel virial pass", lambda: cell_pair.cell_pair_forces(
            st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
            st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
            uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, want_virial=True,
            **cheb), 1),
        ("  bonded strain derivative (autograd)",
         lambda: bonded_forces.bonded_strain_derivative(
             spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
             st.angles, st.dihedrals, st.pairs14,
             dense=integrate._dense_of(cfg, st)), 1),
        ("reaction_step + re-derivation (1 per interval)",
         lambda: excl_dense.rederive(cfg, bonded_dense.rederive(
             cfg, reactions.reaction_step(spec, cfg, st, 0))), 0.1),
    ]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="step_profile")
    p.add_argument("--melt", choices=("lj", "tab", "npt", "chain", "row"),
                   default="tab")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_profile: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    if a.melt == "lj":
        built, systop, _ = testsystems.build_melt(n_mols=N_MOLS)
    elif a.melt == "npt":
        built, systop, _ = testsystems.build_melt(
            n_mols=N_MOLS, barostat="br", pressure=0.15, barostat_tau=2.0)
    elif a.melt == "chain":
        built, systop, _ = testsystems.build_chain_melt(n_mols=CHAIN_MOLS)
    elif a.melt == "row":
        built, systop, _ = testsystems.build_row_melt(n_mols=N_MOLS)
    else:
        built, systop, _ = testsystems.build_tabulated_melt(n_mols=N_MOLS,
                                                            reactive=True)
    spec, cfg = built.spec, built.cfg
    st = runner.initial_forces(spec, cfg, built.state)
    st = testsystems.warmup(built, st, steps=600)
    if a.melt == "chain":
        st = dataclasses.replace(st, reactions_on=torch.ones(
            (), dtype=torch.bool, device=st.device))
    else:
        st = testsystems.activate_initiators(
            built, systop, st, n=max(cfg.n_particles // 300, 4))
    gen = runner.make_generator(1234, "cuda")
    st = runner.run_block(spec, cfg, st, 200, gen=gen)
    torch.cuda.synchronize()
    print("%s melt: %d particles, grid %s, cap %d; events so far %d"
          % (a.melt, cfg.n_particles, cfg.cell_dims, cfg.cell_cap,
             int(st.reaction_counts.sum())))
    print("| Layer | host ms / call | device-event ms / call |")
    print("|---|---|---|")
    for name, fn, scale in layers(spec, cfg, st):
        host, dev = _timed(fn, max(int(CALLS * scale), 5))
        print("| %s | %.4f | %.4f |" % (name, host, dev))

    steps = 40
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    st2 = dataclasses.replace(st)
    no_gates = {"reaction": False, "atrp": False, "cpt": False}
    for _ in range(5):
        st2 = runner.step_with_extensions(spec, cfg, st2, gen=gen,
                                          gates=no_gates)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            st2 = runner.step_with_extensions(spec, cfg, st2, gen=gen,
                                              gates=no_gates)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not perf.is_span(e.name)]
    busy = sum(e.device_time_total for e in kern) / 1e3 / steps
    print("profiled: %.3f ms per step (profiler on), device busy %.4f ms, "
          "busy share %.4f, %.1f kernel launches per step"
          % (wall, busy, busy / wall, len(kern) / steps))
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    total = sum(by_name.values())
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        print("  %6.2f %%  %.4f ms/step  %s" % (100 * t / total,
                                                 t / 1e3 / steps, name[:90]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
