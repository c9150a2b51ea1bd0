"""Chebyshev-vs-row dynamics fidelity on a tabulated workload (M9).

Port of ``scripts/nve_drift.py``.  The production tabulated path is a
Chebyshev approximant of each table (``engine/tab_cheb.py``, K1c); the
exact path evaluates the tables themselves over persistent Verlet rows
(``engine/pair_forces.py``).  This measures the dynamics consequence, two
ways, on the tabulated melt (``testsystems.build_tabulated_melt``: every
nonbonded pair a func-8 table):

1. NVE drift: thermostat off, the total-energy trajectory on the kernel
   build (``use_pallas=None``: K1c) against the row build
   (``use_pallas=False``).  Reported as the linear drift rate dE/dt per
   particle per step (in kT) plus the RMS fluctuation around the fit.
   Both legs start from one warmed particle state, each with its neighbour
   state and forces rebuilt for its own geometry, so the only difference
   is the pair-force evaluation.
2. Thermostatted reactive observables: Langevin plus the ATRP reactions,
   the T, P and bond-count trajectories of the two builds.  The noise
   comes from a ``torch.Generator``, so these compare to the reference's
   statistically, never step by step.

    python -m chemlab_tpu_torch.nve_drift [--n_mols 2000]
        [--nve_steps 50000] [--reactive_steps 20000] [--block 1000]
        [--skip_nve] [--skip_reactive]

(``main(argv, device="cpu")`` runs it on the CPU.)

The last line is ``NVE_DRIFT_RESULT {json}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import numpy as np
import torch

from . import testsystems
from .engine import neighbor, runner


def run_leg(built, state0, steps, block, label, reactive=False,
            systop=None):
    """Run one path, returning per-block observable records; the Langevin
    noise, where the build has a thermostat, draws from a generator seeded
    with 0."""
    spec, cfg = built.spec, built.cfg
    st = state0
    gen = runner.make_generator(0, st.device)
    if reactive:
        st = testsystems.activate_initiators(
            built, systop, st, n=max(cfg.n_particles // 300, 4))
    recs = []
    t0 = time.perf_counter()
    done = 0
    while done < steps:
        st = runner.run_block(spec, cfg, st, block, gen=gen)
        done += block
        m = runner.measure(spec, cfg, st)
        rec = {"step": done,
               "T": float(m["T"]),
               "ekin": float(m["ekin"]),
               "epot": float(m["epot"]),
               "etot": float(m["ekin"]) + float(m["epot"]),
               "P": float(m["P"]) if "P" in m else None,
               "n_bonds": int(m["n_bonds"]),
               "events": int(m["reaction_counts"].sum()),
               "overflow": bool(m["overflow"])}
        recs.append(rec)
        if done % (block * 10) == 0:
            print(json.dumps({"leg": label, **rec}), flush=True)
    runner.synchronize(st.device)
    wall = time.perf_counter() - t0
    print(json.dumps({"leg": label, "wall_s": round(wall, 1),
                      "pps": round(cfg.n_particles * steps / wall, 1)}),
          flush=True)
    return recs


def drift_fit(recs, n_particles, kT=1.0):
    """Linear fit of Etot(step): drift per particle per step in kT."""
    s = np.array([r["step"] for r in recs], dtype=np.float64)
    e = np.array([r["etot"] for r in recs], dtype=np.float64)
    a, b = np.polyfit(s, e, 1)
    resid = e - (a * s + b)
    return {"drift_kT_per_particle_per_step": a / (n_particles * kT),
            "rms_fluct_kT_per_particle": float(np.sqrt(np.mean(resid**2)))
            / (n_particles * kT),
            "etot_first": e[0], "etot_last": e[-1]}


def _tables() -> str:
    """The melt's pair tables, written once into a fresh directory."""
    table_dir = tempfile.mkdtemp(prefix="chemlab_nve_")
    testsystems.write_lj_pair_tables(table_dir)
    return table_dir


def nve_builds(n_mols, device):
    """The NVE pair from one set of tables: (kernel build, row build)."""
    table_dir = _tables()
    return tuple(testsystems.build_tabulated_melt(
        n_mols=n_mols, reactive=False, use_pallas=use_pallas,
        thermostat="no", gen_velocity=True, table_dir=table_dir,
        device=device)[0] for use_pallas in (None, False))


def leg_start(built, st0):
    """The particle state of ``st0`` in ``built``'s own state, with its
    neighbour state and forces rebuilt for ``built``'s geometry."""
    spec, cfg = built.spec, built.cfg
    st = dataclasses.replace(built.state, step=st0.step, pos=st0.pos,
                             vel=st0.vel, image=st0.image, box=st0.box)
    rc_skin = torch.sqrt(torch.max(spec.pair_cutoff2)) + spec.skin
    nbr = neighbor.build_neighbor_state(
        st.pos, st.box, st.active, st.excl, rc_skin,
        dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
        max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap,
        track_birth=cfg.has_pps)
    return runner.initial_forces(spec, cfg,
                                 dataclasses.replace(st, nbr=nbr))


def nve_start(built_row, warmup_steps=600, settle_steps=400):
    """One shared warmup on the row build: the descent, then an NVE
    block."""
    st0 = runner.initial_forces(built_row.spec, built_row.cfg,
                                built_row.state)
    st0 = testsystems.warmup(built_row, st0, steps=warmup_steps, kT=1.0)
    return runner.run_block(built_row.spec, built_row.cfg, st0,
                            settle_steps)


def phase_nve(n_mols, nve_steps, block, device):
    """Phase 1: {"cheb": fit, "row": fit}, each with its ``records``."""
    built_k, built_x = nve_builds(n_mols, device)
    st0 = nve_start(built_x)
    legs = {}
    for label, built in (("cheb", built_k), ("row", built_x)):
        recs = run_leg(built, leg_start(built, st0), nve_steps, block,
                       "nve_" + label)
        legs[label] = drift_fit(recs, built.cfg.n_particles)
        legs[label]["records"] = recs
    return legs


def phase_reactive(n_mols, steps, block, device):
    """Phase 2: the thermostatted reactive pair's observables."""
    obs = {}
    table_dir = _tables()
    for label, use_pallas in (("cheb", None), ("row", False)):
        built, systop, _ = testsystems.build_tabulated_melt(
            n_mols=n_mols, reactive=True, use_pallas=use_pallas,
            store_pressure=True, table_dir=table_dir, device=device)
        spec, cfg = built.spec, built.cfg
        st = runner.initial_forces(spec, cfg, built.state)
        st = testsystems.warmup(built, st, steps=600)
        recs = run_leg(built, st, steps, block, "reactive_" + label,
                       reactive=True, systop=systop)
        half = recs[len(recs) // 2:]          # equilibrated half
        obs[label] = {
            "T_mean": float(np.mean([r["T"] for r in half])),
            "T_std": float(np.std([r["T"] for r in half])),
            "P_mean": float(np.mean([r["P"] for r in half])),
            "P_std": float(np.std([r["P"] for r in half])),
            "final_bonds": recs[-1]["n_bonds"],
            "final_events": recs[-1]["events"],
            "bond_traj": [r["n_bonds"] for r in recs],
        }
    return obs


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(prog="nve_drift")
    p.add_argument("--n_mols", type=int, default=2000)
    p.add_argument("--nve_steps", type=int, default=50000)
    p.add_argument("--reactive_steps", type=int, default=20000)
    p.add_argument("--block", type=int, default=1000)
    p.add_argument("--skip_nve", action="store_true")
    p.add_argument("--skip_reactive", action="store_true")
    a = p.parse_args(argv)
    dev = torch.device(device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(json.dumps({"device": name}), flush=True)

    out = {"n_mols": a.n_mols, "nve_steps": a.nve_steps,
           "reactive_steps": a.reactive_steps}
    if not a.skip_nve:
        legs = phase_nve(a.n_mols, a.nve_steps, a.block, dev)
        out["nve"] = {k: {kk: vv for kk, vv in v.items() if kk != "records"}
                      for k, v in legs.items()}
        out["nve_records"] = {
            k: v["records"][:: max(len(v["records"]) // 20, 1)]
            for k, v in legs.items()}
    if not a.skip_reactive:
        out["reactive"] = phase_reactive(a.n_mols, a.reactive_steps, a.block,
                                         dev)
    print("NVE_DRIFT_RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
