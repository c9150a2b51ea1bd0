#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (chemlab_tpu_torch).

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA GPU, ``nvcc`` and PyTorch built for CUDA.  It builds the CUDA
kernel from ``chemlab_tpu_torch/csrc`` and drives the port's main path, the
reactive ATRP-style trimer LJ melt at 10k particles:

  1. prints the card's name and power limit, builds the kernel;
  2. K1 against its plain torch version on the warmed 10k melt, in every
     parameter mode (uniform, all-LJ, per-pair lookup) and every ch3
     channel (none, energy, virial), and the kernel's and the plain
     version's times;
  3. the cancellation check: an excluded pair at r = 0.05 sigma;
  4. a small melt stepped on the GPU and on the CPU (the plain path the
     CPU tests hold against the JAX reference) from one state;
  5. the main path: one untimed and three timed 200-step Langevin blocks
     with reaction steps, checking that K1 ran on every step, that events
     fired, that the topology grew by exactly the accepted events, that
     no capacity overflowed and that the temperature held.

Any failed check raises and the script exits non-zero; without a GPU it
exits non-zero at once.  The last two lines are a JSON object with the
kernel's numbers and a JSON object ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

N_MOLS = 3334           # 10 002 particles
BLOCK_STEPS = 200
TIMED_BLOCKS = 3
MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)


def _tol(ref):
    """Kernel vs plain: per-row sums of ~10^2 f32 terms in another order."""
    return 2e-5 * (1.0 + ref.abs().max().item())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, reps: int) -> float:
    import torch

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


def mixed_params(spec, n_types: int, islj_gate: bool):
    """(5, T, T) K1 parameters with per-type-pair sigma and epsilon (seeded),
    and with one non-LJ type pair when ``islj_gate``: the inputs of the
    general lookup modes."""
    import numpy as np
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (n_types, n_types)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (n_types, n_types)).astype(np.float32)
    kind = spec.pair_kind.reshape(n_types, n_types).clone()
    if islj_gate:
        kind[0, 1] = kind[1, 0] = 0
    dev = spec.pair_sig.device
    mixed = dataclasses.replace(
        spec, pair_sig=torch.from_numpy(((s + s.T) / 2).reshape(-1)).to(dev),
        pair_eps=torch.from_numpy(((e + e.T) / 2).reshape(-1)).to(dev),
        pair_kind=kind.reshape(-1))
    return cell_pair.pair_params(mixed, n_types)


def check_kernel(built, state):
    """K1 vs plain in every mode on ``state``; returns (max_abs_err, ms,
    plain_ms)."""
    import numpy as np
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(state.pos, state.type_id, state.active),
        state.nbr.buckets, int(np.prod(cfg.cell_dims)))
    worst = 0.0
    for uniform, all_lj in MODES:
        params = (cell_pair.pair_params(spec, cfg.n_types) if uniform
                  else mixed_params(spec, cfg.n_types, not all_lj))
        for mode, label in ((cell_pair.CH3_NONE, "none"),
                            (cell_pair.CH3_ENERGY, "energy"),
                            (cell_pair.CH3_VIRIAL, "virial")):
            args = (cells, counts, state.box, params, cfg.cell_dims, uniform,
                    all_lj, mode)
            got = cell_pair.cell_pair_forces_colt_kernel(*args)
            ref = cell_pair.cell_pair_forces_colt_ref(*args)
            torch.cuda.synchronize()
            err_f = (got[..., :3] - ref[..., :3]).abs().max().item()
            err_3 = (got[..., 3] - ref[..., 3]).abs().max().item()
            tol_f, tol_3 = _tol(ref[..., :3]), _tol(ref[..., 3])
            print("K1 vs plain uniform=%d all_lj=%d ch3=%-6s max|dF| %.3e "
                  "(tol %.3e)  max|dch3| %.3e (tol %.3e)"
                  % (uniform, all_lj, label, err_f, tol_f, err_3, tol_3))
            if not (err_f <= tol_f and err_3 <= tol_3):
                raise AssertionError("K1 disagrees with its plain version")
            worst = max(worst, err_f, err_3)
    args = (cells, counts, state.box, cell_pair.pair_params(spec, cfg.n_types),
            cfg.cell_dims, cfg.uniform_lj, cfg.all_lj, cell_pair.CH3_NONE)
    ms = _time_ms(lambda: cell_pair.cell_pair_forces_colt_kernel(*args), 50)
    plain_ms = _time_ms(lambda: cell_pair.cell_pair_forces_colt_ref(*args), 5)
    print("K1 time at %s cells x cap %d: kernel %.4f ms, plain %.4f ms"
          % (cfg.cell_dims, cfg.cell_cap, ms, plain_ms))
    return worst, ms, plain_ms


def check_cancellation(built, state):
    """One excluded pair at r = 0.05 sigma: kernel minus correction is
    finite and equals plain minus correction."""
    import numpy as np
    import torch

    from chemlab_tpu_torch.engine import cell_pair, neighbor

    cfg, spec = built.cfg, built.spec
    i, j = (int(x) for x in state.excl[0].tolist())
    pos = state.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0], device=pos.device)
    pos = pos - torch.floor(pos / state.box) * state.box
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, state.box, state.active, cfg.cell_dims, cfg.cell_cap)
    assert not bool(ovf)
    n_cells = int(np.prod(cfg.cell_dims))
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(pos, state.type_id, state.active), buckets,
        n_cells)
    args = (cells, counts, state.box, cell_pair.pair_params(spec, cfg.n_types),
            cfg.cell_dims, cfg.uniform_lj, cfg.all_lj, cell_pair.CH3_NONE)
    in_grid = slot_of < n_cells * cfg.cell_cap
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, state.box, state.type_id, state.excl,
        active=state.active)[0]
    out = []
    for fn in (cell_pair.cell_pair_forces_colt_kernel,
               cell_pair.cell_pair_forces_colt_ref):
        rows = fn(*args).reshape(-1, 4)[torch.where(in_grid, slot_of, 0)
                                        .long()]
        out.append(torch.where(in_grid[:, None], rows[:, :3], 0.0) - f_ex)
    got, ref = out
    big = max(ref.abs().max().item(), f_ex.abs().max().item())
    err = (got - ref).abs().max().item()
    tol = 2e-5 * (1.0 + big)
    print("cancellation at r=0.05 sigma: pair (%d, %d) max|dF| %.3e (tol "
          "%.3e), |F_i| kernel %.4f plain %.4f" % (
              i, j, err, tol, got[i].norm().item(), ref[i].norm().item()))
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("kernel minus correction does not cancel")


def check_small_melt_against_cpu():
    """The 70-trimer melt on the GPU and on the CPU from one state: forces
    and 20 NVE steps agree."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    built, _, _ = testsystems.build_melt(n_mols=70, thermostat="no",
                                         device="cpu")
    cfg = built.cfg
    st_c = runner.initial_forces(built.spec, cfg, built.state)
    st_c = testsystems.warmup(built, st_c, steps=50)
    spec_g, st_g = built.spec.to("cuda"), st_c.to("cuda")
    f_c, e_c, _ = integrate.compute_forces(built.spec, cfg, st_c)
    f_g, e_g, _ = integrate.compute_forces(spec_g, cfg, st_g)
    err = (f_g.cpu() - f_c).abs().max().item()
    # the excluded pairs' terms sit in both f32 sums before they cancel, so
    # the rounding scales with the all-pairs sum, not with the net force
    f_all = cell_pair.cell_pair_forces(
        st_c.pos, st_c.type_id, st_c.active, st_c.box, st_c.nbr.buckets,
        st_c.nbr.slot_of, cfg.cell_dims, built.spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
    tol = _tol(f_all)
    print("small melt GPU vs CPU: max|dF| %.3e (tol %.3e), lj %.5f vs %.5f"
          % (err, tol, float(e_g["lj"]), float(e_c["lj"])))
    if err > tol:
        raise AssertionError("GPU forces disagree with the CPU path")
    for _ in range(20):
        st_c = integrate.md_step(built.spec, cfg, st_c)
        st_g = integrate.md_step(spec_g, cfg, st_g)
    err = (st_g.pos.cpu() - st_c.pos).abs().max().item()
    print("small melt 20 NVE steps GPU vs CPU: max|dpos| %.3e (tol 1e-4)"
          % err)
    if not err <= 1e-4:
        raise AssertionError("GPU trajectory disagrees with the CPU path")


def main_path(built, systop, state, card: str):
    """Untimed + timed reactive blocks; returns the launch count."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, runner

    cfg, spec = built.cfg, built.spec
    n_bonds0 = int(state.bonds.valid.sum())
    state = testsystems.activate_initiators(
        built, systop, state, n=max(cfg.n_particles // 300, 4))
    gen = runner.make_generator(1234, "cuda")

    cell_pair.K1.launches = 0
    state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    events0 = int(state.reaction_counts.sum())
    t0 = time.perf_counter()
    for _ in range(TIMED_BLOCKS):
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cell_pair.K1.launches

    m = {k: v.cpu() for k, v in runner.measure_cheap(spec, cfg,
                                                      state).items()}
    steps = (TIMED_BLOCKS + 1) * BLOCK_STEPS
    events = int(m["reaction_counts"].sum())
    T = float(runner.measure(spec, cfg, state)["T"])
    pps = cfg.n_particles * TIMED_BLOCKS * BLOCK_STEPS / wall
    print("main path: %d particles, %d timed steps in %.3f s: %.1f "
          "particle-steps/s on %s" % (cfg.n_particles,
                                      TIMED_BLOCKS * BLOCK_STEPS, wall, pps,
                                      card))
    print("reaction events: %d (%d in the timed blocks), per channel %s"
          % (events, events - events0, m["reaction_counts"].tolist()))
    print("final T %.4f kT; n_bonds %d (%d at build), n_angles %d, n_excl %d;"
          " K1 launches %d over %d steps; overflow %s"
          % (T, int(m["n_bonds"]), n_bonds0, int(m["n_angles"]),
             int(m["n_excl"]), launches, steps, bool(m["overflow"])))
    kT = float(spec.kT)
    checks = {
        "K1 launched on every step": launches >= steps,
        "no capacity overflow": not bool(m["overflow"]),
        "T finite and within 0.5-1.5 kT": 0.5 * kT <= T <= 1.5 * kT,
        "reaction events fired": events > 0,
        "one new bond per event": int(m["n_bonds"]) - n_bonds0 == events,
        "jax never imported": "jax" not in sys.modules,
    }
    for name, ok in checks.items():
        print("check %-32s %s" % (name, "ok" if ok else "FAILED"))
    if not all(checks.values()):
        raise AssertionError("main-path checks failed")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    build_s = cell_pair.K1.build()
    print("K1 build: %.2f s" % build_s)

    t0 = time.perf_counter()
    built, systop, _ = testsystems.build_melt(n_mols=N_MOLS, device="cuda")
    state = runner.initial_forces(built.spec, built.cfg, built.state)
    state = testsystems.warmup(built, state, steps=600)
    torch.cuda.synchronize()
    print("10k melt: %d particles, grid %s, cell_cap %d; build + warmup "
          "%.1f s" % (built.cfg.n_particles, built.cfg.cell_dims,
                      built.cfg.cell_cap, time.perf_counter() - t0))

    err, ms, plain_ms = check_kernel(built, state)
    check_cancellation(built, state)
    check_small_melt_against_cpu()
    launches = main_path(built, systop, state, card)

    print(json.dumps({"kernels": [{
        "name": "K1 cell_pair_colt (LJ)", "route": "cuda",
        "source": "chemlab_tpu_torch/csrc/cell_pair.cu",
        "replaces": "chemlab_tpu/engine/pallas_pair.py:211",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
