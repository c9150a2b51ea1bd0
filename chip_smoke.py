#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (chemlab_tpu_torch).

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA GPU, ``nvcc`` and PyTorch built for CUDA.  It builds the CUDA
kernels from ``chemlab_tpu_torch/csrc`` (one ``nvcc`` per source, all at
once) and drives the port's paths at 10k particles:

  1. prints the card's name and power limit, builds the kernels;
  2. the reactive trimer LJ melt (K1): K1 against its plain torch version
     in every parameter mode (uniform, all-LJ, per-pair lookup) and every
     ch3 channel (none, energy, virial), K1's column-segment kernel against
     its cellwise baseline (the first design) bit for bit in every mode and
     channel, with device times by the profiler in turns (new, cellwise,
     cellwise, new) in every channel, here and on the melt tiled 2 x 2 x 2
     (22^3 cells at cap 32 and at cap 40, also against plain), K2 against
     K1 on the same operands (difference, bitwise or not, both times), the
     cancellation check at an excluded pair 0.05 sigma apart, a small melt
     stepped on the GPU and on the CPU from one state, and the main path:
     one untimed and one timed 200-step Langevin block with reaction
     steps;
  3. K2, the LJ kernel for grids colt2 cannot take (K1's column-segment
     kernel over the deduplicated stencil): on the 10k melt built with
     cell_cap=36 (11x11x11, S = 27) and on the 40-trimer melt at density
     0.3 (2x2x2, S = 8), K2 against its plain version in every mode and
     channel and the cancellation check; K2 against its cellwise baseline
     (the first design) bit for bit in every mode and channel on both and
     on the film (32 x 32 x 2 cells, ~13.5k particles, S = 18), with
     device times by the profiler in turns (new, cellwise, cellwise, new)
     at 10k and on the film; then the K2 main path: one untimed and one
     timed reactive block of the cap-36 melt;
  3b. the ladder (K1' colt1, K3a packet, K3b resident, K3c colz, K3d
     column) on the warmed 10k LJ melt: each against its plain version in
     both parameter modes, K3a-K3d against K2 and K1 on the same operands
     (forces bit for bit), K1' against K1, the cancellation check, times
     and bounds (K3d's row on its own path's operands, the cap-36 melt);
     K3a (a warp per live packet), K3b (a warp per row), K3c (whole
     neighbour columns by bulk copies), K3d (column windows by bulk
     copies) and K1' (K1's body with colt1's per-column sums) against
     their first designs bit for bit in both parameter modes, with device
     times in turns (K3a, K3b and K3c at 10k, K3c's bits also on a random
     grid with an axis of 2 at cap 24; K3d at 10k cap 36 and on the film,
     bits also on the 2x2x2 melt; K1' at 10k in both of its channels); the
     five ladder kernels, K1 and K2 timed in turns on identical operands;
     one untimed and one timed reactive block through
     ``run_block(pair_kernel=...)`` for "colt1", "packet", "resident" and
     "column" (K3c at cap 32; K3d on the cap-36 melt), each launching its
     kernel exactly once a step and K1 never; then the kernel matrix
     (``chemlab_tpu_torch.kernel_matrix.time_kernels``);
  4. NPT: the 10k reactive melt under the Berendsen barostat (pressure
     0.15, tau 2.0) with Langevin, one untimed and one timed block, K1
     for the forces and K1b (the virial channel) for the pressure on every
     step; after a first block (the box has moved) K1b against its plain
     version and K1/K1b against the cellwise kernel bit for bit and in
     turns; then the 40-trimer melt: 20 NVE steps under 'br' on the GPU
     and on the CPU from one state (K2 in both channels), and 200 Langevin
     steps under the Langevin barostat 'lv';
  5. the tabulated melt (every type pair a func-8 table, K1c) and the
     blended tabulated melt (func 10/12 pairs, K1d): K1c, K1d and the
     coefficient-plane mode K1e against their plain versions in every ch3
     channel and against the cellwise kernel (the first design, kept as
     the baseline) bit for bit, with device times by the profiler in turns
     (new, cellwise, cellwise, new) at 10k and on the melt tiled 2 x 2 x 2
     (22^3 cells at cap 32 and at cap 40), the whole pair call of both
     (the kernel matrix's), the cancellation check in the wall, a small
     tabulated melt stepped on the GPU and on the CPU, and the main path:
     one untimed and one timed reactive block of the tabulated melt;
     then one untimed and one timed block of the blended melt (K1d) and of
     the tabulated melt in plane mode (K1e);
  6. the slab decomposition (K1f): on the 10k LJ melts built with
     slab_devices=2 (10x11x11) and 4 (8x11x11) and the tabulated and
     blended melts built with slab_devices=2, K1f on every slab against its
     plain version in every mode and ch3 channel (and against the cellwise
     kernel bit for bit, timed in turns on slab 0; LJ on slab 0 of 2 and of
     4), the slabs laid side by side against the full-grid K1, K1c, K1d and
     K1e bit for bit, and the cancellation check; then two gloo ranks of
     ``parallel.launch``, both on cuda:0, run the reactive LJ melt (one
     untimed and one timed block),
     one tabulated and one blended block and one NPT pressure, each against
     one rank from the same state and seed (positions, replicas, launches,
     pressure);
  7. the CLI (``cli``): ``start_simulation.main`` in-process on a copy of
     ``examples/atrp_melt`` (6000 particles, 9^3 cells, cap 40) with
     ``@params --run 1200 --int_step 200 --start_ar 600 --retune_caps
     0 ...``: exit 0, K1 at least once a step and no other kernel, the
     retune equal to ``shrink_neighbor_caps`` on the frame of its step, no
     overflow, events fired and in ``_topol.top``, every energy row finite
     with T in 0.5-1.5, 6000 atoms in ``_confout.gro``, the CLI's own
     particle-steps/s and ``--timers`` phases (where h5py is missing a
     recording stand-in takes the H5MD frames, and the script says so);
     then caps changed on the card (a build at cell_cap 8 grown until the
     overflow flag clears, grown once more and shrunk back, K1 against
     plain at every cap and a block with no overflow; the term tables
     grown from nearly full and the next blocks' events all landed) and a
     checkpoint restored into a fresh build continuing bit for bit;
  8. the bonded layer (``bonded``): the 10k step-growth chain melt
     (``testsystems.build_chain_melt``: E-B-B-E tetramers with func-8
     bonds and angles, Ryckaert-Bellemans dihedrals and their 1-4 pairs,
     and an E + E -> F:F link that creates func-1, func-8 and, by type
     lookup, func-12 dihedrals; the type_1 side is half the particles, so
     the full-row matcher runs): the build's funcs and gates, bonded
     forces, every energy term and the bonded strain derivative on the
     card against the CPU on the warmed state, one full-row reaction step
     on both with equal event lists and tables, the 40-tetramer melt
     (3x3x3 cells) stepped 20 NVE steps on both, and the main path: one
     untimed and one timed reactive block, K1 exactly once a step in
     each;
  9. the reaction extensions (``extensions``) on two 10k trimer melts:
     the break melt (``testsystems.build_break_melt``: CSVR, the ATRP
     forward reaction with ChangeNeighboursProperty and
     RemoveNeighboursBonds, so the sequential event scan runs, chain
     growth restricted to a connectivity map, MA:ML dissociation with a
     lambda fade) and the release melt (``build_release_melt``: a
     ReleaseMolecule dummy per MA, JoinMolecule, ATRPActivator,
     ChangeParticleType, a removing FreezeRegion): (a) the build's flags
     and K1 against plain at the melt's own caps, (b) one reaction step
     and the ATRP, FreezeRegion and ChangeParticleType steps on the card
     and on the CPU from one state under the same draws, event lists and
     integer tables equal, (c) the 70-trimer melt stepped 20 NVE steps on
     both, (d) the main path: one untimed and two timed blocks, K1
     exactly once a step in each, then the same run from the same start,
     not timed, with every mechanism counted (each must fire), (e) the
     invariants of the counted run's end (adjacency =
     bonds, angle and dihedral pairs are bonds, molecules = components
     away from unrelabelled removals, bond balance, FixDistances pairs at
     eq, lambda in [0, 1], removed particles in no table and at rest, T,
     no overflow), then the launches a step and a reaction step and the
     ms of a reaction step;
  10. the Verlet row path (``rows``) on the 10k row melt
     (``testsystems.build_row_melt``: the charged ATRP melt with funcs 8,
     13-17 and LJ on its type pairs and Coulomb between the charges, which
     sends it to the row path): (a) the build took the row path and no
     cell kernel launches in the phase, (c) after a 600-step descent one
     untimed and two timed 200-step blocks (T, events, bonds gained =
     events, no overflow, rebuilds, func-14 pairs in the rows, the MA-PA
     blend's switch crossed, every energy finite), (b) at the run's end
     the rows with their func-14 births, ``pair_forces``, the row-path
     virial and one reaction step on the card against the CPU, then the
     ms of a rebuild, a ``pair_forces`` and a ``virial_pressure`` and the
     launches a step, (d) a 200-step Berendsen side run (P finite, the box
     moved);
  11. the engine's tools (``tools``): (a) the native host library builds
     and its .gro read equals ``read_gro`` field for field on
     ``examples/atrp_melt``, (b) ``testsystems.generate_example`` writes a
     10k example (K1 once a step of its descent and Langevin block and at
     each force initialisation) and the port's CLI runs it 400 steps
     (exit 0, energies finite, T in 0.5-1.5), (c) ``tune_skin`` on it over
     three skins (particle-steps/s a skin, the winner, K1 for every step),
     (d) ``nve_drift``'s NVE pair on the 10k tabulated melt, 600 steps a
     leg from one state: K1c once a step in the kernel leg, no cell kernel
     in the row leg, the step-0 pair energies within 5e-3, every Etot
     finite, each leg's drift, fluctuation and wall time;
  12. M14 (``m14``): (a) ``start_simulation.main`` on a copy of
     ``examples/atrp_melt`` with ``--node_grid 1,1,3`` and
     ``device="cuda:0"`` (3 gloo ranks on the card, reactions from step 0,
     2 blocks of 200 steps) against the same flags on one rank: counters,
     bonds and ``_confout.gro`` equal, each rank's K1f count (K1 none),
     rank 0 alone writing files; (b)-(d) in one ``run_jobs`` call on 2
     gloo ranks of cuda:0: the 10k break and release melts
     (``slab_devices=2``, reaction interval 50, 200 steps), a
     ``grow_neighbor_caps`` between two 100-step blocks of the 10k LJ melt
     and the 10k row melt (each rank its block of rows), each against one
     rank from the same state and seed: the integer state equal, positions
     bitwise on the K1f paths, every mechanism fired, the row path's
     max|dF|, energies and virial pressure, the replicas, the launches a
     step and the particle-steps/s; then the phase's wall time;
  13. the bonded kernel (``bonded_kernel``, ``csrc/bonded.cu``) at the
     benchmark cell's shapes: the 400 002-particle ATRP melt after a
     capped descent, the caps' retune, 1 333 initiators and two reactive
     blocks with the CLI's cap decisions after each, as the cell sets up:
     the kernel
     against its plain twin and the autograd path on the card, a second
     call bit for bit, one launch count a call, the device operations of
     one ``bonded_forces`` call by the profiler (no autograd kernel), the
     kernel's device time beside its byte bound, the twin's and the
     autograd path's, and one main-path block with the kernel once a
     step.  The total wall time is printed last.  ``python3 chip_smoke.py
     --only m14`` (or ``--only bonded_kernel``) builds the kernels and
     runs that phase alone (no kernels line and no result line).
  Each path checks that its kernel ran on every step, that events fired,
  that the topology grew by exactly the accepted events, that no capacity
  overflowed and that the temperature held; the NPT path also that the
  pressure is finite, that the box moved and that the static cell grid
  still holds (box / cell_dims >= cutoff + skin).

Any failed check raises and the script exits non-zero; without a GPU it
exits non-zero at once.  The last lines are the card line, a JSON object
with every kernel's numbers and a JSON object ``{"ok": true, ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

N_MOLS = 3334           # 10 002 particles
BLOCK_STEPS = 200
TIMED_BLOCKS = 1
# the reference NPT test's settings and its 2x2x2 melt
NPT = dict(barostat="br", pressure=0.15, barostat_tau=2.0)
SMALL_GRID = dict(n_mols=40, density=0.3, seed=3, reactive=False)
MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
TILE_CAPS = (32, 40)    # the 10k melt's cap and the 100k melt's
CH3 = ((0, "none"), (1, "energy"), (2, "virial"))
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and f32 FLOP/s
# outside the tensor cores, the units every kernel here computes in
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12
# f32 operations per candidate pair (minimum image, r2, validity, cut) and
# per pair inside the cutoff (LJ: soft core, s6, force; accumulate)
OPS_CANDIDATE = 22
OPS_LJ = 24
OPS_VIRIAL = 2          # the virial channel's f * r2 and its accumulation


def _ops_cheb(kw: int, ko: int, mix: bool) -> int:
    """f32 operations of one Chebyshev evaluation and its accumulation:
    clamp and y (5), two terms (2), 5 per further term; the well piece the
    same in x; the blend 5 more and a second chain; accumulation 6."""
    chain = 7 + 5 * (kw - 2) + (7 + 5 * (ko - 2) if ko else 0)
    return (2 * chain + 5 if mix else chain) + 6


def _tol(ref):
    """Kernel vs plain: per-row sums of ~10^2 f32 terms in another order."""
    return 2e-5 * (1.0 + ref.abs().max().item())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _time_ms(fn, reps: int) -> float:
    """CUDA events around ``reps`` calls after one (the kernel matrix's
    timer)."""
    from chemlab_tpu_torch.kernel_matrix import time_ms

    return time_ms(fn, reps)


def _no_reference_modules() -> bool:
    return not any(m == "jax" or m.startswith("jax.") or m == "chemlab_tpu"
                   or m.startswith("chemlab_tpu.") for m in sys.modules)


def _require(checks: dict, label: str):
    """Print each named check; raise if any failed."""
    for name, ok in checks.items():
        print("check %-42s %s" % (name, "ok" if ok else "FAILED"))
    if not all(checks.values()):
        raise AssertionError("%s checks failed" % label)


def pair_counts(cells, box, cut2, dims, x_halo: bool = False):
    """(candidate pairs the kernel loop visits, pairs inside the cutoff) on
    these cells (a K1f slab with ``x_halo``): the data-dependent work of
    one call."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    _, r2, valid, xi, xj = cell_pair.stencil_pairs(cells, box, dims, x_halo)
    vi = xi[:, :, 3] > 0.5
    vj = xj[:, :, 3] > 0.5
    cand = int((vi.sum(1).to(torch.int64) * vj.sum(1)).sum())
    pid = cell_pair.type_pairs(xi, xj, cut2.shape[0])
    inside = valid & (r2 < cut2.reshape(-1)[pid])
    return cand, int(inside.sum())


def bound_ms(cells, small_bytes: int, cand: int, inside: int,
             ops_pair: int, out_rows=None, out_ch: int = 4):
    """The least time for the call: each input read once and the output
    (``out_rows`` cells, every cell by default, ``out_ch`` floats a slot)
    written once over HBM, or its f32 operations over the f32 peak."""
    out_rows = cells.shape[0] if out_rows is None else out_rows
    n_bytes = (cells.numel() + out_rows * cells.shape[1] * out_ch) * 4 \
        + cells.shape[0] * 4 + small_bytes
    ops = cand * OPS_CANDIDATE + inside * ops_pair
    t_bytes, t_ops = n_bytes / HBM_BYTES_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cells(built, state):
    import numpy as np

    from chemlab_tpu_torch.engine import cell_pair

    return cell_pair.colt_operands(
        cell_pair.pack_rows(state.pos, state.type_id, state.active),
        state.nbr.buckets, int(np.prod(built.cfg.cell_dims)))


# ---- K1 (LJ) ------------------------------------------------------------------

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


# name, source, TPU kernel replaced, of each LJ kernel's row
LJ_ROWS = {
    "K1": ("K1 cell_pair_colt (LJ)", "chemlab_tpu_torch/csrc/cell_pair.cu",
           "chemlab_tpu/engine/pallas_pair.py:211"),
    "K1b": ("K1b cell_pair_colt (LJ, virial channel)",
            "chemlab_tpu_torch/csrc/cell_pair.cu",
            "chemlab_tpu/engine/pallas_pair.py:211"),
    "K2": ("K2 cell_pair_cell (LJ, any grid: the column-segment kernel "
           "over the deduplicated stencil)",
           "chemlab_tpu_torch/csrc/cell_pair_cell.cu",
           "chemlab_tpu/engine/pallas_pair.py:97"),
}


def lj_fns(cfg):
    """(kernel launcher, plain version) of the LJ kernel the grid takes:
    K1 on a colt2 grid, K2 on any other."""
    from chemlab_tpu_torch.engine import cell_pair

    if cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims):
        return (cell_pair.cell_pair_forces_colt_kernel,
                cell_pair.cell_pair_forces_colt_ref)
    return (cell_pair.cell_pair_forces_cell_kernel,
            cell_pair.cell_pair_forces_cell_ref)


def check_kernel(built, state, label: str, channels=CH3, time_mode=0,
                 timed: bool = True):
    """The grid's LJ kernel vs plain in every parameter mode and in
    ``channels`` on ``state``; with ``timed``, times both in ``time_mode``
    and returns the row of ``label`` (launches filled in later)."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    kern, plain = lj_fns(cfg)
    cells, counts = _cells(built, state)
    worst = 0.0
    for uniform, all_lj in MODES:
        params = (cell_pair.pair_params(spec, cfg.n_types) if uniform
                  else mixed_params(spec, cfg.n_types, not all_lj))
        for mode, name in channels:
            args = (cells, counts, state.box, params, cfg.cell_dims, uniform,
                    all_lj, mode)
            got = kern(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err_f = (got[..., :3] - ref[..., :3]).abs().max().item()
            err_3 = (got[..., 3] - ref[..., 3]).abs().max().item()
            tol_f, tol_3 = _tol(ref[..., :3]), _tol(ref[..., 3])
            print("%s vs plain at %s x cap %d uniform=%d all_lj=%d ch3=%-6s "
                  "max|dF| %.3e (tol %.3e)  max|dch3| %.3e (tol %.3e)"
                  % (label, cfg.cell_dims, cfg.cell_cap, uniform, all_lj,
                     name, err_f, tol_f, err_3, tol_3))
            if not (err_f <= tol_f and err_3 <= tol_3):
                raise AssertionError("%s disagrees with its plain version"
                                     % label)
            worst = max(worst, err_f, err_3)
    if not timed:
        return None
    params = cell_pair.pair_params(spec, cfg.n_types)
    args = (cells, counts, state.box, params, cfg.cell_dims, cfg.uniform_lj,
            cfg.all_lj, time_mode)
    ms = _time_ms(lambda: kern(*args), 50)
    plain_ms = _time_ms(lambda: plain(*args), 5)
    extra = {}
    if label in ("K1", "K1b", "K2"):
        old = (k2_fns() if label == "K2" else colt_fns())[1]
        extra["ms_before"] = _time_ms(lambda: old(*args), 50)
    cand, inside = pair_counts(cells, state.box, params[2], cfg.cell_dims)
    n_stencil = cell_pair.stencil_table(cfg.cell_dims).shape[1]
    ops_pair = OPS_LJ + (OPS_VIRIAL if time_mode == 2 else 0)
    b_ms, b_by = bound_ms(cells, params.numel() * 4 + 12 + 12 * n_stencil,
                          cand, inside, ops_pair)
    print("%s time at %s cells x cap %d (S = %d): kernel %.4f ms%s, plain "
          "%.4f ms; %d candidate pairs, %d inside the cutoff, bound %.6f ms "
          "(%s)" % (label, cfg.cell_dims, cfg.cell_cap, n_stencil, ms,
                    " (cellwise %.4f ms)" % extra["ms_before"] if extra
                    else "", plain_ms, cand, inside, b_ms, b_by))
    name, source, replaces = LJ_ROWS[label]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, **extra}


def colt_fns(x_halo: bool = False):
    """(column-segment kernel, cellwise kernel) of LJ as functions of the
    operands (cells, counts, box, params, dims, uniform, all_lj, ch3)."""
    from chemlab_tpu_torch.engine import cell_pair

    return (lambda *a: cell_pair.cell_pair_forces_colt_kernel(
                *a, x_halo=x_halo),
            lambda *a: cell_pair.cell_pair_forces_colt_cellwise(
                *a, x_halo=x_halo))


def k2_fns():
    """(column-segment K2, cellwise K2) as functions of the operands
    (cells, counts, box, params, dims, uniform, all_lj, ch3)."""
    from chemlab_tpu_torch.engine import cell_pair

    return (cell_pair.cell_pair_forces_cell_kernel,
            cell_pair.cell_pair_forces_cell_cellwise)


def colt_ab(label: str, built, cells, counts, box, dims,
            x_halo: bool = False, timed: bool = True, k2: bool = False):
    """The LJ column-segment kernel (K1, K1b, K1f; K2 with ``k2``) against
    its cellwise kernel on these operands: bit for bit in every parameter
    mode of MODES and every ch3 channel; then, with ``timed``, device time
    by the profiler, 50 calls each in turns (new, old, old, new), in every
    channel in the melt's own parameter mode.  Returns {ch3: (new ms, old
    ms)}, each the mean of its two turns."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair
    from chemlab_tpu_torch.kernel_matrix import (COLT_NEW, COLT_OLD, K2_NEW,
                                                 K2_OLD)

    cfg, spec = built.cfg, built.spec
    new, old = k2_fns() if k2 else colt_fns(x_halo)
    names = (K2_NEW, K2_OLD) if k2 else (COLT_NEW, COLT_OLD)
    for uniform, all_lj in MODES:
        params = (cell_pair.pair_params(spec, cfg.n_types) if uniform
                  else mixed_params(spec, cfg.n_types, not all_lj))
        for mode_3, name in CH3:
            args = (cells, counts, box, params, dims, uniform, all_lj,
                    mode_3)
            a, b = new(*args), old(*args)
            torch.cuda.synchronize()
            diff = (a - b).abs().max().item()
            print("%s new vs cellwise uniform=%d all_lj=%d ch3=%-6s "
                  "max|diff| %.3e, bitwise %s"
                  % (label, uniform, all_lj, name, diff, torch.equal(a, b)))
            if not torch.equal(a, b):
                raise AssertionError("%s: the column-segment kernel differs "
                                     "from the cellwise kernel" % label)
    if not timed:
        return {}
    args = (cells, counts, box, cell_pair.pair_params(spec, cfg.n_types),
            dims, cfg.uniform_lj, cfg.all_lj)
    return device_turns(label, lambda m: new(*args, m),
                        lambda m: old(*args, m), *names,
                        [m for m, _ in CH3])


def ab_numbers(ab, ch3: int) -> dict:
    """A row's device times from ``colt_ab``/``cheb_ab``: the row's own
    channel ``ch3``, and every channel timed."""
    return {"device_ms": ab[ch3][0], "device_ms_before": ab[ch3][1],
            "device_ms_by_ch3": {str(k): list(v) for k, v in ab.items()}}


def check_colt_tiled(built, state):
    """K1 on the LJ melt tiled 2 x 2 x 2 (22^3 cells) at each of TILE_CAPS:
    the new kernel against the cellwise kernel (bits in every mode and
    channel, device time in turns) and, in the energy channel, against the
    plain version."""
    from chemlab_tpu_torch import kernel_matrix
    from chemlab_tpu_torch.engine import cell_pair

    cfg = built.cfg
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    out = {}
    for cap in TILE_CAPS:
        cells, counts, box, dims = kernel_matrix.tiled_operands(built, state,
                                                                cap)
        label = "K1 tiled %s x cap %d (%d particles)" % (
            dims, cap, int(counts.sum()))
        ab = colt_ab(label, built, cells, counts, box, dims)
        args = (params, dims, cfg.uniform_lj, cfg.all_lj,
                cell_pair.CH3_ENERGY)
        got = cell_pair.cell_pair_forces_colt_kernel(cells, counts, box,
                                                     *args)
        check_by_halves(label, got, cells, counts, dims,
                        lambda c, n, d: cell_pair.cell_pair_forces_colt_ref(
                            c, n, box, params, d, cfg.uniform_lj, cfg.all_lj,
                            cell_pair.CH3_ENERGY, x_halo=True))
        out[str(cap)] = ab_numbers(ab, cell_pair.CH3_NONE)
    return out


def check_by_halves(label: str, got, cells, counts, dims, plain_slab):
    """``got`` (the kernel's energy-channel rows on a tiled grid) against
    the plain version, run slab by slab over the halves of x as K1f
    (``plain_slab(cells, counts, slab dims)``), which keeps its (cells,
    cap, 27 cap) intermediates within the card."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair_halo

    ref = torch.cat([
        plain_slab(cells[ids], counts[ids],
                   (dims[0] // 2 + 2, dims[1], dims[2]))
        for ids in (cell_pair_halo.slab_cells(dims, 2, r, cells.device)
                    for r in range(2))])
    torch.cuda.synchronize()
    err, tol = (got - ref).abs().max().item(), _tol(ref)
    del ref
    torch.cuda.empty_cache()
    print("%s vs plain ch3=energy max|d| %.3e (tol %.3e)" % (label, err, tol))
    if not err <= tol:
        raise AssertionError("%s disagrees with its plain version" % label)


def compare_k1_k2(built, state):
    """K1 and K2 on the same colt2 operands: equal bit for bit in every
    channel (the same stencil order, then slot order), and both times,
    taken in turns (K1, K2, K2, K1)."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    cfg = built.cfg
    cells, counts = _cells(built, state)
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    fns = (cell_pair.cell_pair_forces_colt_kernel,
           cell_pair.cell_pair_forces_cell_kernel)
    for mode, name in CH3:
        args = (cells, counts, state.box, params, cfg.cell_dims,
                cfg.uniform_lj, cfg.all_lj, mode)
        k1, k2 = (fn(*args) for fn in fns)
        torch.cuda.synchronize()
        diff = (k1 - k2).abs().max().item()
        print("K1 vs K2 on identical operands (%s x cap %d) ch3=%-6s "
              "max|diff| %.3e, bitwise %s" % (cfg.cell_dims, cfg.cell_cap,
                                              name, diff, torch.equal(k1, k2)))
        if not torch.equal(k1, k2):
            raise AssertionError("K1 and K2 differ on a full grid")
    args = (cells, counts, state.box, params, cfg.cell_dims, cfg.uniform_lj,
            cfg.all_lj, cell_pair.CH3_NONE)
    t = [_time_ms(lambda fn=fn: fn(*args), 50)
         for fn in (fns[0], fns[1], fns[1], fns[0])]
    print("K1 vs K2 A/B on identical operands: K1 %.6f / %.6f ms, K2 %.6f / "
          "%.6f ms" % (t[0], t[3], t[1], t[2]))


def check_cancellation(built, state, obs_x=None, ladder=None):
    """One excluded pair at r = 0.05 sigma: kernel minus correction is
    finite and equals plain minus correction (LJ or tabulated; the ladder
    kernel of kind ``ladder`` when given)."""
    import numpy as np
    import torch

    from chemlab_tpu_torch.engine import cell_pair, neighbor
    from chemlab_tpu_torch.engine import cell_pair_variants as variants

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
    if ladder is not None:
        args = (cells, counts, state.box,
                cell_pair.pair_params(spec, cfg.n_types), cfg.cell_dims,
                cfg.uniform_lj, cell_pair.CH3_ENERGY)
        fns = (lambda *a: variants.ladder_kernel(ladder, *a),
               lambda *a: variants.ladder_ref(ladder, *a))
        cheb = None
    elif cfg.tab_cheb:
        ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko,
                                      cfg.cheb_ntab, cfg.cheb_mix, obs_x)
        args = (cells, counts, state.box, *ops, cfg.cell_dims, cfg.cheb_kw,
                cfg.cheb_ko, cell_pair.CH3_NONE)
        fns = (lambda *a: cell_pair.cell_pair_forces_cheb_kernel(
                   *a, ntab=cfg.cheb_ntab),
               cell_pair.cell_pair_forces_cheb_ref)
        cheb = (cfg.cheb_kw, cfg.cheb_ko)
    else:
        args = (cells, counts, state.box,
                cell_pair.pair_params(spec, cfg.n_types), cfg.cell_dims,
                cfg.uniform_lj, cfg.all_lj, cell_pair.CH3_NONE)
        fns = lj_fns(cfg)
        cheb = None
    in_grid = slot_of < n_cells * cfg.cell_cap
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, state.box, state.type_id, state.excl,
        active=state.active, cheb=cheb, cheb_mix=cfg.cheb_mix,
        obs_x=obs_x)[0]
    out = []
    for fn in fns:
        rows = fn(*args)
        rows = rows.reshape(-1, rows.shape[-1])[
            torch.where(in_grid, slot_of, 0).long()]
        out.append(torch.where(in_grid[:, None], rows[:, :3], 0.0) - f_ex)
    got, ref = out
    big = max(ref.abs().max().item(), f_ex.abs().max().item())
    err = (got - ref).abs().max().item()
    tol = 2e-5 * (1.0 + big)
    label = ("ladder " + ladder if ladder else "tabulated" if cheb
             else "LJ")
    print("cancellation at r=0.05 sigma (%s, grid %s, cap %d): pair (%d, %d) "
          "max|dF| %.3e (tol %.3e), |F_i| kernel %.4f plain %.4f, |F_ex| %.1f"
          % (label, cfg.cell_dims, cfg.cell_cap, i,
             j, err, tol, got[i].norm().item(), ref[i].norm().item(),
             f_ex.abs().max().item()))
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("kernel minus correction does not cancel")


def check_small_melt_against_cpu(builder, label: str, kernel,
                                 n_mols: int = 70, terms=(), **build_kw):
    """A small melt (70 molecules unless ``n_mols``) on the GPU and on the
    CPU from one state: forces, the energy ``terms`` and 20 NVE steps
    agree, and the GPU steps launched ``kernel``."""
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    built, _, _ = builder(n_mols=n_mols, thermostat="no", device="cpu",
                          **build_kw)
    cfg = built.cfg
    st_c = runner.initial_forces(built.spec, cfg, built.state)
    st_c = testsystems.warmup(built, st_c, steps=50)
    spec_g, st_g = built.spec.to(DEVICE), st_c.to(DEVICE)
    f_c, e_c, _ = integrate.compute_forces(built.spec, cfg, st_c)
    f_g, e_g, _ = integrate.compute_forces(spec_g, cfg, st_g)
    err = (f_g.cpu() - f_c).abs().max().item()
    # the excluded pairs' terms sit in both f32 sums before they cancel, so
    # the rounding scales with the all-pairs sum, not with the net force
    f_all = cell_pair.cell_pair_forces(
        st_c.pos, st_c.type_id, st_c.active, st_c.box, st_c.nbr.buckets,
        st_c.nbr.slot_of, cfg.cell_dims, built.spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj,
        cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0, cheb_ko=cfg.cheb_ko,
        cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix)[0]
    tol = _tol(f_all)
    key = "lj-tab" if cfg.tab_cheb else "lj"
    print("small %s melt GPU vs CPU: max|dF| %.3e (tol %.3e), %s %.5f vs "
          "%.5f" % (label, err, tol, key, float(e_g[key]), float(e_c[key])))
    if err > tol:
        raise AssertionError("GPU forces disagree with the CPU path")
    for k in terms:
        r, g = float(e_c[k]), float(e_g[k])
        print("small %s melt %s GPU %.6f CPU %.6f" % (label, k, g, r))
        if not abs(g - r) <= 2e-5 * (1.0 + abs(r)):
            raise AssertionError("GPU energy %s disagrees with the CPU "
                                 "path" % k)
    n0 = kernel.launches
    for _ in range(20):
        st_c = integrate.md_step(built.spec, cfg, st_c)
        st_g = integrate.md_step(spec_g, cfg, st_g)
    err = (st_g.pos.cpu() - st_c.pos).abs().max().item()
    print("small %s melt 20 NVE steps GPU vs CPU: max|dpos| %.3e (tol 1e-4)"
          % (label, err))
    if not (err <= 1e-4 and kernel.launches >= n0 + 20):
        raise AssertionError("GPU trajectory disagrees with the CPU path")


def run_path(built, systop, state, card: str, kernel, label: str,
             timed_blocks: int, cfg=None, virial=None,
             pair_kernel: str = "auto"):
    """Reactive blocks (one untimed, then ``timed_blocks`` timed) with the
    launch counts set to 0 just before; checks and returns (launches,
    particle-steps/s or None, launches of ``virial``).  Under a barostat
    ``virial`` is the kernel of the pressure pass, which must run on every
    step too, and the box must move while the cell grid stays valid.  A
    named ``pair_kernel`` (the ladder) must launch exactly once a step."""
    import math

    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, runner

    cfg = cfg or built.cfg
    spec = built.spec
    n_bonds0 = int(state.bonds.valid.sum())
    state = testsystems.activate_initiators(
        built, systop, state, n=max(cfg.n_particles // 300, 4))
    gen = runner.make_generator(1234, DEVICE)
    box0 = state.box.clone()

    for k in cell_pair.KERNELS:
        k.launches = 0
    state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen,
                             pair_kernel=pair_kernel)
    torch.cuda.synchronize()
    events0 = int(state.reaction_counts.sum())
    t0 = time.perf_counter()
    for _ in range(timed_blocks):
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen,
                                 pair_kernel=pair_kernel)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    v_launches = virial.launches if virial is not None else 0
    others = sum(k.launches for k in cell_pair.KERNELS
                 if k is not kernel and k is not virial)

    m = {k: v.cpu() for k, v in runner.measure_cheap(spec, cfg,
                                                      state).items()}
    steps = (timed_blocks + 1) * BLOCK_STEPS
    events = int(m["reaction_counts"].sum())
    full = runner.measure(spec, cfg, state)
    T = float(full["T"])
    pps = (cfg.n_particles * timed_blocks * BLOCK_STEPS / wall
           if timed_blocks else None)
    if pps is not None:
        print("%s: %d particles, %d timed steps in %.3f s: %.1f "
              "particle-steps/s on %s" % (label, cfg.n_particles,
                                          timed_blocks * BLOCK_STEPS, wall,
                                          pps, card))
    print("%s: reaction events %d (%d after the first block), per channel "
          "%s, conversions %s" % (label, events, events - events0,
                                  m["reaction_counts"].tolist(),
                                  m["conversions"].tolist()))
    print("%s: final T %.4f kT; n_bonds %d (%d at build), n_angles %d, "
          "n_excl %d; %s launches %d over %d steps (others %d); overflow %s"
          % (label, T, int(m["n_bonds"]), n_bonds0, int(m["n_angles"]),
             int(m["n_excl"]), kernel.symbol, launches, steps, others,
             bool(m["overflow"])))
    kT = float(spec.kT)
    checks = {
        "kernel launched on every step": launches >= steps and others == 0,
        "no capacity overflow": not bool(m["overflow"]),
        "T finite and within 0.5-1.5 kT": 0.5 * kT <= T <= 1.5 * kT,
        "reaction events fired": events > 0,
        "one new bond per event": int(m["n_bonds"]) - n_bonds0 == events,
        "no jax, no JAX package": _no_reference_modules(),
    }
    if pair_kernel != "auto":
        checks["named kernel exactly once a step"] = launches == steps
    if virial is not None:
        rc_skin = math.sqrt(float(spec.pair_cutoff2.max())) + float(spec.skin)
        edge = min(float(b) / d for b, d in zip(state.box.tolist(),
                                                 cfg.cell_dims))
        rx_edge = min(float(b) / d for b, d in zip(state.box.tolist(),
                                                    cfg.rx_dims))
        P = float(full["P"])
        print("%s: pressure-pass launches %d over %d steps; P %.6f (target "
              "%.4f), box %.6f -> %.6f, baro_v %.6f, cell edge %.6f (cutoff "
              "+ skin %.4f), reaction cell edge %.6f (reaction cutoff %.4f)"
              % (label, v_launches, steps, P, float(spec.pressure),
                 float(box0[0]), float(state.box[0]), float(state.baro_v),
                 edge, rc_skin, rx_edge, cfg.rx_rc))
        checks.update({
            "pressure pass on every step": v_launches >= steps,
            "P finite": math.isfinite(P),
            "the box moved": not torch.equal(state.box, box0),
            "cell grid still valid": edge >= rc_skin,
            "reaction grid still valid": rx_edge >= cfg.rx_rc,
        })
    _require(checks, label)
    return launches, pps, v_launches


def lj_path(card: str):
    """The LJ path: the reactive LJ melt through K1."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, runner

    t0 = time.perf_counter()
    built, systop, _ = testsystems.build_melt(n_mols=N_MOLS, device=DEVICE)
    state = runner.initial_forces(built.spec, built.cfg, built.state)
    state = testsystems.warmup(built, state, steps=600)
    torch.cuda.synchronize()
    print("10k LJ melt: %d particles, grid %s, cell_cap %d; build + warmup "
          "%.1f s" % (built.cfg.n_particles, built.cfg.cell_dims,
                      built.cfg.cell_cap, time.perf_counter() - t0))
    row = check_kernel(built, state, "K1")
    cells, counts = _cells(built, state)
    row.update(ab_numbers(colt_ab(
        "K1 at %s x cap %d" % (built.cfg.cell_dims, built.cfg.cell_cap),
        built, cells, counts, state.box, built.cfg.cell_dims),
        cell_pair.CH3_NONE))
    row["tiled"] = check_colt_tiled(built, state)
    compare_k1_k2(built, state)
    check_cancellation(built, state)
    check_small_melt_against_cpu(testsystems.build_melt, "LJ", cell_pair.K1)
    row["launches"], _, _ = run_path(built, systop, state, card,
                                     cell_pair.K1, "LJ main path",
                                     TIMED_BLOCKS)
    return row, (built, systop, state)


# ---- K2 (per-cell LJ, any grid) --------------------------------------------------

def _warm_melt(label: str, steps: int = 600, **kw):
    """A melt built on the card and warmed up."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, runner

    t0 = time.perf_counter()
    built, systop, _ = testsystems.build_melt(device=DEVICE, **kw)
    cfg = built.cfg
    state = runner.initial_forces(built.spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=steps)
    torch.cuda.synchronize()
    print("%s: %d particles, grid %s (S = %d), cell_cap %d, barostat %s; "
          "build + warmup %.1f s" % (
              label, cfg.n_particles, cfg.cell_dims,
              cell_pair.stencil_table(cfg.cell_dims).shape[1], cfg.cell_cap,
              cfg.barostat, time.perf_counter() - t0))
    return built, systop, state


def k2_path(card: str):
    """K2 on the grids colt2 cannot take: the 10k melt at cell_cap 36 and
    the 2x2x2 melt (against plain and against its cellwise baseline), the
    film (against the baseline), then the K2 main path."""
    from chemlab_tpu_torch import kernel_matrix
    from chemlab_tpu_torch.engine import cell_pair

    built, systop, state = _warm_melt("10k LJ melt at cell_cap 36",
                                      n_mols=N_MOLS, cell_cap=36)
    if cell_pair.colt_legal(built.cfg.cell_cap, built.cfg.cell_dims):
        raise AssertionError("the cap-36 melt did not take K2")
    row = check_kernel(built, state, "K2")
    cfg = built.cfg
    cells, counts = _cells(built, state)
    print("K2 launch plan at %s x cap %d: %s, stencil mask %s"
          % (cfg.cell_dims, cfg.cell_cap,
             cell_pair.k2_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types),
             bin(cell_pair.stencil_mask(cfg.cell_dims))))
    row.update(ab_numbers(colt_ab(
        "K2 at %s x cap %d" % (cfg.cell_dims, cfg.cell_cap), built, cells,
        counts, state.box, cfg.cell_dims, k2=True), cell_pair.CH3_NONE))
    check_cancellation(built, state)
    small, _, st_s = _warm_melt("small-grid melt", steps=50, **SMALL_GRID)
    if small.cfg.cell_dims != (2, 2, 2):
        raise AssertionError("the small melt is not on a 2x2x2 grid")
    check_kernel(small, st_s, "K2", timed=False)
    cells_s, counts_s = _cells(small, st_s)
    colt_ab("K2 on the 2x2x2 melt (cap %d, S = 8)" % small.cfg.cell_cap,
            small, cells_s, counts_s, st_s.box, small.cfg.cell_dims,
            timed=False, k2=True)
    check_cancellation(small, st_s)
    f_cells, f_counts, f_box, f_dims = kernel_matrix.film_operands(built)
    print("K2 film: %s cells x cap %d, %d particles (%.2f a cell), S = %d, "
          "%.2f MB of rows, plan %s, stencil mask %s"
          % (f_dims, f_cells.shape[1], int(f_counts.sum()),
             float(f_counts.float().mean()),
             cell_pair.stencil_table(f_dims).shape[1],
             f_cells.numel() * 4 / 1e6,
             cell_pair.k2_launch_plan(f_dims, f_cells.shape[1], cfg.n_types),
             bin(cell_pair.stencil_mask(f_dims))))
    film = colt_ab("K2 film %s x cap %d" % (f_dims, f_cells.shape[1]), built,
                   f_cells, f_counts, f_box, f_dims, k2=True)
    row["film"] = ab_numbers(film, cell_pair.CH3_NONE)
    del f_cells, f_counts
    row["launches"], _, _ = run_path(built, systop, state, card,
                                     cell_pair.K2, "K2 main path", 1)
    return row, (built, systop, state), (small, None, st_s)


# ---- NPT (pressure pass K1b, barostats) --------------------------------------

def check_small_npt():
    """The 2x2x2 melt: 20 NVE steps under 'br' on the GPU and on the CPU
    from one state (K2 for the force and for the virial), then 200
    Langevin steps under the Langevin barostat 'lv' on the card."""
    import math

    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    built, _, _ = testsystems.build_melt(thermostat="no", device="cpu",
                                         **SMALL_GRID, **NPT)
    cfg = built.cfg
    st_c = runner.initial_forces(built.spec, cfg, built.state)
    st_c = testsystems.warmup(built, st_c, steps=50)
    box0 = st_c.box.clone()
    spec_g, st_g = built.spec.to(DEVICE), st_c.to(DEVICE)
    n0 = cell_pair.K2.launches
    for _ in range(20):
        st_c = integrate.md_step(built.spec, cfg, st_c)
        st_g = integrate.md_step(spec_g, cfg, st_g)
    launches = cell_pair.K2.launches - n0
    box_err = ((st_g.box.cpu() - st_c.box).abs() / st_c.box).max().item()
    pos_err = (st_g.pos.cpu() - st_c.pos).abs().max().item()
    print("small-grid NPT ('br', NVE) 20 steps GPU vs CPU: box %.6f -> %.6f, "
          "max rel|dbox| %.3e (tol 1e-5), max|dpos| %.3e (tol 1e-4), K2 "
          "launches %d" % (float(box0[0]), float(st_c.box[0]), box_err,
                           pos_err, launches))
    if not (box_err <= 1e-5 and pos_err <= 1e-4 and launches >= 40
            and not torch.equal(st_c.box, box0)):
        raise AssertionError("the small NPT run disagrees with the CPU path")

    lv, _, st = _warm_melt("small-grid melt under 'lv'", steps=50,
                           **SMALL_GRID, **dict(NPT, barostat="lv"))
    box0 = st.box.clone()
    st = runner.run_block(lv.spec, lv.cfg, st, 200,
                          gen=runner.make_generator(5, DEVICE))
    P = float(integrate.virial_pressure(lv.spec, lv.cfg, st))
    print("small-grid 'lv' 200 steps: box %.6f -> %.6f, baro_v %.6f, P %.6f"
          % (float(box0[0]), float(st.box[0]), float(st.baro_v), P))
    if not (torch.isfinite(st.pos).all() and math.isfinite(P)
            and not torch.equal(st.box, box0)):
        raise AssertionError("the 'lv' run is not finite or the box did not "
                             "move")


def npt_path(card: str):
    """The 10k reactive melt under the Berendsen barostat: K1b against its
    plain version, the small-grid NPT runs, then the NPT main path."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    built, systop, state = _warm_melt("10k NPT melt", n_mols=N_MOLS, **NPT)
    cfg = built.cfg
    if cfg.barostat != "br" or not cell_pair.colt_legal(cfg.cell_cap,
                                                         cfg.cell_dims):
        raise AssertionError("the NPT melt is not a 'br' melt on a K1 grid")
    # the kernels meet a box that has moved: a block under the barostat on
    # a copy of the warmed state, so that the main path below starts from
    # the warmed state itself
    moved = runner.run_block(built.spec, cfg, state.to("cpu").to(DEVICE),
                             BLOCK_STEPS // 2,
                             gen=runner.make_generator(11, DEVICE))
    if torch.equal(moved.box, state.box):
        raise AssertionError("the NPT melt's box did not move")
    print("10k NPT melt after warmup and %d steps (a copy): box %.6f -> "
          "%.6f, P %.6f"
          % (BLOCK_STEPS // 2, float(state.box[0]), float(moved.box[0]),
             float(integrate.virial_pressure(built.spec, cfg, moved))))
    row = check_kernel(built, moved, "K1b", channels=CH3[2:],
                       time_mode=cell_pair.CH3_VIRIAL)
    cells, counts = _cells(built, moved)
    row.update(ab_numbers(colt_ab(
        "K1/K1b on the NPT grid %s x cap %d" % (cfg.cell_dims, cfg.cell_cap),
        built, cells, counts, moved.box, cfg.cell_dims),
        cell_pair.CH3_VIRIAL))
    del moved, cells, counts
    check_small_npt()
    _, pps, row["launches"] = run_path(built, systop, state, card,
                                       cell_pair.K1, "NPT main path",
                                       TIMED_BLOCKS, virial=cell_pair.K1B)
    return row, pps


# ---- the ladder: K1' (colt1) and K3a-K3d ------------------------------------

LADDER_SOURCE = "chemlab_tpu_torch/csrc/cell_pair_ladder.cu"
# launch count -> (row name, kind, TPU kernel replaced, the block's
# pair_kernel)
LADDER_ROWS = {
    "K1p": ("K1p ladder_colt1 (K1's column-segment body with colt1's "
            "per-column partial sums)", "colt1",
            "chemlab_tpu/engine/pallas_pair_variants.py:617", "colt1"),
    "K3a": ("K3a ladder_packet (a warp per live 8-row packet, one stage "
            "per cell)", "packet",
            "chemlab_tpu/engine/pallas_pair_variants.py:23", "packet"),
    "K3b": ("K3b ladder_resident (a warp per row, nothing staged)",
            "resident",
            "chemlab_tpu/engine/pallas_pair_variants.py:131", "resident"),
    "K3c": ("K3c ladder_colz (a block per xy column, whole neighbour "
            "columns by bulk copies, a warp per row)", "colz",
            "chemlab_tpu/engine/pallas_pair_variants.py:510", "column"),
    "K3d": ("K3d ladder_column (column windows by bulk copies, a warp per "
            "row)", "column",
            "chemlab_tpu/engine/pallas_pair_variants.py:420", "column"),
}


def check_ladder(built, state, key: str, timed: bool = True):
    """One ladder kernel on ``state``'s operands: against its plain version
    in both parameter modes (K1' in both of its channels); K3a-K3d against
    K2 and, on operands K1 takes, K1 (bit for bit), K1' against K1 (to f32
    rounding); then, when ``timed``, its time, its plain version's and its
    bound.  Returns its row (launches filled in later), or None untimed."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair
    from chemlab_tpu_torch.engine import cell_pair_variants as variants

    cfg, spec = built.cfg, built.spec
    name, kind, replaces, _ = LADDER_ROWS[key]
    cells, counts = _cells(built, state)
    dims = cfg.cell_dims
    colt2 = cell_pair.colt_legal(cfg.cell_cap, dims)
    worst = 0.0
    for uniform in (True, False):
        params = (cell_pair.pair_params(spec, cfg.n_types) if uniform
                  else mixed_params(spec, cfg.n_types, True))
        k2 = [cell_pair.cell_pair_forces_cell_kernel(
                  cells, counts, state.box, params, dims, uniform, False, m)
              for m in (cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)]
        modes = ((cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)
                 if kind == "colt1" else (cell_pair.CH3_ENERGY,))
        for mode in modes:
            args = (cells, counts, state.box, params, dims, uniform, mode)
            got = variants.ladder_kernel(kind, *args)
            ref = variants.ladder_ref(kind, *args)
            k1 = (cell_pair.cell_pair_forces_colt_kernel(
                cells, counts, state.box, params, dims, uniform, False, mode)
                  if colt2 else k2[0])
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = max(_tol(ref[..., :3]), _tol(ref[..., 3:]))
            line = ("%s vs plain at %s x cap %d uniform=%d ch3=%d: max|d| "
                    "%.3e (tol %.3e)" % (key, dims, cfg.cell_cap, uniform,
                                         mode, err, tol))
            if not err <= tol:
                raise AssertionError("%s disagrees with its plain version"
                                     % key)
            worst = max(worst, err)
            if kind == "colt1":
                d1 = (got - k1).abs().max().item()
                print("%s; vs K1 max|d| %.3e (tol %.3e), bitwise %s"
                      % (line, d1, _tol(k1), torch.equal(got, k1)))
                if not d1 <= _tol(k1):
                    raise AssertionError("K1p disagrees with K1")
                continue
            d_f = (got[..., :3] - k2[0][..., :3]).abs().max().item()
            d_e = (got[..., 3] - k2[0][..., 3]).abs().max().item()
            d_w = (got[..., 4] - k2[1][..., 3]).abs().max().item()
            d_1 = (got[..., :3] - k1[..., :3]).abs().max().item()
            same = (torch.equal(got[..., :3], k2[0][..., :3])
                    and torch.equal(got[..., :3], k1[..., :3]))
            print("%s; vs K2 max|dF| %.3e max|de| %.3e max|dw| %.3e, vs %s "
                  "max|dF| %.3e; forces bitwise %s"
                  % (line, d_f, d_e, d_w, "K1" if colt2 else "K2 (no K1 "
                     "at this cap)", d_1, same))
            if not (same and d_e <= _tol(k2[0][..., 3])
                    and d_w <= _tol(k2[1][..., 3])):
                raise AssertionError("%s differs from K2/K1" % key)
    if not timed:
        return None
    params = cell_pair.pair_params(spec, cfg.n_types)
    args = (cells, counts, state.box, params, dims, cfg.uniform_lj,
            cell_pair.CH3_ENERGY)
    ms = _time_ms(lambda: variants.ladder_kernel(kind, *args), 50)
    plain_ms = _time_ms(lambda: variants.ladder_ref(kind, *args), 3)
    cand, inside = pair_counts(cells, state.box, params[2], dims)
    table = variants.ladder_table(dims)
    # K3a-K3d compute both channels: the virial's operations count too
    ops_pair = OPS_LJ + (0 if kind == "colt1" else OPS_VIRIAL)
    b_ms, b_by = bound_ms(cells, params.numel() * 4 + 12 + 4 * table.size,
                          cand, inside, ops_pair,
                          out_ch=4 if kind == "colt1" else 8)
    print("%s time at %s cells x cap %d: kernel %.6f ms, plain %.4f ms; %d "
          "candidate pairs, %d inside the cutoff, bound %.6f ms (%s)"
          % (key, dims, cfg.cell_cap, ms, plain_ms, cand, inside, b_ms,
             b_by))
    return {"name": name, "route": "cuda", "source": LADDER_SOURCE,
            "replaces": replaces, "launches": 0, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def _device_ms(fn, reps: int, kernel_name: str):
    """Device time per call of the CUDA kernel whose name holds
    ``kernel_name`` (the kernel matrix's profiler timer)."""
    from chemlab_tpu_torch.kernel_matrix import device_ms

    return device_ms(fn, reps, kernel_name)


def ladder_ab(built, state):
    """K1, K2 and the five ladder kernels on identical operands, device
    time by the profiler, in turns (forward, then backward); K1 and K2 in
    their energy mode, K3a-K3d filling both channels."""
    from chemlab_tpu_torch.engine import cell_pair
    from chemlab_tpu_torch.engine import cell_pair_variants as variants
    from chemlab_tpu_torch.kernel_matrix import K2_NEW, LADDER_KERNEL_NAMES

    cfg = built.cfg
    cells, counts = _cells(built, state)
    args = (cells, counts, state.box,
            cell_pair.pair_params(built.spec, cfg.n_types), cfg.cell_dims,
            cfg.uniform_lj)
    mode = cell_pair.CH3_ENERGY
    fns = [("K1", "colt_packed_kernel",
            lambda: cell_pair.cell_pair_forces_colt_kernel(
                *args, cfg.all_lj, mode)),
           ("K2", K2_NEW,
            lambda: cell_pair.cell_pair_forces_cell_kernel(
                *args, cfg.all_lj, mode))]
    for key, (_, kind, _, _) in LADDER_ROWS.items():
        fns.append((key, LADDER_KERNEL_NAMES[kind],
                    lambda kind=kind: variants.ladder_kernel(kind, *args,
                                                             mode)))
    out = {key: [] for key, _, _ in fns}
    for key, name, fn in fns + fns[::-1]:
        out[key].append(_device_ms(fn, 50, name))
    print("device time by the profiler, ms, in turns (%s cells x cap %d): %s"
          % (cfg.cell_dims, cfg.cell_cap, json.dumps(out)))
    return out


def baseline_ab(key: str, label: str, new, old, new_name: str,
                old_name: str, cells, counts, box, dims, spec, n_types: int,
                uniform_lj: bool, timed: bool = True) -> dict:
    """A redesigned ladder kernel (``new``) against its first design
    (``old``), functions of (cells, counts, box, params, dims, uniform), on
    these operands: bit for bit in both parameter modes (both channels);
    then, when ``timed``, device time by the profiler, 50 calls each in
    turns (new, baseline, baseline, new).  Returns the numbers."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    for uniform in (True, False):
        params = (cell_pair.pair_params(spec, n_types) if uniform
                  else mixed_params(spec, n_types, True))
        args = (cells, counts, box, params, dims, uniform)
        a, b = new(*args), old(*args)
        torch.cuda.synchronize()
        print("%s new vs baseline %s uniform=%d (both channels) max|diff| "
              "%.3e, bitwise %s" % (key, label, uniform,
                                    (a - b).abs().max().item(),
                                    torch.equal(a, b)))
        if not torch.equal(a, b):
            raise AssertionError("%s: the new kernel differs from its "
                                 "baseline %s" % (key, label))
    if not timed:
        return {}
    args = (cells, counts, box, cell_pair.pair_params(spec, n_types), dims,
            uniform_lj)
    t = [_device_ms(lambda fn=fn: fn(*args), 50, name)
         for fn, name in ((new, new_name), (old, old_name), (old, old_name),
                          (new, new_name))]
    if None in t:
        raise AssertionError("%s: the profiler did not time both kernels"
                             % key)
    print("%s %s device time by the profiler, in turns: new %.6f / %.6f "
          "ms, baseline %.6f / %.6f ms" % (key, label, t[0], t[3], t[1],
                                           t[2]))
    return {"device_ms": (t[0] + t[3]) / 2,
            "device_ms_before": (t[1] + t[2]) / 2,
            "ms_before": _time_ms(lambda: old(*args), 50)}


# a grid with an axis of 2 (U = 6 columns, S = 18) at a cap K3c takes
RAGGED_DIMS, RAGGED_CAP = (6, 2, 5), 24


def random_grid(dims, cap: int, n_types: int, seed: int, edge: float = 2.9,
                fill: int = 16):
    """Seeded random occupancy on the card: up to ``fill`` particles a
    cell, uniform inside cells of side ``edge`` (the melt's cutoff + skin),
    types 1..n_types: (cells, counts, box)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    n_cells = int(np.prod(dims))
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, min(cap, fill) + 1, n_cells).astype(np.int32)
    for c in range(n_cells):
        at = np.array([c // (dims[1] * dims[2]), (c // dims[2]) % dims[1],
                       c % dims[2]])
        k = counts[c]
        cells[c, :k, :3] = (at + rng.uniform(0, 1, (k, 3))) * edge
        cells[c, :k, 3] = rng.randint(1, n_types + 1, k)
    box = np.asarray(dims, np.float32) * edge
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (cells, counts, box))


def ladder_abs(lj, cap36, small) -> dict:
    """K3a, K3b, K3c, K3d and K1' against their first designs: K3a, K3b,
    K3c and K1' (both channels) on the 10k LJ melt (cap 32), K3c also on a
    random grid with an axis of 2 (bits only), K3d on the 10k melt at cap
    36 (its path), the 2x2x2 melt (bits only) and the film.  Returns each
    row's numbers."""
    from chemlab_tpu_torch import kernel_matrix as km
    from chemlab_tpu_torch.engine import cell_pair
    from chemlab_tpu_torch.engine import cell_pair_variants as variants

    out = {}
    for key, kind, old, names in (
            ("K3a", "packet", variants.packet_baseline_kernel,
             (km.K3A_NEW, km.K3A_OLD)),
            ("K3b", "resident", variants.resident_packet_kernel,
             (km.K3B_NEW, km.K3B_OLD))):
        built, _, state = lj
        cfg = built.cfg
        print("%s launch plan at cap %d: %s" % (
            key, cfg.cell_cap,
            variants.packet_launch_plan(cfg.cell_cap) if kind == "packet"
            else variants.resident_launch_plan(cfg.cell_cap)))
        out[key] = baseline_ab(
            key, "at %s x cap %d" % (cfg.cell_dims, cfg.cell_cap),
            lambda *a, kind=kind: variants.ladder_kernel(kind, *a), old,
            *names, *_cells(built, state), state.box, cfg.cell_dims,
            built.spec, cfg.n_types, cfg.uniform_lj)

    built, _, state = lj
    cfg = built.cfg
    ragged = random_grid(RAGGED_DIMS, RAGGED_CAP, cfg.n_types, 24)
    for operands in ((*_cells(built, state), state.box, cfg.cell_dims),
                     (*ragged[:3], RAGGED_DIMS)):
        cells, dims = operands[0], operands[3]
        print("K3c launch plan at %s x cap %d: %s" % (
            dims, cells.shape[1],
            variants.colz_launch_plan(cells.shape[1], dims)))
        nums = baseline_ab(
            "K3c", "at %s x cap %d" % (dims, cells.shape[1]),
            lambda *a: variants.ladder_kernel("colz", *a),
            variants.colz_baseline_kernel, km.K3C_NEW, km.K3C_OLD, *operands,
            built.spec, cfg.n_types, cfg.uniform_lj,
            timed=dims == cfg.cell_dims)
        out.setdefault("K3c", nums)
    print("K1p launch plan at %s x cap %d: %s" % (
        cfg.cell_dims, cfg.cell_cap,
        variants.colt1_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                   cfg.n_types)))
    for mode in (cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL):
        nums = baseline_ab(
            "K1p", "at %s x cap %d ch3=%d" % (cfg.cell_dims, cfg.cell_cap,
                                              mode),
            lambda *a, mode=mode: variants.ladder_kernel("colt1", *a, mode),
            lambda *a, mode=mode: variants.colt1_baseline_kernel(*a, mode),
            km.K1P_NEW, km.K1P_OLD, *_cells(built, state), state.box,
            cfg.cell_dims, built.spec, cfg.n_types, cfg.uniform_lj,
            timed=mode == cell_pair.CH3_ENERGY)
        out.setdefault("K1p", nums)

    def new(*a):
        return variants.ladder_kernel("column", *a)

    built = cap36[0]
    f_cells, f_counts, f_box, f_dims = km.film_operands(built)
    for label, (b, _, st), operands in (
            ("cap36", cap36, None), ("small", small, None),
            ("film", cap36, (f_cells, f_counts, f_box, f_dims))):
        cfg = b.cfg
        if operands is None:
            operands = (*_cells(b, st), st.box, cfg.cell_dims)
        cells, dims = operands[0], operands[3]
        print("K3d launch plan at %s x cap %d: %s" % (
            dims, cells.shape[1],
            variants.column_launch_plan(cells.shape[1], dims)))
        nums = baseline_ab("K3d", "at %s x cap %d" % (dims, cells.shape[1]),
                           new, variants.column_baseline_kernel, km.K3D_NEW,
                           km.K3D_OLD, *operands,
                           b.spec, cfg.n_types, cfg.uniform_lj,
                           timed=label != "small")
        if label == "cap36":
            out["K3d"] = nums
        elif label == "film":
            out["K3d"]["film"] = nums
    return out


def ladder_path(card: str, lj, cap36, small):
    """The ladder on the warmed 10k LJ melt (cap 32) and the cap-36 melt:
    each kernel against plain, K2 and K1 (K3d also on its own cap-36
    operands, which give its row), K3a, K3b, K3c, K3d and K1' against
    their first designs (K3c also on a random grid with an axis of 2, K3d
    on the 2x2x2 melt and the film), the cancellation, a
    reactive block per choice (``run_block(pair_kernel=...)``: "column"
    takes K3c at cap 32 and K3d at cap 36), then the kernel matrix."""
    import torch

    from chemlab_tpu_torch import kernel_matrix
    from chemlab_tpu_torch.engine import cell_pair

    built, systop, state = lj
    # K3d's bits against K1 on the cap-32 melt; its row from its own path
    rows = {key: check_ladder(built, state, key, timed=key != "K3d")
            for key in LADDER_ROWS}
    rows["K3d"] = check_ladder(cap36[0], cap36[2], "K3d")
    for key, nums in ladder_abs(lj, cap36, small).items():
        rows[key].update(nums)
    ladder_ab(built, state)
    for key in LADDER_ROWS:
        check_cancellation(built, state, ladder=LADDER_ROWS[key][1])
    for key, melt in (("K1p", lj), ("K3a", lj), ("K3b", lj), ("K3c", lj),
                      ("K3d", cap36)):
        name = LADDER_ROWS[key][3]
        b, sys_, st = melt
        if key == "K3d" and b.cfg.cell_cap % 8 == 0:
            raise AssertionError("the K3d block needs the cap-36 melt")
        rows[key]["launches"], _, _ = run_path(
            b, sys_, st, card, cell_pair.BY_NAME[key],
            "ladder block, pair_kernel=%r (%s, cap %d)"
            % (name, key, b.cfg.cell_cap), 1, pair_kernel=name)
    km = kernel_matrix.time_kernels(built, state)
    torch.cuda.synchronize()
    print("kernel matrix, whole pair call in ms (%d particles, %s cells, cap "
          "%d, %s): %s" % (built.cfg.n_particles, built.cfg.cell_dims,
                           built.cfg.cell_cap, card, json.dumps(km)))
    return [rows[key] for key in LADDER_ROWS], km

# ---- K1c / K1d / K1e (Chebyshev tabulated) ------------------------------------

def cheb_fns(ntab: int, x_halo: bool = False):
    """(column-segment kernel, cellwise kernel) as functions of the
    Chebyshev operands (cells, counts, box, cut2, tmap, tmap_b, xmat, coef,
    dims, kw, ko, ch3)."""
    from chemlab_tpu_torch.engine import cell_pair

    return (lambda *a: cell_pair.cell_pair_forces_cheb_kernel(
                *a, ntab=ntab, x_halo=x_halo),
            lambda *a: cell_pair.cell_pair_forces_cheb_cellwise(
                *a, x_halo=x_halo))


def cheb_ab(label: str, args, ntab: int, x_halo: bool = False,
            modes=(0, 1)):
    """The column-segment kernel against the cellwise kernel on ``args``
    (the operands up to ko): bit for bit in every ch3 channel, then device
    time by the profiler, 50 calls each in turns (new, old, old, new) in
    ch3 ``modes``.  Returns {mode: (new ms, old ms)}, each the mean of its
    two turns."""
    import torch

    from chemlab_tpu_torch.kernel_matrix import CHEB_NEW, CHEB_OLD

    new, old = cheb_fns(ntab, x_halo)
    for mode_3, name in CH3:
        a, b = new(*args, mode_3), old(*args, mode_3)
        torch.cuda.synchronize()
        diff = (a - b).abs().max().item()
        print("%s new vs cellwise ch3=%-6s max|diff| %.3e, bitwise %s"
              % (label, name, diff, torch.equal(a, b)))
        if not torch.equal(a, b):
            raise AssertionError("%s: the column-segment kernel differs from "
                                 "the cellwise kernel" % label)
    return device_turns(label, lambda m: new(*args, m),
                        lambda m: old(*args, m), CHEB_NEW, CHEB_OLD, modes)


def device_turns(label: str, new, old, new_name: str, old_name: str,
                 modes) -> dict:
    """Device time by the profiler of ``new(ch3)`` and ``old(ch3)`` (the
    kernels named ``new_name`` and ``old_name``), 50 calls each in turns
    (new, old, old, new), in each ch3 mode of ``modes``.  Returns {mode:
    (new ms, old ms)}, each the mean of its two turns."""
    out = {}
    for mode_3 in modes:
        t = [_device_ms(lambda fn=fn: fn(mode_3), 50, name)
             for fn, name in ((new, new_name), (old, old_name),
                              (old, old_name), (new, new_name))]
        if None in t:
            raise AssertionError("%s: the profiler did not time both kernels"
                                 % label)
        print("%s device time by the profiler, ch3=%d, in turns: new %.6f / "
              "%.6f ms, cellwise %.6f / %.6f ms" % (label, mode_3, t[0],
                                                    t[3], t[1], t[2]))
        out[mode_3] = ((t[0] + t[3]) / 2, (t[1] + t[2]) / 2)
    return out


def check_tiled(built, state, mode: str, obs_x):
    """K1c/K1d/K1e on the tiled melt at each of TILE_CAPS: the new kernel
    against the cellwise kernel (bits, device time in turns) and, in the
    energy channel, against the plain version."""
    from chemlab_tpu_torch import kernel_matrix
    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    ntab = 0 if mode == "K1e" else cfg.cheb_ntab
    ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko, ntab,
                                  mode == "K1d", obs_x)
    out = {}
    for cap in TILE_CAPS:
        cells, counts, box, dims = kernel_matrix.tiled_operands(built, state,
                                                                cap)
        args = (cells, counts, box, *ops, dims, cfg.cheb_kw, cfg.cheb_ko)
        label = "%s tiled %s x cap %d (%d particles)" % (
            mode, dims, cap, int(counts.sum()))
        ab = cheb_ab(label, args, ntab)
        got = cell_pair.cell_pair_forces_cheb_kernel(
            *args, cell_pair.CH3_ENERGY, ntab=ntab)
        check_by_halves(label, got, cells, counts, dims,
                        lambda c, n, d: cell_pair.cell_pair_forces_cheb_ref(
                            c, n, box, *ops, d, cfg.cheb_kw, cfg.cheb_ko,
                            cell_pair.CH3_ENERGY, x_halo=True))
        out[str(cap)] = {"device_ms": ab[0][0], "device_ms_before": ab[0][1],
                         "device_ms_energy": ab[1][0],
                         "device_ms_energy_before": ab[1][1]}
    return out


def check_cheb(built, state, mode: str, obs_x):
    """K1c/K1d/K1e vs plain in every ch3 channel on ``state``, against the
    cellwise kernel bit for bit and in turns, here and on the tiled melt;
    returns the kernel's numbers (launches filled in later)."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    ntab = 0 if mode == "K1e" else cfg.cheb_ntab
    mix = mode == "K1d"
    cells, counts = _cells(built, state)
    ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko, ntab, mix,
                                  obs_x)
    kern = cell_pair.cheb_kernel_for(ops[2], ntab)
    worst = 0.0
    for mode_3, label in CH3:
        args = (cells, counts, state.box, *ops, cfg.cell_dims, cfg.cheb_kw,
                cfg.cheb_ko, mode_3)
        got = cell_pair.cell_pair_forces_cheb_kernel(*args, ntab=ntab)
        ref = cell_pair.cell_pair_forces_cheb_ref(*args)
        torch.cuda.synchronize()
        err_f = (got[..., :3] - ref[..., :3]).abs().max().item()
        err_3 = (got[..., 3] - ref[..., 3]).abs().max().item()
        tol_f, tol_3 = _tol(ref[..., :3]), _tol(ref[..., 3])
        print("%s vs plain (kw %d, ko %d, %d rows) ch3=%-6s max|dF| %.3e "
              "(tol %.3e)  max|dch3| %.3e (tol %.3e)"
              % (mode, cfg.cheb_kw, cfg.cheb_ko, ops[4].shape[0], label,
                 err_f, tol_f, err_3, tol_3))
        if not (err_f <= tol_f and err_3 <= tol_3):
            raise AssertionError("%s disagrees with its plain version" % mode)
        worst = max(worst, err_f, err_3)
    plan = cell_pair.cheb_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types, ops[4].shape[0],
                                      cfg.cheb_kw, cfg.cheb_ko, mix)
    print("%s launch plan at %s x cap %d: %s" % (mode, cfg.cell_dims,
                                                 cfg.cell_cap, plan))
    ab = cheb_ab("%s at %s x cap %d" % (mode, cfg.cell_dims, cfg.cell_cap),
                 (cells, counts, state.box, *ops, cfg.cell_dims, cfg.cheb_kw,
                  cfg.cheb_ko), ntab)
    args = (cells, counts, state.box, *ops, cfg.cell_dims, cfg.cheb_kw,
            cfg.cheb_ko, cell_pair.CH3_NONE)
    new, old = cheb_fns(ntab)
    ms = _time_ms(lambda: new(*args), 50)
    ms_before = _time_ms(lambda: old(*args), 50)
    plain_ms = _time_ms(lambda: cell_pair.cell_pair_forces_cheb_ref(*args), 3)
    cand, inside = pair_counts(cells, state.box, ops[0], cfg.cell_dims)
    small = sum(t.numel() * 4 for t in ops if t is not None) + 12
    b_ms, b_by = bound_ms(cells, small, cand, inside,
                          _ops_cheb(cfg.cheb_kw, cfg.cheb_ko, mix))
    print("%s time at %s cells x cap %d: kernel %.4f ms (cellwise %.4f ms), "
          "plain %.4f ms; %d candidate pairs, %d inside the cutoff, bound "
          "%.6f ms (%s)" % (mode, cfg.cell_dims, cfg.cell_cap, ms, ms_before,
                            plain_ms, cand, inside, b_ms, b_by))
    tiled = check_tiled(built, state, mode, obs_x)
    name = {"K1c": "K1c cell_pair_cheb (table-scalar)",
            "K1d": "K1d cell_pair_cheb_mix (two-table blend)",
            "K1e": "K1e cell_pair_cheb (coefficient planes)"}[mode]
    return kern, {"name": name, "route": "cuda",
                  "source": "chemlab_tpu_torch/csrc/cell_pair_cheb.cu",
                  "replaces": "chemlab_tpu/engine/pallas_pair.py:211",
                  "launches": 0, "max_abs_err": worst, "ms": ms,
                  "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                  "library_ms": None, "ms_before": ms_before,
                  "device_ms": ab[0][0], "device_ms_before": ab[0][1],
                  "device_ms_energy": ab[1][0],
                  "device_ms_energy_before": ab[1][1], "tiled": tiled}


def tab_paths(card: str):
    """The tabulated melts: K1c, K1e (plane mode) and K1d (blend)."""
    import torch

    from chemlab_tpu_torch import kernel_matrix, testsystems
    from chemlab_tpu_torch.engine import cell_pair, observables, runner

    t0 = time.perf_counter()
    built, systop, _ = testsystems.build_tabulated_melt(
        n_mols=N_MOLS, reactive=True, device=DEVICE)
    cfg = built.cfg
    if not (cfg.tab_cheb and cfg.cheb_ntab == 1 and cfg.cheb_kw == 8
            and not cfg.cheb_mix):
        raise AssertionError("the tabulated melt did not take K1c: %s"
                             % ((cfg.tab_cheb, cfg.cheb_kw, cfg.cheb_ko,
                                 cfg.cheb_ntab, cfg.cheb_mix),))
    state = runner.initial_forces(built.spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=600)
    torch.cuda.synchronize()
    print("10k tabulated melt: %d particles, grid %s, cell_cap %d, kw %d, "
          "ko %d, ntab %d; build + warmup %.1f s"
          % (cfg.n_particles, cfg.cell_dims, cfg.cell_cap, cfg.cheb_kw,
             cfg.cheb_ko, cfg.cheb_ntab, time.perf_counter() - t0))
    x0 = torch.zeros(1, device=DEVICE)
    k1c, row_c = check_cheb(built, state, "K1c", x0)
    k1e, row_e = check_cheb(built, state, "K1e", x0)
    km = kernel_matrix.cheb_calls(built, state, x0)
    print("kernel matrix, whole tabulated pair call in ms (%d particles, "
          "%s): %s" % (cfg.n_particles, card, json.dumps(km)))
    check_cancellation(built, state, x0)
    check_small_melt_against_cpu(testsystems.build_tabulated_melt,
                                 "tabulated", cell_pair.K1C)
    row_c["launches"], pps, _ = run_path(built, systop, state, card, k1c,
                                         "tabulated main path", TIMED_BLOCKS)
    plane = dataclasses.replace(cfg, cheb_ntab=0)
    row_e["launches"], _, _ = run_path(built, systop, state, card, k1e,
                                       "tabulated plane-mode path", 1,
                                       cfg=plane)

    t0 = time.perf_counter()
    mbuilt, msystop, _ = testsystems.build_mixed_tab_melt(
        n_mols=N_MOLS, reactive=True, device=DEVICE)
    mst = runner.initial_forces(mbuilt.spec, mbuilt.cfg, mbuilt.state)
    mst = testsystems.warmup(mbuilt, mst, steps=300)
    torch.cuda.synchronize()
    mcfg = mbuilt.cfg
    print("10k blended tabulated melt: ntab %d, mix %s, conversions %s; "
          "build + warmup %.1f s" % (mcfg.cheb_ntab, mcfg.cheb_mix,
                                     observables.conversions(
                                         mbuilt.spec, mst.type_id,
                                         mst.chem_state, mst.active).tolist(),
                                     time.perf_counter() - t0))
    x = observables.conversions(mbuilt.spec, mst.type_id, mst.chem_state,
                                mst.active)
    k1d, row_d = check_cheb(mbuilt, mst, "K1d", x)
    km_mix = kernel_matrix.cheb_calls(mbuilt, mst, x)
    print("kernel matrix, whole blended pair call in ms (%s): %s"
          % (card, json.dumps(km_mix)))
    check_cancellation(mbuilt, mst, x)
    row_d["launches"], _, _ = run_path(mbuilt, msystop, mst, card, k1d,
                                       "blended path", 1)
    return [row_c, row_d, row_e], pps

# ---- K1f (the slab decomposition over ranks) ----------------------------------

SLAB_RANKS = 2          # the path's ranks, time-sharing the one card
K1F_ROWS = {
    "K1f": ("K1f cell_pair_colt x_halo (LJ, one x-slab)",
            "chemlab_tpu_torch/csrc/cell_pair.cu"),
    "K1f-cheb": ("K1f cell_pair_cheb x_halo (Chebyshev modes, one x-slab)",
                 "chemlab_tpu_torch/csrc/cell_pair_cheb.cu"),
    "K1f-cheb-mix": ("K1f cell_pair_cheb_mix x_halo (two-table blend, one "
                     "x-slab)", "chemlab_tpu_torch/csrc/cell_pair_cheb.cu"),
}


def slab_operands(cfg, pos, type_id, active, buckets, n_ranks: int,
                  rank: int):
    """Rank ``rank``'s haloed slab of the bucket table (the kernel
    matrix's): (cells, counts, slab dims)."""
    from chemlab_tpu_torch import kernel_matrix

    return kernel_matrix.slab_operands(cfg, pos, type_id, active, buckets,
                                       n_ranks, rank)


def k1f_fns(built, mode: str, obs_x=None, uniform=None, all_lj=None,
            params=None):
    """(kernel, plain) row functions of (cells, counts, box, dims, ch3,
    x_halo) for LJ (``mode`` "K1") or a Chebyshev mode ("K1c", "K1d",
    "K1e"): K1f with ``x_halo``, else the full-grid K1, K1c, K1d or K1e."""
    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    if mode == "K1":
        params = (cell_pair.pair_params(spec, cfg.n_types) if params is None
                  else params)
        uniform = cfg.uniform_lj if uniform is None else uniform
        all_lj = cfg.all_lj if all_lj is None else all_lj

        def make(fn):
            return lambda cells, counts, box, dims, ch3, x_halo: fn(
                cells, counts, box, params, dims, uniform, all_lj, ch3,
                x_halo)
        return (make(cell_pair.cell_pair_forces_colt_kernel),
                make(cell_pair.cell_pair_forces_colt_ref))
    ntab = 0 if mode == "K1e" else cfg.cheb_ntab
    ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko, ntab,
                                  mode == "K1d", obs_x)

    def kern(cells, counts, box, dims, ch3, x_halo):
        return cell_pair.cell_pair_forces_cheb_kernel(
            cells, counts, box, *ops, dims, cfg.cheb_kw, cfg.cheb_ko, ch3,
            ntab, x_halo)

    def plain(cells, counts, box, dims, ch3, x_halo):
        return cell_pair.cell_pair_forces_cheb_ref(
            cells, counts, box, *ops, dims, cfg.cheb_kw, cfg.cheb_ko, ch3,
            x_halo)
    return kern, plain


def check_k1f(built, state, n_ranks: int, mode: str, obs_x=None,
              timed: bool = True):
    """K1f in ``mode`` on each of the ``n_ranks`` slabs of ``state``: against
    its plain version (every LJ parameter mode, or the Chebyshev mode, in
    every ch3 channel), and the slabs laid side by side against the
    full-grid kernel, bit for bit; in a Chebyshev mode each slab's K1f also
    against the cellwise kernel, bit for bit.  With ``timed``, times K1f
    and its plain version on rank 0's slab (and, in a Chebyshev mode, the
    cellwise kernel, by CUDA events and in turns by the profiler) and
    returns (ms, plain_ms, bound_ms, bound_by, largest error against plain,
    the cellwise kernel's numbers)."""
    import torch

    from chemlab_tpu_torch.engine import cell_pair

    cfg, spec = built.cfg, built.spec
    slabs = [slab_operands(cfg, state.pos, state.type_id, state.active,
                           state.nbr.buckets, n_ranks, r)
             for r in range(n_ranks)]
    full_cells, full_counts = _cells(built, state)
    variants = ([dict(uniform=u, all_lj=a, params=(
                    cell_pair.pair_params(spec, cfg.n_types) if u
                    else mixed_params(spec, cfg.n_types, not a)))
                 for u, a in MODES] if mode == "K1" else [{}])
    worst = 0.0
    for var in variants:
        kern, plain = k1f_fns(built, mode, obs_x, **var)
        label = ("uniform=%d all_lj=%d" % (var["uniform"], var["all_lj"])
                 if var else mode)
        for ch3, name in CH3:
            rows = []
            for cells, counts, dims in slabs:
                got = kern(cells, counts, state.box, dims, ch3, True)
                ref = plain(cells, counts, state.box, dims, ch3, True)
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                tol = max(_tol(ref[..., :3]), _tol(ref[..., 3]))
                if not err <= tol:
                    raise AssertionError("K1f (%s) disagrees with its plain "
                                         "version: %.3e > %.3e"
                                         % (label, err, tol))
                worst = max(worst, err)
                rows.append(got)
            full = kern(full_cells, full_counts, state.box, cfg.cell_dims,
                        ch3, False)
            torch.cuda.synchronize()
            side = torch.cat(rows)
            diff = (side - full).abs().max().item()
            print("K1f (%s) on %d slabs of %s x cap %d ch3=%-6s: max|K1f - "
                  "plain| %.3e; slabs side by side vs the full grid's "
                  "kernel max|diff| %.3e, bitwise %s"
                  % (label, n_ranks, cfg.cell_dims, cfg.cell_cap, name,
                     worst, diff, torch.equal(side, full)))
            if not torch.equal(side, full):
                raise AssertionError("the K1f slabs differ from the full "
                                     "grid's kernel")
    extra = {}
    if mode == "K1":
        cells, counts, dims = slabs[0]
        ab = colt_ab("K1f slab 0 of %d (%s x cap %d)" % (n_ranks, dims,
                                                         cfg.cell_cap),
                     built, cells, counts, state.box, dims, x_halo=True,
                     timed=timed)
        if timed:
            old = colt_fns(x_halo=True)[1]
            params = cell_pair.pair_params(spec, cfg.n_types)
            extra = {"ms_before": _time_ms(lambda: old(
                         cells, counts, state.box, params, dims,
                         cfg.uniform_lj, cfg.all_lj, cell_pair.CH3_NONE),
                         50),
                     **ab_numbers(ab, cell_pair.CH3_NONE)}
    else:
        ntab = 0 if mode == "K1e" else cfg.cheb_ntab
        ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko, ntab,
                                      mode == "K1d", obs_x)
        for r, (cells, counts, dims) in enumerate(slabs):
            ab = cheb_ab("K1f (%s) slab %d of %d" % (mode, r, n_ranks),
                         (cells, counts, state.box, *ops, dims, cfg.cheb_kw,
                          cfg.cheb_ko), ntab, x_halo=True,
                         modes=(0, 1) if timed and r == 0 else ())
            if r == 0 and timed:
                old = cheb_fns(ntab, x_halo=True)[1]
                extra = {"ms_before": _time_ms(lambda: old(
                             cells, counts, state.box, *ops, dims,
                             cfg.cheb_kw, cfg.cheb_ko, cell_pair.CH3_NONE),
                             50),
                         "device_ms": ab[0][0], "device_ms_before": ab[0][1],
                         "device_ms_energy": ab[1][0],
                         "device_ms_energy_before": ab[1][1]}
    if not timed:
        return None
    kern, plain = k1f_fns(built, mode, obs_x)
    cells, counts, dims = slabs[0]
    args = (cells, counts, state.box, dims, cell_pair.CH3_NONE, True)
    ms = _time_ms(lambda: kern(*args), 50)
    plain_ms = _time_ms(lambda: plain(*args), 5 if mode == "K1" else 3)
    full_ms = _time_ms(lambda: kern(full_cells, full_counts, state.box,
                                    cfg.cell_dims, cell_pair.CH3_NONE,
                                    False), 50)
    if mode == "K1":
        params = cell_pair.pair_params(spec, cfg.n_types)
        cut2, small, ops_pair = params[2], params.numel() * 4 + 12, OPS_LJ
    else:
        ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko,
                                      cfg.cheb_ntab, mode == "K1d", obs_x)
        cut2 = ops[0]
        small = sum(t.numel() * 4 for t in ops if t is not None) + 12
        ops_pair = _ops_cheb(cfg.cheb_kw, cfg.cheb_ko, mode == "K1d")
    cand, inside = pair_counts(cells, state.box, cut2, dims, x_halo=True)
    n_out = (dims[0] - 2) * dims[1] * dims[2]
    b_ms, b_by = bound_ms(cells, small, cand, inside, ops_pair,
                          out_rows=n_out)
    print("K1f (%s) time on slab 0 of %d (%s x cap %d): kernel %.6f ms, "
          "plain %.4f ms; %d candidate pairs, %d inside the cutoff, bound "
          "%.6f ms (%s); the full-grid kernel on the same melt (%s): %.6f ms"
          % (mode, n_ranks, dims, cfg.cell_cap, ms, plain_ms, cand, inside,
             b_ms, b_by, cfg.cell_dims, full_ms))
    return ms, plain_ms, b_ms, b_by, worst, extra


def check_k1f_cancellation(built, state, n_ranks: int, mode: str,
                           obs_x=None):
    """One excluded pair at r = 0.05 sigma: the K1f slabs' rows, gathered
    through ``slot_of`` as ``cell_pair_halo`` gathers them, minus the
    correction equal the plain slabs' minus the correction."""
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
    n_slots = int(np.prod(cfg.cell_dims)) * cfg.cell_cap
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, state.box, state.type_id, state.excl,
        active=state.active,
        cheb=(cfg.cheb_kw, cfg.cheb_ko) if cfg.tab_cheb else None,
        cheb_mix=cfg.cheb_mix, obs_x=obs_x)[0]
    in_grid = slot_of < n_slots
    slabs = [slab_operands(cfg, pos, state.type_id, state.active, buckets,
                           n_ranks, r) for r in range(n_ranks)]
    out = []
    for fn in k1f_fns(built, mode, obs_x):
        rows = torch.cat([fn(cells, counts, state.box, dims,
                             cell_pair.CH3_NONE, True)
                          for cells, counts, dims in slabs]).reshape(-1, 4)
        rows = rows[torch.where(in_grid, slot_of, 0).long()]
        out.append(torch.where(in_grid[:, None], rows[:, :3], 0.0) - f_ex)
    got, ref = out
    big = max(ref.abs().max().item(), f_ex.abs().max().item())
    err = (got - ref).abs().max().item()
    tol = 2e-5 * (1.0 + big)
    print("K1f cancellation at r=0.05 sigma (%s, %d slabs of %s): pair (%d, "
          "%d) max|dF| %.3e (tol %.3e), |F_ex| %.1f"
          % (mode, n_ranks, cfg.cell_dims, i, j, err, tol,
             f_ex.abs().max().item()))
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError("K1f minus correction does not cancel")


def _warm_tab(label: str, build_fn, steps: int, **kw):
    """A 10k tabulated melt built on the card and warmed up."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import runner

    t0 = time.perf_counter()
    built, systop, _ = build_fn(n_mols=N_MOLS, reactive=True,
                                device=DEVICE, **kw)
    state = runner.initial_forces(built.spec, built.cfg, built.state)
    state = testsystems.warmup(built, state, steps=steps)
    torch.cuda.synchronize()
    print("%s: grid %s, cell_cap %d; build + warmup %.1f s"
          % (label, built.cfg.cell_dims, built.cfg.cell_cap,
             time.perf_counter() - t0))
    return built, systop, state


def slab_kernels():
    """K1f against plain and against the full-grid kernels on the 10k
    melts built for 2 and 4 slabs; returns the melts the path runs and
    the kernels' numbers."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import observables

    lj2 = _warm_melt("10k LJ melt, slab_devices=2", n_mols=N_MOLS,
                     slab_devices=2)
    lj4 = _warm_melt("10k LJ melt, slab_devices=4", n_mols=N_MOLS,
                     slab_devices=4)
    if (lj2[0].cfg.cell_dims != (10, 11, 11)
            or lj4[0].cfg.cell_dims != (8, 11, 11)):
        raise AssertionError("unexpected slab grids: %s, %s"
                             % (lj2[0].cfg.cell_dims, lj4[0].cfg.cell_dims))
    k1f = check_k1f(lj2[0], lj2[2], 2, "K1")
    check_k1f(lj4[0], lj4[2], 4, "K1")
    check_k1f_cancellation(lj2[0], lj2[2], 2, "K1")

    tab2 = _warm_tab("10k tabulated melt, slab_devices=2",
                     testsystems.build_tabulated_melt, 300, slab_devices=2)
    x0 = torch.zeros(1, device=DEVICE)
    cheb = check_k1f(tab2[0], tab2[2], 2, "K1c", x0)
    check_k1f(tab2[0], tab2[2], 2, "K1e", x0, timed=False)
    check_k1f_cancellation(tab2[0], tab2[2], 2, "K1c", x0)
    mix2 = _warm_tab("10k blended tabulated melt, slab_devices=2",
                     testsystems.build_mixed_tab_melt, 100, slab_devices=2)
    x = observables.conversions(mix2[0].spec, mix2[2].type_id,
                                mix2[2].chem_state, mix2[2].active)
    cheb_mix = check_k1f(mix2[0], mix2[2], 2, "K1d", x)
    check_k1f_cancellation(mix2[0], mix2[2], 2, "K1d", x)
    return lj2, tab2, mix2, k1f, cheb, cheb_mix


def slab_path(card: str):
    """The slab decomposition on the one card: K1f against plain and the
    full grid, then two gloo ranks (both on cuda:0) running the reactive LJ
    melt with slab_devices=2 (one untimed and one timed block) and one
    tabulated block, and the NPT melt's pressure, each against one rank."""
    import numpy as np
    import torch

    from chemlab_tpu_torch import bridge, testsystems
    from chemlab_tpu_torch.engine import _kernels, integrate, runner
    from chemlab_tpu_torch.parallel import launch

    ((lj, lj_sys, lj_st), (tab, tab_sys, tab_st), (mix, mix_sys, mix_st),
     k1f, cheb, cheb_mix) = slab_kernels()
    npt, _, npt_st = _warm_melt("10k NPT melt, slab_devices=2", steps=100,
                                n_mols=N_MOLS, slab_devices=2, **NPT)
    starts = [testsystems.activate_initiators(
                  b, systop, st, n=max(b.cfg.n_particles // 300, 4))
              for b, systop, st in ((lj, lj_sys, lj_st),
                                    (tab, tab_sys, tab_st),
                                    (mix, mix_sys, mix_st))]
    jobs = [("run_blocks", dict(system=bridge.to_numpy(lj.cfg, lj.spec,
                                                       starts[0]),
                                n_blocks=2, block_steps=BLOCK_STEPS,
                                seed=1234)),
            ("run_blocks", dict(system=bridge.to_numpy(tab.cfg, tab.spec,
                                                       starts[1]),
                                n_blocks=1, block_steps=BLOCK_STEPS,
                                seed=1234)),
            ("run_blocks", dict(system=bridge.to_numpy(mix.cfg, mix.spec,
                                                       starts[2]),
                                n_blocks=1, block_steps=BLOCK_STEPS,
                                seed=1234)),
            ("forces", dict(system=bridge.to_numpy(npt.cfg, npt.spec,
                                                   npt_st))),
            ("imported_modules", {})]
    t0 = time.perf_counter()
    lj_res, tab_res, mix_res, npt_res, mods = launch.run_jobs(
        jobs, SLAB_RANKS, _kernels.BUILD_DIR / "launch", backend="gloo",
        device="cuda:0", timeout=900)
    print("%d gloo ranks on cuda:0: %.1f s for the jobs, start-up included"
          % (SLAB_RANKS, time.perf_counter() - t0))

    # the same state and seed on one rank, on the card
    gen = runner.make_generator(1234, DEVICE)
    one = starts[0]
    for _ in range(2):
        one = runner.run_block(lj.spec, lj.cfg, one, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    one_pos = one.pos.cpu().numpy()
    p_one = float(integrate.virial_pressure(npt.spec, npt.cfg, npt_st))

    steps = 2 * BLOCK_STEPS
    n_bonds0 = int(starts[0].bonds.valid.sum())
    kT = float(lj.spec.kT)
    r0, t0 = lj_res[0], tab_res[0]
    dpos = max(float(np.abs(r["pos"] - one_pos).max()) for r in lj_res)
    wall = max(float(r["walls"][1]) for r in lj_res)
    pps = lj.cfg.n_particles * BLOCK_STEPS / wall
    events = int(r0["reaction_counts"].sum())
    for r, res in enumerate(lj_res):
        print("slab path rank %d: K1f launches %d over %d steps (other "
              "kernels %s), events %d, n_bonds %d (%d before), T %.4f, "
              "overflow %s, block walls %s s" % (
                  r, res["launches"]["K1f"], steps,
                  {k: v for k, v in res["launches"].items()
                   if k != "K1f" and v}, int(res["reaction_counts"].sum()),
                  int(res["n_bonds"]), n_bonds0, float(res["T"]),
                  bool(res["overflow"]), res["walls"].tolist()))
    print("slab path vs one rank from the same state and seed, %d steps: "
          "max|dpos| %.3e, bitwise %s; one rank %d events"
          % (steps, dpos, all(np.array_equal(r["pos"], one_pos)
                              for r in lj_res),
             int(one.reaction_counts.sum())))
    print("slab path: %d particles, %d timed steps in %.3f s on the slowest "
          "rank: %.1f particle-steps/s; %d ranks time-sharing one card over "
          "host-staged gloo (a functional number, not a scaling result) on "
          "%s" % (lj.cfg.n_particles, BLOCK_STEPS, wall, pps, SLAB_RANKS,
                  card))
    print("tabulated slab block, rank 0: K1f-cheb launches %d over %d steps, "
          "events %d, T %.4f" % (t0["launches"]["K1f-cheb"], BLOCK_STEPS,
                                 int(t0["reaction_counts"].sum()),
                                 float(t0["T"])))
    m0 = mix_res[0]
    print("blended slab block, rank 0: K1f-cheb-mix launches %d over %d "
          "steps, events %d, T %.4f" % (m0["launches"]["K1f-cheb-mix"],
                                        BLOCK_STEPS,
                                        int(m0["reaction_counts"].sum()),
                                        float(m0["T"])))
    p_ranks = [float(r["P"]) for r in npt_res]
    print("NPT melt (slab_devices=2, %s) virial_pressure: ranks %s, one rank "
          "%.9g" % (npt.cfg.cell_dims, p_ranks, p_one))
    others = sum(v for res in lj_res for k, v in res["launches"].items()
                 if k != "K1f")
    checks = {
        "K1f on every step of every rank": all(
            r["launches"]["K1f"] == steps for r in lj_res) and others == 0,
        "replicas equal (bitwise)": all(
            np.array_equal(r["pos"], r0["pos"])
            and np.array_equal(r["bonds_idx"], r0["bonds_idx"])
            for r in lj_res),
        "reaction events fired": events > 0,
        "one new bond per event": int(r0["n_bonds"]) - n_bonds0 == events,
        "no capacity overflow": not any(bool(r["overflow"]) for r in lj_res),
        "T within 0.5-1.5 kT": all(0.5 * kT <= float(r["T"]) <= 1.5 * kT
                                   for r in lj_res),
        "positions within f32 rounding of one rank": dpos <= 1e-4,
        "K1f-cheb on every tabulated step": all(
            r["launches"]["K1f-cheb"] == BLOCK_STEPS for r in tab_res),
        "K1f-cheb-mix on every blended step": all(
            r["launches"]["K1f-cheb-mix"] == BLOCK_STEPS
            and bool(np.isfinite(r["pos"]).all()) for r in mix_res),
        "pressure within rel 1e-5 of one rank": all(
            abs(p - p_one) <= 1e-5 * abs(p_one) for p in p_ranks),
        "ranks import no jax": all(m["modules"] == [] for m in mods),
        "no jax, no JAX package": _no_reference_modules(),
    }
    _require(checks, "slab path")
    rows = []
    for key, nums, launches in (
            ("K1f", k1f, int(r0["launches"]["K1f"])),
            ("K1f-cheb", cheb, int(t0["launches"]["K1f-cheb"])),
            ("K1f-cheb-mix", cheb_mix,
             int(m0["launches"]["K1f-cheb-mix"]))):
        ms, plain_ms, b_ms, b_by, worst, extra = nums
        name, source = K1F_ROWS[key]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": "chemlab_tpu/engine/pallas_pair.py:211",
                     "launches": launches, "max_abs_err": worst, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None, **extra})
    return rows, pps


# ---- the CLI (start_simulation.main on examples/atrp_melt) ---------------------

EXAMPLE = "examples/atrp_melt"
CLI_STEPS = 1200
CLI_BLOCK = 200
# the caps are retuned on the input coordinates: conf.gro's fullest cell
# holds 24 particles, so the reference's rule shrinks cell_cap 40 -> 32
# there, whatever the trajectory; later in the fluid the fullest cell
# holds about 26, where the rule keeps 40
CLI_RETUNE = 0


def cli_flags():
    """``@params --run 1200 --int_step 200 --start_ar 600 --retune_caps
    0 --trj_collect 200 --energy_collect 200 --topol_collect 200
    --rng_seed 11``."""
    b = str(CLI_BLOCK)
    return ["@params", "--run", str(CLI_STEPS), "--int_step", b,
            "--start_ar", str(CLI_STEPS // 2), "--retune_caps",
            str(CLI_RETUNE), "--trj_collect", b, "--energy_collect", b,
            "--topol_collect", b, "--rng_seed", "11"]


class RecordingWriter:
    """Stand-in for ``writers.H5MDWriter`` where h5py is missing: records
    each frame's step and each array's shape instead of writing them."""

    def __init__(self, path, n_particles, box, store=None, **kw):
        self.path, self.n, self.store = path, n_particles, store
        self.frames, self.connectivity, self.parameters = [], {}, None

    def dump(self, step, t, **arrays):
        for name, a in arrays.items():
            if a.shape[0] != self.n:
                raise AssertionError("frame %d: %s has %d rows, not %d"
                                     % (step, name, a.shape[0], self.n))
        self.frames.append((step, sorted(arrays)))

    def dump_connectivity(self, name, step, t, table):
        self.connectivity.setdefault(name, []).append((step, table.shape))

    def write_parameters(self, args_namespace=None, force_field=None):
        self.parameters = (vars(args_namespace), force_field)

    def flush(self):
        pass

    def close(self):
        pass


class _Tee:
    """Standard output copied into a buffer."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def example_copy() -> str:
    """A copy of the example in a new temporary directory (the checkout's
    example is never written)."""
    import os
    import shutil
    import tempfile

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXAMPLE)
    dst = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_cli_"),
                       "atrp_melt")
    shutil.copytree(src, dst)
    return dst


def example_build(example: str, **overrides):
    """The example's system, built on the card as the CLI builds it, with
    ``SimOptions`` fields in ``overrides``: (built, systop)."""
    import os

    from chemlab_tpu_torch import app_args, files_io, reaction_parser
    from chemlab_tpu_torch.engine import build
    from chemlab_tpu_torch.start_simulation import build_sim_options
    from chemlab_tpu_torch.topology import build_system_topology

    def at(name):
        return os.path.join(example, name)

    _, args = app_args.parse_args(["@" + at("params"), "--rng_seed", "11"])
    systop = build_system_topology(at(args.top))
    coords = files_io.read_coordinates(at(args.conf))
    opts = dataclasses.replace(build_sim_options(args, (example, ".")),
                               **overrides)
    built = build.build_system(
        systop, coords, opts,
        reaction_config=reaction_parser.parse_config(at(args.reactions)),
        device=DEVICE)
    return built, systop


def cli_path(card: str, example: str):
    """``start_simulation.main`` on the example in its copy: 6 blocks of
    200 steps at 6000 particles, the caps retuned on the input, reactions
    from step 600; the launches of every kernel counted over the run, and
    K1's counted within each block of the loop."""
    import contextlib
    import os
    import pickle

    import numpy as np
    import torch

    from chemlab_tpu_torch import files_io, start_simulation, writers
    from chemlab_tpu_torch.engine import cell_pair, runner
    from chemlab_tpu_torch.topology import build_system_topology

    recorded = []

    def recording(*a, **kw):
        recorded.append(RecordingWriter(*a, **kw))
        return recorded[-1]

    try:
        import h5py  # noqa: F401
        writer = writers.H5MDWriter
    except ImportError:
        writer = recording
        print("cli: h5py is missing on this machine: the H5MD trajectory "
              "goes to a recording stand-in writer; every other output "
              "file is written and checked")

    k1 = cell_pair.BY_NAME["K1"]
    blocks = []     # (steps, K1 launches) of each run_block call
    run_block = runner.run_block

    def counted_block(spec, cfg, state, n_steps, **kw):
        before = k1.launches
        state = run_block(spec, cfg, state, n_steps, **kw)
        blocks.append((n_steps, k1.launches - before))
        return state

    cwd = os.getcwd()
    os.chdir(example)
    tee = _Tee(sys.stdout)
    h5_writer = writers.H5MDWriter
    writers.H5MDWriter, runner.run_block = writer, counted_block
    try:
        n_bonds0 = len(build_system_topology("topol.top").bonds)
        for k in cell_pair.KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            rc = start_simulation.main(cli_flags(), device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in cell_pair.BY_NAME.items()
                    if k.launches}
        out = tee.buf.getvalue()
        with open("atrp_benchmark.pck", "rb") as f:
            timers = pickle.load(f)
        head, *rows = open("atrp_energy.csv").read().splitlines()
        head = head.split(",")
        energy = np.array([[float(x) for x in r.split(",")] for r in rows])
        counters = open("atrp_reaction_counters.csv").read().splitlines()
        events = sum(int(ln.rsplit(",", 1)[1]) for ln in counters
                     if not ln.startswith(("intra", "inter")))
        n_bonds = sum(1 for ln in _section(open("atrp_topol.top"), "bonds"))
        confout = files_io.read_gro("atrp_confout.gro")
    finally:
        writers.H5MDWriter, runner.run_block = h5_writer, run_block
        os.chdir(cwd)
    retune = [ln for ln in out.splitlines()
              if ln.startswith(("caps retuned", "caps kept"))]
    k_after, cell_after = _caps_of(retune[0]) if len(retune) == 1 \
        else (None, None)
    T = energy[:, head.index("T")]
    in_loop = sum(d for _, d in blocks)
    n = confout.n_atoms
    pps = n * timers["steps"] / timers["integrator_loop"]
    print("cli: main() returned %d in %.1f s; %d particles, %d steps, loop "
          "%.3f s: %.1f particle-steps/s on %s" % (
              rc, wall, n, timers["steps"], timers["integrator_loop"], pps,
              card))
    print("cli: launches over the run %s, K1 within the loop's blocks %d "
          "(per block %s); %s" % (launches, in_loop,
                                  sorted({d for _, d in blocks}), retune))
    print("cli: --timers phases (s per call) on %s: %s" % (card, {
        k: timers[k] for k in ("neighbor_rebuild", "pair_forces",
                               "bonded_forces", "integrate_step",
                               "reaction_step", "observables")}))
    print("cli: events %d, bonds %d (%d at start), T %s, neighbor rebuilds "
          "%d" % (events, n_bonds, n_bonds0, np.round(T, 4).tolist(),
                  timers["neighbor_rebuilds"]))
    if recorded:
        w = recorded[0]
        print("cli: stand-in writer recorded %d frames (steps %s), "
              "connectivity %s" % (len(w.frames), [f[0] for f in w.frames],
                                   {k: len(v) for k, v in
                                    w.connectivity.items()}))
    checks = {
        "main returned 0": rc == 0,
        "K1 once a step in every block": sum(s for s, _ in blocks)
        == CLI_STEPS and all(d >= s for s, d in blocks),
        "no other kernel on the path": set(launches) <= {"K1"},
        "caps retuned, cell_cap below 40": bool(retune)
        and retune[0].startswith("caps retuned at step %d" % CLI_RETUNE)
        and cell_after < 40 and cell_after % 8 == 0,
        "no overflow": "overflow" not in out,
        "reaction events fired": events > 0,
        "bonds = initial + events": n_bonds == n_bonds0 + events,
        "energy rows finite": bool(np.isfinite(energy).all())
        and len(rows) == CLI_STEPS // CLI_BLOCK,
        "T within 0.5-1.5": bool(((T >= 0.5) & (T <= 1.5)).all()),
        "confout holds 6000 atoms": n == 6000,
        "frames every 200 steps": not recorded
        or [f[0] for f in recorded[0].frames]
        == list(range(0, CLI_STEPS, CLI_BLOCK)) + [CLI_STEPS],
        "no jax, no JAX package": _no_reference_modules(),
    }
    _require(checks, "cli")
    return {"pps": pps, "launches": launches["K1"], "in_loop": in_loop,
            "events": events, "cell_cap": cell_after,
            "timers": {k: timers[k] for k in timers
                       if isinstance(timers[k], float)}}


def _caps_of(line: str):
    """(K, cell_cap) after a "caps retuned" or "caps kept" line."""
    k = line.split(" K ")[1].split()[0].split("->")[-1]
    cell = line.split(" cell ")[1].split()[0].split("->")[-1]
    return int(k), int(cell)


def _section(lines, name):
    """The non-empty lines of a .top section."""
    on = False
    for ln in lines:
        if ln.startswith("["):
            on = ln.strip() == "[ %s ]" % name
        elif on and ln.strip():
            yield ln


def _k1_at(built_cfg, spec, state, label):
    """K1 (or K2) vs plain at the state's caps, every parameter mode."""
    import types

    check_kernel(types.SimpleNamespace(cfg=built_cfg, spec=spec), state,
                 label, channels=((0, "none"),), timed=False)


def cap_change_path(example: str):
    """Neighbor caps changed on the card: a build at cell_cap 8 latches the
    overflow flag, ``grow_neighbor_caps`` until it clears (K1 vs plain at
    every cap, a block with no overflow), a grow above the need and
    ``shrink_neighbor_caps`` back (the same checks); then ``grow_term_caps``
    on a nearly full bond table and a reactive block whose events must all
    land."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import build, runner

    built, systop = example_build(example, cell_cap=8)
    spec, cfg = built.spec, built.cfg
    state = runner.initial_forces(spec, cfg, built.state)
    gen = runner.make_generator(11, DEVICE)
    steps = 0
    while not bool(state.nbr.overflow) and steps < 200:
        state = runner.run_block(spec, cfg, state, 10, gen=gen)
        steps += 10
    if not bool(state.nbr.overflow):
        raise AssertionError("cell_cap 8 never overflowed")
    print("cap change: cell_cap 8 latched the overflow flag after %d steps"
          % steps)
    _k1_at(cfg, spec, state, "K1 at cap 8 (overflowing)")
    # the CLI's rule: regrow whenever a block ends with the flag latched,
    # until a whole block runs without it
    caps = [cfg.cell_cap]
    ok_grown = False
    while not ok_grown and len(caps) < 7:
        while bool(state.nbr.overflow) and len(caps) < 7:
            cfg, state = build.grow_neighbor_caps(cfg, spec, state)
            caps.append(cfg.cell_cap)
            _k1_at(cfg, spec, state, "K1 at grown cap %d" % cfg.cell_cap)
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
        ok_grown = not bool(state.nbr.overflow)
    cfg_big, st_big = build.grow_neighbor_caps(cfg, spec, state)
    _k1_at(cfg_big, spec, st_big, "K1 at cap %d" % cfg_big.cell_cap)
    cfg_s, st_s = build.shrink_neighbor_caps(cfg_big, spec, st_big)
    _k1_at(cfg_s, spec, st_s, "K1 at shrunk cap %d" % cfg_s.cell_cap)
    st_s = runner.run_block(spec, cfg_s, st_s, BLOCK_STEPS, gen=gen)
    ok_shrunk = not bool(st_s.nbr.overflow)
    print("cap change: cell_cap %s until a block ran with no overflow (%s); "
          "%d -> shrunk to %d (K %d -> %d), block with no overflow %s"
          % (caps, ok_grown, cfg_big.cell_cap, cfg_s.cell_cap,
             cfg_big.max_neighbors, cfg_s.max_neighbors, ok_shrunk))

    built, systop = example_build(example, extra_bonds=8)
    spec, cfg = built.spec, built.cfg
    state = runner.initial_forces(spec, cfg, built.state)
    counts = {k: int(v) for k, v in runner.measure_cheap(
        spec, cfg, state).items() if k.startswith("n_")}
    counts["excl_pair_cap"] = state.excl.shape[0]
    near_full = build.term_caps_near_full(cfg, counts)
    old = (cfg.bond_cap, cfg.angle_cap, state.excl.shape[0])
    cfg, state = build.grow_term_caps(cfg, state, counts=counts)
    state = testsystems.activate_initiators(built, systop, state, n=20)
    n0 = int(state.bonds.valid.sum())
    e0 = int(state.reaction_counts.sum())
    for _ in range(2):      # two reaction steps
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    events = int(state.reaction_counts.sum()) - e0
    landed = int(state.bonds.valid.sum()) - n0
    print("term caps: near full %s at bonds/angles/excl %s (%d bonds), "
          "grown to %s; the next 2 blocks: %d events, %d new bonds, overflow "
          "%s" % (near_full, old, n0, (cfg.bond_cap, cfg.angle_cap,
                                        state.excl.shape[0]), events, landed,
                  bool(state.nbr.overflow)))
    checks = {
        "grown caps: a block with no overflow": ok_grown,
        "shrunk below the grown cap": cfg_s.cell_cap < cfg_big.cell_cap,
        "shrunk caps: a block with no overflow": ok_shrunk,
        "caps stay multiples of 8": all(c % 8 == 0 for c in
                                        caps + [cfg_s.cell_cap]),
        "the bond table was near full": near_full,
        "the tables grew": cfg.bond_cap > old[0],
        "every event landed": events > 0 and landed == events
        and not bool(state.nbr.overflow),
    }
    _require(checks, "cap change")


def checkpoint_path(example: str):
    """``save_state`` then ``load_state`` into a fresh build, the
    generator's state included: one block from each gives the same bits."""
    import os
    import tempfile

    import torch

    from chemlab_tpu_torch import checkpoint, testsystems
    from chemlab_tpu_torch.engine import runner

    built, systop = example_build(example)
    spec, cfg = built.spec, built.cfg
    state = runner.initial_forces(spec, cfg, built.state)
    state = testsystems.activate_initiators(built, systop, state, n=20)
    gen = runner.make_generator(11, DEVICE)
    state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"),
                        "state.npz")
    checkpoint.save_state(path, state, cfg=cfg, gen=gen, rng_seed=11)
    fresh, _ = example_build(example)
    gen2 = runner.make_generator(0, DEVICE)
    st2, cfg2 = checkpoint.load_state(path, fresh.state, cfg=fresh.cfg,
                                      spec=fresh.spec, gen=gen2)
    a = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    b = runner.run_block(fresh.spec, cfg2, st2, BLOCK_STEPS, gen=gen2)
    torch.cuda.synchronize()
    same = {name: torch.equal(getattr(a, name), getattr(b, name))
            for name in ("pos", "vel", "force", "type_id")}
    same["bonds.idx"] = torch.equal(a.bonds.idx, b.bonds.idx)
    events = int(a.reaction_counts.sum())
    print("checkpoint: a block from the saved state and from its restore "
          "into a fresh build, %d events: bitwise %s, max|dpos| %.3e"
          % (events, same, (a.pos - b.pos).abs().max().item()))
    if not (all(same.values()) and events > 0 and cfg2 == cfg):
        raise AssertionError("the restored run differs")


# ---- the bonded layer: the step-growth chain melt -------------------------

CHAIN_MOLS = 2500       # E-B-B-E tetramers: 10 000 particles
SMALL_CHAIN = dict(n_mols=40, density=0.22)   # 3x3x3 cells: K1


def _bonded_args(cfg, spec, st):
    return (spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
            st.angles, st.dihedrals, st.pairs14)


def check_chain_events(spec, cfg, state):
    """One full-row ``reaction_step`` on the card and on the CPU from one
    state: the same events, and the same tables after them."""
    import torch

    from chemlab_tpu_torch.engine import reactions

    st = dataclasses.replace(
        state, step=torch.full_like(state.step, 200),
        reactions_on=torch.ones((), dtype=torch.bool, device=DEVICE))
    out_g = reactions.reaction_step(spec, cfg, st, 0)
    out_c = reactions.reaction_step(spec.to("cpu"), cfg, st.to("cpu"), 0)
    ev = [{(a, b, r) for a, b, r in zip(*(getattr(o, k).tolist() for k in
                                          ("ev_log_a", "ev_log_b",
                                           "ev_log_r"))) if a >= 0}
          for o in (out_g, out_c)]
    same = {k: torch.equal(getattr(out_g, k).cpu(), getattr(out_c, k))
            for k in ("ev_log_a", "ev_log_b", "ev_log_r", "excl", "adj",
                      "type_id", "mol_id")}
    for t in ("bonds", "angles", "dihedrals"):
        same[t] = torch.equal(getattr(out_g, t).idx.cpu(),
                              getattr(out_c, t).idx)
    cut = float(spec.r_cutoff2[0]) ** 0.5
    print("full-row events: card %d, CPU %d, equal lists %s; tables %s"
          % (len(ev[0]), len(ev[1]), ev[0] == ev[1], same))
    pos, box = st.pos.cpu(), st.box.cpu()
    for a, b, r in sorted(ev[0] ^ ev[1]):
        d = pos[a] - pos[b]
        d = d - box * torch.round(d / box)
        print("  only on the %s: %d-%d (channel %d) at %.7f, cutoff %.7f"
              % ("card" if (a, b, r) in ev[0] else "CPU", a, b, r,
                 float(d.norm()), cut))
    return len(ev[0]) > 0 and ev[0] == ev[1] and all(same.values())


def bonded_path(card: str):
    """The step-growth chain melt (dihedrals of funcs 1, 3, 8 and 12, 1-4
    pairs, func-8 bonds and angles, full-row reaction matching) on K1:
    (a) the build, (b) bonded forces, energies and strain derivative on
    the card against the CPU, (c) one full-row reaction step on both, (d)
    the 40-tetramer melt stepped on both, (e) the main path."""
    import math

    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import (bonded_forces, cell_pair,
                                          integrate, runner)

    t0 = time.perf_counter()
    built, _, _ = testsystems.build_chain_melt(n_mols=CHAIN_MOLS,
                                               device=DEVICE)
    cfg, spec = built.cfg, built.spec
    print("chain melt: %d particles, grid %s, cell_cap %d, rx grid %s cap "
          "%d K %d, rx_compact %s, bond funcs %s, angle funcs %s, dihedral "
          "funcs %s, pair14_cap %d, dihedral_cap %d"
          % (cfg.n_particles, cfg.cell_dims, cfg.cell_cap, cfg.rx_dims,
             cfg.rx_cell_cap, cfg.rx_k, cfg.rx_compact, cfg.bond_funcs,
             cfg.angle_funcs, cfg.dihedral_funcs, cfg.pair14_cap,
             cfg.dihedral_cap))
    _require({
        "(a) full-row matching": not cfg.rx_compact,
        "(a) dihedral funcs include 1, 3, 8": {1, 3, 8} <= set(
            cfg.dihedral_funcs),
        "(a) 1-4 pairs": cfg.pair14_cap > 0,
        "(a) bond funcs include 1, 8": {1, 8} <= set(cfg.bond_funcs),
        "(a) angle funcs include 1, 8": {1, 8} <= set(cfg.angle_funcs),
        "(a) K1's grid": cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims),
    }, "chain build")
    state = runner.initial_forces(spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=600)
    torch.cuda.synchronize()
    print("chain melt build + warmup %.1f s" % (time.perf_counter() - t0))

    # (b) the bonded pass on the card against the CPU
    spec_c, st_c = spec.to("cpu"), state.to("cpu")
    dense_g = integrate._dense_of(cfg, state)
    dense_c = integrate._dense_of(cfg, st_c)
    f_g, e_g = bonded_forces.bonded_forces(*_bonded_args(cfg, spec, state),
                                           dense=dense_g)
    f_c, e_c = bonded_forces.bonded_forces(*_bonded_args(cfg, spec_c, st_c),
                                           dense=dense_c)
    f_err = (f_g.cpu() - f_c).abs().max().item()
    f_tol = _tol(f_c)
    e_ok = {}
    for k in sorted(e_c):
        r, g = float(e_c[k]), float(e_g[k])
        e_ok[k] = math.isfinite(g) and abs(g - r) <= 2e-5 * (1.0 + abs(r))
        print("chain bonded %-13s card %.6f CPU %.6f" % (k, g, r))
    w_g = float(bonded_forces.bonded_strain_derivative(
        *_bonded_args(cfg, spec, state), dense=dense_g))
    w_c = float(bonded_forces.bonded_strain_derivative(
        *_bonded_args(cfg, spec_c, st_c), dense=dense_c))
    w_pair = float(integrate._pair_sum(spec, cfg, state, want_virial=True,
                                       obs_x=None, kernel="auto")[3]
                   - integrate._excl_correction(spec, cfg, state, None)[3])
    w_tol = 2e-5 * (1.0 + abs(w_pair) + abs(w_c))
    print("chain bonded forces card vs CPU: max|dF| %.3e (tol %.3e); "
          "strain derivative %.6f vs %.6f (tol %.3e, W_pair %.3f)"
          % (f_err, f_tol, w_g, w_c, w_tol, w_pair))
    bonded_ms = _time_ms(lambda: bonded_forces.bonded_forces(
        *_bonded_args(cfg, spec, state), dense=dense_g), 20)
    print("chain bonded_forces: %.4f ms a call (CUDA events, 20 calls) on "
          "%s" % (bonded_ms, card))
    _require({
        "(b) bonded forces card = CPU": bool(torch.isfinite(f_g).all())
        and f_err <= f_tol,
        "(b) every energy term card = CPU": all(e_ok.values()),
        "(b) strain derivative card = CPU": abs(w_g - w_c) <= w_tol,
    }, "chain bonded pass")

    # (c) one full-row reaction step on both
    _require({"(c) full-row events card = CPU":
              check_chain_events(spec, cfg, state)}, "chain events")

    # (d) the small chain melt on both
    check_small_melt_against_cpu(
        testsystems.build_chain_melt, "chain", cell_pair.K1,
        terms=("bond_f8", "angle_f8", "dihedral_f3", "lj14"), **SMALL_CHAIN)

    # (e) the main path
    state = dataclasses.replace(state, reactions_on=torch.ones(
        (), dtype=torch.bool, device=DEVICE))
    before = {k: int(getattr(state, k).valid.sum())
              for k in ("bonds", "angles", "dihedrals")}
    gen = runner.make_generator(1234, DEVICE)
    per_block, wall = [], 0.0
    for b in range(1 + TIMED_BLOCKS):
        for k in cell_pair.KERNELS:
            k.launches = 0
        t1 = time.perf_counter()
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
        torch.cuda.synchronize()
        if b:
            wall += time.perf_counter() - t1
        others = sum(k.launches for k in cell_pair.KERNELS
                     if k is not cell_pair.K1)
        per_block.append((cell_pair.K1.launches, others))
        print("chain main path block %d%s: K1 launches %d over %d steps, "
              "other kernels %d, events so far %d"
              % (b, " (timed)" if b else " (untimed)",
                 cell_pair.K1.launches, BLOCK_STEPS, others,
                 int(state.reaction_counts.sum())))
    pps = cfg.n_particles * TIMED_BLOCKS * BLOCK_STEPS / wall
    print("chain melt main path: %d particles, %d timed steps in %.3f s: "
          "%.1f particle-steps/s on %s" % (cfg.n_particles,
                                           TIMED_BLOCKS * BLOCK_STEPS, wall,
                                           pps, card))
    m = runner.measure(spec, cfg, state)
    after = {k: int(m["n_%s" % k]) for k in ("bonds", "angles", "dihedrals")}
    events = int(m["reaction_counts"].sum())
    T = float(m["T"])
    terms = {k: float(v) for k, v in m.items()
             if k.startswith("dihedral_f") or k in ("angle_f8", "bond_f8",
                                                     "lj14")}
    print("chain main path: events %d, bonds %d -> %d, angles %d -> %d, "
          "dihedrals %d -> %d, T %.4f kT, overflow %s, terms %s"
          % (events, before["bonds"], after["bonds"], before["angles"],
             after["angles"], before["dihedrals"], after["dihedrals"], T,
             bool(m["overflow"]), terms))
    kT = float(spec.kT)
    _require({
        "(e) K1 once a step in every block": all(
            k1 == BLOCK_STEPS and o == 0 for k1, o in per_block),
        "(e) reaction events fired": events > 0,
        "(e) one new bond per event": after["bonds"] - before["bonds"]
        == events,
        "(e) the angle count grew": after["angles"] > before["angles"],
        "(e) the dihedral count grew": after["dihedrals"]
        > before["dihedrals"],
        "(e) bonded terms finite": len(terms) >= 6 and all(
            math.isfinite(v) for v in terms.values()),
        "(e) T within 0.5-1.5 kT": 0.5 * kT <= T <= 1.5 * kT,
        "(e) no capacity overflow": not bool(m["overflow"]),
        "(e) no jax, no JAX package": _no_reference_modules(),
    }, "chain main path")
    return {"launches": sum(k1 for k1, _ in per_block), "pps": pps,
            "bonded_ms": bonded_ms}


# ---- the reaction extensions: the break and release melts -------------------

EXT_MOLS = 3334         # trimers: 10 002 particles (+ 6 668 dummies)
EXT_WARMUP = 300        # descent steps (the LJ path takes 600)
EXT_TIMED = 2           # timed 200-step blocks after one untimed
EXT_SMALL = 70          # the small melt stepped on both (3x3x3 cells: K1)


def _sync():
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


class _Tally:
    """Counters of what the extensions did in a run that is not timed:
    each wrapped function adds its count on the device, read once at the
    end.  ``touched`` marks the particles whose molecule a removal split
    without a relabel.  Wrapping is undone by ``close``."""

    def __init__(self):
        self.sums, self.saved, self.host = {}, [], {}
        self.touched = None

    def count(self, module, name, fn_count, state_of=None):
        """``fn_count(args, out)``; with ``state_of(args, out)`` giving
        (state in, state out), the ends of the bonds the call removed are
        marked ``touched``."""
        import torch

        orig = getattr(module, name)

        def wrapped(*a, **kw):
            out = orig(*a, **kw)
            k = fn_count(a, out)
            self.sums[name] = self.sums.get(name, 0) + k
            if state_of is not None:
                before, after = state_of(a, out)
                gone = before.bonds.valid & ~after.bonds.valid
                ends = before.bonds.idx[gone].reshape(-1).long()
                if self.touched is None:
                    self.touched = torch.zeros_like(before.active)
                self.touched = self.touched.index_fill(0, ends, True)
            return out

        self.saved.append((module, name, orig))
        setattr(module, name, wrapped)

    def timed(self, module, name):
        """Host ms of each call, between synchronizes."""
        orig = getattr(module, name)

        def wrapped(*a, **kw):
            _sync()
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            _sync()
            self.host.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

        self.saved.append((module, name, orig))
        setattr(module, name, wrapped)

    def read(self):
        return {k: int(v) for k, v in self.sums.items()}

    def close(self):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)


def _live(st):
    return int((st.fixd_host >= 0).sum())


def _bonds(st):
    return st.bonds.valid.sum()


def _atrp_centres(spec, cfg, st):
    import torch

    c = torch.zeros_like(st.active)
    for e in range(cfg.n_atrp):
        c |= (st.type_id == spec.atrp_type[e]) \
            & (st.chem_state == spec.atrp_state[e])
    return int((c & st.active).sum())


def capacity_report(cfg, state) -> str:
    """Each capacity the sticky overflow flag may stand for, with its use
    in ``state``."""
    import torch

    from chemlab_tpu_torch.engine import neighbor

    def occupancy(dims):
        b, _, _, _ = neighbor.build_cell_buckets(
            state.pos, state.box, state.active, dims, 256)
        return int((b[:-1] >= 0).sum(dim=1).max())

    e = state.excl[state.excl[:, 0] >= 0]
    deg = torch.bincount(e.reshape(-1).long(), minlength=1)
    adj_deg = int((state.adj >= 0).sum(dim=1).max())
    out = {"cell": (occupancy(cfg.cell_dims), cfg.cell_cap),
           "rx cell": (occupancy(cfg.rx_dims), cfg.rx_cell_cap),
           "excl rows": (int(deg.max()), cfg.excl_cap),
           "adj": (adj_deg, cfg.deg_cap),
           "bonds": (int(state.bonds.count), cfg.bond_cap),
           "angles": (int(state.angles.count), cfg.angle_cap),
           "excl pairs": (int(state.n_excl), state.excl.shape[0]),
           "fixd": (int((state.fixd_host >= 0).sum()), cfg.fixd_cap)}
    if cfg.bonded_dense:
        out["bonds irr"] = (int(state.bonds_irr.count), cfg.bond_irr_cap)
        out["angles irr"] = (int(state.angles_irr.count), cfg.angle_irr_cap)
    if state.excl_irr is not None:
        out["excl irr"] = (int((state.excl_irr[:, 0] >= 0).sum()),
                           cfg.excl_irr_cap)
    return ", ".join("%s %d of %d" % (k, u, c) for k, (u, c) in out.items())


def check_ext_events(spec, cfg, state):
    """(b) One reaction step on the card and on the CPU from one state,
    then the ATRP, FreezeRegion and ChangeParticleType steps under the
    same draws: event lists and every integer table equal.  Returns the
    event count and the checks."""
    import torch

    from chemlab_tpu_torch.engine import reactions

    st = dataclasses.replace(
        state, step=torch.full_like(state.step, 200),
        reactions_on=torch.ones((), dtype=torch.bool, device=state.device))
    gen = torch.Generator().manual_seed(17)
    n = st.pos.shape[0]
    draws = {}
    if cfg.has_atrp:
        hi = (cfg.n_particles if cfg.atrp_select_from_all
              else max(_atrp_centres(spec, cfg, st), 1))
        draws["atrp"] = (torch.randint(0, hi, (cfg.atrp_num,),
                                       generator=gen),
                         torch.rand(cfg.atrp_num, generator=gen))
    draws["freeze"] = torch.rand(n, generator=gen)
    draws["cpt"] = torch.rand(n, generator=gen)
    outs = []
    for dev in ("cpu", DEVICE):
        sp, s = spec.to(dev), st.to(dev)
        s = reactions.reaction_step(sp, cfg, s, 0)
        if cfg.has_atrp:
            s = reactions.atrp_step(sp, cfg, s, draws=draws["atrp"])
        if cfg.has_freeze:
            s = reactions.freeze_region_step(sp, cfg, s, u=draws["freeze"])
        if cfg.has_cpt:
            s = reactions.change_particle_type_step(sp, cfg, s,
                                                    u=draws["cpt"])
        outs.append(s)
    cpu, card = outs
    same = {k: torch.equal(getattr(card, k).cpu(), getattr(cpu, k))
            for k in ("ev_log_a", "ev_log_b", "ev_log_r", "excl", "n_excl",
                      "adj", "type_id", "chem_state", "mol_id", "fixd_host",
                      "fixd_dummy", "active", "reaction_counts", "atrp_stats",
                      "freeze_count")}
    for t in ("bonds", "angles", "dihedrals"):
        same[t] = all(torch.equal(getattr(getattr(card, t), k).cpu(),
                                  getattr(getattr(cpu, t), k))
                      for k in ("idx", "func", "group"))
    n_ev = int((cpu.ev_log_a >= 0).sum())
    print("extension events card vs CPU: %d normal events, counts %s, "
          "equal: %s" % (n_ev, cpu.reaction_counts.tolist(),
                         {k: v for k, v in same.items() if not v} or "all"))
    return n_ev, all(same.values())


def _partition(labels):
    """Each label replaced by the index of its first occurrence."""
    first = {}
    return [first.setdefault(x, i) for i, x in enumerate(labels)]


def check_invariants(spec, cfg, state, removed_rows, touched):
    """(e) The topology invariants at the end of the main path; returns the
    checks (the caller adds the counts).  ``touched``: the ends of the
    bonds that RemoveNeighboursBonds and FreezeRegion removals took."""
    import collections
    import math

    import torch

    from chemlab_tpu_torch.engine import topo

    st = state.to("cpu")
    active = st.active.numpy()
    bidx = st.bonds.idx.numpy()
    bonds = [tuple(sorted(r)) for r in bidx.tolist() if r[0] >= 0]
    bond_set = set(bonds)
    adj = st.adj.numpy()
    edges = collections.Counter(
        tuple(sorted((i, int(j)))) for i, row in enumerate(adj.tolist())
        for j in row if j >= 0)
    adj_ok = (len(bond_set) == len(bonds) and set(edges) == bond_set
              and all(c == 2 for c in edges.values()))
    terms_ok = True
    for t in ("angles", "dihedrals"):
        for row in getattr(st, t).idx.numpy().tolist():
            if row[0] >= 0 and not all(
                    tuple(sorted(row[k:k + 2])) in bond_set
                    for k in range(len(row) - 1)):
                terms_ok = False
    # molecules: the relabel's components equal the mol_id classes, except
    # where RemoveNeighboursBonds or a FreezeRegion removal took a bond: the
    # reference relabels only after a dissociation, so such a molecule keeps
    # one label and its components refine it (a later break's relabel
    # repairs it, so a touched class may also be exact)
    label = topo.relabel_components(st.adj, st.active).numpy()
    mol = st.mol_id.numpy()
    touched = {int(mol[r]) for r in list(removed_rows) + list(touched)}
    keep = [i for i in range(len(mol)) if active[i]
            and int(mol[i]) not in touched]
    mol_ok = (_partition([int(mol[i]) for i in keep])
              == _partition([int(label[i]) for i in keep]))
    by_label = {}
    for i in range(len(mol)):
        if active[i]:
            by_label.setdefault(int(label[i]), set()).add(int(mol[i]))
    mol_ok = mol_ok and all(len(v) == 1 for v in by_label.values())
    lam = st.lam.numpy()[active]
    dead = set(removed_rows)
    scrubbed = not any(
        int(x) in dead for t in ("bonds", "angles", "dihedrals")
        for x in getattr(st, t).idx.numpy().reshape(-1) if x >= 0) \
        and not any(int(x) in dead for x in adj.reshape(-1) if x >= 0) \
        and not any(int(x) in dead for x in st.excl.numpy().reshape(-1)
                    if x >= 0)
    frozen = (st.type_id == spec.fr_final_type.cpu()) & st.active
    still = frozen.clone()
    still[list(removed_rows)] = True
    vel0 = bool((st.vel[still] == 0).all())
    fix = (st.fixd_host >= 0) & (st.fixd_dummy >= 0)
    h = st.fixd_host[fix].long()
    d = st.fixd_dummy[fix].long()
    dr = st.pos[d] - st.pos[h]
    dr = dr - st.box * torch.round(dr / st.box)
    from chemlab_tpu_torch.engine import reactions

    eq = spec.fd_eq.cpu()[reactions._fd_def_of(spec.to("cpu"), cfg,
                                                st.type_id, st.fixd_dummy)
                           [fix]]
    fix_err = float((dr.norm(dim=-1) - eq).abs().max()) if fix.any() else 0.0
    print("invariants: %d bonds, %d adjacency edges, %d molecules (%d "
          "touched by removals), lambda in [%.4f, %.4f], %d live "
          "FixDistances pairs (max |d - eq| %.2e), %d removed, %d frozen"
          % (len(bonds), len(edges), len(by_label), len(touched),
             float(lam.min()), float(lam.max()), int(fix.sum()), fix_err,
             len(dead), int(frozen.sum())))
    return {
        "(e) adjacency = valid bond edges": adj_ok,
        "(e) angle/dihedral pairs are bonds": terms_ok,
        "(e) mol_id partition = relabel_components'": mol_ok,
        "(e) FixDistances pairs at eq within 1e-4": fix_err <= 1e-4,
        "(e) lambda in [0, 1]": float(lam.min()) >= 0.0
        and float(lam.max()) <= 1.0 and math.isfinite(float(lam.sum())),
        "(e) removed particles in no table": scrubbed,
        "(e) frozen / removed particles at zero velocity": vel0,
    }


def _ext_blocks(spec, cfg, state, name, timed):
    """One untimed and ``EXT_TIMED`` timed ``run_block`` calls of
    ``BLOCK_STEPS`` steps from a generator seeded 1234, the kernels' counts
    set to 0 before each block; returns (state, [(K1 launches, other
    launches)] a block, wall seconds of the timed blocks)."""
    from chemlab_tpu_torch.engine import cell_pair, runner

    gen = runner.make_generator(1234, DEVICE)
    per_block, wall = [], 0.0
    for b in range(1 + EXT_TIMED):
        for k in cell_pair.KERNELS:
            k.launches = 0
        _sync()
        t1 = time.perf_counter()
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
        _sync()
        if b:
            wall += time.perf_counter() - t1
        others = sum(k.launches for k in cell_pair.KERNELS
                     if k is not cell_pair.K1)
        per_block.append((cell_pair.K1.launches, others))
        print("%s %s block %d%s: K1 launches %d over %d steps, other "
              "kernels %d, events so far %s, overflow %s"
              % (name, "main path" if timed else "counted run", b,
                 " (timed)" if timed and b else " (untimed)",
                 cell_pair.K1.launches, BLOCK_STEPS, others,
                 state.reaction_counts.tolist(), bool(state.nbr.overflow)))
    return state, per_block, wall


def _ext_deltas(spec, cfg, start, state):
    """What a run from ``start`` (on the CPU) to ``state`` did, read from
    the state alone: bonds formed and broken, restricted events, ATRP
    flips, frozen and removed particles."""
    end = state.to("cpu")
    diss = spec.r_is_diss.cpu()
    events = end.reaction_counts - start.reaction_counts
    return {"formed": int(events[~diss].sum()),
            "broken": int(events[diss].sum()),
            "restricted": int(events[spec.r_restricted.cpu()].sum()),
            "atrp": int((end.atrp_stats - start.atrp_stats).sum()),
            "frozen": int(end.freeze_count - start.freeze_count),
            "removed": int((start.active & ~end.active).sum())}


def ext_path(card: str, name: str, builder, flags, mechanisms, **kw):
    """One extension melt on K1: (a) the build's flags, K1 against plain
    at the melt's caps, (b) a reaction step and the periodic steps card vs
    CPU, (c) the small melt stepped on both, (d) the main path, then the
    same run from the same start with the extensions' counters, (e) the
    invariants.  ``flags(cfg, spec, state)`` gives (a)'s checks,
    ``mechanisms(counts)`` the counts that must be > 0."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import (cell_pair, integrate, reactions,
                                          runner)

    t0 = time.perf_counter()
    built, systop, _ = builder(n_mols=EXT_MOLS, device=DEVICE, **kw)
    cfg, spec = built.cfg, built.spec
    print("%s melt: %d particles (%d real), grid %s, cell_cap %d, rx grid "
          "%s cap %d, rx_compact %s, thermostat %s, has_dissociation %s, "
          "has_dyn_resolution %s, n_rb %d, restrict rows %d (scan %d), "
          "has_fixd %s (n_fd %d, fixd_cap %d, live %d), has_atrp %s "
          "(select_from_all %s), has_cpt %s, has_freeze %s (%s)"
          % (name, cfg.n_particles, 3 * EXT_MOLS, cfg.cell_dims,
             cfg.cell_cap, cfg.rx_dims, cfg.rx_cell_cap, cfg.rx_compact,
             cfg.thermostat, cfg.has_dissociation, cfg.has_dyn_resolution,
             cfg.n_rb, spec.restrict_lo.shape[0], cfg.restrict_scan,
             cfg.has_fixd, cfg.n_fd, cfg.fixd_cap, _live(built.state),
             cfg.has_atrp, cfg.atrp_select_from_all, cfg.has_cpt,
             cfg.has_freeze, cfg.freeze_mode))
    checks = flags(cfg, spec, built.state)
    checks["(a) K1's grid"] = cell_pair.colt_legal(cfg.cell_cap,
                                                    cfg.cell_dims)
    _require(checks, "%s build" % name)
    state = runner.initial_forces(spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=EXT_WARMUP)
    state = testsystems.activate_initiators(
        built, systop, state, n=max(3 * EXT_MOLS // 300, 4))
    _sync()
    print("%s melt build + warmup %.1f s" % (name, time.perf_counter() - t0))

    # K1 against plain at the main path's own cap, grid and occupancy
    _k1_at(cfg, spec, state, "%s melt K1 at cap %d" % (name, cfg.cell_cap))

    # (b) a reaction step and the periodic steps on both
    n_ev, same = check_ext_events(spec, cfg, state)
    _require({"(b) events card = CPU": same}, "%s events" % name)

    # (c) the small melt on both
    check_small_melt_against_cpu(builder, name, cell_pair.K1,
                                 n_mols=EXT_SMALL)

    # (d) the main path: one untimed and EXT_TIMED timed blocks through
    # run_block, with nothing of the smoke's own inside them
    state = dataclasses.replace(state, step=torch.zeros_like(state.step))
    start = state.to("cpu")
    bonds0 = int(state.bonds.valid.sum())
    state, per_block, wall = _ext_blocks(spec, cfg, state, name, True)
    timed_end, timed_counts = state, _ext_deltas(spec, cfg, start, state)
    # the same run again from the same start, its mechanisms counted by
    # wrappers that add on the device; it is not timed, and only its host
    # ms of each reaction and ATRP step (between synchronizes) are kept
    tally = _Tally()
    tally.count(reactions, "_remove_neighbour_bonds",
                lambda a, out: _bonds(a[2]) - _bonds(out[0]),
                lambda a, out: (a[2], out[0]))
    tally.count(reactions, "_remove_dead",
                lambda a, out: _bonds(a[1]) - _bonds(out),
                lambda a, out: (a[1], out))
    tally.count(reactions, "_apply_ppnb",
                lambda a, out: (out.type_id != a[2].type_id).sum())
    tally.count(reactions, "_release_constraints",
                lambda a, out: (a[2].fixd_host >= 0).sum()
                - (out.fixd_host >= 0).sum())
    tally.count(reactions, "_join",
                lambda a, out: (out[0].fixd_dummy != a[1].fixd_dummy).sum())
    tally.count(reactions, "change_particle_type_step",
                lambda a, out: (out.type_id != a[2].type_id).sum())
    tally.count(integrate, "_dynamic_resolution",
                lambda a, out: (out.type_id != a[1].type_id).sum())
    tally.count(integrate, "_fix_distances",
                lambda a, out: (a[2].fixd_host >= 0).sum()
                - (out.fixd_host >= 0).sum())
    tally.timed(runner, "_fire_reactions")
    tally.timed(reactions, "atrp_step")
    active0 = start.active.to(DEVICE)
    try:
        counted, per_block_c, _ = _ext_blocks(spec, cfg, start.to(DEVICE),
                                              name, False)
        # one more step (not a reaction step) settles the constraints the
        # last reaction step made
        state = runner.step_with_extensions(
            spec, cfg, counted, gen=runner.make_generator(99, DEVICE),
            gates={"reaction": False, "atrp": False, "cpt": False})
        counts = tally.read()
        touched = ([] if tally.touched is None else
                   torch.nonzero(tally.touched.cpu()).flatten().tolist())
        rx_ms = tally.host.get("_fire_reactions", [])
        atrp_ms = tally.host.get("atrp_step", [])
    finally:
        tally.close()
    pps = cfg.n_particles * EXT_TIMED * BLOCK_STEPS / wall
    m_t = runner.measure(spec, cfg, timed_end)
    m = runner.measure(spec, cfg, state)
    T = float(m["T"])
    removed = counts.get("_remove_neighbour_bonds", 0) + counts.get(
        "_remove_dead", 0)
    bonds1 = int(m["n_bonds"])
    removed_rows = torch.nonzero((active0 & ~state.active).cpu()).flatten()
    deltas = _ext_deltas(spec, cfg, start, state)
    formed, broken = deltas["formed"], deltas["broken"]
    counts.update(deltas)
    print("%s main path: %d particles, %d timed steps in %.3f s: %.1f "
          "particle-steps/s on %s; its end: %s, T %.4f kT, overflow %s"
          % (name, cfg.n_particles, EXT_TIMED * BLOCK_STEPS, wall, pps,
             card, timed_counts,
             float(m_t["T"]), bool(m_t["overflow"])))
    print("%s mechanisms (the counted run): %s; bonds %d -> %d (formed %d, "
          "broken %d, removed %d); T %.4f kT; overflow %s"
          % (name, counts, bonds0, bonds1, formed, broken, removed, T,
             bool(m["overflow"])))
    print("%s reaction steps (host ms each, synchronized, the counted "
          "run): %s; ATRP steps: %d, mean %.3f ms"
          % (name, ["%.3f" % x for x in rx_ms], len(atrp_ms),
             sum(atrp_ms) / max(len(atrp_ms), 1)))
    print("%s capacities: %s" % (name, capacity_report(cfg, state)))
    kT = float(spec.kT)
    checks = check_invariants(spec, cfg, state, removed_rows.tolist(),
                              touched)
    checks.update({
        "(d) K1 once a step in every block": all(
            k1 == BLOCK_STEPS and o == 0
            for k1, o in per_block + per_block_c),
        "(e) bonds = before + formed - broken - removed":
            bonds1 == bonds0 + formed - broken - removed,
        "(e) T within 0.5-1.5 kT": all(
            0.5 * kT <= float(x["T"]) <= 1.5 * kT for x in (m, m_t)),
        "(e) no capacity overflow": not (bool(m["overflow"])
                                         or bool(m_t["overflow"])),
        "(e) no jax, no JAX package": _no_reference_modules(),
    })
    for mech in mechanisms:
        checks["(d) %s fired" % mech] = counts.get(mech, 0) > 0
    _require(checks, "%s main path" % name)
    launches = ext_launches(spec, cfg, state,
                            runner.make_generator(4321, DEVICE))
    print("%s launches: %.1f a step, %d in a reaction step (%.3f ms), %s in "
          "an ATRP step on %s" % (name, launches["step"],
                                  launches["reaction"],
                                  launches["reaction_ms"],
                                  launches.get("atrp", "none"), card))
    return {"launches": sum(k1 for k1, _ in per_block), "pps": pps,
            "rx_ms": sum(rx_ms[1:]) / max(len(rx_ms) - 1, 1),
            "atrp_ms": sum(atrp_ms) / max(len(atrp_ms), 1),
            "events": counts, **launches}


def ext_launches(spec, cfg, state, gen):
    """Kernel launches of 10 steps without a reaction step, of one
    reaction step and of one ATRP step, under ``torch.profiler``; the
    reaction step's time by the host clock between synchronizes (profiler
    off)."""
    import torch

    from chemlab_tpu_torch.engine import perf, runner

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    st = dataclasses.replace(state, reactions_on=torch.ones(
        (), dtype=torch.bool, device=state.device))

    def kernels(prof):
        return len([e for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not perf.is_span(e.name)])

    with torch.profiler.profile(activities=acts) as prof:
        s = st
        for _ in range(10):
            s = runner.step_with_extensions(
                spec, cfg, s, gen=gen,
                gates={"reaction": False, "atrp": False, "cpt": False})
        _sync()
    step = kernels(prof) / 10.0
    with torch.profiler.profile(activities=acts) as prof:
        runner._fire_reactions(spec, cfg, st, 0)
        _sync()
    reaction = kernels(prof)
    _sync()
    t0 = time.perf_counter()
    runner._fire_reactions(spec, cfg, st, 0)
    _sync()
    out = {"step": step, "reaction": reaction,
           "reaction_ms": (time.perf_counter() - t0) * 1e3}
    if cfg.has_atrp:
        from chemlab_tpu_torch.engine import reactions

        with torch.profiler.profile(activities=acts) as prof:
            reactions.atrp_step(spec, cfg, st, gen=gen)
            _sync()
        out["atrp"] = kernels(prof)
    return out


def _break_flags(cfg, spec, state):
    return {"(a) dissociation": cfg.has_dissociation,
            "(a) dynamic resolution": cfg.has_dyn_resolution,
            "(a) RemoveNeighboursBonds (the sequential scan)": cfg.n_rb > 0,
            "(a) restrict rows": spec.restrict_lo.shape[0] > 0
            and bool(spec.r_restricted.any()),
            "(a) CSVR thermostat": cfg.thermostat == "vr",
            "(a) ChangeNeighboursProperty": cfg.max_ppnb > 0}


def _release_flags(cfg, spec, state):
    return {"(a) FixDistances (2 definitions)": cfg.has_fixd
            and cfg.n_fd == 2,
            "(a) a dummy per MA": cfg.n_particles == 5 * EXT_MOLS
            and _live(state) == 2 * EXT_MOLS,
            "(a) ATRPActivator": cfg.has_atrp,
            "(a) ChangeParticleType": cfg.has_cpt,
            "(a) FreezeRegion removing": cfg.has_freeze
            and bool(spec.fr_remove),
            "(a) Langevin": cfg.thermostat == "lv"}


def extensions_path(card: str):
    """The reaction extensions on two 10k melts (``build_break_melt``,
    ``build_release_melt``), K1 once a step."""
    import tempfile

    from chemlab_tpu_torch import testsystems

    table_dir = tempfile.mkdtemp(prefix="chip_smoke_break_")
    brk = ext_path(card, "break", testsystems.build_break_melt, _break_flags,
                   ("formed", "broken", "restricted",
                    "_remove_neighbour_bonds", "_apply_ppnb",
                    "_dynamic_resolution"), table_dir=table_dir)
    rel = ext_path(card, "release", testsystems.build_release_melt,
                   _release_flags,
                   ("formed", "_release_constraints", "_join",
                    "_dynamic_resolution", "atrp",
                    "change_particle_type_step", "removed", "_remove_dead"))
    return brk, rel


# ---- the Verlet row path (rows) ---------------------------------------------

ROW_MOLS = 3334         # trimers: 10 002 particles
ROW_WARMUP = 600        # descent steps
ROW_TIMED = 2           # timed 200-step blocks after one untimed
ROW_INITIATORS = 20     # testsystems.row_switch's default
ROW_NPT_STEPS = 200


def _row_pairs(idx, vals, n):
    """{(i, j): value} over the real slots of the first ``n`` rows."""
    out = {}
    for i, (js, vs) in enumerate(zip(idx[:n].tolist(), vals[:n].tolist())):
        for j, v in zip(js, vs):
            if j != i:
                out[(i, j)] = v
    return out


def check_rows_against_cpu(spec, cfg, state):
    """(b) the card against the CPU on one state: the rows rebuilt from
    the state's rows (per-row sets, each pair's birth step and exclusion
    flag, exactly), ``pair_forces`` over the same rows (forces within
    2e-5 (1 + max|ref|), each energy kind likewise), the row-path
    pressure's W within 2e-5 (1 + |W|) and one reaction step's event list
    exactly."""
    import torch

    from chemlab_tpu_torch.engine import integrate, observables, reactions

    spec_c, st_c = spec.to("cpu"), state.to("cpu")
    n = cfg.n_particles
    g = integrate.maybe_rebuild_neighbors(spec, cfg, state, force=True)
    c = integrate.maybe_rebuild_neighbors(spec_c, cfg, st_c, force=True)
    rows_g = _row_pairs(g.nbr.idx.cpu(), g.nbr.birth.cpu(), n)
    rows_c = _row_pairs(c.nbr.idx, c.nbr.birth, n)
    excl_same = (_row_pairs(g.nbr.idx.cpu(), g.nbr.excl_mask.cpu(), n)
                 == _row_pairs(c.nbr.idx, c.nbr.excl_mask, n))
    births = sorted(set(rows_c.values()))
    print("rows card vs CPU: %d pairs, births %d..%d (%d distinct), equal "
          "%s, exclusion flags equal %s" % (len(rows_c), births[0],
                                            births[-1], len(births),
                                            rows_g == rows_c, excl_same))
    # the same rows on both from here on
    st_c = dataclasses.replace(c, nbr=g.nbr.to("cpu"))
    obs_g = observables.conversions(spec, g.type_id, g.chem_state, g.active)
    obs_c = observables.conversions(spec_c, st_c.type_id, st_c.chem_state,
                                    st_c.active)
    f_g, e_g = integrate.row_pair_forces(spec, cfg, g, obs_g)
    f_c, e_c = integrate.row_pair_forces(spec_c, cfg, st_c, obs_c)
    err = (f_g.cpu() - f_c).abs().max().item()
    tol = _tol(f_c)
    e_ok = all(abs(float(e_g[k]) - float(e_c[k]))
               <= 2e-5 * (1.0 + abs(float(e_c[k]))) for k in e_c)
    print("pair_forces card vs CPU: max|dF| %.3e (tol %.3e); %s"
          % (err, tol, ", ".join("%s %.6f vs %.6f" % (k, float(e_g[k]),
                                                        float(e_c[k]))
                                 for k in sorted(e_c))))
    w_g = float(integrate.row_strain_derivative(spec, cfg, g))
    w_c = float(integrate.row_strain_derivative(spec_c, cfg, st_c))
    print("row-path dU/ds card %.6f CPU %.6f" % (w_g, w_c))
    on = dict(step=torch.full_like(g.step, 200 * (int(g.step) // 200 + 1)),
              reactions_on=torch.ones_like(g.reactions_on))
    r_g = reactions.reaction_step(spec, cfg, dataclasses.replace(g, **on), 0)
    r_c = reactions.reaction_step(spec_c, cfg, dataclasses.replace(
        st_c, **{k: v.cpu() for k, v in on.items()}), 0)
    ev_same = all(torch.equal(getattr(r_g, k).cpu(), getattr(r_c, k))
                  for k in ("ev_log_a", "ev_log_b", "ev_log_r", "q",
                            "type_id"))
    ev_same = ev_same and torch.equal(r_g.nbr.excl_mask.cpu(),
                                      r_c.nbr.excl_mask)
    n_ev = int((r_c.ev_log_a >= 0).sum())
    print("reaction step on the rows card vs CPU: %d events, equal lists, "
          "charges and exclusion mask %s" % (n_ev, ev_same))
    _require({"(b) rows and births card = CPU": rows_g == rows_c,
              "(b) exclusion flags card = CPU": excl_same,
              "(b) births spread over the run": len(births) > 1,
              "(b) pair_forces forces card = CPU": err <= tol,
              "(b) pair_forces energies card = CPU": e_ok,
              "(b) virial card = CPU": abs(w_g - w_c)
              <= 2e-5 * (1.0 + abs(w_c)),
              "(b) reaction step card = CPU": ev_same and n_ev > 0},
             "rows card vs CPU")


def _row_ms(spec, cfg, state):
    """ms of a row rebuild, a ``pair_forces`` and a row-path
    ``virial_pressure`` (CUDA events, the kernel matrix's timer), and the
    kernels launched a step (10 steps without a reaction step under
    ``torch.profiler``)."""
    import torch

    from chemlab_tpu_torch.engine import integrate, observables, perf, runner

    obs = observables.conversions(spec, state.type_id, state.chem_state,
                                  state.active)
    out = {"rebuild_ms": _time_ms(lambda: integrate.maybe_rebuild_neighbors(
               spec, cfg, state, force=True), 20),
           "pair_ms": _time_ms(lambda: integrate.row_pair_forces(
               spec, cfg, state, obs), 50),
           "virial_ms": _time_ms(lambda: integrate.virial_pressure(
               spec, cfg, state), 20)}
    gen = runner.make_generator(77, DEVICE)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        s = state
        for _ in range(10):
            s = runner.step_with_extensions(
                spec, cfg, s, gen=gen,
                gates={"reaction": False, "atrp": False, "cpt": False})
        _sync()
    out["launches_step"] = len(
        [e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not perf.is_span(e.name)]) / 10.0
    return out


def rows_path(card: str):
    """The Verlet row path (``rows``) on the 10k row melt: (a) the build
    took the row path and no cell kernel runs in the phase, (b) the card
    against the CPU on one state, (c) one untimed and ROW_TIMED timed
    blocks, (d) a Berendsen NPT side run of the same melt."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    t0 = time.perf_counter()
    for k in cell_pair.KERNELS:
        k.launches = 0
    built, systop, _ = testsystems.build_row_melt(n_mols=ROW_MOLS,
                                                  device=DEVICE)
    cfg, spec = built.cfg, built.spec
    x_switch = testsystems.row_switch(ROW_MOLS, ROW_INITIATORS)
    print("row melt: %d particles, grid %s, cell_cap %d, max_neighbors %d, "
          "excl_cap %d, use_pallas %s, lazy_rows %s, has_coulomb %s, "
          "has_caps %s, has_pps %s, has_lambda_pairs %s, n_mix_entries %d, "
          "rx_compact %s, x_switch %.6f"
          % (cfg.n_particles, cfg.cell_dims, cfg.cell_cap,
             cfg.max_neighbors, cfg.excl_cap, cfg.use_pallas, cfg.lazy_rows,
             cfg.has_coulomb, cfg.has_caps, cfg.has_pps,
             cfg.has_lambda_pairs, cfg.n_mix_entries, cfg.rx_compact,
             x_switch))
    _require({"(a) the row path (use_pallas, lazy_rows False)":
              not cfg.use_pallas and not cfg.lazy_rows,
              "(a) every row-path family": cfg.has_coulomb and cfg.has_caps
              and cfg.has_pps and cfg.has_lambda_pairs and cfg.has_lj
              and cfg.has_tabulated and cfg.n_mix_entries > 0,
              "(a) func-14 births kept": built.state.nbr.birth.shape
              == built.state.nbr.idx.shape},
             "row build")
    state = runner.initial_forces(spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=ROW_WARMUP)
    state = testsystems.activate_initiators(built, systop, state,
                                            n=ROW_INITIATORS)
    _sync()
    print("row melt build + warmup %.1f s" % (time.perf_counter() - t0))

    # (c) the main path: one untimed and ROW_TIMED timed blocks; the cell
    # kernels' counts (0 since the phase began) are set to 0 before it and
    # read after
    before_main = sum(k.launches for k in cell_pair.KERNELS)
    for k in cell_pair.KERNELS:
        k.launches = 0
    gen = runner.make_generator(1234, DEVICE)
    m0 = runner.measure(spec, cfg, state)
    bonds0, events0 = int(m0["n_bonds"]), int(m0["reaction_counts"].sum())
    rebuilds0 = int(state.nbr.n_rebuilds)
    wall = 0.0
    for b in range(1 + ROW_TIMED):
        _sync()
        t1 = time.perf_counter()
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
        _sync()
        if b:
            wall += time.perf_counter() - t1
        print("rows main path block %d%s: events so far %s, rebuilds %d, "
              "overflow %s" % (b, " (timed)" if b else " (untimed)",
                               state.reaction_counts.tolist(),
                               int(state.nbr.n_rebuilds) - rebuilds0,
                               bool(state.nbr.overflow)))
    cell_launches = sum(k.launches for k in cell_pair.KERNELS)
    pps = cfg.n_particles * ROW_TIMED * BLOCK_STEPS / wall
    m = runner.measure(spec, cfg, state)
    kT = float(spec.kT)
    events = int(m["reaction_counts"].sum()) - events0
    bonds = int(m["n_bonds"]) - bonds0
    x0, x1 = float(m0["conversions"][0]), float(m["conversions"][0])
    energies = {k: float(m[k]) for k in ("lj", "lj-tab", "coulomb",
                                         "bond_f1", "angle_f1")}
    print("rows main path: %d particles, %d timed steps in %.3f s: %.1f "
          "particle-steps/s on %s; T %.4f kT, events %d, bonds +%d, "
          "rebuilds %d, pair_scale %d, MA conversion %.6f -> %.6f (switch "
          "%.6f), energies %s, overflow %s, cell-kernel launches %d"
          % (cfg.n_particles, ROW_TIMED * BLOCK_STEPS, wall, pps, card,
             float(m["T"]), events, bonds,
             int(state.nbr.n_rebuilds) - rebuilds0, int(m["pair_scale"]),
             x0, x1, x_switch, energies, bool(m["overflow"]), cell_launches))
    _require({"(a) no cell kernel launched": before_main == 0
              and cell_launches == 0,
              "(c) T within 0.5-1.5 kT": 0.5 * kT <= float(m["T"])
              <= 1.5 * kT,
              "(c) events fired": events > 0,
              "(c) bonds gained = events": bonds == events,
              "(c) no capacity overflow": not bool(m["overflow"]),
              "(c) rows rebuilt": int(state.nbr.n_rebuilds) > rebuilds0,
              "(c) func-14 pairs in the rows": int(m["pair_scale"]) > 0,
              "(c) the MA-PA blend crossed its switch": x0 >= x_switch > x1,
              "(c) every energy finite": all(
                  map(lambda v: v == v and abs(v) < float("inf"),
                      energies.values())),
              "(c) no jax, no JAX package": _no_reference_modules()},
             "rows main path")

    # (b) the card against the CPU at the run's end
    check_rows_against_cpu(spec, cfg, state)
    times = _row_ms(spec, cfg, state)

    # (d) a Berendsen NPT side run of the same melt, from the run's end
    # (its grid has the barostat's margin: the rows are rebuilt on it)
    npt, _, _ = testsystems.build_row_melt(n_mols=ROW_MOLS, device=DEVICE,
                                           **NPT)
    st = integrate.maybe_rebuild_neighbors(npt.spec, npt.cfg, state,
                                           force=True)
    st = runner.initial_forces(npt.spec, npt.cfg, st)
    box0 = st.box.clone()
    _sync()
    t1 = time.perf_counter()
    st = runner.run_block(npt.spec, npt.cfg, st, ROW_NPT_STEPS,
                          gen=runner.make_generator(4321, DEVICE))
    _sync()
    npt_s = time.perf_counter() - t1
    p = float(integrate.virial_pressure(npt.spec, npt.cfg, st))
    moved = float((st.box - box0).abs().max())
    print("rows NPT side run (br, pressure %.2f): %d steps in %.3f s, P "
          "%.6f, box %.6f -> %.6f, overflow %s"
          % (float(npt.spec.pressure), ROW_NPT_STEPS, npt_s, p,
             float(box0[0]), float(st.box[0]), bool(st.nbr.overflow)))
    _require({"(d) the row path under br": npt.cfg.barostat == "br"
              and not npt.cfg.use_pallas,
              "(d) P finite": p == p and abs(p) < float("inf"),
              "(d) the box moved": moved > 0.0,
              "(d) no cell kernel launched": sum(
                  k.launches for k in cell_pair.KERNELS) == 0},
             "rows NPT")
    print("rows: %.1f particle-steps/s, %.1f launches a step, %.4f ms a "
          "rebuild, %.4f ms a pair_forces, %.4f ms a virial_pressure, "
          "max_neighbors %d on %s"
          % (pps, times["launches_step"], times["rebuild_ms"],
             times["pair_ms"], times["virial_ms"], cfg.max_neighbors, card))
    print("rows phase wall time %.1f s" % (time.perf_counter() - t0))
    return dict(times, pps=pps, events=events,
                max_neighbors=cfg.max_neighbors)


TOOLS_EQUILIBRATE = 100  # genmelt: 100 descent steps, then 100 Langevin
TOOLS_CLI_STEPS = 400
TUNE_SKINS = (0.3, 0.4, 0.5)
TUNE_BLOCK = 100
NVE_STEPS = 600
NVE_BLOCK = 200
NVE_WARMUP = 200        # descent steps on the row build (the module: 600)
NVE_SETTLE = 200        # NVE steps after it (the module: 400)
# the pair energies of the Chebyshev and the exact tables at one state: the
# reference's K1c-vs-row tolerance (tests/test_tab_cheb.py, lj-tab); the
# gap is systematic, ~5e-4 of the pair energy on the CPU at 70 and 200
# trimers, the per-table fit tolerance (tab_cheb.DEFAULT_TOL)
CHEB_EPAIR_RTOL = 5e-3


def _launches():
    from chemlab_tpu_torch.engine import cell_pair

    return {name: k.launches for name, k in cell_pair.BY_NAME.items()
            if k.launches}


def _zero_launches():
    from chemlab_tpu_torch.engine import cell_pair

    for k in cell_pair.KERNELS:
        k.launches = 0


def tools_native():
    """(a) the host library builds; its .gro read equals the Python
    reader's field for field (the title aside: the native reader keeps
    none, as in the reference)."""
    import os

    import numpy as np

    from chemlab_tpu_torch import files_io, native

    t0 = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - t0
    conf = os.path.join(os.path.dirname(os.path.abspath(__file__)), EXAMPLE,
                        "conf.gro")
    t0 = time.perf_counter()
    fast = files_io.read_gro_native(conf) if ok else None
    fast_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = files_io.read_gro(conf)
    slow_s = time.perf_counter() - t0
    same = fast is not None and fast.title == "" and all(
        np.array_equal(getattr(fast, f), getattr(slow, f))
        if isinstance(getattr(slow, f), np.ndarray)
        else getattr(fast, f) == getattr(slow, f)
        for f in ("atom_ids", "res_idx", "res_names", "atom_names", "pos",
                  "vel", "box"))
    print("tools (a): native library %s (build and load %.2f s), %s: %d "
          "atoms, read_gro_native %.4f s, read_gro %.4f s"
          % (native.library_path().name, build_s, EXAMPLE, slow.n_atoms,
             fast_s, slow_s))
    _require({"(a) native.available()": ok,
              "(a) read_gro_native = read_gro": same}, "tools native")


def tools_genmelt(card: str):
    """(b) ``generate_example`` writes a 10k example (K1 once a step of the
    descent and of the Langevin block, and at each of the two force
    initialisations), then the port's CLI runs it."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from chemlab_tpu_torch import files_io, start_simulation, testsystems
    from chemlab_tpu_torch import writers

    out_dir = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_genmelt_"),
                           "melt")
    _zero_launches()
    t0 = time.perf_counter()
    testsystems.generate_example(out_dir, n_mols=N_MOLS,
                                 equilibrate=TOOLS_EQUILIBRATE, device=DEVICE)
    _sync()
    gen_s = time.perf_counter() - t0
    gen_launches = _launches()
    steps = max(TOOLS_EQUILIBRATE, 100) + TOOLS_EQUILIBRATE
    conf = files_io.read_coordinates(os.path.join(out_dir, "conf.gro"))
    print("tools (b): generate_example(n_mols=%d, equilibrate=%d) in %.1f s "
          "on %s: %s, %d atoms, box %s; launches %s (%d steps + 2 force "
          "initialisations)" % (N_MOLS, TOOLS_EQUILIBRATE, gen_s, card,
                                sorted(os.listdir(out_dir)), conf.n_atoms,
                                np.round(conf.box, 4).tolist(), gen_launches,
                                steps))
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             EXAMPLE, "params"), out_dir)
    try:
        import h5py  # noqa: F401
        writer = writers.H5MDWriter
    except ImportError:
        writer = RecordingWriter
    b = str(BLOCK_STEPS)
    cwd = os.getcwd()
    os.chdir(out_dir)
    h5_writer = writers.H5MDWriter
    writers.H5MDWriter = writer
    _zero_launches()
    try:
        t0 = time.perf_counter()
        rc = start_simulation.main(
            ["@params", "--run", str(TOOLS_CLI_STEPS), "--int_step", b,
             "--trj_collect", b, "--energy_collect", b, "--topol_collect", b,
             "--rng_seed", "11"], device=DEVICE)
        _sync()
        cli_s = time.perf_counter() - t0
        head, *rows = open("atrp_energy.csv").read().splitlines()
        energy = np.array([[float(x) for x in r.split(",")] for r in rows])
        T = energy[:, head.split(",").index("T")]
    finally:
        writers.H5MDWriter = h5_writer
        os.chdir(cwd)
    cli_launches = _launches()
    print("tools (b): the CLI on the generated example: main() returned %d "
          "in %.1f s, %d energy rows, T %s, launches %s"
          % (rc, cli_s, len(rows), np.round(T, 4).tolist(), cli_launches))
    _require({"(b) conf.gro, topol.top, atrp.cfg written":
              {"conf.gro", "topol.top", "atrp.cfg"} <= set(os.listdir(
                  out_dir)) and conf.n_atoms == 3 * N_MOLS,
              "(b) genmelt: K1 once a step and per initialisation":
              gen_launches == {"K1": steps + 2},
              "(b) CLI returned 0": rc == 0,
              "(b) CLI: K1 at least once a step, no other kernel":
              set(cli_launches) == {"K1"}
              and cli_launches["K1"] >= TOOLS_CLI_STEPS,
              "(b) CLI: every energy row finite":
              bool(np.isfinite(energy).all())
              and len(rows) == TOOLS_CLI_STEPS // BLOCK_STEPS,
              "(b) CLI: T within 0.5-1.5": bool(((T >= 0.5)
                                                  & (T <= 1.5)).all())},
             "tools genmelt")
    return out_dir, gen_launches["K1"] + cli_launches["K1"]


def tools_tune(card: str, out_dir: str):
    """(c) ``tune_skin`` on the generated 10k LJ melt over three skins."""
    import os

    from chemlab_tpu_torch import files_io, testsystems
    from chemlab_tpu_torch.engine import build, tuning
    from chemlab_tpu_torch.topology import build_system_topology

    systop = build_system_topology(os.path.join(out_dir, "topol.top"))
    coords = files_io.read_coordinates(os.path.join(out_dir, "conf.gro"))
    opts = build.SimOptions(**testsystems.melt_options())
    _zero_launches()
    t0 = time.perf_counter()
    best, res = tuning.tune_skin(systop, coords, opts, candidates=TUNE_SKINS,
                                 block_steps=TUNE_BLOCK, verbose=False,
                                 device=DEVICE)
    tune_s = time.perf_counter() - t0
    launches = _launches()
    per = 2 * TUNE_BLOCK + 1
    for skin in TUNE_SKINS:
        print("tools (c): tune_skin skin %.2f: %.1f particle-steps/s on %s"
              % (skin, res[skin], card))
    print("tools (c): tune_skin picked skin %.2f in %.1f s; launches %s (%d "
          "a candidate: %d steps and the initial forces)"
          % (best, tune_s, launches, per, 2 * TUNE_BLOCK))
    _require({"(c) every candidate timed": sorted(res) == list(TUNE_SKINS)
              and all(v > 0 for v in res.values()),
              "(c) the winner is the fastest": res[best]
              == max(res.values()),
              "(c) K1 for every step of each candidate":
              launches == {"K1": per * len(TUNE_SKINS)}},
             "tools tune_skin")
    return launches["K1"], res, best


def tools_nve(card: str):
    """(d) ``nve_drift``'s phase 1 on the 10k tabulated melt: the kernel
    leg (K1c once a step, and once in each block's measure) and the row
    leg (no cell kernel) from one warmed state."""
    import numpy as np
    import torch

    from chemlab_tpu_torch import nve_drift
    from chemlab_tpu_torch.engine import runner, tab_cheb

    t0 = time.perf_counter()
    built_k, built_x = nve_drift.nve_builds(N_MOLS, DEVICE)
    st0 = nve_drift.nve_start(built_x, NVE_WARMUP, NVE_SETTLE)
    _sync()
    print("tools (d): the NVE pair built and warmed in %.1f s (kernel build "
          "grid %s cap %d, cheb kw %d ko %d ntab %d; row build K %d)"
          % (time.perf_counter() - t0, built_k.cfg.cell_dims,
             built_k.cfg.cell_cap, built_k.cfg.cheb_kw, built_k.cfg.cheb_ko,
             built_k.cfg.cheb_ntab, built_x.cfg.max_neighbors))
    n_blocks = NVE_STEPS // NVE_BLOCK
    legs, checks = {}, {}
    for label, built in (("cheb", built_k), ("row", built_x)):
        spec, cfg = built.spec, built.cfg
        st = nve_drift.leg_start(built, st0)
        _zero_launches()
        m0 = runner.measure(spec, cfg, st)
        epot0, epair0 = float(m0["epot"]), float(m0["lj-tab"])
        per_measure = _launches()
        _zero_launches()
        _sync()
        t1 = time.perf_counter()
        recs = nve_drift.run_leg(built, st, NVE_STEPS, NVE_BLOCK,
                                 "nve_" + label)
        _sync()
        wall = time.perf_counter() - t1
        launches = _launches()
        fit = nve_drift.drift_fit(recs, cfg.n_particles)
        etot = np.array([r["etot"] for r in recs])
        legs[label] = dict(fit, epot0=epot0, epair0=epair0, wall=wall,
                           launches=launches,
                           per_measure=per_measure)
        print("tools (d): nve %s leg: %d steps in %.3f s on %s (%.1f "
              "particle-steps/s with a measure a block); drift %.6e kT per "
              "particle per step, RMS fluctuation %.6e kT per particle, "
              "Etot %.6f -> %.6f, step-0 Epot %.6f; launches %s (%s a "
              "measure)" % (label, NVE_STEPS, wall, card,
                            cfg.n_particles * NVE_STEPS / wall,
                            fit["drift_kT_per_particle_per_step"],
                            fit["rms_fluct_kT_per_particle"],
                            fit["etot_first"], fit["etot_last"], epot0,
                            launches, per_measure))
        checks["(d) %s: every Etot finite, no overflow" % label] = bool(
            np.isfinite(etot).all()) and not any(r["overflow"] for r in recs)
        checks["(d) %s: same particles at step 0" % label] = all(
            torch.equal(getattr(st, f), getattr(st0, f))
            for f in ("pos", "vel", "box"))
    k = legs["cheb"]
    kern = "K1c" if built_k.cfg.cheb_ntab > 0 else "K1e"
    checks["(d) kernel leg on %s (tab_cheb)" % kern] = \
        built_k.cfg.tab_cheb and built_k.cfg.use_pallas and kern == "K1c"
    m_k1c = k["per_measure"].get("K1c", 0)
    checks["(d) K1c once a step (and per measure), nothing else"] = (
        set(k["per_measure"]) == {"K1c"} and set(k["launches"]) == {"K1c"}
        and k["launches"]["K1c"] - n_blocks * m_k1c == NVE_STEPS)
    checks["(d) row leg: no cell kernel"] = not built_x.cfg.use_pallas \
        and legs["row"]["launches"] == {} and legs["row"]["per_measure"] == {}
    row = legs["row"]
    d_epot = abs(k["epot0"] - row["epot0"])
    checks["(d) step-0 pair energies agree"] = \
        d_epot <= CHEB_EPAIR_RTOL * abs(row["epair0"])
    checks["(d) step-0 Epot differs only in the pair energy"] = abs(
        (k["epot0"] - k["epair0"]) - (row["epot0"] - row["epair0"])) \
        <= 1e-5 * (1.0 + abs(row["epot0"] - row["epair0"]))
    print("tools (d): step-0 Epot cheb %.6f, row %.6f, |difference| %.6e, "
          "%.3e of the row leg's pair energy %.6f (tolerance %.1e; the "
          "tables' fit tolerance %.1e)"
          % (k["epot0"], row["epot0"], d_epot, d_epot / abs(row["epair0"]),
             row["epair0"], CHEB_EPAIR_RTOL, tab_cheb.DEFAULT_TOL))
    _require(checks, "tools nve_drift")
    return legs


def tools_path(card: str):
    """The engine's tools (``tools``): (a) the native host library, (b)
    ``generate_example`` and the CLI on its output, (c) ``tune_skin``, (d)
    ``nve_drift``'s NVE pair."""
    t0 = time.perf_counter()
    tools_native()
    out_dir, genmelt_k1 = tools_genmelt(card)
    tune_k1, res, best = tools_tune(card, out_dir)
    legs = tools_nve(card)
    _require({"(tools) no jax, no JAX package": _no_reference_modules()},
             "tools")
    print("tools phase wall time %.1f s" % (time.perf_counter() - t0))
    return {"k1_launches": genmelt_k1 + tune_k1,
            "k1c_launches": legs["cheb"]["launches"]["K1c"],
            "tune": res, "best": best, "nve": legs}


# ---- M14: the CLI, the extensions, cap changes and the rows on ranks -------

M14_CLI_RANKS = 3       # --node_grid 1,1,3: atrp_melt's 9 x-layers, 3 a slab
M14_RANKS = 2           # (b)-(d): the 10k melts' even x-layer counts
M14_CLI_STEPS = 400     # 2 blocks of M14_CLI_BLOCK
M14_CLI_BLOCK = 200
M14_DEVICE = "cuda:0"   # every rank's card: gloo ranks time-sharing it
M14_STEPS = 200         # (b): the extension melts' block
M14_INTERVAL = 50       # (b): their reaction interval, 4 in the block
M14_CAP_STEPS = 100     # (c): a block each side of the regrowth
M14_ROW_STEPS = 100     # (d): the row melt's timed block


def m14_cli_flags(node_grid: str):
    b = str(M14_CLI_BLOCK)
    return ["@params", "--run", str(M14_CLI_STEPS), "--int_step", b,
            "--start_ar", "0", "--retune_caps", "0", "--trj_collect", b,
            "--energy_collect", b, "--topol_collect", b, "--rng_seed", "11",
            "--timers", "False", "--node_grid", node_grid]


def _cli_outputs(d: str) -> dict:
    """What a CLI run in ``d`` wrote that the ranks must agree on."""
    import os

    from chemlab_tpu_torch import files_io

    def at(name):
        return os.path.join(d, name)

    return {"counters": open(at("atrp_reaction_counters.csv")).read(),
            "bonds": list(_section(open(at("atrp_topol.top")), "bonds")),
            "energy": open(at("atrp_energy.csv")).read().splitlines(),
            "pos": files_io.read_gro(at("atrp_confout.gro")).pos}


def m14_cli(card: str):
    """(a) ``start_simulation.main`` on a copy of ``examples/atrp_melt``
    with ``--node_grid 1,1,3`` and ``device="cuda:0"``: 3 gloo ranks on
    the card, reactions from step 0, 2 blocks of 200 steps, then the same
    flags on one rank in this process (``--node_grid 1,1,1``)."""
    import contextlib
    import io
    import os

    import numpy as np

    from chemlab_tpu_torch import start_simulation
    from chemlab_tpu_torch.engine import cell_pair
    from chemlab_tpu_torch.parallel import launch

    try:
        import h5py  # noqa: F401
        h5md = None
    except ImportError:
        # rank 0 imports this script's stand-in by name
        h5md = "chip_smoke:RecordingWriter"
    calls = []
    run_jobs = launch.run_jobs

    def recorded(*a, **kw):
        calls.append(run_jobs(*a, **kw))
        return calls[-1]

    dirs, outs, walls = {}, {}, {}
    launch.run_jobs = recorded
    cwd = os.getcwd()
    try:
        for grid in ("1,1,3", "1,1,1"):
            dirs[grid] = example_copy()
            os.chdir(dirs[grid])
            for k in cell_pair.KERNELS:
                k.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = start_simulation.main(m14_cli_flags(grid),
                                           device=M14_DEVICE,
                                           h5md_writer=h5md)
            walls[grid] = time.perf_counter() - t0
            outs[grid] = dict(_cli_outputs(dirs[grid]), rc=rc,
                              stdout=buf.getvalue(),
                              launches={n: k.launches for n, k in
                                        cell_pair.BY_NAME.items()
                                        if k.launches})
    finally:
        launch.run_jobs = run_jobs
        os.chdir(cwd)
    ((res,),) = calls
    many, one = outs["1,1,3"], outs["1,1,1"]
    mesh_line = [ln for ln in many["stdout"].splitlines()
                 if ln.startswith("Device mesh:")]
    dpos = float(np.abs(many["pos"] - one["pos"]).max())
    written = [len(r["writes"]) for r in res]
    events = sum(int(ln.rsplit(",", 1)[1]) for ln in
                 one["counters"].splitlines()
                 if not ln.startswith(("intra", "inter")))
    print("m14 (a) cli: %s; %d ranks in %.1f s, one rank in %.1f s "
          "(start-up and build included)" % (
              mesh_line, M14_CLI_RANKS, walls["1,1,3"], walls["1,1,1"]))
    for r, out in enumerate(res):
        print("m14 (a) cli rank %d: rc %d, K1f launches %d, K1 %d, files "
              "written %d %s" % (r, out["rc"], out["launches"]["K1f"],
                                 out["launches"]["K1"], len(out["writes"]),
                                 out["writes"][:8]))
    print("m14 (a) cli vs one rank: events %d, counters equal %s, bonds "
          "equal %s (%d), confout max|dpos| %.3e, bitwise %s; one rank's "
          "launches %s" % (events, many["counters"] == one["counters"],
                           many["bonds"] == one["bonds"], len(one["bonds"]),
                           dpos, np.array_equal(many["pos"], one["pos"]),
                           one["launches"]))
    _require({
        "(a) exit 0 on every rank and on one": all(
            r["rc"] == 0 for r in res) and one["rc"] == 0 and many["rc"] == 0,
        "(a) the mesh line": mesh_line == [
            "Device mesh: %d x cuda (the pair sum split by x-slab; every "
            "rank holds the whole state)" % M14_CLI_RANKS],
        "(a) K1f on every step of every rank, K1 never": all(
            r["launches"]["K1f"] >= M14_CLI_STEPS
            and r["launches"]["K1"] == 0 for r in res),
        "(a) events fired": events > 0,
        "(a) counters and bonds equal to one rank":
            many["counters"] == one["counters"]
            and many["bonds"] == one["bonds"],
        "(a) confout positions equal to one rank": dpos == 0.0,
        "(a) only rank 0 wrote files": written[0] > 0
            and written[1:] == [0] * (M14_CLI_RANKS - 1),
    }, "m14 cli")
    return {"launches": min(r["launches"]["K1f"] for r in res)}


def _m14_start(label, builder, n_init, **kw):
    """A 10k melt built with ``slab_devices=2`` on the card, warmed,
    ``n_init`` initiators on, at step 0."""
    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import runner

    t0 = time.perf_counter()
    built, systop, _ = builder(device=DEVICE, slab_devices=M14_RANKS, **kw)
    state = runner.initial_forces(built.spec, built.cfg, built.state)
    state = testsystems.warmup(built, state, steps=EXT_WARMUP)
    state = testsystems.activate_initiators(built, systop, state, n=n_init)
    state = dataclasses.replace(state, step=torch.zeros_like(state.step))
    _sync()
    print("m14 %s: %d particles, grid %s, cell_cap %d, use_pallas %s; "
          "build + warmup %.1f s" % (label, built.cfg.n_particles,
                                     built.cfg.cell_dims, built.cfg.cell_cap,
                                     built.cfg.use_pallas,
                                     time.perf_counter() - t0))
    return built, state


M14_INTEGER = ("type_id", "active", "chem_state", "reaction_counts",
               "fixd_host", "fixd_dummy")


def m14_ranks(card: str):
    """(b) the 10k break and release melts, (c) a regrowth mid-run on the
    10k LJ melt, (d) the 10k row melt: 2 gloo ranks on cuda:0, all in one
    ``run_jobs`` call, each against one rank from the same state and
    seed."""
    import numpy as np

    from chemlab_tpu_torch import bridge, testsystems
    from chemlab_tpu_torch.engine import _kernels, integrate, runner
    from chemlab_tpu_torch.parallel import jobs, launch

    fast = {"reaction_interval": M14_INTERVAL}
    brk, brk_st = _m14_start("break melt", testsystems.build_break_melt,
                             max(3 * EXT_MOLS // 300, 4), n_mols=EXT_MOLS)
    rel, rel_st = _m14_start("release melt", testsystems.build_release_melt,
                             max(3 * EXT_MOLS // 300, 4), n_mols=EXT_MOLS)
    lj, lj_st = _m14_start("LJ melt", testsystems.build_melt,
                           max(3 * N_MOLS // 300, 4), n_mols=N_MOLS)
    row, row_st = _m14_start("row melt", testsystems.build_row_melt,
                             ROW_INITIATORS, n_mols=ROW_MOLS)
    brk_cfg = dataclasses.replace(brk.cfg, **fast)
    rel_cfg = dataclasses.replace(rel.cfg, **fast)
    # name: (cfg, spec, state, run_blocks' n_blocks, block_steps and
    # cap_changes)
    systems = {"break": (brk_cfg, brk.spec, brk_st,
                         dict(n_blocks=1, block_steps=M14_STEPS)),
               "release": (rel_cfg, rel.spec, rel_st,
                           dict(n_blocks=1, block_steps=M14_STEPS)),
               "regrowth": (lj.cfg, lj.spec, lj_st,
                            dict(n_blocks=2, block_steps=M14_CAP_STEPS,
                                 cap_changes=((0, "grow"),))),
               "rows": (row.cfg, row.spec, row_st,
                        dict(n_blocks=1, block_steps=M14_ROW_STEPS))}
    todo = [("run_blocks", dict(system=bridge.to_numpy(c, sp, st), seed=77,
                                **kw))
            for c, sp, st, kw in systems.values()]
    todo.append(("forces", dict(system=bridge.to_numpy(row.cfg, row.spec,
                                                       row_st))))
    t0 = time.perf_counter()
    res = launch.run_jobs(todo, M14_RANKS, _kernels.BUILD_DIR / "m14",
                          backend="gloo", device=M14_DEVICE, timeout=900)
    print("m14 (b)-(d): %d gloo ranks on %s, %.1f s for the jobs, "
          "start-up included" % (M14_RANKS, M14_DEVICE,
                                 time.perf_counter() - t0))
    runs = dict(zip(systems, res))
    checks, out = {}, {}
    for name, (cfg, spec, st, kw) in systems.items():
        cfg1, one, _ = jobs.blocks(spec, cfg, st, gen=runner.make_generator(
            77, DEVICE), **kw)
        _sync()
        ref = bridge.tree_to_numpy(one)
        got = [r["state"] for r in runs[name]]
        ints = all(np.array_equal(g[k], ref[k]) for g in got
                   for k in M14_INTEGER) and all(
            np.array_equal(g["bonds"]["idx"], ref["bonds"]["idx"])
            and np.array_equal(g["lam"] == 0.0, ref["lam"] == 0.0)
            for g in got)
        bitwise = all(g["pos"].tobytes() == ref["pos"].tobytes()
                      for g in got)
        dpos = max(float(np.abs(g["pos"] - ref["pos"]).max()) for g in got)
        k1f = [r["launches"]["K1f"] for r in runs[name]]
        steps = kw["n_blocks"] * kw["block_steps"]
        print("m14 (%s) %s vs one rank, %d steps: integer state equal %s, "
              "positions max|dpos| %.3e, bitwise %s; replicas checked after "
              "every block (run_block); K1f launches by rank %s; caps %s "
              "(one rank %s)" % ("c" if name == "regrowth" else "d"
                                 if name == "rows" else "b", name, steps,
                                 ints, dpos, bitwise, k1f,
                                 runs[name][0]["caps"],
                                 {f: getattr(cfg1, f) for f in
                                  runs[name][0]["caps"]}))
        checks["(%s) integer state equal" % name] = ints
        out[name] = dict(one=one, start=st, spec=spec, got=got, k1f=k1f,
                         bitwise=bitwise, dpos=dpos)
        if name != "rows":
            checks["(%s) K1f on every step" % name] = all(
                k >= steps for k in k1f)
    # the mechanisms, from the one-rank run (= every rank's integers)
    b0, b1 = out["break"]["start"], out["break"]["one"]
    diss = brk.spec.r_is_diss
    ev = (b1.reaction_counts - b0.reaction_counts).cpu()
    brk_mech = {"formed": int(ev[~diss.cpu()].sum()),
                "restricted": int(ev[brk.spec.r_restricted.cpu()].sum()),
                "broken": int(ev[diss.cpu()].sum()),
                "fading": int(((b1.lam < 1.0) & b1.active).sum())}
    r0, r1 = out["release"]["start"], out["release"]["one"]
    rel_mech = {"events": int((r1.reaction_counts
                               - r0.reaction_counts).sum()),
                "release+join rows": int((r1.fixd_dummy
                                          != r0.fixd_dummy).sum()),
                "atrp": int((r1.atrp_stats - r0.atrp_stats).sum()),
                "frozen": int(r1.freeze_count - r0.freeze_count),
                "removed": int((r0.active & ~r1.active).sum()),
                "cpt+events types": int((r1.type_id != r0.type_id).sum())}
    print("m14 (b) mechanisms: break %s, release %s" % (brk_mech, rel_mech))
    checks["(b) every mechanism fired"] = all(
        v > 0 for v in list(brk_mech.values()) + list(rel_mech.values()))
    checks["(b) positions bitwise"] = (out["break"]["bitwise"]
                                       and out["release"]["bitwise"])
    g = runs["regrowth"][0]["caps"]
    checks["(c) regrown caps, bit for bit"] = (
        out["regrowth"]["bitwise"]
        and g["max_neighbors"] > lj.cfg.max_neighbors
        and g["cell_cap"] % 8 == 0)
    # (d) the rows: forces, energies, virial, replicas, launches, speed
    f1, e1, _ = integrate.compute_forces(row.spec, row.cfg, row_st)
    p1 = float(integrate.virial_pressure(row.spec, row.cfg, row_st))
    f1 = f1.cpu().numpy()
    fr = runs["rows"]
    frc = res[-1]
    dF = max(float(np.abs(r["force"] - f1).max()) for r in frc)
    tol = 2e-5 * (1.0 + float(np.abs(f1).max()))
    dP = max(abs(float(r["P"]) - p1) / abs(p1) for r in frc)
    dE = max(abs(float(r["energies"][k]) - float(e1[k]))
             / (1.0 + abs(float(e1[k]))) for r in frc for k in e1
             if k in ("lj", "lj-tab", "coulomb"))
    agree = all(r["force"].tobytes() == frc[0]["force"].tobytes()
                and r["P"].tobytes() == frc[0]["P"].tobytes() for r in frc) \
        and all(x["state"]["pos"].tobytes() == fr[0]["state"]["pos"]
                .tobytes() for x in fr)
    cell_launches = sum(sum(r["launches"].values()) for r in fr)
    wall = max(float(r["walls"][0]) for r in fr)
    pps = row.cfg.n_particles * M14_ROW_STEPS / wall
    print("m14 (d) rows on %d ranks vs one rank: max|dF| %.3e (tol %.3e), "
          "forces bitwise %s, energies max rel %.3e, virial pressure rel "
          "diff %.3e (%.9g vs %.9g), replicas agree %s, cell-kernel "
          "launches a step %.1f, block positions max|dpos| %.3e bitwise %s"
          % (M14_RANKS, dF, tol, all(r["force"].tobytes() == f1.tobytes()
                                     for r in frc), dE, dP,
             float(frc[0]["P"]), p1, agree,
             cell_launches / (M14_RANKS * M14_ROW_STEPS),
             out["rows"]["dpos"], out["rows"]["bitwise"]))
    print("m14 (d) rows: %d particles, %d steps in %.3f s on the slowest "
          "rank: %.1f particle-steps/s; %d ranks time-sharing one card "
          "over host-staged gloo (a functional number, not a scaling "
          "result) on %s" % (row.cfg.n_particles, M14_ROW_STEPS, wall, pps,
                             M14_RANKS, card))
    checks["(d) forces within tol of one rank"] = dF <= tol
    checks["(d) virial pressure within rel 1e-5"] = dP <= 1e-5
    checks["(d) energies within 1e-5 (1 + |E|)"] = dE <= 1e-5
    checks["(d) replicas agree"] = agree
    checks["(d) no cell kernel on the row path"] = cell_launches == 0
    _require(checks, "m14 ranks")
    return {"launches": {k: min(out[k]["k1f"]) for k in
                         ("break", "release", "regrowth")}, "row_pps": pps,
            "row_dF": dF, "row_dP": dP}


def m14_path(card: str):
    """M14 on the one card: (a) the CLI on 3 ranks, (b)-(d) the extension
    melts, a regrowth and the row melt on 2 ranks, each against one
    rank."""
    t0 = time.perf_counter()
    cli = m14_cli(card)
    ranks = m14_ranks(card)
    print("m14 phase wall time: %.1f s" % (time.perf_counter() - t0))
    return dict(ranks, cli_launches=cli["launches"])


# ---- the bonded kernel at the benchmark cell's shapes -----------------------

BK_MOLS = 133334        # trimers: 400 002 particles, the benchmark cell's melt
BK_DESCENT = 200        # capped descent steps (the cell takes 600)
BK_INITIATORS = 1333    # the cell's: one living end per 300 particles
BK_EVENTS = 2048        # the cell's max_events, above the living ends
BK_BLOCKS = 2           # reactive blocks before the timing (the cell's
                        # untimed block and first regrowth block)
BK_ROW_BYTES = 33       # func, 6 params, typelookup, lambda of a term row


def bonded_bytes(n: int, tables) -> int:
    """Bytes the bonded kernel's work needs, each read or written once:
    positions and types in, forces out, each dense row's first index and
    term row, each listed slot's first index and, where live, its other
    indices and term row (``tables``: (table, arity, dense) triples)."""
    total = 16 * n + 12 * n
    for table, arity, dense in tables:
        if table is None:
            continue
        if dense:
            total += (4 + BK_ROW_BYTES) * n
        else:
            live = int(table.valid.sum())
            total += 4 * table.capacity + (4 * (arity - 1) + BK_ROW_BYTES) \
                * live
    return total


def _autograd_bonded(spec, cfg, state, dense):
    """The bonds' and angles' forces by autograd, as the port took them
    before the kernel: -grad of ``bonded_energy_terms``."""
    import torch

    from chemlab_tpu_torch.engine import bonded_forces

    with torch.enable_grad():
        p = state.pos.detach().requires_grad_(True)
        terms = bonded_forces.bonded_energy_terms(
            spec, cfg, p, state.box, state.type_id, state.q, state.bonds,
            state.angles, state.dihedrals, state.pairs14, dense=dense)
        (g,) = torch.autograd.grad(sum(terms.values()), p)
    return -g, {k: v.detach() for k, v in terms.items()}


def bonded_kernel_path(card: str):
    """The bonded kernel at the benchmark cell's shapes (docstring item
    13)."""
    import math

    import torch

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import (bonded_forces, build, cell_pair,
                                          integrate, runner)

    def caps(cfg, state):
        """The CLI's decisions at a block's end (as the benchmark takes
        them): the term tables regrown before they fill, the neighbour
        caps after an overflow."""
        m = runner.measure_cheap(spec, cfg, state)
        counts = {k: int(m[k]) for k in ("n_bonds", "n_angles",
                                         "n_dihedrals", "n_excl",
                                         "n_bonds_irr", "n_angles_irr")}
        counts["excl_pair_cap"] = state.excl.shape[0]
        if build.term_caps_near_full(cfg, counts):
            return build.grow_term_caps(cfg, state, counts=counts)
        if bool(m["overflow"]):
            return build.grow_neighbor_caps(cfg, spec, state)
        return cfg, state

    t0 = time.perf_counter()
    built, systop, _ = testsystems.build_melt(n_mols=BK_MOLS, device=DEVICE,
                                              max_events=BK_EVENTS)
    cfg, spec = built.cfg, built.spec
    state = runner.initial_forces(spec, cfg, built.state)
    state = testsystems.warmup(built, state, steps=BK_DESCENT, max_disp=0.05)
    cfg, state = build.shrink_neighbor_caps(cfg, spec, state)
    cfg, state = build.shrink_term_caps(cfg, state)
    state = testsystems.activate_initiators(built, systop, state,
                                            n=BK_INITIATORS)
    gen = runner.make_generator(20, DEVICE)
    for _ in range(BK_BLOCKS):
        state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
        cfg, state = caps(cfg, state)
    torch.cuda.synchronize()
    dense = integrate._dense_of(cfg, state)
    bd, ad, bl, al = bonded_forces.bond_angle_tables(
        cfg, state.bonds, state.angles, dense)
    print("bonded kernel: %d particles, built, descended, retuned and %d "
          "reactive blocks in %.1f s; events %d; irregular bonds %d live of "
          "%d, angles %d live of %d"
          % (cfg.n_particles, BK_BLOCKS, time.perf_counter() - t0,
             int(state.reaction_counts.sum()), int(bl.valid.sum()),
             bl.capacity, int(al.valid.sum()), al.capacity))

    args = (spec, cfg, state.pos, state.box, state.type_id, state.bonds,
            state.angles, dense)
    k0 = bonded_forces.BOND_ANGLE.launches
    f_k, e_k = bonded_forces.bond_angle_forces(*args)
    f_k2, e_k2 = bonded_forces.bond_angle_forces(*args)
    calls = bonded_forces.BOND_ANGLE.launches - k0
    f_p, e_p = bonded_forces.bond_angle_forces_plain(*args)
    f_a, e_a = _autograd_bonded(spec, cfg, state, dense)
    checks = {}
    for label, f_r, e_r in (("twin", f_p, e_p), ("autograd", f_a, e_a)):
        dF = (f_k - f_r).abs().max().item()
        dE = max(abs(float(e_k[k]) - float(e_r[k]))
                 / (1.0 + abs(float(e_r[k]))) for k in e_r)
        print("bonded kernel vs %s on the card: max|dF| %.3e (tol %.3e), "
              "energies max rel %.3e, %s" % (label, dF, _tol(f_r), dE,
                                              {k: float(e_k[k]) for k in e_k}))
        checks["(a) forces = %s" % label] = dF <= _tol(f_r)
        checks["(a) energies = %s" % label] = dE <= 2e-5 \
            and sorted(e_k) == sorted(e_r)
    checks["(b) a second call bit for bit"] = torch.equal(f_k, f_k2) and all(
        torch.equal(e_k[k], e_k2[k]) for k in e_k)
    checks["(b) one launch count a call"] = calls == 2
    checks["(b) forces finite"] = bool(torch.isfinite(f_k).all())

    call = (spec, cfg, state.pos, state.box, state.type_id, state.q,
            state.bonds, state.angles, state.dihedrals, state.pairs14)
    # a profiler session late in a long process may record no device op
    # (kernel_matrix.device_ms retries for the same reason): up to three
    dev_events = []
    for _ in range(3):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            bonded_forces.bonded_forces(*call, dense=dense)
            torch.cuda.synchronize()
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("bonded_particle_kernel" in e.name for e in dev_events):
            break
    ops = [e.name for e in dev_events]
    kernels = [o for o in ops if not o.startswith(("Memcpy", "Memset"))]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    if any("bonded_particle_kernel" in o for o in ops):
        print("bonded_forces device operations (profiler): %d, kernels %d, "
              "%.1f us busy: %s" % (len(ops), len(kernels), busy_us,
                                    [(e.name[:48], e.time_range.elapsed_us())
                                     for e in dev_events]))
        checks["(c) no autograd kernel in bonded_forces"] = not any(
            "backward" in o or "index_put" in o or "sort" in o.lower()
            for o in ops)
        checks["(c) at most 10 launches a call"] = len(kernels) <= 10
    else:
        busy_us = float("nan")
        print("bonded_forces device operations: not measured (three "
              "profiler sessions recorded %d device ops, none the bonded "
              "kernel's)" % len(ops))

    n = cfg.n_particles
    nbytes = bonded_bytes(state.pos.shape[0], ((bd, 2, True), (ad, 3, True),
                                               (bl, 2, False),
                                               (al, 3, False)))
    bound_ms = 1e3 * nbytes / HBM_BYTES_S
    kernel_ms = _time_ms(lambda: bonded_forces.bond_angle_forces(*args), 50)
    layer_ms = _time_ms(lambda: bonded_forces.bonded_forces(
        *call, dense=dense), 20)
    plain_ms = _time_ms(lambda: bonded_forces.bond_angle_forces_plain(
        *args), 5)
    autograd_ms = _time_ms(lambda: _autograd_bonded(spec, cfg, state, dense),
                           5)
    print("bonded kernel at %d particles: %.4f ms a call (CUDA events, 50 "
          "calls), bound %.4f ms (%.2f MB at %.2f TB/s, bytes), %.1f %% of "
          "it; bonded_forces %.4f ms; plain twin on the card %.4f ms; the "
          "autograd path %.4f ms on %s"
          % (n, kernel_ms, bound_ms, nbytes / 1e6, HBM_BYTES_S / 1e12,
             100.0 * bound_ms / kernel_ms, layer_ms, plain_ms, autograd_ms,
             card))

    bonded_forces.BOND_ANGLE.launches = 0
    cell_pair.K1.launches = 0
    t1 = time.perf_counter()
    state = runner.run_block(spec, cfg, state, BLOCK_STEPS, gen=gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    calls, k1 = bonded_forces.BOND_ANGLE.launches, cell_pair.K1.launches
    m = runner.measure(spec, cfg, state)
    T = float(m["T"])
    print("bonded kernel main path: one %d-step block in %.3f s, %.1f "
          "particle-steps/s, bonded kernel launches %d, K1 %d, events %d, T "
          "%.4f on %s" % (BLOCK_STEPS, wall, n * BLOCK_STEPS / wall, calls,
                          k1, int(state.reaction_counts.sum()), T, card))
    checks["(d) the kernel once a step"] = calls == k1 == BLOCK_STEPS
    checks["(d) T finite, within 0.5-1.5 kT"] = math.isfinite(T) and \
        0.5 * float(spec.kT) <= T <= 1.5 * float(spec.kT)
    checks["(d) no capacity overflow"] = not bool(m["overflow"])
    checks["(d) no jax, no JAX package"] = _no_reference_modules()
    _require(checks, "bonded kernel")
    print("bonded kernel phase wall time: %.1f s" % (time.perf_counter()
                                                     - t0))
    return {"kernel_ms": kernel_ms, "bound_ms": bound_ms,
            "plain_ms": plain_ms, "autograd_ms": autograd_ms,
            "layer_ms": layer_ms, "busy_us": busy_us}


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from chemlab_tpu_torch.engine import _kernels, bonded_forces, cell_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    kernels = cell_pair.KERNELS + (bonded_forces.BOND_ANGLE,)
    build_s = _kernels.build_all(kernels)
    print("kernel build (%d sources in parallel): %.2f s"
          % (len({k.source for k in kernels}), build_s))
    alone = {"m14": m14_path, "bonded_kernel": bonded_kernel_path}
    if len(argv) == 2 and argv[0] == "--only" and argv[1] in alone:
        alone[argv[1]](card)
        print("chip_smoke: the %s phase alone (no kernels line, no result)"
              % argv[1])
        return 0

    def done(phase):
        print("chip_smoke: %s done at %.1f s" % (phase,
                                                 time.perf_counter()
                                                 - t_start))

    lj_row, lj = lj_path(card)
    done("lj")
    k2_row, cap36, small = k2_path(card)
    done("k2")
    rows = [lj_row, k2_row]
    ladder_rows, km = ladder_path(card, lj, cap36, small)
    rows += ladder_rows
    done("ladder")
    npt_row, npt_pps = npt_path(card)
    rows.append(npt_row)
    done("npt")
    tab_rows, pps = tab_paths(card)
    rows += tab_rows
    done("tabulated")
    slab_rows, slab_pps = slab_path(card)
    rows += slab_rows
    done("slab")
    example = example_copy()
    cli = cli_path(card, example)
    lj_row["cli_launches"] = cli["launches"]
    cap_change_path(example)
    checkpoint_path(example)
    done("cli")
    chain = bonded_path(card)
    lj_row["chain_launches"] = chain["launches"]
    done("bonded")
    brk, rel = extensions_path(card)
    lj_row["break_launches"] = brk["launches"]
    lj_row["release_launches"] = rel["launches"]
    done("extensions")
    rows_run = rows_path(card)
    done("rows")
    tools = tools_path(card)
    lj_row["tools_launches"] = tools["k1_launches"]
    done("tools")
    m14 = m14_path(card)
    done("m14")
    bk = bonded_kernel_path(card)
    done("bonded kernel")
    k1f_row = next(r for r in rows if r["name"] == K1F_ROWS["K1f"][0])
    k1f_row["m14_cli_launches"] = m14["cli_launches"]
    k1f_row["m14_launches"] = m14["launches"]
    next(r for r in rows if r["name"].startswith("K1c "))[
        "nve_launches"] = tools["k1c_launches"]
    print("NPT 10k melt: %.1f particle-steps/s on %s" % (npt_pps, card))
    print("tabulated 10k melt: %.1f particle-steps/s on %s" % (pps, card))
    print("slab path, %d ranks on one card: %.1f particle-steps/s on %s"
          % (SLAB_RANKS, slab_pps, card))
    print("chain melt (10k, dihedrals, 1-4 pairs, func-8 bonded, full-row "
          "reactions): %.1f particle-steps/s, K1 launches %d, bonded_forces "
          "%.4f ms on %s" % (chain["pps"], chain["launches"],
                             chain["bonded_ms"], card))
    for label, ext in (("break", brk), ("release", rel)):
        print("%s melt (10k, reaction extensions): %.1f particle-steps/s, K1 "
              "launches %d, %.3f ms a reaction step on the main path (%.3f "
              "ms, %d launches alone), %.1f launches a step, ATRP step "
              "%.3f ms on %s" % (label, ext["pps"], ext["launches"],
                                 ext["rx_ms"], ext["reaction_ms"],
                                 ext["reaction"], ext["step"],
                                 ext["atrp_ms"], card))
    print("row melt (10k, the Verlet row path: funcs 8, 13-17, LJ, "
          "Coulomb): %.1f particle-steps/s, %.1f launches a step, %.4f ms a "
          "rebuild, %.4f ms a pair_forces, %.4f ms a virial_pressure, "
          "max_neighbors %d on %s"
          % (rows_run["pps"], rows_run["launches_step"],
             rows_run["rebuild_ms"], rows_run["pair_ms"],
             rows_run["virial_ms"], rows_run["max_neighbors"], card))
    print("tools: tune_skin %s particle-steps/s, winner %.2f; NVE drift "
          "(kT per particle per step) K1c %.6e, row %.6e on %s"
          % ({k: round(v, 1) for k, v in tools["tune"].items()},
             tools["best"],
             tools["nve"]["cheb"]["drift_kT_per_particle_per_step"],
             tools["nve"]["row"]["drift_kT_per_particle_per_step"], card))
    print("m14: K1f launches, the CLI on %d ranks %d a rank, the 2-rank "
          "melts %s; the row melt on %d ranks %.1f particle-steps/s, "
          "max|dF| %.3e, virial rel %.3e on %s"
          % (M14_CLI_RANKS, m14["cli_launches"], m14["launches"],
             M14_RANKS, m14["row_pps"], m14["row_dF"], m14["row_dP"], card))
    print("bonded kernel (400k, csrc/bonded.cu): %.4f ms a call (events), "
          "%.1f us device busy (profiler; nan: not measured), bound %.4f ms, bonded_forces "
          "%.4f ms, plain twin %.4f ms, autograd %.4f ms on %s"
          % (bk["kernel_ms"], bk["busy_us"], bk["bound_ms"], bk["layer_ms"],
             bk["plain_ms"], bk["autograd_ms"], card))
    print("kernel matrix (ms): %s" % json.dumps(km))
    print("cli (examples/atrp_melt, 6000 particles): %.1f particle-steps/s, "
          "K1 launches %d (%d within the loop's %d steps), cell_cap 40 -> "
          "%d, %d events on %s"
          % (cli["pps"], cli["launches"], cli["in_loop"], CLI_STEPS,
             cli["cell_cap"], cli["events"], card))
    if len(rows) != len(cell_pair.BY_NAME) or not all(
            r["launches"] > 0 for r in rows):
        raise AssertionError("the kernels line needs every launch count of "
                             "cell_pair.BY_NAME (%d), each > 0: %s"
                             % (len(cell_pair.BY_NAME),
                                [(r["name"], r["launches"]) for r in rows]))
    print("chip_smoke total wall time: %.1f s" % (time.perf_counter()
                                                  - t_start))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
