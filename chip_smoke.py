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
     one untimed and three timed 200-step Langevin blocks with reaction
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
     0.15, tau 2.0) with Langevin, one untimed and three timed blocks, K1
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
     one untimed and three timed reactive blocks of the tabulated melt;
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
     pressure).
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
TIMED_BLOCKS = 3
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


def check_small_melt_against_cpu(builder, label: str, kernel):
    """A 70-trimer melt on the GPU and on the CPU from one state: forces
    and 20 NVE steps agree, and the GPU steps launched ``kernel``."""
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import cell_pair, integrate, runner

    built, _, _ = builder(n_mols=70, thermostat="no", device="cpu")
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
    for name, ok in checks.items():
        print("check %-32s %s" % (name, "ok" if ok else "FAILED"))
    if not all(checks.values()):
        raise AssertionError("%s checks failed" % label)
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
    for name, ok in checks.items():
        print("check %-42s %s" % (name, "ok" if ok else "FAILED"))
    if not all(checks.values()):
        raise AssertionError("slab path checks failed")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from chemlab_tpu_torch.engine import _kernels, cell_pair

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    build_s = _kernels.build_all(cell_pair.KERNELS)
    print("kernel build (%d sources in parallel): %.2f s"
          % (len({k.source for k in cell_pair.KERNELS}), build_s))

    lj_row, lj = lj_path(card)
    k2_row, cap36, small = k2_path(card)
    rows = [lj_row, k2_row]
    ladder_rows, km = ladder_path(card, lj, cap36, small)
    rows += ladder_rows
    npt_row, npt_pps = npt_path(card)
    rows.append(npt_row)
    tab_rows, pps = tab_paths(card)
    rows += tab_rows
    slab_rows, slab_pps = slab_path(card)
    rows += slab_rows
    print("NPT 10k melt: %.1f particle-steps/s on %s" % (npt_pps, card))
    print("tabulated 10k melt: %.1f particle-steps/s on %s" % (pps, card))
    print("slab path, %d ranks on one card: %.1f particle-steps/s on %s"
          % (SLAB_RANKS, slab_pps, card))
    print("kernel matrix (ms): %s" % json.dumps(km))
    if len(rows) != len(cell_pair.BY_NAME) or not all(
            r["launches"] > 0 for r in rows):
        raise AssertionError("the kernels line needs every launch count of "
                             "cell_pair.BY_NAME (%d), each > 0: %s"
                             % (len(cell_pair.BY_NAME),
                                [(r["name"], r["launches"]) for r in rows]))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
