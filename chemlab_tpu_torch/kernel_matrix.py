"""The port's kernel matrix: every LJ pair kernel timed side by side on the
warmed reactive melt, then a run of the default path.

Usage, on a machine with a CUDA card (it fails without one, and never falls
back to the CPU)::

    python -m chemlab_tpu_torch.kernel_matrix [n_mols]

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

Left out: ``cell_scatter`` (the TPU's scatter epilogue, which the port does
not carry) and ``KM_RETUNE`` (it waits for capacity management's
``shrink_neighbor_caps``).
"""

from __future__ import annotations

import json
import sys
import time

import torch

from . import testsystems
from .engine import cell_pair, runner
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


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("kernel_matrix: no CUDA device", file=sys.stderr)
        return 2
    n_mols = int(argv[0]) if argv else 3334
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
