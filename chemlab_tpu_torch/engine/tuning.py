"""Runtime auto-tuning: the espressopp ``tools.decomp.tuneSkin`` analog
(ref: start_simulation.py:716-721).

Port of ``chemlab_tpu/engine/tuning.py``.  The Verlet skin trades rebuild
frequency against per-step candidate count; the optimum depends on
temperature, density, and hardware.  ``tune_skin`` rebuilds the system at
several skins, times a short block on the build's device for each (the
clock read after a synchronize on the card), and returns the fastest
configuration.
"""

from __future__ import annotations

import dataclasses
import time


def tune_skin(systop, coords, opts, reaction_config=None,
              candidates=(0.1, 0.2, 0.3, 0.4, 0.6), block_steps: int = 100,
              verbose: bool = True, device="cuda"):
    """Return (best_skin, results dict skin -> particle-steps/s).

    Each candidate builds the system at its skin on ``device``, runs one
    untimed block and one timed block of ``block_steps`` (the Langevin
    noise from a generator seeded with ``opts.rng_seed``); run this once
    per workload class and bake the winner into the params file.
    """
    from . import build as build_mod
    from . import runner

    results = {}
    best = (None, 0.0)
    for skin in candidates:
        o = dataclasses.replace(opts, skin=skin)
        built = build_mod.build_system(systop, coords, o,
                                       reaction_config=reaction_config,
                                       device=device)
        st = runner.initial_forces(built.spec, built.cfg, built.state)
        gen = runner.make_generator(opts.rng_seed, st.device)
        st = runner.run_block(built.spec, built.cfg, st, block_steps,
                              gen=gen)
        runner.synchronize(st.device)
        t0 = time.perf_counter()
        st = runner.run_block(built.spec, built.cfg, st, block_steps,
                              gen=gen)
        runner.synchronize(st.device)
        dt = time.perf_counter() - t0
        pps = built.cfg.n_particles * block_steps / dt
        results[skin] = pps
        if verbose:
            print("skin %.2f: %.3g particle-steps/s" % (skin, pps))
        if pps > best[1]:
            best = (skin, pps)
    return best[0], results
