"""The step's pair sum (the kernel's all-pairs sum minus the
excluded-pair correction, ``engine.integrate``'s ``_pair_sum`` and
``_excl_correction``) against its least time, in percent.  The least time
is the larger of the operations its unordered pairs inside the cutoff
need (the benchmark's own count from the end state's positions) over the
float32 peak, and its bytes (``roofline.pair_bytes``) over HBM's; the
time is device events over many calls on the end state after a warm
one."""

import torch

from portbench import roofline


def read(ctx):
    integ, st, cfg, spec = ctx.prog.integrate, ctx.state, ctx.cfg, ctx.spec
    if not cfg.use_pallas or cfg.needs_conversions:
        return None
    obs_x = torch.zeros(spec.obs_total.shape[0], dtype=torch.float32,
                        device=st.pos.device)

    def call():
        integ._pair_sum(spec, cfg, st, want_energy=False, obs_x=obs_x,
                        kernel="auto")
        integ._excl_correction(spec, cfg, st, obs_x)
    ms = ctx.device_ms(call, reps=50)
    if ms is None:
        return None
    points = 0
    if ctx.tables is not None:
        points = ctx.tables[1].shape[0] * (ctx.tables[1].shape[0] + 1) // 2 \
            * ctx.tables[1].shape[2]
    least, _ = roofline.least_seconds(
        roofline.pair_flops(ctx.pair_kind, ctx.pairs()),
        roofline.pair_bytes(st.pos.shape[0], int(st.n_excl), points))
    return 100.0 * least / (ms * 1e-3)
