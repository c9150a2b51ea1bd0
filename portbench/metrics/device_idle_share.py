"""Share of a block in which no operation ran on the device, in percent:
100 (1 - busy / wall), busy the union of the device events' intervals in
the traced block, wall the median wall time of the window's untraced
blocks (the profiler's host overhead stretches the traced block's)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0.0 or not ctx.block_s > 0.0:
        return None
    return 100.0 * (1.0 - t.busy_s / ctx.block_s)
