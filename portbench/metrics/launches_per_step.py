"""CUDA kernels launched per MD step: the profiler's kernel count over the
traced block, over its steps (copies and sets not counted)."""


def read(ctx):
    t = ctx.trace
    if t is None or t.launches == 0:
        return None
    return t.launches / t.steps
