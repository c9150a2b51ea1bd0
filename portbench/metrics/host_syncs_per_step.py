"""Host waits on the device per MD step: the CUDA runtime's synchronizing
calls (stream, device and event synchronizes, blocking copies) in the
traced block, over its steps."""


def read(ctx):
    t = ctx.trace
    if t is None or t.launches == 0:
        return None
    return t.syncs / t.steps
