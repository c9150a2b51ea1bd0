"""Device busy milliseconds a step of the bonded layer, read in the span
block (``spans.of``: one block traced after the window): the busy time of
the device operations launched inside the program's ``chemlab::bonded``
spans (``bonded_forces``, its autograd backward included, whichever
thread launched it), over the block's steps.  Device time, so the
profiler's host overhead, which stretches the traced block, does not
enter it.  None where the program opens no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    if t is None or "bonded" not in t.rows:
        return None
    return 1e3 * t.rows["bonded"]["busy_s"] / t.steps
