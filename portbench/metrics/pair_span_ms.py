"""Device busy milliseconds a step of the pair layer, read in the span
block (``spans.of``: one block traced after the window): the busy time of
the device operations launched inside the program's ``chemlab::pair_sum``
and ``chemlab::excl_correction`` spans (the kernel's all-pairs sum and
the excluded-pair correction, inclusive), over the block's steps.  Device
time, so the profiler's host overhead, which stretches the traced block,
does not enter it.  None where the program opens no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    if t is None or "pair_sum" not in t.rows:
        return None
    busy = sum(t.rows[n]["busy_s"] for n in ("pair_sum", "excl_correction")
               if n in t.rows)
    return 1e3 * busy / t.steps
