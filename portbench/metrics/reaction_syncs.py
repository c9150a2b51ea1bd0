"""Host syncs of one reaction step, read in the span block (``spans.of``:
one block traced after the window): the CUDA runtime's synchronizing
calls (``trace.SYNC_CALLS``) made while the program's
``chemlab::reaction_step`` span was open, over the spans' count.  A
count, which the profiler's host overhead does not change.  None where
the block ran no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    r = None if t is None else t.rows.get("reaction_step")
    if r is None or r["count"] == 0:
        return None
    return r["syncs"] / r["count"]
