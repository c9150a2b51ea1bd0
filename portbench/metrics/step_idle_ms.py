"""Device idle milliseconds a step inside the MD step, read in the span
block (``spans.of``: one block traced after the window): the time no
device operation ran while the program's ``chemlab::md_step`` span was
open, over the block's steps.  Read with the profiler on: its host
overhead stretches the host's share, so the idle time too (a traced
block runs 8.6-10.8 s against 6.5-7.8 s untraced on an H100 at 400k).
None where the program opens no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    if t is None or "md_step" not in t.rows:
        return None
    return 1e3 * t.rows["md_step"]["idle_s"] / t.steps
