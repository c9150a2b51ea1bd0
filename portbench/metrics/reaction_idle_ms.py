"""Device idle milliseconds of one reaction step, read in the span block
(``spans.of``: one block traced after the window): the time no device
operation ran while the program's ``chemlab::reaction_step`` span was
open, over the spans' count.  Read with the profiler on: its host
overhead stretches the host's share, so the idle time too (a traced
block runs 8.6-10.8 s against 6.5-7.8 s untraced on an H100 at 400k).
None where the block ran no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    r = None if t is None else t.rows.get("reaction_step")
    if r is None or r["count"] == 0:
        return None
    return 1e3 * r["idle_s"] / r["count"]
