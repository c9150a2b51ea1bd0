"""Host milliseconds of one reaction step, read in the span block
(``spans.of``: one block traced after the window): the time the
program's ``chemlab::reaction_step`` spans (``runner._fire_reactions``:
matching, the events, the re-derivation) were open, over their count.
Read with the profiler on: its host overhead is inside (a traced block
runs 8.6-10.8 s against 6.5-7.8 s untraced on an H100 at 400k).  None
where the block ran no such span."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    r = None if t is None else t.rows.get("reaction_step")
    if r is None or r["count"] == 0:
        return None
    return 1e3 * r["host_s"] / r["count"]
