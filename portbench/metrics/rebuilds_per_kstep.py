"""Neighbour refreshes per 1 000 MD steps, read in the span block
(``spans.of``: one block traced after the window): the count of the
program's ``chemlab::rebuild`` spans (the cell-bucket refresh on the
kernel path, the row rebuild on the row path, each when the skin
criterion fires), times 1 000, over the block's steps.  A count, which
the profiler does not change.  None where the program opens no
``chemlab::md_step`` span (0 where it steps but never rebuilds)."""

from portbench import spans


def read(ctx):
    t = spans.of(ctx)
    if t is None or "md_step" not in t.rows:
        return None
    n = t.rows["rebuild"]["count"] if "rebuild" in t.rows else 0
    return 1e3 * n / t.steps
