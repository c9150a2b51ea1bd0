"""The program's spans in one traced block: the ``chemlab::<name>``
ranges that ``chemlab_tpu_torch/engine/perf.py`` opens at each engine
layer while a profiler records, reduced to a table per span.

The block is one more block of the cell's traffic, run under the
profiler from the window's end state after the window closes (``of``),
once a run, for the readers of ``program_span`` metrics; the window's own
traced block stays ``trace.py``'s.  It is a block of a settled run, not
the window's first, and the profiler's host overhead stretches it as it
does the window's traced block.

For each span name, over the block: its count; host time, inclusive and
self (self: while it is the innermost span); device busy time of the
operations launched inside it, inclusive and self; device idle time while
it is open, inclusive and self; the host syncs inside it.  Spans are read
on the thread that opened ``chemlab::block``.  A device operation is
joined to the CUDA call that launched it by the profiler's
``correlation_id()`` (on an H100 with torch 2.11 it joins every one), and
placed by that call's start against the block thread's span stack: a
launch from autograd's worker thread, made while the block thread waits
inside ``chemlab::bonded``, lands in ``bonded``.  Busy time is the union
of the device operations' intervals (``trace.py``'s ``busy_s``), each
instant given to the operation that first covers it; idle time is its
complement inside the trace's window, given to the span open on the block
thread at that instant.  Time outside every span goes to ``(none)``,
device operations with no launch found to ``(unlinked)``.  With no span
in the trace (a program without them) the table is empty.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import sys
import time

import numpy as np
import torch

from . import trace
from .trace import SYNC_CALLS, TOP, _union_ns

SPAN_PREFIX = "chemlab::"

BLOCK = "block"
NONE = "(none)"
UNLINKED = "(unlinked)"
FIELDS = ("count", "host_s", "host_self_s", "busy_s", "busy_self_s",
          "idle_s", "idle_self_s", "syncs", "syncs_self")
SELF = {"host_s": "host_self_s", "busy_s": "busy_self_s",
        "idle_s": "idle_self_s", "syncs": "syncs_self"}


@dataclasses.dataclass
class Table:
    rows: dict            # {span name: {field: value}} (FIELDS)
    gaps: list            # [[span path, seconds], ...], longest idle first
    busy_s: float         # the sum of the rows' busy_self_s
    unlinked: int         # device operations with no launch found
    steps: int = 0        # MD steps of the block


def is_span(name: str) -> bool:
    """Whether a profiler event is one of the program's spans."""
    return name.startswith(SPAN_PREFIX)


def _segments(spans):
    """The block thread's spans, (start, end, name) each, flattened into
    runs of one stack: (starts, ends, stacks) in time order."""
    starts, ends, stacks = [], [], []
    stack = []            # [(end, name)], innermost last
    t = None

    def emit(a, b):
        if stack and b > a:
            starts.append(a)
            ends.append(b)
            stacks.append(tuple(n for _, n in stack))

    def close_until(s):
        nonlocal t
        while stack and stack[-1][0] <= s:
            end = stack[-1][0]
            emit(t, end)
            stack.pop()
            t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close_until(s)
        if stack:
            emit(t, s)
            e = min(e, stack[-1][0])
        stack.append((e, name))
        t = s
    close_until(float("inf"))
    return starts, ends, stacks


def _row():
    return dict.fromkeys(FIELDS, 0)


def reduce(events) -> Table:
    """The per-span table of the profiler's events (kineto events:
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``start_thread_id()``, ``correlation_id()``)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans, dev, syncs = [], [], []
    launch = {}           # correlation id: start of the CUDA call
    host_lo, host_hi = [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            if not is_span(name):
                dev.append((start, end, e.correlation_id()))
            continue
        if is_span(name):
            spans.append((start, end, name[len(SPAN_PREFIX):],
                          e.start_thread_id()))
            continue
        host_lo.append(start)
        host_hi.append(end)
        if name in SYNC_CALLS:
            syncs.append(start)
        if name.startswith("cu"):
            launch[e.correlation_id()] = start
    if not spans:
        return Table(rows={}, gaps=[], busy_s=0.0, unlinked=0)
    thread = next((th for s, e, n, th in spans if n == BLOCK), spans[0][3])
    mine = [(s, e, n) for s, e, n, th in spans if th == thread]
    seg_s, seg_e, seg_k = _segments(mine)
    rows = {}

    def row(name):
        return rows.setdefault(name, _row())

    def stack_at(t):
        k = bisect.bisect_right(seg_s, t) - 1
        if k >= 0 and t < seg_e[k]:
            return seg_k[k]
        return (NONE,)

    def add(stack, field, value):
        row(stack[-1])[SELF[field]] += value
        for name in set(stack):
            row(name)[field] += value

    for s, e, n in mine:
        row(n)["count"] += 1
    for a, b, k in zip(seg_s, seg_e, seg_k):
        add(k, "host_s", (b - a) * 1e-9)
    for t in syncs:
        add(stack_at(t), "syncs", 1)

    # busy: each instant of the union to the first operation covering it
    unlinked = 0
    covered = None
    for s, e, corr in sorted(dev):
        part = e - s if covered is None else e - max(s, covered)
        covered = e if covered is None else max(covered, e)
        t = launch.get(corr)
        unlinked += t is None
        if part > 0:
            add((UNLINKED,) if t is None else stack_at(t), "busy_s",
                part * 1e-9)

    # idle: the complement of the union inside the window, by stack
    dev_s = np.array([d[0] for d in dev], dtype=np.int64)
    dev_e = np.array([d[1] for d in dev], dtype=np.int64)
    _, merged = _union_ns(dev_s, dev_e)
    gaps = []
    if len(merged):
        lo = min(dev_s.min(), min(host_lo, default=dev_s.min()))
        hi = max(dev_e.max(), max(host_hi, default=dev_e.max()))
        edges = np.concatenate([[lo], merged.ravel(), [hi]]).reshape(-1, 2)
        k = 0
        for a, b in edges.tolist():
            if b <= a:
                continue
            gaps.append(["/".join(stack_at((a + b) // 2)), (b - a) * 1e-9])
            while k < len(seg_s) and seg_e[k] <= a:
                k += 1
            t, j = a, k
            while t < b:
                if j < len(seg_s) and seg_s[j] <= t:
                    u = min(b, seg_e[j])
                    add(seg_k[j], "idle_s", (u - t) * 1e-9)
                    j += 1
                else:
                    u = min(b, seg_s[j]) if j < len(seg_s) else b
                    add((NONE,), "idle_s", (u - t) * 1e-9)
                t = u
    gaps.sort(key=lambda g: -g[1])
    busy = sum(r["busy_self_s"] for r in rows.values())
    return Table(rows=rows, gaps=gaps[:TOP], busy_s=busy, unlinked=unlinked)


def of(ctx):
    """The span table of one block (as many steps as the window's traced
    block) run under the profiler from ``ctx``'s end state, with the
    window's configuration and seeds, after the window; run once a run and
    kept on ``ctx``, its table printed to standard error.  None where the
    program has no spans, so that a program without them pays no block."""
    if not hasattr(ctx, "_span_table"):
        ctx._span_table = _capture(ctx)
    return ctx._span_table


def _capture(ctx):
    from torch.profiler import ProfilerActivity, profile

    runner = ctx.prog.runner
    perf = importlib.import_module(runner.__package__ + ".perf")
    if ctx.trace is None or not hasattr(perf, "span"):
        return None
    steps = ctx.trace.steps
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with torch.random.fork_rng(devices=[dev] if cuda else []):
        gen = runner.make_generator(ctx.seeds["langevin"], dev)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter_ns()
            state = runner.run_block(ctx.spec, ctx.cfg, ctx.state, steps,
                                     rng_seed=ctx.seeds["reactions"],
                                     gen=gen)
            runner.synchronize(dev)
            t1 = time.perf_counter_ns()
        del state
    events = prof.profiler.kineto_results.events()
    table = reduce(events)
    table.steps = steps
    busy = trace.reduce_events(events, steps, (t1 - t0) * 1e-9).busy_s
    print("portbench: spans of one block after the window, %.3f s traced"
          % ((t1 - t0) * 1e-9), file=sys.stderr)
    print(format_table(table, steps, busy), file=sys.stderr, flush=True)
    return table


def format_table(table: Table, steps: int, busy_s: float) -> str:
    """The table as lines for standard error: each span, most busy time
    first, then the longest idle gaps with their span paths."""
    head = ("portbench: spans %-16s %6s %9s %9s %9s %9s %9s %9s %7s %7s"
            % ("span", "count", "host_s", "self", "busy_s", "self",
               "idle_s", "self", "syncs", "self"))
    lines = [head]
    for name, r in sorted(table.rows.items(),
                          key=lambda kv: (-kv[1]["busy_s"], kv[0])):
        lines.append(
            "portbench: spans %-16s %6d %9.4f %9.4f %9.4f %9.4f %9.4f %9.4f "
            "%7d %7d" % (name, r["count"], r["host_s"], r["host_self_s"],
                         r["busy_s"], r["busy_self_s"], r["idle_s"],
                         r["idle_self_s"], r["syncs"], r["syncs_self"]))
    lines.append("portbench: spans over %d steps: busy by span %.6f s, the "
                 "trace's busy_s %.6f s; %d device operations with no "
                 "launch found" % (steps, table.busy_s, busy_s,
                                   table.unlinked))
    for path, sec in table.gaps:
        lines.append("portbench: spans idle gap %.6f s in %s" % (sec, path))
    return "\n".join(lines)
