"""The device trace of the traced run: ``torch.profiler`` over one whole
block of the window, reduced to counts, busy time, the device operations
that took most time and the longest idle gaps.

Device events are the profiler's CUDA activities (kernels, copies,
sets).  Host syncs are the CUDA runtime calls that wait for the device:
``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the blocking ``cudaMemcpy``.  An idle gap
is an interval of the window in which no device event runs; it is
labelled by the innermost host operation running at its middle, or
"python (no operator)" where the host ran none.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
TOP = 10


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    launches: int
    syncs: int
    device_ops: list      # [[name, seconds], ...], most time first
    idle_gaps: list       # [[host activity, seconds], ...], longest first


def capture(fn, steps: int, device) -> Trace:
    """Run ``fn`` (``steps`` MD steps) under the profiler and reduce its
    trace; ``fn`` ends with the device synchronized."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize(device)
        t1 = time.perf_counter_ns()
    return reduce_events(prof.profiler.kineto_results.events(), steps,
                         (t1 - t0) * 1e-9)


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its return type and parameter list, at
    most ``width`` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:k]
            break
    return name[:width]


def _union_ns(starts, ends):
    """(busy ns, merged intervals) of intervals given as arrays."""
    if len(starts) == 0:
        return 0, np.zeros((0, 2), dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    merged = []
    cs, ce = s[0], e[0]
    for a, b in zip(s[1:], e[1:]):
        if a > ce:
            merged.append((cs, ce))
            cs, ce = a, b
        elif b > ce:
            ce = b
    merged.append((cs, ce))
    m = np.array(merged, dtype=np.int64)
    return int(np.sum(m[:, 1] - m[:, 0])), m


def reduce_events(events, steps: int, window_s: float) -> Trace:
    """A ``Trace`` from the profiler's events; the window spans from the
    first to the last event the profiler recorded, or ``window_s`` of the
    host clock where that is longer."""
    cuda = torch.autograd.DeviceType.CUDA
    dev_s, dev_e, dev_name = [], [], []
    host_s, host_e, host_name = [], [], []
    syncs = 0
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            dev_s.append(start)
            dev_e.append(end)
            dev_name.append(name)
        else:
            if name in SYNC_CALLS:
                syncs += 1
            host_s.append(start)
            host_e.append(end)
            host_name.append(name)
    dev_s = np.array(dev_s, dtype=np.int64)
    dev_e = np.array(dev_e, dtype=np.int64)
    launches = sum(1 for n in dev_name
                   if not n.startswith(("Memcpy", "Memset")))
    busy_ns, merged = _union_ns(dev_s, dev_e)
    by_name = {}
    for n, a, b in zip(dev_name, dev_s, dev_e):
        n = short_name(n)
        by_name[n] = by_name.get(n, 0) + int(b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    host_s = np.array(host_s, dtype=np.int64)
    host_e = np.array(host_e, dtype=np.int64)
    lo = min([x.min() for x in (dev_s, host_s) if len(x)], default=0)
    hi = max([x.max() for x in (dev_e, host_e) if len(x)], default=0)
    span_s = max((hi - lo) * 1e-9, window_s)
    gaps = []
    if len(merged):
        edges = np.concatenate([[lo], merged.ravel(), [hi]]).reshape(-1, 2)
        length = edges[:, 1] - edges[:, 0]
        for k in np.argsort(-length, kind="stable")[:TOP]:
            if length[k] <= 0:
                break
            mid = (edges[k, 0] + edges[k, 1]) // 2
            inside = np.nonzero((host_s <= mid) & (host_e >= mid))[0]
            label = "python (no operator)"
            if len(inside):
                label = host_name[inside[np.argmin(host_e[inside]
                                                   - host_s[inside])]]
            gaps.append([label, float(length[k]) * 1e-9])
    return Trace(steps=steps, window_s=span_s, busy_s=busy_ns * 1e-9,
                 launches=launches, syncs=syncs,
                 device_ops=[[n, t * 1e-9] for n, t in ops],
                 idle_gaps=gaps)
