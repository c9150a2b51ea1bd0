"""The engine's profiler spans (``engine/perf.py``) and the benchmark's
reduction of them (``portbench/spans.py``): a span is a shared null
context with no profiler and changes no bit of a block; under the CPU
profiler a block nests its spans layer by layer; on synthetic event lists
the reduction joins kernels to spans by correlation, splits idle time by
the innermost span, counts syncs, and its inclusive and self times add
up; ``spans.of`` traces one block from a run's end state and leaves the
state as it was; ``trace.reduce_events`` reads the same launches, syncs
and busy time with the program's spans in its input."""

import dataclasses
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import perf, runner
from portbench import spans, trace


@pytest.fixture(scope="module")
def melt():
    """A tiny reactive melt three steps before a reaction step."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    built, systop, _ = testsystems.build_melt(n_mols=20, device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.activate_initiators(built, systop, st, n=4)
    step = built.cfg.reaction_interval - 3
    st = dataclasses.replace(st, step=torch.full_like(st.step, step))
    yield built, st
    torch.set_num_threads(n)


def _block(built, st):
    return runner.run_block(built.spec, built.cfg, st, 3,
                            gen=runner.make_generator(5, "cpu"))


def _leaves(x, path="state"):
    if isinstance(x, torch.Tensor):
        yield path, x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), path + "." + f.name)


def test_span_is_a_shared_null_context_and_changes_no_bit(melt):
    built, st = melt
    assert not torch.autograd._profiler_enabled()
    assert perf.span(perf.MD_STEP) is perf.span(perf.BONDED)
    with perf.span(perf.BLOCK) as inside:
        assert inside is None
    plain = _block(built, st)
    with profile(activities=[ProfilerActivity.CPU]):
        assert perf.span(perf.MD_STEP) is not perf.span(perf.MD_STEP)
        traced = _block(built, st)
    assert int(traced.step) == built.cfg.reaction_interval
    a, b = dict(_leaves(plain)), dict(_leaves(traced))
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_block_nests_its_spans(melt):
    built, st = melt
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _block(built, st)
    found = [(e.start_ns(), e.start_ns() + e.duration_ns(),
              e.name()[len(perf.SPAN_PREFIX):])
             for e in prof.profiler.kineto_results.events()
             if perf.is_span(e.name())]

    def parent(s, e, name):
        around = [x for x in found if x[0] <= s and e <= x[1]
                  and x != (s, e, name)]
        return min(around, key=lambda x: x[1] - x[0])[2] if around else None

    names = [n for _, _, n in found]
    assert names.count(perf.BLOCK) == 1
    assert names.count(perf.MD_STEP) == 3
    assert names.count(perf.REACTION_STEP) == 1
    for child in (perf.BONDED, perf.PAIR_SUM, perf.EXCL_CORRECTION,
                  perf.REBUILD_CHECK):
        assert [parent(*x) for x in found if x[2] == child] == \
            [perf.MD_STEP] * 3, child
    for child in (perf.RX_MATCH, perf.RX_APPLY, perf.REDERIVE):
        assert [parent(*x) for x in found if x[2] == child] == \
            [perf.REACTION_STEP], child
    assert [parent(*x) for x in found if x[2] == perf.RX_MERGE] == \
        [perf.RX_APPLY]
    for x in found:
        if x[2] in (perf.MD_STEP, perf.REACTION_STEP):
            assert parent(*x) == perf.BLOCK
    assert set(names) <= set(perf.SPANS)
    # operator-scope ranges: the profiler makes no device-side copy of them
    assert not any(e.is_user_annotation()
                   for e in prof.profiler.kineto_results.events()
                   if perf.is_span(e.name()))
    table = spans.reduce(prof.profiler.kineto_results.events())
    assert table.rows[perf.MD_STEP]["count"] == 3
    assert table.rows[perf.BLOCK]["host_s"] >= \
        table.rows[perf.MD_STEP]["host_s"] > 0


class Ev:
    """A kineto event as ``spans.reduce`` and ``trace.reduce_events`` read
    it."""

    def __init__(self, name, start, end, device=False, thread=1, corr=0):
        self._v = (name, start, end, device, thread, corr)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)

    def start_thread_id(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]


def _span(name, a, b, thread=1):
    return Ev("chemlab::" + name, a, b, thread=thread)


def _launch(a, corr, thread=1):
    return Ev("cudaLaunchKernel", a, a + 4, thread=thread, corr=corr)


def _kernel(name, a, b, corr=0):
    return Ev(name, a, b, device=True, corr=corr)


# block [0, 1000] > md_step [100, 600] > bonded [200, 400], pair_sum
# [450, 550]; block > reaction_step [700, 900].  Kernel k2 is launched by
# autograd's worker (thread 2) while the block thread is in bonded and
# runs after bonded closed; k5 overlaps k1; k6 has no launch.  The window is the host operations' and the
# kernels' (spans left out): [0, 1000].
PROGRAM = [
    _span("block", 0, 1000), _span("md_step", 100, 600),
    _span("bonded", 200, 400), _span("pair_sum", 450, 550),
    _span("reaction_step", 700, 900),
    _kernel("chemlab::bonded", 300, 420),     # a GPU-side annotation
]
OTHERS = [
    Ev("aten::empty", 0, 5, corr=70),
    _launch(210, 1), _kernel("k1", 300, 350, corr=1),
    _launch(215, 5), _kernel("k5", 340, 355, corr=5),
    _launch(250, 2, thread=2), _kernel("k2", 360, 420, corr=2),
    _launch(460, 3), _kernel("k3", 470, 500, corr=3),
    _launch(720, 4), _kernel("k4", 730, 760, corr=4),
    _kernel("k6", 800, 810, corr=42),
    Ev("cudaStreamSynchronize", 500, 505),
    Ev("cudaStreamSynchronize", 750, 752),
    Ev("cudaDeviceSynchronize", 980, 1000),
]
# the program's spans as it opens them: operator-scope, with no copy on
# the device's timeline
HOST_SPANS = [e for e in PROGRAM
              if e.device_type() != torch.autograd.DeviceType.CUDA]
NS = 1e-9


def test_spans_attribute_busy_idle_and_syncs():
    t = spans.reduce(PROGRAM + OTHERS)
    r = t.rows
    assert t.unlinked == 1
    want = {  # name: (host, host self, busy, busy self, idle, idle self,
              #        syncs, syncs self)
        "block": (1000, 300, 175, 0, 815, 300, 3, 1),
        "md_step": (500, 200, 145, 0, 355, 180, 1, 0),
        "bonded": (200, 200, 115, 115, 105, 105, 0, 0),
        "pair_sum": (100, 100, 30, 30, 70, 70, 1, 1),
        "reaction_step": (200, 200, 30, 30, 160, 160, 1, 1),
        "(unlinked)": (0, 0, 10, 10, 0, 0, 0, 0),
    }
    assert set(r) == set(want)
    for name, w in want.items():
        got = tuple(r[name][f] for f in spans.FIELDS[1:])
        assert got[:6] == pytest.approx(tuple(x * NS for x in w[:6]),
                                        abs=1e-15), name
        assert got[6:] == w[6:], name
        assert r[name]["count"] == (name != "(unlinked)")
    for field in ("host_s", "busy_s", "idle_s", "syncs"):
        self_sum = sum(x[spans.SELF[field]] for x in r.values())
        assert self_sum == pytest.approx(
            r["block"][field] + r["(unlinked)"][field], abs=1e-15)
    tr = trace.reduce_events(HOST_SPANS + OTHERS, 1, 0.0)
    assert t.busy_s == pytest.approx(tr.busy_s, abs=1e-15)
    assert tr.busy_s == pytest.approx(185 * NS)
    assert t.gaps[0] == ["block/md_step", pytest.approx(300 * NS)]


def test_spans_table_is_empty_without_spans():
    t = spans.reduce(OTHERS)
    assert (t.rows, t.gaps, t.busy_s) == ({}, [], 0.0)


def test_reduce_events_reads_the_same_with_spans():
    with_spans = trace.reduce_events(HOST_SPANS + OTHERS, 200, 1e-6)
    without = trace.reduce_events(OTHERS, 200, 1e-6)
    a, b = dataclasses.asdict(with_spans), dataclasses.asdict(without)
    gaps_a, gaps_b = a.pop("idle_gaps"), b.pop("idle_gaps")
    assert a == b
    assert without.launches == 6 and without.syncs == 3
    # a gap the host spent in no operator is named by its innermost span
    assert [g[1] for g in gaps_a] == [g[1] for g in gaps_b]
    for (la, _), (lb, _) in zip(gaps_a, gaps_b):
        assert la == lb or (lb == "python (no operator)"
                            and perf.is_span(la)), (la, lb)
    assert any(la != lb for (la, _), (lb, _) in zip(gaps_a, gaps_b))


def _ctx(built, st, steps):
    return types.SimpleNamespace(
        prog=types.SimpleNamespace(runner=runner), spec=built.spec,
        cfg=built.cfg, state=st, trace=types.SimpleNamespace(steps=steps),
        seeds={"langevin": 11, "reactions": 12}, device="cpu")


def test_span_block_after_the_window(melt, monkeypatch, capsys):
    built, st = melt
    before = {k: v.clone() for k, v in _leaves(st)}
    ctx = _ctx(built, st, 3)
    t = spans.of(ctx)
    assert spans.of(ctx) is t
    assert t.steps == 3
    assert t.rows[perf.MD_STEP]["count"] == 3
    assert t.rows[perf.REACTION_STEP]["count"] == 1
    assert t.rows[perf.BLOCK]["count"] == 1
    assert "portbench: spans md_step" in capsys.readouterr().err
    for k, v in _leaves(st):
        assert torch.equal(v, before[k]), k
    untraced = _ctx(built, st, 3)
    untraced.trace = None
    assert spans.of(untraced) is None
    monkeypatch.delattr(perf, "span")
    assert spans.of(_ctx(built, st, 3)) is None
