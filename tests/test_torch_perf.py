"""Per-phase timing breakdown (``engine/perf.py``), mirroring
``test_perf.py``: the port's ``phase_timers`` gives the reference's six
phases, each a positive time (the reaction step 0.0 without reactions),
and ``format_timers`` prints the reference's table for the same dict."""

import pytest
import torch

from chemlab_tpu.engine import perf as rperf
from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import perf, runner

PHASES = ("neighbor_rebuild", "pair_forces", "bonded_forces",
          "integrate_step", "reaction_step", "observables")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_phase_timers_reactive():
    built, _, _ = testsystems.build_melt(n_mols=60, reactive=True,
                                         device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    timers = perf.phase_timers(built.spec, built.cfg, st, repeats=1)
    assert set(timers) == set(PHASES)
    for k in PHASES:
        assert timers[k] > 0.0, k
    report = perf.format_timers(timers)
    assert report == rperf.format_timers(timers)
    for k in PHASES:
        assert k in report


def test_phase_timers_nonreactive():
    built, _, _ = testsystems.build_melt(n_mols=40, reactive=False,
                                         device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    timers = perf.phase_timers(built.spec, built.cfg, st, repeats=1)
    assert timers["reaction_step"] == 0.0
    assert timers["pair_forces"] > 0.0
