"""The comparison that decides ``correct`` fails when it should.

The control: the reference in bfloat16 (the precision below the
configuration's float32) put in the program's place.  The faults: the
timed path broken underneath a whole run, with the chip's look skipped.
Each must come out not correct at the cells' limits; a sound run of the
same size must come out correct."""

import dataclasses
import sys

import pytest
import torch

from conftest import ROOT, TINY
from portbench import harness


def _run(seed, **kw):
    result, checks = harness.run(ROOT, "atrp-lj-400k-nvt", seed, 0.0, False,
                                 device="cpu", overrides=TINY, **kw)
    return result["correct"], {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("seed", [21, 2**31 + 7])
def test_control_fails_and_the_program_passes(seed):
    sys.path.insert(0, str(ROOT / "portbench"))
    import control

    cell = "atrp-lj-400k-nvt"
    limits = harness.load_cell(ROOT, cell)[0]["limits"]
    r = control.readings(cell, seed, 0.0, "cpu", TINY)
    assert r["program_correct"] and not r["control_correct"]
    assert r["control"]["force_gap"] > limits["force_gap"]


def _frozen_step(orig):
    def md_step(spec, cfg, state, *a, **k):
        return dataclasses.replace(state, step=state.step + 1)
    return md_step


def _half_forces(orig):
    def compute_forces(spec, cfg, state, *a, **k):
        force, e, obs = orig(spec, cfg, state, *a, **k)
        keep = torch.arange(force.shape[0]) < force.shape[0] // 2
        return torch.where(keep[:, None], force, 0.0), e, obs
    return compute_forces


def _altered_events(orig):
    def apply_reaction_events(spec, cfg, state, *a, **k):
        state, ovf = orig(spec, cfg, state, *a, **k)
        chem = state.chem_state.clone()
        chem[0] += 1
        return dataclasses.replace(state, chem_state=chem), ovf
    return apply_reaction_events


@pytest.mark.parametrize("module,name,fault,caught_by", [
    ("integrate", "md_step", _frozen_step, "drift_gap"),
    ("integrate", "compute_forces", _half_forces, "force_gap"),
    ("reactions", "apply_reaction_events", _altered_events,
     "reaction_mismatch"),
])
def test_fault_is_not_correct(monkeypatch, module, name, fault, caught_by):
    import importlib

    mod = importlib.import_module("chemlab_tpu_torch.engine." + module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    ok, numbers = _run(31)
    assert not ok
    cell, _, _ = harness.load_cell(ROOT, "atrp-lj-400k-nvt")
    assert numbers[caught_by] > cell["limits"][caught_by]
