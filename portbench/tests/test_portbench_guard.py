"""``run.py`` refuses to run without a card and with JAX loaded, and the
reference imports nothing of the program it judges."""

import subprocess
import sys
import types

import pytest

from conftest import ROOT
from portbench import harness


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "chemlab_tpu_torch_extra", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "chemlab_tpu.engine", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("x"))
    assert harness.banned_modules() == ["chemlab_tpu", "jax"]


def test_run_exits_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "atrp-lj-400k-nvt", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 2 and r.stdout == ""
    assert "CUDA" in r.stderr


def test_run_exits_when_jax_is_loaded(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    def fake_run(*a, guard=None, **k):
        guard("set-up")
        sys.modules["jax"] = types.ModuleType("jax")
        guard("window")
        return {"correct": True}, {}

    monkeypatch.setattr("torch.set_num_threads", lambda n: None)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", fake_run)
    try:
        assert run.main(["--workload", "atrp-lj-400k-nvt", "--seed", "1",
                         "--seconds", "1"]) == 3
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import portbench.check, portbench.roofline, "
            "portbench.reference.barostat, portbench.reference.forces, "
            "portbench.reference.reactions, portbench.reference.system; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'chemlab_tpu_torch', 'chemlab_tpu', 'jax'}); print(bad)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stderr
