"""A cell, a traffic mix and a per-layer metric added as files only are
found by name, and a run of the added cell reports what its files say."""

import json
import shutil

from conftest import ROOT, TINY
from portbench import harness


def _copy_with_extras(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "dummy-cell", "config": "atrp-lj-400k",
        "traffic": "dummy-traffic", "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({
        "name": "dummy.metric", "unit": "n", "better": "lower",
        "source": "program_counter", "layer": "device",
        "moves": "particle_steps_per_s", "workloads": ["dummy-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = json.loads((ROOT / "portbench" / "workloads"
                       / "atrp-lj-400k-nvt.json").read_text())
    cell.update(traffic="dummy-traffic", why="a test's cell")
    (root / "portbench" / "workloads" / "dummy-cell.json").write_text(
        json.dumps(cell))
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "nvt-rx200.json").read_text())
    traffic["untimed_blocks"] = 2
    (root / "portbench" / "traffic" / "dummy-traffic.json").write_text(
        json.dumps(traffic))
    (root / "portbench" / "metrics" / "dummy.metric.py").write_text(
        "def read(ctx):\n    return 7.0 if ctx.cfg is not None else None\n")
    return root, bench


def test_added_files_are_found_by_name(tmp_path):
    root, bench = _copy_with_extras(tmp_path)
    cell, conf, traffic = harness.load_cell(root, "dummy-cell")
    assert conf["name"] == "atrp-lj-400k" and traffic["untimed_blocks"] == 2
    e2e, per_layer = harness.cell_metrics(bench, "dummy-cell")
    assert [m["name"] for m in per_layer] == ["dummy.metric"]
    assert {m["name"] for m in e2e} == {"particle_steps_per_s", "setup_s"}
    _, others = harness.cell_metrics(bench, "atrp-lj-400k-nvt")
    assert "dummy.metric" not in {m["name"] for m in others}
    metric = harness.load_metric(root, "dummy.metric")

    class Ctx:
        cfg = object()
    assert metric.read(Ctx()) == 7.0
    assert harness.read_per_layer(root, per_layer, Ctx()) == {
        "dummy.metric": {"value": 7.0, "unit": "n"}}


def test_added_cell_runs(tmp_path):
    root, _ = _copy_with_extras(tmp_path)
    result, checks = harness.run(root, "dummy-cell", 5, 0.0, False,
                                 device="cpu", overrides=TINY)
    assert result["correct"] and result["attempted"] == 1
    assert set(result["metrics"]) == {"particle_steps_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"
