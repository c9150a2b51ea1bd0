"""Every file of the benchmark parses, and every configuration and cell
builds at a tiny size on the CPU."""

import json
import re

import pytest

from conftest import ROOT
from portbench import check, harness
from portbench.reference import system as ref_system

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in names
            names.add(entry["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / (m["name"] + ".py")).is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_agree_with_benchmark_json(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    c, conf, traffic = harness.load_cell(ROOT, cell)
    assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert conf["name"] == entry["config"]
    # a limit for each number compared: the five, and under a barostat
    # pressure_gap and box_gap
    sys_ = ref_system.load_system(conf["system"])
    assert set(c["limits"]) == set(check.names(sys_))
    assert traffic["block_steps"] == traffic["reaction_interval"]
    # room for every event a reaction step can fire: each living end
    # (one per initiator) takes part in at most one
    n = 3 * conf["args"]["n_mols"]
    assert conf["args"]["max_events"] >= n // traffic["particles_per_initiator"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_builds_tiny_on_cpu(config, tmp_path):
    from chemlab_tpu_torch import testsystems

    conf = harness.load_json(ROOT, "configs", config)
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert sorted(entry["reduced"]) == sorted(conf["reduced"])
    sys_ = ref_system.load_system(conf["system"])
    kw = dict(conf["args"], n_mols=20, device="cpu")
    if sys_.pair["kind"] == "table":
        ref_system.write_tables(str(tmp_path), sys_.types,
                                sys_.pair["table"])
        kw["table_dir"] = str(tmp_path)
    built, systop, _ = getattr(testsystems, conf["builder"])(**kw)
    assert built.cfg.n_particles == 60
    assert dict(systop.atomsym_atomtype) == {
        t: k for k, t in enumerate(sys_.types)}
