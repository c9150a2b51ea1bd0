"""The check under a barostat: the reference's virial pressure and box
step against the port's, and a tiny NPT cell, added as files only, that
runs through ``harness.run``, comes out correct with ``pressure_gap`` and
``box_gap``, and fails for the bfloat16 control and for each fault of the
barostat's step."""

import dataclasses
import json
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from portbench import check, harness
from portbench.reference import barostat as ref_baro
from portbench.reference import system as ref_system

# the repository's NPT settings (P0 0.15, tau 2.0; the piston's defaults)
# as the program's build arguments and the configuration's block
BAROSTATS = {
    "br": ({"barostat": "br", "pressure": 0.15, "barostat_tau": 2.0},
           {"form": "br", "pressure": 0.15, "tau": 2.0}),
    "lv": ({"barostat": "lv", "pressure": 0.15, "barostat_mass": 50.0,
            "barostat_gammaP": 1.0},
           {"form": "lv", "pressure": 0.15, "mass": 50.0, "gammaP": 1.0}),
}
# at the 70-trimer melt the program reads pressure_gap under 2e-6 and
# box_gap under 1e-7, the bfloat16 control over 4e-3 and 1e-4
LIMITS = {"pressure_gap": 1e-4, "box_gap": 1e-6}


def _npt_checkout(tmp_path, form):
    """A checkout with the cell ``tiny-npt-<form>`` added as files only:
    the 400k melt's configuration under the barostat ``form``, its
    traffic and the cell with its limits."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    name = "tiny-npt-" + form
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": name, "source": "a test's configuration",
        "file": "portbench/configs/%s.json" % name, "reduced": ["n_mols"],
        "why": "a test's configuration"})
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": "npt-rx200", "chips": 1,
                               "why": "a test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    args, block = BAROSTATS[form]
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "atrp-lj-400k.json").read_text())
    conf["name"] = name
    conf["args"].update(args)
    conf["system"]["barostat"] = block
    (root / "portbench" / "configs" / (name + ".json")).write_text(
        json.dumps(conf))
    traffic = json.loads((ROOT / "portbench" / "traffic"
                          / "nvt-rx200.json").read_text())
    traffic["ensemble"] = "Langevin, and the configuration's barostat"
    (root / "portbench" / "traffic" / "npt-rx200.json").write_text(
        json.dumps(traffic))
    cell = json.loads((ROOT / "portbench" / "workloads"
                       / "atrp-lj-400k-nvt.json").read_text())
    cell.update(config=name, traffic="npt-rx200", why="a test's cell")
    cell["limits"].update(LIMITS)
    (root / "portbench" / "workloads" / (name + ".json")).write_text(
        json.dumps(cell))
    return root, name, cell["limits"]


def _melt(barostat=None):
    """The 70-trimer melt of the 400k configuration, warmed, and its
    reference description; ``barostat`` (the build's arguments, the
    configuration's block) puts both under a barostat."""
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import runner

    conf = json.loads((ROOT / "portbench" / "configs"
                       / "atrp-lj-400k.json").read_text())
    kw = {}
    if barostat is not None:
        kw, conf["system"]["barostat"] = barostat
    sys_ = ref_system.load_system(conf["system"])
    built, systop, _ = testsystems.build_melt(**dict(
        conf["args"], n_mols=70, device="cpu", **kw))
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return sys_, built, systop, testsystems.warmup(built, st, steps=60)


def _topology(st):
    snap = check.snapshot_topology(st)["topo"]
    return snap.type_id, snap.bonds, snap.angles, snap.excl


def test_pressure_matches_the_port_after_a_reactive_block():
    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import bonded_forces, integrate, runner

    sys_, built, systop, st = _melt()
    st = testsystems.activate_initiators(built, systop, st, n=10, seed=3)
    st = runner.run_block(built.spec, built.cfg, st, 200, rng_seed=7,
                          gen=runner.make_generator(5, "cpu"))
    assert int(st.reaction_counts.sum()) > 0
    n = check.active_count(st)
    tid, bonds, _, excl = _topology(st)
    mass = torch.full((n,), sys_.mass, dtype=torch.float64)
    ref = ref_baro.pressure(sys_, st.pos[:n], st.vel[:n], mass, st.box,
                            torch.as_tensor(tid), bonds, excl, torch.float64)
    scale = (2 * ref["ekin"] + ref["w_pair"].abs()
             + ref["w_bonded"].abs()) / (3 * ref["vol"])
    p_port = integrate.virial_pressure(built.spec, built.cfg, st)
    assert float(abs(p_port.double() - ref["p"]) / scale) < 1e-5
    w_port = -bonded_forces.bonded_strain_derivative(
        built.spec, built.cfg, st.pos, st.box, st.type_id, st.q, st.bonds,
        st.angles, st.dihedrals, st.pairs14, dense=integrate._dense_of(
            built.cfg, st))
    assert float(abs(w_port.double() - ref["w_bonded"])) < 1e-4 * float(
        ref["w_bonded"].abs())
    # a bond of length 0 (both ends on one bfloat16 position, as in the
    # control at 100k) adds 0, not NaN
    pos = torch.tensor([[70.0, 1.0, 1.0], [70.0, 1.0, 1.0], [70.0, 2.0, 1.0]])
    w = ref_baro.bonded_virial(pos, torch.full((3,), 72.0), [[0, 1], [1, 2]],
                               30.0, 0.97, torch.bfloat16)
    # (r0 0.97 is 0.96875 in bfloat16)
    assert torch.isfinite(w) and float(w) == pytest.approx(-2 * 30.0 * 0.03,
                                                           rel=0.05)


def _unclipped_barostat(spec, cfg, state, noise=None, pair_kernel="auto"):
    """The Berendsen step without its 0.98-1.02 clip of mu (a fault)."""
    from chemlab_tpu_torch.engine import integrate

    p_now = integrate.virial_pressure(spec, cfg, state, pair_kernel)
    base = torch.clamp(1.0 - spec.dt / spec.barostat_tau
                       * (spec.pressure - p_now), 0.9, 1.1)
    mu = base ** (1.0 / 3.0)
    pos = torch.where(state.active[:, None], state.pos * mu, state.pos)
    return dataclasses.replace(state, pos=pos, box=state.box * mu)


# (barostat, whether mu meets the clip); at P0 3.0 and tau 0.05 the
# melt's pressure (about -0.05) asks for mu 0.9655
STEPS = {
    "br": (BAROSTATS["br"], False),
    "lv": (BAROSTATS["lv"], False),
    "br-clipped": (({"barostat": "br", "pressure": 3.0,
                     "barostat_tau": 0.05},
                    {"form": "br", "pressure": 3.0, "tau": 0.05}), True),
}


@pytest.mark.parametrize("case,unclipped", [
    ("br", False), ("lv", False), ("br-clipped", False),
    ("br-clipped", True)])
def test_box_step_matches_the_port(monkeypatch, case, unclipped):
    from chemlab_tpu_torch.engine import integrate

    barostat, clipped = STEPS[case]
    sys_, built, _, st = _melt(barostat)
    if unclipped:
        monkeypatch.setattr(integrate, "_barostat_step", _unclipped_barostat)
    st = dataclasses.replace(st, baro_v=torch.tensor(0.3))
    xi = torch.tensor(-0.7)
    s1 = integrate._barostat_step(built.spec, built.cfg, st, xi)
    n = check.active_count(st)
    x1, mu = check.unscale(check._np(s1.pos)[:n], check._np(st.box),
                           check._np(s1.box))
    # the positions the barostat read come back within an ulp (exactly,
    # where the coordinates single mu out: test_unscale_...)
    ulps = np.abs(x1.view(np.int32) - check._np(st.pos)[:n].view(np.int32))
    assert ulps.max() <= 1
    assert (float(mu) == np.float32(0.98)) == (clipped and not unclipped)
    p1 = float(integrate.virial_pressure(built.spec, built.cfg, st))
    mass = np.full(n, sys_.mass)
    tid, bonds, _, excl = _topology(st)
    pg, bg, mu_ref = check.barostat_gaps(
        sys_, x1, check._np(st.vel)[:n], mass, check._np(st.box),
        check._np(s1.box), p1, 0.3, float(xi), tid, bonds, excl, None, "cpu")
    assert pg < 1e-5
    if unclipped:
        assert bg > 1e3 * LIMITS["box_gap"] and mu_ref == pytest.approx(0.98)
    else:
        assert bg < 0.1 * LIMITS["box_gap"]
    # the reference's own step puts the positions where the program does
    x_ref, _ = ref_baro.barostat_step(
        sys_.barostat, torch.as_tensor(x1, dtype=torch.float64),
        torch.as_tensor(check._np(st.box), dtype=torch.float64),
        torch.tensor(p1, dtype=torch.float64), float(torch.prod(
            st.box.double())), 0.3, float(xi), sys_.dt, sys_.kT)
    gap = float((x_ref - s1.pos[:n].double()).abs().max())
    assert (gap > 1e-3) == unclipped


def test_unscale_recovers_every_coordinate():
    # the 100k cell's box: a 1-ulp step of mu moves its far coordinates
    # across a rounding, so the coordinates single out mu where the box
    # alone leaves two values
    g = torch.Generator().manual_seed(1)
    box = np.full(3, 71.84, dtype=np.float32)
    x = (torch.rand((100_000, 3), generator=g) * 71.84).numpy()
    for mu in (np.float32(0.99996), np.float32(1.00004), np.float32(0.98),
               np.float32(1.02)):
        got, got_mu = check.unscale(x * mu, box, box * mu)
        assert got_mu == mu
        # a product with two float32 sources (about a share |1 - mu| of
        # them, more at the powers of two) may come back as the other, an
        # ulp away
        ulps = np.abs(got.view(np.int32) - x.view(np.int32))
        assert ulps.max() <= 1
        assert np.mean(ulps == 0) >= 1.0 - 2.0 * abs(1.0 - float(mu))


def test_a_configuration_without_a_barostat_compares_the_five():
    conf = json.loads((ROOT / "portbench" / "configs"
                       / "atrp-lj-400k.json").read_text())
    sys_ = ref_system.load_system(conf["system"])
    assert sys_.barostat is None and check.names(sys_) == check.NAMES
    _, checks = harness.run(ROOT, "atrp-lj-400k-nvt", 41, 0.0, False,
                            device="cpu", overrides=TINY)
    assert list(checks) == list(check.NAMES)


@pytest.mark.parametrize("form", ["br", "lv"])
def test_barostat_settings_must_be_the_configurations(form):
    args, block = BAROSTATS[form]
    sys_ = types.SimpleNamespace(barostat=ref_system.load_barostat(block))
    spec = types.SimpleNamespace(pressure=torch.tensor(0.15),
                                 barostat_tau=torch.tensor(2.0),
                                 barostat_mass=torch.tensor(50.0),
                                 barostat_gammaP=torch.tensor(1.0))
    harness.check_barostat(sys_, types.SimpleNamespace(barostat=form), spec)
    with pytest.raises(RuntimeError, match="barostat"):
        harness.check_barostat(sys_, types.SimpleNamespace(barostat="no"),
                               spec)
    key = "barostat_tau" if form == "br" else "barostat_mass"
    wrong = types.SimpleNamespace(**dict(vars(spec),
                                         **{key: torch.tensor(3.0)}))
    with pytest.raises(RuntimeError, match="barostat"):
        harness.check_barostat(sys_, types.SimpleNamespace(barostat=form),
                               wrong)
    with pytest.raises(RuntimeError, match="barostat"):
        harness.check_barostat(types.SimpleNamespace(barostat=None),
                               types.SimpleNamespace(barostat=form), spec)


@pytest.mark.parametrize("form", ["br", "lv"])
def test_npt_cell_added_as_files_runs_correct(tmp_path, form):
    root, name, _ = _npt_checkout(tmp_path, form)
    result, checks = harness.run(root, name, 5, 0.0, False, device="cpu",
                                 overrides=TINY)
    assert result["correct"], checks
    assert list(checks) == list(check.NAMES + check.BAROSTAT_NAMES)
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"particle_steps_per_s", "setup_s"}


@pytest.mark.parametrize("seed", [23, 2**31 + 11])
def test_npt_control_fails_and_the_program_passes(tmp_path, monkeypatch,
                                                  seed):
    sys.path.insert(0, str(ROOT / "portbench"))
    import control

    root, name, limits = _npt_checkout(tmp_path, "br")
    monkeypatch.setattr(control, "ROOT", root)
    r = control.readings(name, seed, 0.0, "cpu", TINY)
    assert r["program_correct"] and not r["control_correct"]
    mine, ctl = r["program"], r["control"]
    assert ctl["pressure_gap"] > max(10 * mine["pressure_gap"],
                                     limits["pressure_gap"])
    assert ctl["box_gap"] > max(10 * mine["box_gap"], limits["box_gap"])


def _no_bonded_virial(orig):
    def bonded_strain_derivative(spec, cfg, pos, *a, **k):
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    return bonded_strain_derivative


def _scaled_velocities(orig):
    def barostat_step(spec, cfg, state, *a, **k):
        out = orig(spec, cfg, state, *a, **k)
        mu = out.box[0] / state.box[0]
        return dataclasses.replace(out, vel=out.vel * mu)
    return barostat_step


def _no_cube_root(orig):
    def barostat_step(spec, cfg, state, *a, **k):
        out = orig(spec, cfg, state, *a, **k)
        mu2 = (out.box[0] / state.box[0]) ** 2
        pos = torch.where(state.active[:, None], out.pos * mu2, out.pos)
        return dataclasses.replace(out, pos=pos, box=out.box * mu2)
    return barostat_step


# the barostat leaves the velocities after their last kick, so scaled
# ones show in the step's velocities alone: vel_gap reads |mu - 1|
@pytest.mark.parametrize("module,name,fault,caught_by", [
    ("bonded_forces", "bonded_strain_derivative", _no_bonded_virial,
     "pressure_gap"),
    ("integrate", "_barostat_step", _scaled_velocities, "vel_gap"),
    ("integrate", "_barostat_step", _no_cube_root, "box_gap"),
])
def test_npt_fault_is_not_correct(tmp_path, monkeypatch, module, name, fault,
                                  caught_by):
    import importlib

    root, cell, limits = _npt_checkout(tmp_path, "br")
    mod = importlib.import_module("chemlab_tpu_torch.engine." + module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    result, checks = harness.run(root, cell, 31, 0.0, False, device="cpu",
                                 overrides=TINY)
    assert not result["correct"]
    assert checks[caught_by]["value"] > limits[caught_by]
