"""The extension melts' builds against the reference's, leaf for leaf.

Both packages build the same text, coordinates and connectivity map: the
break melt (``testsystems.build_break_melt`` at 40 trimers, density 0.4:
dissociation, RemoveNeighboursBonds, the restrict whitelist, CSVR), the
release melt (``build_release_melt`` at 80 trimers, density 0.3:
ReleaseMolecule dummies, JoinMolecule, ATRPActivator, ChangeParticleType,
FreezeRegion) and ``test_multi_release_join.py``'s TWO_RELEASE_CFG at 80
trimers (two FixDistances definitions, dummies of two types).  Config,
spec and state must be equal leaf for leaf (the K-nearest build rows as
per-row sets, as in ``test_torch_bridge.py``), dummies, ``fd_*``, restrict
rows and ATRP leaves included.  The three reference builds share this
module, so that its compiled programs serve all three.
"""

import pytest

from chemlab_tpu import reaction_parser as rrp
from chemlab_tpu import topfile as rtopfile
from chemlab_tpu.engine import build as rbuild
from chemlab_tpu.topology import compile_system_topology
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from test_multi_release_join import TWO_RELEASE_CFG
from test_torch_bridge import _assert_bit_equal, _sorted_rows

PARTS = ["config", "spec", "state"]
FREEZE = dict(freeze_width=1.5, freeze_prob=0.5)


def reference_build(text, n_mols, density, seed, **opts):
    """The reference's build of the trimer melt under ``text``, with the
    options of ``testsystems.melt_options`` and its pallas path."""
    systop = compile_system_topology(rtopfile.parse_lines(
        pts._melt_topology_text(n_mols).splitlines(), "<generated>"))
    return rbuild.build_system(
        systop, pts.melt_coordinates(n_mols, density, seed=seed),
        rbuild.SimOptions(**pts.melt_options(seed=seed, use_pallas=True,
                                             **opts)),
        reaction_config=rrp.parse_config_lines(text.splitlines()))


def assert_builds_equal(rb, pb, part):
    """Config, spec or state of two builds, leaf for leaf (the build-time
    K-nearest rows as per-row sets)."""
    if part == "config":
        assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(pb.cfg)
        return
    ref = bridge.tree_to_numpy(getattr(rb, part))
    got = bridge.tree_to_numpy(getattr(pb, part))
    if part == "state":
        rows = []
        for tree in (ref, got):
            nbr = dict(tree["nbr"])
            rows.append(_sorted_rows(nbr.pop("idx"), nbr.pop("excl_mask")))
            tree["nbr"] = nbr
        assert rows[0] == rows[1]
    _assert_bit_equal(ref, got)




@pytest.fixture(scope="module")
def break_builds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("break"))
    pb, _, _ = pts.build_break_melt(n_mols=40, density=0.4, seed=5,
                                    table_dir=d, diss_rate=2.0,
                                    device="cpu", max_events=16)
    text = pts.BREAK_CFG_TEXT % {"cmap": pts.RESTRICT_MAP, "diss_rate": "2.0"}
    rb = reference_build(text, 40, 0.4, 5, thermostat="vr", max_events=16,
                         table_dirs=(d,))
    return rb, pb


@pytest.mark.parametrize("part", PARTS)
def test_break_build_is_leaf_for_leaf_equal(break_builds, part):
    rb, pb = break_builds
    cfg = pb.cfg
    assert cfg.has_dissociation and cfg.has_dyn_resolution
    assert cfg.n_rb == 1 and cfg.thermostat == "vr" and cfg.rx_compact
    assert pb.spec.restrict_lo.shape[0] > 0 and cfg.restrict_scan > 1
    assert bool(pb.spec.r_restricted.any())
    assert_builds_equal(rb, pb, part)


@pytest.fixture(scope="module")
def release_builds():
    pb, _, _ = pts.build_release_melt(n_mols=80, density=0.3, seed=3,
                                      device="cpu", max_events=16, **FREEZE)
    text = pts.RELEASE_CFG_TEXT % {k: repr(v) for k, v in FREEZE.items()}
    rb = reference_build(text, 80, 0.3, 3, max_events=16, cell_cap=48)
    return rb, pb


@pytest.mark.parametrize("part", PARTS)
def test_release_build_is_leaf_for_leaf_equal(release_builds, part):
    rb, pb = release_builds
    cfg = pb.cfg
    assert cfg.has_atrp and cfg.has_cpt and cfg.has_freeze and cfg.has_fixd
    assert cfg.n_fd == 2 and cfg.n_particles == 3 * 80 + 2 * 80
    assert cfg.has_dyn_resolution and not cfg.atrp_select_from_all
    assert_builds_equal(rb, pb, part)


@pytest.fixture(scope="module")
def two_release():
    pb, _, _ = pts._build_trimer_melt(TWO_RELEASE_CFG, 80, 0.3, 1.0, 3,
                                      "cpu", dict(max_events=16))
    rb = reference_build(TWO_RELEASE_CFG, 80, 0.3, 3, max_events=16)
    return rb, pb


@pytest.mark.parametrize("part", PARTS)
def test_two_release_build_is_leaf_for_leaf_equal(two_release, part):
    rb, pb = two_release
    assert pb.cfg.n_fd == 2 and pb.cfg.n_particles == 240 + 80 + 160
    assert_builds_equal(rb, pb, part)
