"""The port's build and the numpy bridge against the reference build.

The port lowers the 70-trimer reactive melt (3x3x3 cells, cap 24), and
its NPT and K2 variants, with the reference's numpy code and draws the same ``np.random.RandomState``
velocities, so every leaf must be bit-equal to the reference's build:
integers and floats alike.  The only leaf without a counterpart is the
reference's PRNG ``key`` (the port's Langevin noise comes from a
``torch.Generator``).  The bridge's round trip must be bit-exact too.
"""

import dataclasses

import numpy as np

import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine.spec import EngineConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def builds():
    rb, _, _ = rts.build_melt(n_mols=70, reactive=True, use_pallas=True)
    pb, _, _ = pts.build_melt(n_mols=70, reactive=True, device="cpu")
    return rb, pb


def _leaves(tree, path=""):
    """(path, array) for every leaf of a nested dict, None leaves as None."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + k + ".")
        else:
            yield path + k, v


def _assert_bit_equal(ref_tree, port_tree, skip=("key",)):
    ref = {p: v for p, v in _leaves(ref_tree) if p.split(".")[-1] not in skip}
    got = dict(_leaves(port_tree))
    assert sorted(ref) == sorted(got)
    for p, r in ref.items():
        g = got[p]
        if r is None or g is None:
            assert r is None and g is None, p
            continue
        assert g.dtype == r.dtype, (p, g.dtype, r.dtype)
        assert g.shape == r.shape, (p, g.shape, r.shape)
        # bit equality: compare raw bytes (also distinguishes -0.0 / NaN)
        assert g.tobytes() == r.tobytes(), p


def test_config_fields_and_values_match(builds):
    rb, pb = builds
    ref_names = {f.name for f in dataclasses.fields(rb.cfg)}
    assert ref_names == {f.name for f in dataclasses.fields(EngineConfig)}
    assert "mesh" not in bridge.config_to_dict(rb.cfg)
    assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(pb.cfg)
    assert hash(pb.cfg) == hash(dataclasses.replace(pb.cfg))


@pytest.mark.parametrize("part", ["spec", "state"])
def test_build_is_leaf_for_leaf_equal(builds, part):
    rb, pb = builds
    _assert_bit_equal(bridge.tree_to_numpy(getattr(rb, part)),
                      bridge.tree_to_numpy(getattr(pb, part)))


@pytest.mark.parametrize("source", ["reference", "port"])
def test_round_trip_is_bit_exact(builds, source):
    rb, pb = builds
    b = rb if source == "reference" else pb
    cfg_d = bridge.config_to_dict(b.cfg)
    spec_np = bridge.tree_to_numpy(b.spec)
    state_np = bridge.tree_to_numpy(b.state)
    cfg, spec, state = bridge.from_numpy(cfg_d, spec_np, state_np, "cpu")
    cfg2, spec2, state2 = bridge.to_numpy(cfg, spec, state)
    assert cfg2 == cfg_d
    _assert_bit_equal(spec_np, spec2)
    _assert_bit_equal(state_np, state2)
    # .to(device) keeps every leaf, nested tables included
    _assert_bit_equal(state_np, bridge.tree_to_numpy(state.to("cpu")))


def test_port_state_dtypes(builds):
    _, pb = builds
    st = pb.state
    assert st.pos.dtype == torch.float32 and st.type_id.dtype == torch.int32
    assert st.active.dtype == torch.bool and st.bonds.idx.dtype == torch.int32
    assert st.nbr.buckets.dtype == torch.int32
    assert st.excl_masks.dtype == torch.bool


@pytest.mark.parametrize("override, charge", [
    (dict(use_pallas=False), None),
    (dict(coulomb_cutoff=1.0),
     ("1 MA 1 MON AI 1 0.000000 1", "1 MA 1 MON AI 1 0.5 1")),
    (dict(coulomb_cutoff=0.9),
     ("  PA    1.0      0.000 ", "  PA    1.0      0.500 ")),
], ids=["row_path", "coulomb", "coulomb_charged_product"])
def test_row_path_configs_build_leaf_for_leaf(override, charge,
                                              monkeypatch):
    """``use_pallas=False``, and Coulomb where a charge can be nonzero (a
    charged atom, or a charged atomtype that only a reaction product
    takes: PA; an event sets the atom's charge to its new type's), build
    on the row path with the reference's leaves; Coulomb over zero
    charges stays on the kernel (``test_coulomb_over_zero_charges_builds``)."""
    from test_torch_ext_builds import assert_builds_equal
    if charge is not None:
        for mod in (pts, rts):
            text = mod._melt_topology_text
            assert charge[0] in text(70)
            monkeypatch.setattr(mod, "_melt_topology_text",
                                lambda n, text=text: text(n).replace(*charge))
    pb, _, _ = pts.build_melt(n_mols=70, reactive=True, device="cpu",
                              **override)
    rb, _, _ = rts.build_melt(n_mols=70, reactive=True,
                              **dict(dict(use_pallas=True), **override))
    assert not pb.cfg.use_pallas and not pb.cfg.lazy_rows
    assert pb.cfg.has_coulomb == (charge is not None)
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)


@pytest.mark.parametrize("builder", ["break", "release"])
def test_extensions_under_slabs_raise_naming_m14(builder, tmp_path):
    """(Named for the refusal it replaced.)  Dissociation and the reaction
    extensions build under ``slab_devices=2``, leaf for leaf the
    reference's ``build_system(..., slab_devices=2)``: the 160-trimer
    melts, whose 4 x-layers the 2 ranks cut."""
    from test_torch_ext_builds import assert_builds_equal, reference_build
    d = str(tmp_path)
    if builder == "break":
        pb, _, _ = pts.build_break_melt(n_mols=160, table_dir=d,
                                        device="cpu", slab_devices=2)
        text = pts.BREAK_CFG_TEXT % {"cmap": pts.RESTRICT_MAP,
                                     "diss_rate": "0.01"}
        rb = reference_build(text, 160, 0.27, 42, thermostat="vr",
                             table_dirs=(d,), slab_devices=2)
        assert pb.cfg.has_dissociation and pb.cfg.n_rb > 0
    else:
        pb, _, _ = pts.build_release_melt(n_mols=160, device="cpu",
                                          slab_devices=2)
        text = pts.RELEASE_CFG_TEXT % {"freeze_width": "0.2",
                                       "freeze_prob": "0.002"}
        rb = reference_build(text, 160, 0.27, 42, cell_cap=48,
                             slab_devices=2)
        assert pb.cfg.has_fixd and pb.cfg.has_atrp and pb.cfg.has_freeze
    assert pb.cfg.cell_dims[0] == 4
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)


@pytest.mark.parametrize("thermostat", ["vr", "br", "iso"])
def test_rescaling_thermostats_build(thermostat):
    """CSVR, Berendsen and isokinetic build, with the reference's
    ``iso_coupling`` rule (``max(int(thermostat_gamma), 1)`` for 'iso')."""
    kw = dict(n_mols=70, reactive=True, thermostat=thermostat,
              thermostat_gamma=3.7)
    pb, _, _ = pts.build_melt(device="cpu", **kw)
    assert pb.cfg.thermostat == thermostat
    assert pb.cfg.iso_coupling == (3 if thermostat == "iso" else 1)
    if thermostat == "iso":
        rb, _, _ = rts.build_melt(use_pallas=True, **kw)
        assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(pb.cfg)


def test_coulomb_over_zero_charges_builds(builds):
    """The melt's charges are all zero: a Coulomb cutoff below the LJ
    cutoff changes no leaf of the build but the cutoff itself."""
    _, pb = builds
    cb, _, _ = pts.build_melt(n_mols=70, reactive=True, device="cpu",
                              coulomb_cutoff=0.9)
    assert cb.cfg == pb.cfg
    _, spec_p, state_p = bridge.to_numpy(pb.cfg, pb.spec, pb.state)
    _, spec_c, state_c = bridge.to_numpy(cb.cfg, cb.spec, cb.state)
    assert spec_p.pop("qq_cutoff2") == 0.0
    assert spec_c.pop("qq_cutoff2") == np.float32(0.81)
    _assert_bit_equal(spec_p, spec_c)
    _assert_bit_equal(state_p, state_c)


# NPT and K2 builds: a Berendsen build (margin 1.10 on both grids: the
# 70-trimer box takes 2x2x2 cells), a pressure-observable build, a cap that
# is not a multiple of 8, and the reference NPT test's 2x2x2 melt
NPT_BUILDS = {
    "br": dict(n_mols=70, reactive=True, barostat="br", pressure=0.15,
               barostat_tau=2.0),
    "store_pressure": dict(n_mols=70, reactive=True, store_pressure=True),
    "cap36": dict(n_mols=70, reactive=True, cell_cap=36),
    "grid222": dict(n_mols=40, density=0.3, reactive=False, seed=3),
}


def _sorted_rows(idx, mask):
    """Each row's (neighbour, excluded) pairs in a fixed order."""
    return [sorted(zip(i.tolist(), m.tolist())) for i, m in zip(idx, mask)]


@pytest.mark.parametrize("name", sorted(NPT_BUILDS))
def test_npt_and_k2_builds_are_leaf_for_leaf_equal(name):
    """Bit equality, with one exception: the build-time K-nearest rows
    (``nbr.idx`` and its ``nbr.excl_mask``) are compared row by row as
    sets.  A trimer's two ends sit at exactly the bond length from its
    centre, and the reference's XLA CPU build contracts ``d2 += d * d`` into
    a fused multiply-add, so such a tie can come out 1 ulp apart there and
    the two ends in the other order; the lazy-row force path never reads
    these rows (it reads the buckets, which are compared bit for bit)."""
    kw = NPT_BUILDS[name]
    rb, _, _ = rts.build_melt(use_pallas=True, **kw)
    pb, _, _ = pts.build_melt(device="cpu", **kw)
    assert bridge.config_to_dict(rb.cfg) == bridge.config_to_dict(pb.cfg)
    _assert_bit_equal(bridge.tree_to_numpy(rb.spec),
                      bridge.tree_to_numpy(pb.spec))
    ref, got = (bridge.tree_to_numpy(b.state) for b in (rb, pb))
    rows = []
    for tree in (ref, got):
        nbr = dict(tree["nbr"])
        rows.append(_sorted_rows(nbr.pop("idx"), nbr.pop("excl_mask")))
        tree["nbr"] = nbr
    _assert_bit_equal(ref, got)
    assert rows[0] == rows[1]
    cfg = pb.cfg
    assert cfg.barostat == ("br" if name == "br" else "no")
    assert cfg.store_pressure == (name == "store_pressure")
    legal = cfg.cell_cap % 8 == 0 and min(cfg.cell_dims) >= 3
    assert legal == (name == "store_pressure"), (cfg.cell_dims, cfg.cell_cap)
    # the bridge carries the barostat and its piston velocity across
    cfg2, _, state2 = bridge.from_trees(rb.cfg, rb.spec, rb.state, "cpu")
    assert cfg2.barostat == rb.cfg.barostat
    assert state2.baro_v.dtype == torch.float32 and state2.baro_v.shape == ()


@pytest.mark.parametrize("override", [
    dict(n_mols=40, density=0.3, seed=3),
    dict(n_mols=70, cell_cap=36),
], ids=["grid222", "cap36"])
def test_tabulated_melt_on_a_k2_grid_builds_on_the_row_path(override,
                                                           tmp_path):
    """The Chebyshev modes exist only in colt2 (K1); on another grid a
    tabulated system takes the row path, with the reference's leaves."""
    from test_torch_ext_builds import assert_builds_equal
    pts.write_lj_pair_tables(str(tmp_path))
    kw = dict(reactive=False, table_dir=str(tmp_path), **override)
    pb, _, _ = pts.build_tabulated_melt(device="cpu", **kw)
    rb, _, _ = rts.build_tabulated_melt(use_pallas=True, **kw)
    assert not pb.cfg.use_pallas and not pb.cfg.lazy_rows
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)
