"""The port's build and the numpy bridge against the reference build.

The port lowers the 70-trimer reactive melt (3x3x3 cells, cap 24) with the
reference's numpy code and draws the same ``np.random.RandomState``
velocities, so every leaf must be bit-equal to the reference's build:
integers and floats alike.  The only leaf without a counterpart is the
reference's PRNG ``key`` (the port's Langevin noise comes from a
``torch.Generator``).  The bridge's round trip must be bit-exact too.
"""

import dataclasses

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
    ref_names = {f.name for f in dataclasses.fields(rb.cfg)} - {"mesh"}
    assert ref_names == {f.name for f in dataclasses.fields(EngineConfig)}
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


@pytest.mark.parametrize("override", [
    dict(thermostat="vr"),
    dict(use_pallas=False),
    dict(coulomb_cutoff=1.0),
    dict(barostat="br", pressure=1.0),
    dict(store_pressure=True),
], ids=["csvr", "row_path", "coulomb", "barostat", "pressure"])
def test_out_of_slice_configs_raise(override):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pts.build_melt(n_mols=70, reactive=True, device="cpu", **override)


def test_non_colt_grid_raises():
    """A grid below 3 cells per axis needs K2, which is not ported yet."""
    with pytest.raises(NotImplementedError, match="K2"):
        pts.build_melt(n_mols=30, reactive=True, device="cpu")
