"""The row path's builds and persistent rows against the reference.

``neighbor.build_neighbor_state`` with func-14 births (``track_birth``,
``prev``, ``step``) on the row melt (``testsystems.build_row_melt`` at 70
trimers): the rows as per-row sets, each (i, j) pair's birth step and
exclusion flag equal to the reference's.  Then the builds that only the
row path takes, config, spec and state leaf for leaf against the
reference's with its ``use_pallas`` (the K-nearest rows as per-row sets):
the row melt (funcs 8, 13-17 and Coulomb between charges), funcs 9 and
11 beside the func 10/12 blends, tabulated systems with more than 8
distinct fits under a blend, and the neighbour scratch rebuilt at grown
caps (every birth restarts at the current step); last, two of the
reference's choices the port keeps (the rows' radius at a rebuild), and
the row path's refusal under slabs.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu import reaction_parser as rrp
from chemlab_tpu import testsystems as rts
from chemlab_tpu import topfile as rtopfile
from chemlab_tpu.engine import build as rbuild
from chemlab_tpu.engine import neighbor as rnb
from chemlab_tpu.topology import compile_system_topology as r_compile
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build as pbuild
from chemlab_tpu_torch.engine import neighbor
from test_torch_bonded_tab import reference_trees
from test_torch_ext_builds import assert_builds_equal
from test_torch_pair_rows import FAMILIES, build_both, family_text

N_ROW = 70


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_row_melt(n_mols, table_dir, **opts):
    """The reference's build of ``testsystems.build_row_melt``'s text,
    coordinates and options."""
    x_switch = pts.row_switch(n_mols)
    systop = r_compile(rtopfile.parse_lines(
        pts.row_topology_text(n_mols, x_switch).splitlines(), "<row>"))
    kw = pts.melt_options(coulomb_cutoff=2.5, table_dirs=(table_dir,),
                          use_pallas=True, **opts)
    return rbuild.build_system(
        systop, pts.melt_coordinates(n_mols, 0.27, seed=42),
        rbuild.SimOptions(**kw),
        reaction_config=rrp.parse_config_lines(
            pts.ATRP_CFG_TEXT.splitlines()))


@pytest.fixture(scope="module")
def row_builds(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rowmelt"))
    pts.write_row_tables(d)
    pb, _, _ = pts.build_row_melt(n_mols=N_ROW, device="cpu", table_dir=d)
    return reference_row_melt(N_ROW, d), pb


def _pairs(idx, vals, n_act):
    """{(i, j): value} over the real slots of active rows."""
    out = {}
    for i in range(n_act):
        for k, j in enumerate(idx[i].tolist()):
            if j != i:
                out[(i, j)] = vals[i][k] if vals is not None else True
    return out


@pytest.mark.parametrize("part", ["config", "spec", "state"])
def test_row_melt_build_is_leaf_for_leaf_equal(row_builds, part):
    rb, pb = row_builds
    cfg = pb.cfg
    assert not cfg.use_pallas and not cfg.lazy_rows
    assert cfg.has_coulomb and cfg.has_caps and cfg.has_pps
    assert cfg.has_lambda_pairs and cfg.has_lj and cfg.has_tabulated
    assert cfg.n_mix_entries == 4 and cfg.rx_compact
    assert pb.state.nbr.birth.shape == pb.state.nbr.idx.shape
    assert_builds_equal(rb, pb, part)


def test_births_across_a_rebuild_match_reference(row_builds):
    """Rows rebuilt at jittered positions from rows with random births:
    a kept pair keeps its earliest birth, a new one starts at ``step``."""
    _, pb = row_builds
    cfg, spec, st = pb.cfg, pb.spec, pb.state
    rng = np.random.RandomState(4)
    prev = dataclasses.replace(st.nbr, birth=torch.from_numpy(
        rng.randint(0, 50, st.nbr.idx.shape).astype(np.int32)))
    jitter = rng.normal(scale=0.3, size=st.pos.shape).astype(np.float32)
    pos = torch.remainder(st.pos + torch.from_numpy(jitter), st.box)
    pos = torch.where(st.active[:, None], pos, st.pos)
    rc_skin = torch.sqrt(torch.max(spec.pair_cutoff2)) + spec.skin
    kw = dict(dims=cfg.cell_dims, cell_cap=cfg.cell_cap,
              max_neighbors=cfg.max_neighbors, excl_cap=cfg.excl_cap,
              track_birth=True)
    got = neighbor.build_neighbor_state(pos, st.box, st.active, st.excl,
                                        rc_skin, prev=prev,
                                        step=torch.tensor(77), **kw)
    _, _, rst = reference_trees(cfg, spec, dataclasses.replace(
        st, pos=pos, nbr=prev))
    ref = jax.jit(rnb.build_neighbor_state, static_argnames=tuple(kw))(
        rst.pos, rst.box, rst.active, rst.excl, np.float32(rc_skin),
        prev=rst.nbr, step=np.int32(77), **kw)
    n = cfg.n_particles
    idx_r = np.asarray(ref.idx)
    birth_r = _pairs(idx_r, np.asarray(ref.birth).tolist(), n)
    birth_g = _pairs(got.idx.numpy(), got.birth.tolist(), n)
    assert birth_g == birth_r
    assert set(birth_g.values()) >= {77} and min(birth_g.values()) < 50
    assert _pairs(got.idx.numpy(), got.excl_mask.tolist(), n) == \
        _pairs(idx_r, np.asarray(ref.excl_mask).tolist(), n)
    assert bool(got.overflow) == bool(ref.overflow)


def test_grown_caps_restart_every_birth(row_builds):
    """``grow_neighbor_caps`` rebuilds the rows with no previous rows:
    every birth is the state's step, as in the reference."""
    rb, pb = row_builds
    st = dataclasses.replace(pb.state, step=torch.tensor(250, dtype=torch.int32))
    cfg, got = pbuild.grow_neighbor_caps(pb.cfg, pb.spec, st)
    rcfg, rspec, rst = reference_trees(pb.cfg, pb.spec, st)
    rcfg2, ref = rbuild.grow_neighbor_caps(rcfg, rspec, rst)
    assert cfg.max_neighbors == rcfg2.max_neighbors > pb.cfg.max_neighbors
    assert bool((got.nbr.birth == 250).all())
    n = cfg.n_particles
    assert _pairs(got.nbr.idx.numpy(), got.nbr.birth.tolist(), n) == \
        _pairs(np.asarray(ref.nbr.idx), np.asarray(ref.nbr.birth).tolist(), n)


N_DISTINCT = 9


def _distinct_tables(out_dir):
    """``N_DISTINCT`` LJ tables of different depths, each its own
    Chebyshev fit."""
    r = np.arange(0.002, 3.0 + 0.001, 0.002)
    for k in range(N_DISTINCT):
        pts._write_table(os.path.join(out_dir, "table_d%d.pot" % k), r,
                         *pts._lj_table(r, 0.2 + 0.02 * k, 1.0))


LIFTED = {
    # funcs 9 and 11 beside the func 10/12 blends and LJ
    "funcs_9_11": ({**FAMILIES["func10"],
                    ("MA", "MA"): FAMILIES["func9"][("MA", "MA")],
                    ("ML", "ML"): FAMILIES["func11"][("MA", "MA")]
                    .replace("MA", "ML")}, dict(use_pallas=False)),
    # 9 distinct fits under a blend: the kernel's gate admits the system,
    # the table-scalar mode cannot hold the blend
    "blend_over_8_fits": ({
        **{pair: "%s %s 8 table_d%d.pot" % (*pair, k % N_DISTINCT)
           for k, pair in enumerate(sorted(FAMILIES["table"]))},
        ("MA", "ML"): "MA ML 12 table_d0.pot table_d1.pot 0.35"},
        dict(use_pallas=True)),
}


@pytest.mark.parametrize("name", sorted(LIFTED))
def test_lifted_builds_are_leaf_for_leaf_equal(name, tmp_path, caplog):
    """Funcs 9 and 11 on the 40-trimer melt; the blend over 9 fits on the
    70-trimer melt, whose 3x3x3 grid the Chebyshev modes take, so the
    build reaches the fit and falls back after it (the reaction grid's
    caps sized before the fallback, the force grid's cap after)."""
    lines, opts = LIFTED[name]
    d = str(tmp_path)
    if name == "blend_over_8_fits":
        _distinct_tables(d)
        geometry = dict(n_mols=70, density=0.27, seed=42)
    else:
        pts.write_row_tables(d)
        geometry = dict(n_mols=40)
    text = family_text(geometry["n_mols"], lines)
    rb, pb = build_both(text, d, **geometry, **opts)
    assert not pb.cfg.use_pallas and not pb.cfg.lazy_rows
    assert pb.cfg.has_mixed_tables
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)
    if name == "blend_over_8_fits":
        assert min(pb.cfg.cell_dims) >= 3
        assert "mixed tables with >8 distinct fits" in caplog.text
        # the port's default (None) asks for the kernel as the reference's
        # True does
        _, pb2 = build_both(text, d, reference=False, use_pallas=None,
                            **geometry)
        assert pb2.cfg == pb.cfg


def test_row_path_under_slabs_raises_naming_m14():
    """(Named for the refusal it replaced.)  A row-path build under
    ``slab_devices=2`` (the 160-trimer melt, 4 x-layers) equals the
    reference's ``build_system(..., slab_devices=2)`` leaf for leaf."""
    pb, _, _ = pts.build_melt(n_mols=160, reactive=False, use_pallas=False,
                              slab_devices=2, device="cpu")
    rb, _, _ = rts.build_melt(n_mols=160, reactive=False, use_pallas=False,
                              slab_devices=2)
    assert not pb.cfg.use_pallas and pb.cfg.cell_dims[0] == 4
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)


def test_rebuild_radius_ignores_the_coulomb_cutoff_as_the_reference_does(
        tmp_path):
    """The build makes rows to the largest cutoff, Coulomb's included, plus
    the skin; a rebuild makes them to the largest pair cutoff plus the
    skin, in both packages (ROADMAP Queue 3): with a Coulomb cutoff of 3.0
    over LJ at 2.5, the rows shrink from 3.4 to 2.9 at the first rebuild,
    to the same pairs as the reference's."""
    from chemlab_tpu.engine import integrate as rint
    from chemlab_tpu_torch.engine import integrate

    pts.write_row_tables(str(tmp_path))
    _, pb = build_both(family_text(40, {}), str(tmp_path), reference=False,
                       coulomb_cutoff=3.0)
    cfg, spec, st = pb.cfg, pb.spec, pb.state
    assert cfg.has_coulomb and not cfg.use_pallas

    def radius(s):
        j = s.nbr.idx.long()
        d = s.pos[:, None, :] - s.pos[j]
        d = d - s.box * torch.round(d / s.box)
        r = torch.sqrt(torch.sum(d * d, -1))
        return float(r[j != torch.arange(j.shape[0])[:, None]].max())

    got = integrate.maybe_rebuild_neighbors(spec, cfg, st, force=True)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    ref = jax.jit(rint.maybe_rebuild_neighbors, static_argnums=(1, 3))(
        rspec, rcfg, rst, True)
    assert 2.9 < radius(st) < 3.4 and radius(got) < 2.9
    n = cfg.n_particles
    ones = np.ones(got.nbr.idx.shape, bool)
    assert _pairs(got.nbr.idx.numpy(), ones, n) == \
        _pairs(np.asarray(ref.nbr.idx), ones, n)
