"""The tabulated melts: Chebyshev fits, builds, the kernel's Chebyshev modes
(K1c, K1d, K1e) in their plain version, the corrections, forces, steps and
reactions, port vs reference.

Both melts are the 70-trimer systems (3x3x3 cells, cap 24): every type pair
a func-8 table (``build_tabulated_melt``: one distinct fit, table-scalar
mode K1c), and the same with func-10 (conversion-blended) and func-12
(static-blended) pairs (``build_mixed_tab_melt``: two distinct fits, K1d).
K1e is the coefficient-plane mode, reached with ``cheb_ntab=0`` on both
sides.  The reference runs its Pallas colt2 kernel in interpret mode on the
CPU; the port runs the kernel's plain torch version.

Tolerances, each with its reason:
  - fits, builds: bit equality (the same numpy code on the same inputs);
  - ``eval_planes``, wall piece: 2 ulp of the series' term scale (the same
    f32 ops in the same order; the reference's compiler may contract a
    multiply-add); well piece: that plus the propagated 1-ulp difference of
    ``r`` (the port's correctly rounded ``sqrt(r2)`` against the
    reference's ``r2 * rsqrt(r2)``), bounded by Markov's inequality
    ``sum k^2 |c_k|`` times ``|ax| * ulp(r)``;
  - all-pairs forces: ``2e-5 * (1 + max|F_all|)``, the f32 rounding of
    per-slot sums taken in another order, where the wall terms of the
    excluded (bonded) pairs sit in both sums before they cancel; the
    Chebyshev chain cancels ~1e3-sized terms, so per-pair values differ by
    a few ulp of the wall scale;
  - energies and virials: ``1e-5`` relative (sums over ~1e5 pairs in
    another order);
  - steps: positions ``1e-5``, velocities ``2e-4`` absolute after 20
    steps (the force rounding above, integrated over 20 steps of dt 0.0025);
    integers (events, topology, buckets) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import excl_dense as r_excl_dense
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import observables as robs
from chemlab_tpu.engine import pallas_pair
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu.engine import tab_cheb as r_tab_cheb
from chemlab_tpu.engine import tables as r_tables
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import cell_pair, excl_dense
from chemlab_tpu_torch.engine import integrate as pint
from chemlab_tpu_torch.engine import neighbor, observables
from chemlab_tpu_torch.engine import runner as prun
from chemlab_tpu_torch.engine import tab_cheb

N_MOLS = 70
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_melt(kind: str):
    if kind == "tab":
        built, systop, _ = rts.build_tabulated_melt(
            n_mols=N_MOLS, reactive=True, use_pallas=True)
    else:
        built, systop, _ = rts.build_mixed_tab_melt(n_mols=N_MOLS,
                                                    use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=30, chunk=30)
    return built, systop, st


@pytest.fixture(scope="module")
def tab():
    return _reference_melt("tab")


@pytest.fixture(scope="module")
def mixed():
    return _reference_melt("mixed")


@pytest.fixture(params=["tab", "mixed"])
def melt(request, tab, mixed):
    return tab if request.param == "tab" else mixed


def _port(rcfg, rspec, rst):
    return bridge.from_trees(rcfg, rspec, rst, "cpu")


def _all_pairs(cfg, spec, st, obs_x, **kw):
    return cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets, st.nbr.slot_of,
        cfg.cell_dims, spec, cfg.n_types, cheb_kw=cfg.cheb_kw,
        cheb_ko=cfg.cheb_ko, cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix,
        obs_x=obs_x, **kw)


def _force_tol(cfg, spec, st):
    obs_x = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    f_all = _all_pairs(cfg, spec, st, obs_x)[0]
    return 2e-5 * (1.0 + f_all.abs().max().item())


def _rel_ok(got, ref, rtol=1e-5):
    return abs(float(got) - float(ref)) <= rtol * (1.0 + abs(float(ref)))


# ---- fits -------------------------------------------------------------------

def test_fit_stack_and_scalar_pack_match_reference(mixed):
    built, _, _ = mixed
    spec = built.spec
    ef4, r0, dr = (np.asarray(a) for a in (spec.nb_ef4, spec.nb_r0,
                                           spec.nb_dr))
    used = np.zeros(ef4.shape[0], bool)
    kinds = np.asarray(spec.pair_kind)
    used[np.asarray(spec.pair_tab_a)[kinds == 2]] = True
    used[np.asarray(spec.pair_tab_b)[kinds == 2]] = True
    ref = r_tab_cheb.fit_stack(ef4, r0, dr, used)
    got = tab_cheb.fit_stack(ef4, r0, dr, used)
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    ids = np.flatnonzero(used)
    np.testing.assert_array_equal(tab_cheb.pack_table_scalars(got, ids),
                                  r_tab_cheb.pack_table_scalars(ref, ids))
    # the stack's interleave is the port's own copy
    from chemlab_tpu_torch.engine import tables as p_tables
    np.testing.assert_array_equal(p_tables.interleave4(np.asarray(spec.nb_ef)),
                                  r_tables.interleave4(np.asarray(spec.nb_ef)))


# ---- eval_planes --------------------------------------------------------------

@pytest.mark.parametrize("kw,ko", [(8, 0), (16, 24)])
def test_eval_planes_matches_reference(kw, ko):
    rng = np.random.RandomState(kw + ko)
    n = 4096
    r2 = rng.uniform(0.3, 7.0, n).astype(np.float32)
    wall_g = rng.normal(0, 50.0, (kw, n)).astype(np.float32)
    wall_e = rng.normal(0, 20.0, (kw, n)).astype(np.float32)
    well_g = rng.normal(0, 0.5, (ko, n)).astype(np.float32)
    well_e = rng.normal(0, 0.5, (ko, n)).astype(np.float32)
    ay = rng.uniform(0.5, 2.0, n).astype(np.float32)
    by = rng.uniform(-1.5, -0.5, n).astype(np.float32)
    ax = rng.uniform(0.5, 1.5, n).astype(np.float32)
    bx = rng.uniform(-2.5, -1.0, n).astype(np.float32)
    rs2 = np.full(n, 2.0, np.float32)
    rcap2 = np.full(n, 0.64, np.float32)
    args = [list(wall_g), list(wall_e), list(well_g) if ko else None,
            list(well_e) if ko else None, ay, by, ax, bx, rs2, rcap2]

    def conv(f, a):
        if a is None:
            return None
        if isinstance(a, list):
            return [f(x) for x in a]
        return f(a)

    g_r, e_r = jax.jit(lambda *a: r_tab_cheb.eval_planes(*a, kw, ko))(
        jnp.asarray(r2), *(conv(jnp.asarray, a) for a in args))
    g_p, e_p = tab_cheb.eval_planes(
        torch.from_numpy(r2), *(conv(torch.from_numpy, a) for a in args),
        kw, ko)
    wall = r2 < rs2 if ko else np.ones(n, bool)
    for ref, got, cw, co in ((g_r, g_p, wall_g, well_g),
                             (e_r, e_p, wall_e, well_e)):
        ref, got = np.asarray(ref), got.numpy()
        # term scale of the series: rounding of each op is an ulp of it
        tol = 2 * kw * F32_EPS * np.abs(cw).sum(0)
        if ko:
            k2 = (np.arange(ko) ** 2)[:, None]
            r = np.sqrt(r2.astype(np.float64))
            tol_well = (2 * ko * F32_EPS * np.abs(co).sum(0)
                        + (k2 * np.abs(co)).sum(0) * ax * 2 * F32_EPS * r)
            tol = np.where(wall, tol, tol_well)
        err = np.abs(got - ref)
        assert (err <= tol).all(), (err.max(), tol[np.argmax(err - tol)])
    # the wall piece is the same op sequence: agreement is tight there
    assert np.abs(g_p.numpy() - np.asarray(g_r))[wall].max() <= \
        4 * F32_EPS * np.abs(wall_g).sum(0).max()


# ---- builds -----------------------------------------------------------------

def _leaves(tree, path=""):
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
        assert g.dtype == r.dtype and g.shape == r.shape, (p, g.dtype,
                                                           r.dtype)
        assert g.tobytes() == r.tobytes(), p


@pytest.mark.parametrize("kind", ["tab", "mixed"])
def test_build_is_leaf_for_leaf_equal(kind):
    if kind == "tab":
        rb, _, _ = rts.build_tabulated_melt(n_mols=N_MOLS, reactive=True,
                                            use_pallas=True)
        pb, _, _ = pts.build_tabulated_melt(n_mols=N_MOLS, reactive=True,
                                            device="cpu")
        assert (pb.cfg.cheb_kw, pb.cfg.cheb_ko, pb.cfg.cheb_ntab,
                pb.cfg.cheb_mix) == (8, 0, 1, False)
    else:
        rb, _, _ = rts.build_mixed_tab_melt(n_mols=N_MOLS, use_pallas=True)
        pb, _, _ = pts.build_mixed_tab_melt(n_mols=N_MOLS, device="cpu")
        assert pb.cfg.cheb_ntab == 2 and pb.cfg.cheb_mix
        assert pb.cfg.needs_conversions and pb.obs.label(0) == "cr_0"
    assert pb.cfg.tab_cheb and pb.cfg.has_tabulated and pb.cfg.use_pallas
    assert pb.cfg.cell_dims == (3, 3, 3) and pb.cfg.cell_cap == 24
    assert bridge.config_to_dict(pb.cfg) == bridge.config_to_dict(rb.cfg)
    for part in ("spec", "state"):
        _assert_bit_equal(bridge.tree_to_numpy(getattr(rb, part)),
                          bridge.tree_to_numpy(getattr(pb, part)))
    # the bridge carries every cheb leaf both ways, bit for bit
    cfg, spec, state = bridge.from_trees(rb.cfg, rb.spec, rb.state, "cpu")
    _assert_bit_equal(bridge.tree_to_numpy(rb.spec),
                      bridge.to_numpy(cfg, spec, state)[1])


def _assert_row_builds_equal(rb, pb):
    """Both builds on the row path, config, spec and state leaf for leaf
    (the K-nearest rows as per-row sets)."""
    from test_torch_ext_builds import assert_builds_equal
    assert not pb.cfg.use_pallas and not pb.cfg.lazy_rows
    for part in ("config", "spec", "state"):
        assert_builds_equal(rb, pb, part)


def test_rough_tables_build_on_the_row_path(tmp_path):
    """A table whose fit fails sends the build to the row path, as the
    reference's does."""
    pts.write_lj_pair_tables(str(tmp_path), rough=0.05)
    kw = dict(n_mols=N_MOLS, reactive=False, seed=3,
              table_dir=str(tmp_path))
    pb, _, _ = pts.build_tabulated_melt(device="cpu", **kw)
    rb, _, _ = rts.build_tabulated_melt(use_pallas=True, **kw)
    assert not pb.cfg.tab_cheb
    _assert_row_builds_equal(rb, pb)


def test_tabulated_beside_lj_builds_on_the_row_path(tmp_path):
    """Tabulated pairs beside LJ pairs are outside the Chebyshev modes: the
    build takes the row path, as the reference's does."""
    pts.write_lj_pair_tables(str(tmp_path))
    kw = dict(n_mols=N_MOLS, reactive=False, table_groups=("MA", "ML"),
              table_dirs=(str(tmp_path),))
    pb, _, _ = pts.build_melt(device="cpu", **kw)
    rb, _, _ = rts.build_melt(use_pallas=True, **kw)
    assert pb.cfg.has_lj and pb.cfg.has_tabulated
    _assert_row_builds_equal(rb, pb)


# ---- plain K1 in the Chebyshev modes -------------------------------------------

MODES = ["K1c", "K1d", "K1e"]
CH3 = [(True, False), (False, False), (False, True)]    # (energy, virial)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("want_energy,want_virial", CH3,
                         ids=["energy", "none", "virial"])
def test_cheb_k1_plain_matches_colt2_interpret(tab, mixed, mode, want_energy,
                                               want_virial):
    rb, _, rst = mixed if mode == "K1d" else tab
    rcfg = rb.cfg
    if mode == "K1e":
        rcfg = dataclasses.replace(rcfg, cheb_ntab=0)
    cfg, spec, st = _port(rcfg, rb.spec, rst)
    obs_r = robs.conversions(rb.spec, rst.type_id, rst.chem_state, rst.active)
    obs_p = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    np.testing.assert_array_equal(obs_p.numpy(), np.asarray(obs_r))
    f_r, e_r, t_r, w_r = pallas_pair.cell_pair_forces_colt(
        rst.pos, rst.type_id, rst.active, rst.box, rst.nbr.buckets,
        rcfg.cell_dims, rb.spec, rcfg.n_types, rcfg.cell_cap, interpret=True,
        slot_of=rst.nbr.slot_of, want_virial=want_virial,
        want_energy=want_energy, cheb_kw=rcfg.cheb_kw, cheb_ko=rcfg.cheb_ko,
        lj_on=False, cheb_ntab=rcfg.cheb_ntab, cheb_mix=rcfg.cheb_mix,
        obs_x=obs_r)
    f_p, e_p, t_p, w_p = _all_pairs(cfg, spec, st, obs_p,
                                    want_energy=want_energy,
                                    want_virial=want_virial)
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all()
    tol = 2e-5 * (1.0 + np.abs(f_r).max())
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0, atol=tol)
    assert float(e_p) == float(e_r) == 0.0
    s3_r, s3_p = (w_r, w_p) if want_virial else (t_r, t_p)
    if want_energy or want_virial:
        assert float(s3_r) != 0.0 and _rel_ok(s3_p, s3_r), (s3_p, s3_r)
    else:
        assert float(s3_p) == 0.0 and float(s3_r) == 0.0


def test_k1d_blend_equals_select_on_pure_pairs(mixed):
    """On the pure pairs (x forced to 1, no second slot) the blend is the
    table-a value exactly: K1d on a spec whose blended pairs are made pure
    equals K1c bit for bit."""
    rb, _, rst = mixed
    cfg, spec, st = _port(rb.cfg, rb.spec, rst)
    pure = dataclasses.replace(
        spec, cheb_tab_slot_b=torch.zeros_like(spec.cheb_tab_slot_b),
        pair_tab_b=spec.pair_tab_a.clone())
    obs_x = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    d = _all_pairs(cfg, pure, st, obs_x)
    c = _all_pairs(dataclasses.replace(cfg, cheb_mix=False), pure, st, obs_x)
    for a, b in zip(d, c):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---- corrections and forces ---------------------------------------------------

@pytest.mark.parametrize("leg", ["flat", "dense"])
def test_corrections_match_reference(melt, leg):
    rb, _, rst = melt
    rcfg, rspec = rb.cfg, rb.spec
    cfg, spec, st = _port(rcfg, rspec, rst)
    obs_r = robs.conversions(rspec, rst.type_id, rst.chem_state, rst.active)
    obs_p = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    kw = dict(cheb=(rcfg.cheb_kw, rcfg.cheb_ko), cheb_mix=rcfg.cheb_mix)
    if leg == "flat":
        ref = pallas_pair.excluded_pair_correction(
            rspec, rcfg.n_types, rst.pos, rst.box, rst.type_id, rst.excl,
            active=rst.active, obs_x=obs_r, **kw)
        got = cell_pair.excluded_pair_correction(
            spec, cfg.n_types, st.pos, st.box, st.type_id, st.excl,
            active=st.active, obs_x=obs_p, **kw)
    else:
        ref = r_excl_dense.correction(
            rspec, rcfg, rst.pos, rst.box, rst.type_id, rst.excl_masks,
            rst.excl_irr, active=rst.active, obs_x=obs_r, **kw)
        got = excl_dense.correction(
            spec, cfg, st.pos, st.box, st.type_id, st.excl_masks, st.excl_irr,
            active=st.active, obs_x=obs_p, **kw)
    f_r = np.asarray(ref[0])
    np.testing.assert_allclose(got[0].numpy(), f_r, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(f_r).max()))
    assert float(got[1]) == float(ref[1]) == 0.0
    for k in (2, 3):     # e_tab, virial
        assert float(ref[k]) != 0.0 and _rel_ok(got[k], ref[k]), k


def test_compute_forces_matches(melt):
    rb, _, rst = melt
    rcfg, rspec = rb.cfg, rb.spec
    cfg, spec, st = _port(rcfg, rspec, rst)
    f_r, e_r, x_r = jax.jit(lambda s: rint.compute_forces(rspec, rcfg, s))(rst)
    f_p, e_p, x_p = pint.compute_forces(spec, cfg, st)
    np.testing.assert_allclose(f_p.numpy(), np.asarray(f_r), rtol=0,
                               atol=_force_tol(cfg, spec, st))
    np.testing.assert_array_equal(x_p.numpy(), np.asarray(x_r))
    assert cfg.needs_conversions == cfg.cheb_mix
    assert sorted(e_p) == sorted(e_r)
    assert float(e_p["lj"]) == 0.0 and float(e_p["lj-tab"]) != 0.0
    for k in e_r:
        assert _rel_ok(e_p[k], e_r[k]), (k, float(e_p[k]), float(e_r[k]))
    f_0, _, _ = pint.compute_forces(spec, cfg, st, want_energy=False)
    torch.testing.assert_close(f_0, f_p, rtol=0, atol=0)


def test_measure_matches(tab):
    rb, _, rst = tab
    cfg, spec, st = _port(rb.cfg, rb.spec, rst)
    m_r = rrun.measure(rb.spec, rb.cfg, rst)
    m_p = prun.measure(spec, cfg, st)
    assert sorted(m_p) == sorted(m_r)
    for k, v in m_r.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(m_p[k].numpy(), v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(m_p[k].numpy(), v, err_msg=k)


def test_plane_mode_matches_scalar_mode(tab):
    """K1e and K1c serve the same f32 fit values through another lookup:
    the plain versions agree bit for bit."""
    rb, _, rst = tab
    cfg, spec, st = _port(rb.cfg, rb.spec, rst)
    x = torch.zeros(1)
    a = _all_pairs(cfg, spec, st, x, want_virial=True)
    b = _all_pairs(dataclasses.replace(cfg, cheb_ntab=0), spec, st, x,
                   want_virial=True)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


# ---- cancellation -------------------------------------------------------------

def _push_pair(cfg, st, i, j, r):
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([r, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, st.box, st.active, cfg.cell_dims, cfg.cell_cap)
    assert not bool(ovf)
    return pos, buckets, slot_of


@pytest.mark.parametrize("kind", ["tab", "mixed"])
def test_cancellation_of_excluded_pair_at_short_range(tab, mixed, kind):
    """An excluded (bonded) pair pushed to r = 0.05 sigma, deep inside the
    wall clamp: all-pairs minus correction stays finite and equals the
    reference's.  The clamped term sits in both f32 sums before it cancels,
    so the tolerance scales with it."""
    rb, _, rst = tab if kind == "tab" else mixed
    rcfg, rspec = rb.cfg, rb.spec
    cfg, spec, st = _port(rcfg, rspec, rst)
    i, j = (int(x) for x in st.excl[0])
    pos, buckets, slot_of = _push_pair(cfg, st, i, j, 0.05)
    st_p = dataclasses.replace(st, pos=pos, nbr=dataclasses.replace(
        st.nbr, buckets=buckets, slot_of=slot_of))
    obs_p = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    f_all = _all_pairs(cfg, spec, st_p, obs_p)[0]
    kw = dict(cheb=(cfg.cheb_kw, cfg.cheb_ko), cheb_mix=cfg.cheb_mix)
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, st.box, st.type_id, st.excl,
        active=st.active, obs_x=obs_p, **kw)[0]
    f_port = (f_all - f_ex).numpy()
    assert np.isfinite(f_port).all()

    rpos = jnp.asarray(pos.numpy())
    obs_r = robs.conversions(rspec, rst.type_id, rst.chem_state, rst.active)
    rf_all = pallas_pair.cell_pair_forces_colt(
        rpos, rst.type_id, rst.active, rst.box, jnp.asarray(buckets.numpy()),
        rcfg.cell_dims, rspec, rcfg.n_types, rcfg.cell_cap, interpret=True,
        slot_of=jnp.asarray(slot_of.numpy()), cheb_kw=rcfg.cheb_kw,
        cheb_ko=rcfg.cheb_ko, lj_on=False, cheb_ntab=rcfg.cheb_ntab,
        cheb_mix=rcfg.cheb_mix, obs_x=obs_r)[0]
    rf_ex = pallas_pair.excluded_pair_correction(
        rspec, rcfg.n_types, rpos, rst.box, rst.type_id, rst.excl,
        active=rst.active, obs_x=obs_r, **kw)[0]
    f_ref = np.asarray(rf_all - rf_ex)
    big = max(np.abs(f_ref).max(), f_ex.abs().max().item())
    assert big > 100.0     # the pair is deep in the wall
    np.testing.assert_allclose(f_port, f_ref, rtol=0, atol=2e-5 * (1.0 + big))


def _two_particle_grid(spec, t_i, t_j, r, device="cpu"):
    """Two particles of types t_i, t_j at distance r in an otherwise empty
    3x3x3 grid of 3-sigma cells: the only pair of the kernel's sum."""
    box = torch.tensor([9.0, 9.0, 9.0])
    pos = torch.tensor([[4.0, 4.5, 4.5], [4.0 + r, 4.5, 4.5]])
    type_id = torch.tensor([t_i, t_j], dtype=torch.int32)
    active = torch.ones(2, dtype=torch.bool)
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, box, active, (3, 3, 3), 8)
    assert not bool(ovf)
    return pos, type_id, active, box, buckets, slot_of


@pytest.mark.parametrize("r", [0.05, 0.9, 0.97, 1.3, 2.2])
def test_k1d_same_slot_blend_cancels_exactly(mixed, r):
    """A blended pair whose two tables dedupe to one slot (both tables of
    the MA-ML pair set to fits of equal content): the port's kernel sum and
    its correction both compute x*g + (1-x)*g, so one excluded pair cancels
    bit for bit.  The reference's kernel computes (x*1 + (1-x)*1) * g for
    it, in another compiled op order: its residual (recorded in ROADMAP
    Queue 3) is held only to the f32 rounding bound of the Chebyshev chain,
    ``kw * eps * sum|c_k|`` times ``r``: the wall coefficients are ~3e3, so
    per-pair values that are not bit-identical differ by ~1e-4."""
    rb, _, rst = mixed
    cfg, spec, st = _port(rb.cfg, rb.spec, rst)
    T = cfg.n_types
    ma, ml = 0, 1
    p1, p2 = ma * T + ml, ml * T + ma
    same = {k: getattr(spec, k).clone() for k in ("pair_tab_b",
                                                  "cheb_tab_slot_b")}
    # table b := the ML-ML pair's table, whose fit equals table a's (mixA)
    same["pair_tab_b"][[p1, p2]] = spec.pair_tab_a[ml * T + ml]
    same["cheb_tab_slot_b"][[p1, p2]] = spec.cheb_tab_slot[p1]
    sp = dataclasses.replace(spec, **same)
    assert float(sp.cheb_tab_slot_b[p1]) == float(sp.cheb_tab_slot[p1]) > 0
    assert float(cell_pair.mix_weights(sp, torch.zeros(1))[p1]) == \
        np.float32(0.35)
    pos, type_id, active, box, buckets, slot_of = _two_particle_grid(
        sp, ma, ml, r)
    excl = torch.tensor([[0, 1]], dtype=torch.int32)
    obs_x = torch.zeros(1)
    f_all = cell_pair.cell_pair_forces(
        pos, type_id, active, box, buckets, slot_of, (3, 3, 3), sp, T,
        cheb_kw=cfg.cheb_kw, cheb_ko=cfg.cheb_ko, cheb_ntab=cfg.cheb_ntab,
        cheb_mix=True, obs_x=obs_x)
    f_ex = cell_pair.excluded_pair_correction(
        sp, T, pos, box, type_id, excl, active=active,
        cheb=(cfg.cheb_kw, cfg.cheb_ko), cheb_mix=True, obs_x=obs_x)
    assert f_all[0].abs().max().item() > 0.0
    torch.testing.assert_close(f_all[0], f_ex[0], rtol=0, atol=0)
    assert float(f_all[2]) == float(f_ex[2])        # e_tab

    rspec = dataclasses.replace(
        rb.spec, **{k: jnp.asarray(v.numpy()) for k, v in same.items()})
    rf = pallas_pair.cell_pair_forces_colt(
        *(jnp.asarray(a.numpy()) for a in (pos, type_id, active, box,
                                           buckets)),
        (3, 3, 3), rspec, T, 8, interpret=True,
        slot_of=jnp.asarray(slot_of.numpy()), cheb_kw=cfg.cheb_kw,
        cheb_ko=cfg.cheb_ko, lj_on=False, cheb_ntab=cfg.cheb_ntab,
        cheb_mix=True, obs_x=jnp.zeros(1))[0]
    rex = pallas_pair.excluded_pair_correction(
        rspec, T, jnp.asarray(pos.numpy()), jnp.asarray(box.numpy()),
        jnp.asarray(type_id.numpy()), jnp.asarray(excl.numpy()),
        active=jnp.asarray(active.numpy()), cheb=(cfg.cheb_kw, cfg.cheb_ko),
        cheb_mix=True, obs_x=jnp.zeros(1))[0]
    resid = np.abs(np.asarray(rf) - np.asarray(rex)).max()
    scale = np.abs(np.asarray(rex)).max()
    print("reference kernel - correction, same-slot blend at r=%g: %.3e "
          "(F_x kernel %.7f, correction %.7f)"
          % (r, resid, float(rf[0, 0]), float(rex[0, 0])))
    row = sp.cheb_sc[int(sp.cheb_tab_slot[p1]) - 1, :cfg.cheb_kw]
    chain = cfg.cheb_kw * F32_EPS * row.abs().sum().item()
    assert resid <= chain * r, (resid, chain * r)


# ---- steps and reactions ------------------------------------------------------

def test_nve_20_steps_match(melt):
    rb, _, rst = melt
    rcfg = dataclasses.replace(rb.cfg, thermostat="no")
    cfg, spec, pst = _port(rcfg, rb.spec, rst)
    step = jax.jit(lambda s: rint.md_step(rb.spec, rcfg, s))
    for _ in range(20):
        rst = step(rst)
        pst = pint.md_step(spec, cfg, pst)
    np.testing.assert_allclose(pst.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pst.vel.numpy(), np.asarray(rst.vel), rtol=0,
                               atol=2e-4)
    for name in ("buckets", "slot_of", "n_rebuilds", "overflow"):
        np.testing.assert_array_equal(getattr(pst.nbr, name).numpy(),
                                      np.asarray(getattr(rst.nbr, name)),
                                      err_msg=name)


def test_reactive_langevin_block_matches(tab):
    """40 Langevin steps with a reaction step every 10, the reference's own
    noise handed to the port each step: equal event lists and topology."""
    rb, systop, rst = tab
    rst = rts.activate_initiators(rb, systop, rst, n=20)
    rst = dataclasses.replace(rst, reaction_rates=rst.reaction_rates * 40.0)
    rcfg = dataclasses.replace(rb.cfg, reaction_interval=10)
    cfg, spec, pst = _port(rcfg, rb.spec, rst)
    step = jax.jit(lambda s: rrun.step_with_extensions(rb.spec, rcfg, s))
    n0 = int(np.asarray(rst.reaction_counts).sum())
    for _ in range(40):
        _, sub = jax.random.split(rst.key)
        noise = jax.random.normal(sub, rst.vel.shape, rst.vel.dtype)
        rst = step(rst)
        pst = prun.step_with_extensions(
            spec, cfg, pst, noise=torch.from_numpy(np.array(noise)))
    assert int(np.asarray(rst.reaction_counts).sum()) > n0
    for name in ("reaction_counts", "ev_log_a", "ev_log_b", "ev_log_r",
                 "ev_log_step", "type_id", "chem_state", "excl", "n_excl",
                 "excl_masks", "excl_irr", "image"):
        np.testing.assert_array_equal(getattr(pst, name).numpy(),
                                      np.asarray(getattr(rst, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(pst.bonds.idx.numpy(),
                                  np.asarray(rst.bonds.idx))
    np.testing.assert_allclose(pst.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(pst.vel.numpy(), np.asarray(rst.vel), rtol=0,
                               atol=2e-4)
