"""The Verlet row path's pair forces against the reference, family by
family.

Each case builds the 40-trimer melt at density 0.3 with one family of
nonbonded funcs on a few type pairs (``FAMILIES``; every other pair LJ by
combination) on the row path, puts it at the warmed positions of the LJ
melt, gives the particles random types of all seven (so every type pair
occurs), random λ != 1 where λ scales pairs, mixed birth ages where
func 14 ramps, and random charges for Coulomb, and rebuilds the rows.
Both packages then resolve the step's tables from the same conversions
(``resolve_pair_tables``: exactly equal) and evaluate ``pair_forces``
over the same rows: forces within ``2e-5 (1 + max|ref|)``, each energy
kind within ``2e-5 (1 + |ref|)``.  The reference runs its own row path,
op by op.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import topfile as rtopfile
from chemlab_tpu.engine import build as rbuild
from chemlab_tpu.engine import observables as robs
from chemlab_tpu.engine import pair_forces as rpf
from chemlab_tpu.topology import compile_system_topology as r_compile
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch import topfile as ptopfile
from chemlab_tpu_torch.engine import build as pbuild
from chemlab_tpu_torch.engine import integrate, observables, runner
from chemlab_tpu_torch.engine import pair_forces as ppf
from chemlab_tpu_torch.topology import compile_system_topology as p_compile
from test_torch_bonded_tab import reference_trees

N_MOLS, DENSITY, SEED = 40, 0.3, 3
NAMES = sorted(pts.MELT_TYPES)

# one family of nonbonded funcs each, on the pairs named (sorted symbols)
FAMILIES = {
    "lj": {},
    "table": {(a, b): "%s %s 8" % (a, b)
              for i, a in enumerate(NAMES) for b in NAMES[i:]},
    "func9": {("MA", "MA"): "MA MA 9 table_rowA.pot MA 80 0.0 0.5 1",
              ("MA", "ML"): "MA ML 9 table_rowB.pot MA 80 0.2 1.01",
              ("ML", "ML"): "ML ML 9 table_rowC.pot ML 40 0.0 0.2 0",
              ("PA", "PL"): "PA PL 8"},
    "func10": {("MA", "MA"): "MA MA 10 table_rowA.pot table_rowB.pot MA 80",
               ("MA", "ML"): "MA ML 12 table_rowA.pot table_rowC.pot 0.35",
               ("PA", "PL"): "PA PL 8"},
    "func17": {("MA", "PA"): "MA PA 17 MA 80 0.0:0.25:table_rowA.pot:"
                             "table_rowB.pot 0.25:1.01:table_rowC.pot:"
                             "table_rowD.pot",
               ("MA", "MA"): "MA MA 17 ML 40 0.0:0.3:table_rowD.pot:"
                             "table_rowA.pot",
               ("ML", "PL"): "ML PL 8"},
    "func13": {("MA", "MA"): "MA MA 13 table_MA_MA.pot 0.9",
               ("ML", "ML"): "ML ML 13 table_ML_ML.pot 0.75",
               ("PA", "PL"): "PA PL 8"},
    "func16": {("MA", "MA"): "MA MA 16 1.0 1.0 0.9",
               ("ML", "ML"): "ML ML 16 0.75",
               ("DA", "FA"): "DA FA 16 0.9 1.2 1.0"},
    "func11": {("MA", "MA"): "MA MA 11 table_MA_MA.pot 30.0",
               ("MA", "ML"): "MA ML 11 table_MA_ML.pot",
               ("PA", "PL"): "PA PL 8"},
    "func15": {("MA", "MA"): "MA MA 15 1.0 1.0 30.0",
               ("ML", "ML"): "ML ML 15 20.0",
               ("MA", "ML"): "MA ML 15"},
    "func14": {("MA", "MA"): "MA MA 14 table_MA_MA.pot 0.02",
               ("MA", "ML"): "MA ML 14 table_MA_ML.pot 0.05 40.0",
               ("PA", "PL"): "PA PL 8"},
    "coulomb": {("PA", "PL"): "PA PL 8"},
}
FAMILY_OPTS = {"coulomb": dict(coulomb_cutoff=2.0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def family_text(n_mols: int, lines: dict) -> str:
    """The trimer melt's topology with a ``[ nonbond_params ]`` line for
    every type pair: ``lines``' where given, else LJ by combination."""
    nb = ["", "[ nonbond_params ]"] + [
        lines.get((a, b), "%s %s 1" % (a, b))
        for i, a in enumerate(NAMES) for b in NAMES[i:]]
    return pts._melt_topology_text(n_mols) + "\n".join(nb) + "\n"


def build_both(text, table_dir, n_mols=N_MOLS, density=DENSITY, seed=SEED,
               reference=True, **opts):
    """The port's build (on the CPU) and the reference's of the trimer melt
    under the topology ``text``, with ``testsystems.melt_options`` and the
    tables in ``table_dir``; ``use_pallas`` is False unless given (the
    reference gets the same value: it treats None as False on the CPU)."""
    kw = pts.melt_options(seed=seed, table_dirs=(table_dir,),
                          **{"use_pallas": False, **opts})
    coords = pts.melt_coordinates(n_mols, density, seed=seed)
    pb = pbuild.build_system(
        p_compile(ptopfile.parse_lines(text.splitlines(), "<rows>")), coords,
        pbuild.SimOptions(**kw), device="cpu")
    if not reference:
        return None, pb
    rb = rbuild.build_system(
        r_compile(rtopfile.parse_lines(text.splitlines(), "<rows>")), coords,
        rbuild.SimOptions(**kw))
    return rb, pb


@pytest.fixture(scope="module")
def table_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("rows"))
    pts.write_row_tables(d)
    return d


@pytest.fixture(scope="module")
def warm_pos(table_dir):
    """The LJ melt's positions after a short descent."""
    _, pb = build_both(family_text(N_MOLS, {}), table_dir, reference=False)
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    return pts.warmup(pb, st, steps=30).pos


def scrambled(pb, pos, seed=0, step=100):
    """The build's state at ``pos`` with random types (chemical states to
    match), charges in [-0.5, 0.5] where the build has Coulomb, λ in
    [0.2, 1] where λ scales pairs, and, where func 14 ramps, the step at
    ``step`` and births spread over [0, 1.5 step] (ages from negative to
    past full strength); the rows rebuilt at ``pos``."""
    cfg, st = pb.cfg, pb.state
    rng = np.random.RandomState(seed)
    n = st.pos.shape[0]
    act = st.active.numpy()
    tid = np.where(act, rng.randint(0, cfg.n_types, n), 0).astype(np.int32)
    st = dataclasses.replace(
        st, pos=pos.clone(), type_id=torch.from_numpy(tid),
        chem_state=pb.spec.type_state[torch.from_numpy(tid).long()],
        step=torch.tensor(step, dtype=torch.int32))
    if cfg.has_coulomb:
        q = np.where(act, rng.uniform(-0.5, 0.5, n), 0.0)
        st = dataclasses.replace(st, q=torch.from_numpy(q.astype(np.float32)))
    if cfg.has_lambda_pairs:
        lam = rng.uniform(0.2, 1.0, n).astype(np.float32)
        st = dataclasses.replace(st, lam=torch.from_numpy(lam))
    st = integrate.maybe_rebuild_neighbors(pb.spec, cfg, st, force=True)
    if cfg.has_pps:
        birth = rng.randint(0, 3 * step // 2, st.nbr.idx.shape)
        st = dataclasses.replace(st, nbr=dataclasses.replace(
            st.nbr, birth=torch.from_numpy(birth.astype(np.int32))))
    return st


def port_pairs(spec, cfg, st):
    obs_x = observables.conversions(spec, st.type_id, st.chem_state,
                                    st.active)
    tabs = ppf.resolve_pair_tables(spec, obs_x, cfg.n_mix_entries)
    return tabs, ppf.pair_forces(
        spec, cfg.n_types, st.pos, st.box, st.type_id, st.q, st.lam,
        st.nbr.idx, st.nbr.excl_mask, *tabs, cfg=cfg,
        pps_step=st.step if cfg.has_pps else None,
        pps_birth=st.nbr.birth if cfg.has_pps else None)


def reference_pairs(cfg, spec, st):
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    obs_x = robs.conversions(rspec, rst.type_id, rst.chem_state, rst.active)
    tabs = rpf.resolve_pair_tables(rspec, obs_x, rcfg.n_mix_entries)
    return tabs, rpf.pair_forces(
        rspec, rcfg.n_types, rst.pos, rst.box, rst.type_id, rst.q, rst.lam,
        rst.nbr.idx, rst.nbr.excl_mask, *tabs, cfg=rcfg,
        pps_step=rst.step if rcfg.has_pps else None,
        pps_birth=rst.nbr.birth if rcfg.has_pps else None)


def assert_forces_close(got, ref):
    ref = np.asarray(ref)
    tol = 2e-5 * (1.0 + np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=tol)


def assert_energies_close(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        r = float(ref[k])
        assert abs(float(got[k]) - r) <= 2e-5 * (1.0 + abs(r)), (k, got[k], r)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_pair_forces_match_reference(family, table_dir, warm_pos):
    _, pb = build_both(family_text(N_MOLS, FAMILIES[family]), table_dir,
                       reference=False, **FAMILY_OPTS.get(family, {}))
    cfg, spec = pb.cfg, pb.spec
    assert not cfg.use_pallas and not cfg.lazy_rows
    st = scrambled(pb, warm_pos)
    flags = {"func11": "has_lambda_pairs", "func15": "has_lambda_pairs",
             "func14": "has_pps", "func13": "has_caps",
             "func16": "has_caps", "coulomb": "has_coulomb",
             "func17": "has_mixed_tables", "func9": "has_mixed_tables",
             "func10": "has_mixed_tables", "table": "has_tabulated"}
    if family in flags:
        assert getattr(cfg, flags[family])
    (ta, tb, x), (f, e) = port_pairs(spec, cfg, st)
    (rta, rtb, rx), (rf, re) = reference_pairs(cfg, spec, st)
    for got, ref in ((ta, rta), (tb, rtb), (x, rx)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert_forces_close(f, rf)
    assert_energies_close(e, re)
    assert float(np.abs(np.asarray(rf)).max()) > 0.0
    kind = {"lj": "lj", "func15": "lj", "func16": "lj",
            "coulomb": "coulomb"}.get(family, "lj-tab")
    assert float(re[kind]) != 0.0


@pytest.mark.parametrize("family", ["func9", "func17"])
def test_resolve_pair_tables_across_the_ranges(family, table_dir):
    """Conversions (counts over totals: never negative) swept across every
    range boundary and onto each one: the per-pair tables and blend
    weights equal the reference's."""
    _, pb = build_both(family_text(N_MOLS, FAMILIES[family]), table_dir,
                       reference=False)
    cfg, spec = pb.cfg, pb.spec
    assert cfg.n_mix_entries > 0
    rcfg, rspec, _ = reference_trees(cfg, spec, pb.state)
    edges = np.unique(np.concatenate([spec.mix_lo.numpy(),
                                      spec.mix_hi.numpy()]))
    sweep = np.unique(np.concatenate(
        [np.linspace(0.0, 1.05, 15, dtype=np.float32), edges,
         np.nextafter(edges, np.float32(-1)),
         np.nextafter(edges, np.float32(2))])).astype(np.float32)
    sweep = sweep[sweep >= 0.0]
    n_obs = spec.obs_total.shape[0]
    for k, v in enumerate(sweep):
        obs_x = np.roll(np.asarray([v, sweep[-1 - k]] * n_obs,
                                   np.float32)[:n_obs], k)
        got = ppf.resolve_pair_tables(spec, torch.from_numpy(obs_x),
                                      cfg.n_mix_entries)
        ref = rpf.resolve_pair_tables(rspec, jnp.asarray(obs_x),
                                      rcfg.n_mix_entries)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pair_forces_at_the_cap_radius(table_dir, warm_pos):
    """A func-16 pair (caprad 0.75) exactly at its cap radius and one
    inside it: zero force from the capped LJ there, energies flat, and
    the reference's values."""
    _, pb = build_both(family_text(N_MOLS, FAMILIES["func16"]), table_dir,
                       reference=False)
    st = pin_ml_pairs(pb, warm_pos, (0.75, 0.5))
    (_, _, _), (f, e) = port_pairs(pb.spec, pb.cfg, st)
    _, (rf, re) = reference_pairs(pb.cfg, pb.spec, st)
    assert_forces_close(f, rf)
    assert_energies_close(e, re)


def pin_ml_pairs(pb, pos, offsets):
    """The build's state at ``pos`` with two far-apart ML pairs moved to
    exact x-separations ``offsets`` (exactly representable) and all other
    particles MA; rows rebuilt."""
    st = pb.state
    tid = torch.zeros_like(st.type_id)
    ml = pb.systop.atomsym_atomtype["ML"]
    pos = pos.clone()
    rows = [(1, 4), (61, 64)]       # middles of trimers 0/1 and 20/21
    base = [(1.0, 1.0, 1.0), (5.0, 5.0, 5.0)]
    for (a, b), off, p0 in zip(rows, offsets, base):
        tid[a] = tid[b] = ml
        pos[a] = torch.tensor(p0)
        pos[b] = torch.tensor((p0[0] + off, p0[1], p0[2]))
    st = dataclasses.replace(st, pos=pos, type_id=tid)
    return integrate.maybe_rebuild_neighbors(pb.spec, pb.cfg, st, force=True)
