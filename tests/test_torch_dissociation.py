"""Bond breaking, RestrictReaction and dynamic resolution against the
reference, on the break melt (``testsystems.build_break_melt``: the ATRP
forward reaction with ChangeNeighboursProperty and RemoveNeighboursBonds,
chain growth restricted to a connectivity map, MA:ML dissociation with a
lambda fade) at 40 trimers, density 0.4.

The build is held to the reference's in ``test_torch_ext_builds.py``.
From one warmed state the
reference's jitted ``reaction_step`` and the port's give the same event
lists and integer tables exactly (the draws are the integer hash, every
sort is stable); lambda values are set, not computed, so they are exact
too.  ``_dynamic_resolution`` ramps lambda and fires the products on both
sides exactly.  Twenty ``step_with_extensions`` steps under the CSVR
thermostat, with the reference's normal draws injected, hold positions to
``1e-5`` and velocities to ``2e-4`` (``test_torch_runner.py``'s bound).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import reactions as rrx
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import build, integrate, runner
from chemlab_tpu_torch.engine import reactions as prx
from test_torch_bonded_tab import reference_trees

TABLES = ("bonds", "angles", "dihedrals")
INT_FIELDS = ("type_id", "chem_state", "mol_id", "adj", "excl", "n_excl",
              "reaction_counts", "intra_counts", "ev_log_a", "ev_log_b",
              "ev_log_r", "ev_log_step", "fixd_host", "fixd_dummy", "active",
              "freeze_count", "atrp_stats")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(r_out, p_out, floats=("lam",), pos_tol=None):
    """Every integer field and table equal; ``floats`` exactly; positions
    and velocities within ``pos_tol`` (exactly when None)."""
    for name in INT_FIELDS + tuple(floats):
        np.testing.assert_array_equal(getattr(p_out, name).numpy(),
                                      np.asarray(getattr(r_out, name)),
                                      err_msg=name)
    for t in TABLES + ("bonds_dense", "bonds_irr", "angles_dense",
                       "angles_irr"):
        if getattr(r_out, t) is None:
            assert getattr(p_out, t) is None
            continue
        ref = bridge.tree_to_numpy(getattr(r_out, t))
        got = bridge.tree_to_numpy(getattr(p_out, t))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg="%s.%s" % (t, k))
    if r_out.excl_masks is not None:
        np.testing.assert_array_equal(p_out.excl_masks.numpy(),
                                      np.asarray(r_out.excl_masks))
        np.testing.assert_array_equal(p_out.excl_irr.numpy(),
                                      np.asarray(r_out.excl_irr))
    assert bool(p_out.nbr.overflow) == bool(r_out.nbr.overflow)
    for name, tol in (("pos", pos_tol), ("vel", None if pos_tol is None
                                         else 2e-4)):
        ref = np.asarray(getattr(r_out, name))
        got = getattr(p_out, name).numpy()
        if tol is None:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=tol,
                                       err_msg=name)


@functools.partial(jax.jit, static_argnames=(
    "n", "lv", "rescale", "vr", "baro", "atrp", "freeze", "cpt"))
def _ref_draw_arrays(key, *, n, lv, rescale, vr, baro, atrp, freeze, cpt):
    """The reference's split chain of one ``step_with_extensions``
    (``atrp`` is None or (count, hi)), jitted: the bits are the eager
    ones."""
    out = {}
    key, sub = jax.random.split(key)
    if lv:
        out["noise"] = jax.random.normal(sub, (n, 3))
    if rescale:
        key, sub = jax.random.split(key)
        if vr:
            out["rescale"] = jax.random.normal(sub, ())
    if baro:
        key, sub = jax.random.split(key)
        out["baro"] = jax.random.normal(sub, ())
    if atrp is not None:
        key, k1, k2 = jax.random.split(key, 3)
        out["atrp"] = (jax.random.randint(k1, (atrp[0],), 0, atrp[1]),
                       jax.random.uniform(k2, (atrp[0],)))
    if freeze:
        key, sub = jax.random.split(key)
        out["freeze"] = jax.random.uniform(sub, (n,))
    if cpt:
        key, sub = jax.random.split(key)
        out["cpt"] = jax.random.uniform(sub, (n,))
    return key, out


def ref_draws(key, cfg, n, gates, atrp_count=None):
    """The reference's draws for one ``step_with_extensions`` from its
    state's ``key``, in its split order: (key after the step, the
    Langevin noise or None, the port's ``draws`` dict)."""
    atrp = None
    if cfg.has_atrp and gates.get("atrp"):
        atrp = (cfg.atrp_num, cfg.n_particles if cfg.atrp_select_from_all
                else max(atrp_count, 1))
    key, out = _ref_draw_arrays(
        key, n=n, lv=cfg.thermostat == "lv",
        rescale=cfg.thermostat in ("vr", "br", "iso"),
        vr=cfg.thermostat == "vr", baro=cfg.barostat != "no", atrp=atrp,
        freeze=cfg.has_freeze, cpt=bool(cfg.has_cpt and gates.get("cpt")))
    noise = np.asarray(out.pop("noise")) if "noise" in out else None
    draws = {}
    for k in ("rescale", "baro"):
        if k in out:
            draws[k] = torch.tensor(np.asarray(out[k]))
    if "atrp" in out:
        draws["atrp"] = tuple(np.asarray(x) for x in out["atrp"])
    for k in ("freeze", "cpt"):
        if k in out:
            draws[k] = np.asarray(out[k])
    return key, noise, draws


ref_step = jax.jit(rrx.reaction_step, static_argnums=(1,))
ref_ext_step = jax.jit(rrun.step_with_extensions, static_argnums=(1,))


def run_steps_both(cfg, spec, st, n_steps, atrp_count=None):
    """``n_steps`` of ``step_with_extensions`` on both packages from
    ``st``, the reference's draws injected into the port."""
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    key = rst.key
    n = st.pos.shape[0]
    for _ in range(n_steps):
        gates = runner._gates(cfg, bool(st.reactions_on), int(st.step) + 1)
        key, noise, draws = ref_draws(key, cfg, n, gates, atrp_count)
        rst = ref_ext_step(rspec, rcfg, rst, 0)
        st = runner.step_with_extensions(
            spec, cfg, st, 0, gates=gates, draws=draws,
            noise=None if noise is None else torch.tensor(noise))
        assert np.array_equal(np.asarray(rst.key), np.asarray(key))
    return rst, st


# ---- the build ------------------------------------------------------------


@pytest.fixture(scope="module")
def break_builds(tmp_path_factory):
    """The port's break melt (the build is held to the reference's in
    ``test_torch_ext_builds.py``)."""
    pb, psys, _ = pts.build_break_melt(
        n_mols=40, density=0.4, seed=5,
        table_dir=str(tmp_path_factory.mktemp("break")), diss_rate=2.0,
        device="cpu", max_events=16)
    return pb, psys


@pytest.fixture(scope="module")
def warm(break_builds):
    """The port's warmed state with 12 initiators, reactions on."""
    pb, psys = break_builds
    st = runner.initial_forces(pb.spec, pb.cfg, pb.state)
    st = pts.warmup(pb, st, steps=30)
    return pts.activate_initiators(pb, psys, st, n=12)


# ---- matching and events --------------------------------------------------


def _at(st, step, **kw):
    return dataclasses.replace(st, step=torch.full_like(st.step, step),
                               reactions_on=torch.ones((), dtype=torch.bool),
                               **kw)


@pytest.mark.parametrize("step", [200, 400])
def test_reaction_step_with_breaks_equal(break_builds, warm, step):
    """Events of all three channels: the ATRP forward reaction (sequential
    scan, ChangeNeighboursProperty, RemoveNeighboursBonds), the restricted
    chain growth and the dissociation, capped at 16 breaks."""
    pb, _ = break_builds
    cfg, spec = pb.cfg, pb.spec
    st = _at(warm, step, reaction_rates=warm.reaction_rates * 5.0)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    r_out = ref_step(rspec, rcfg, rst, 0)
    p_out = prx.reaction_step(spec, cfg, st, 0)
    assert_same_state(r_out, p_out)
    counts = p_out.reaction_counts.tolist()
    assert counts[0] > 0 and counts[2] == cfg.max_events, counts
    dv, drow, dr = prx.match_dissociations(spec, cfg, st, 0)
    rv, rrow, rr = jax.jit(rrx.match_dissociations, static_argnums=(1,))(
        rspec, rcfg, rst, 0)
    for got, ref in ((dv, rv), (drow, rrow), (dr, rr)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # a break with alpha keeps the old types at lambda 0
    lam0 = (p_out.lam == 0.0) & p_out.active
    assert int(lam0.sum()) > 0
    assert torch.equal(p_out.type_id[lam0], st.type_id[lam0])
    # molecules split: the labels are the components of the new graph
    assert int(p_out.mol_id.unique().numel()) > int(st.mol_id.unique()
                                                    .numel())


def test_products_fire_after_the_ramp(break_builds, warm):
    """``_dynamic_resolution`` for 100 steps after the breaks: lambda
    climbs by alpha a step on both sides and, crossing 1, the products
    take their types (PA, PL), mass and charge; particles already at 1
    never convert."""
    pb, psys = break_builds
    cfg, spec = pb.cfg, pb.spec
    st = prx.reaction_step(spec, cfg, _at(warm, 200), 0)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    faded = ((st.lam == 0.0) & st.active).clone()
    ramp = jax.jit(rint._dynamic_resolution)
    for k in range(101):
        rst = ramp(rspec, rst)
        st = integrate._dynamic_resolution(spec, st)
        if k in (0, 50, 99, 100):
            for name in ("lam", "type_id", "mass", "q", "chem_state"):
                np.testing.assert_array_equal(getattr(st, name).numpy(),
                                              np.asarray(getattr(rst, name)),
                                              err_msg=name)
    tsym = psys.atomsym_atomtype
    fired = st.type_id[faded]
    assert bool(((fired == tsym["PA"]) | (fired == tsym["PL"])).all())
    assert float(st.lam.min()) >= 0.0 and float(st.lam.max()) <= 1.0


def test_restrict_admits_only_listed_pairs(break_builds, warm):
    """Chain growth (reaction_b) is restricted: with half the MA turned
    DA(3) and the rates raised, only pairs of the whitelist react, on both
    sides.  The whitelist here keeps every third row of the build's (the
    build's own covers every pair that comes within reach in a short run;
    the others get ``hi`` -1, which no pair has, so that the shapes stay),
    and without the restriction the same state reacts on pairs it does not
    list."""
    pb, psys = break_builds
    cfg = pb.cfg
    hi = pb.spec.restrict_hi.clone()
    hi[torch.arange(hi.shape[0]) % 3 != 0] = -1
    spec = dataclasses.replace(pb.spec, restrict_hi=hi)
    tsym = psys.atomsym_atomtype
    tid, chem = warm.type_id.clone(), warm.chem_state.clone()
    heads = torch.nonzero((tid == tsym["MA"]) & warm.active).flatten()[::2]
    tid[heads], chem[heads] = tsym["DA"], 3
    st = _at(warm, 200, type_id=tid, chem_state=chem,
             reaction_rates=warm.reaction_rates * 10.0)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    r_out = ref_step(rspec, rcfg, rst, 0)
    p_out = prx.reaction_step(spec, cfg, st, 0)
    assert_same_state(r_out, p_out)
    listed = set(zip(spec.restrict_lo.tolist(), spec.restrict_hi.tolist()))

    def grown(out):
        return [(min(a, b), max(a, b)) for a, b, r in zip(
            out.ev_log_a.tolist(), out.ev_log_b.tolist(),
            out.ev_log_r.tolist()) if a >= 0 and r == 1]

    assert grown(p_out) and all(p in listed for p in grown(p_out))
    free = dataclasses.replace(spec, r_restricted=torch.zeros_like(
        spec.r_restricted))
    assert any(p not in listed
               for p in grown(prx.reaction_step(free, cfg, st, 0)))


# ---- twenty steps ---------------------------------------------------------


def test_twenty_csvr_steps_equal(break_builds, warm):
    """From step 190: a reaction step (200) inside the run, breaks fading,
    the CSVR thermostat's normal draw injected every step."""
    pb, _ = break_builds
    cfg, spec = pb.cfg, pb.spec
    st = _at(warm, 190, reaction_rates=warm.reaction_rates * 5.0)
    r_out, p_out = run_steps_both(cfg, spec, st, 20)
    assert int(p_out.reaction_counts.sum()) > 0
    assert_same_state(r_out, p_out, floats=(), pos_tol=1e-5)
    np.testing.assert_allclose(p_out.lam.numpy(), np.asarray(r_out.lam),
                               rtol=0, atol=1e-6)


def test_exclusion_holes_count_toward_regrowth(break_builds, warm):
    """``excl_remove`` leaves -1 holes and keeps the cursor, so breaks use
    up exclusion capacity: the regrowth check reads the cursor, and
    ``grow_term_caps`` grows the pair list and clears the flag."""
    pb, _ = break_builds
    cfg, spec = pb.cfg, pb.spec
    st = prx.reaction_step(spec, cfg, _at(warm, 200), 0)
    n_excl = int(st.n_excl)
    assert int((st.excl[:n_excl, 0] < 0).sum()) > 0
    cfg2, st2 = build.apply_term_caps(cfg, st, {}, excl_pair_cap=n_excl + 4)
    st2 = dataclasses.replace(st2, nbr=dataclasses.replace(
        st2.nbr, overflow=torch.ones((), dtype=torch.bool)))
    counts = {k: int(v) for k, v in runner.measure_cheap(spec, cfg2,
                                                         st2).items()
              if k.startswith("n_")}
    counts["excl_pair_cap"] = st2.excl.shape[0]
    assert build.term_caps_near_full(cfg2, counts)
    cfg3, st3 = build.grow_term_caps(cfg2, st2, counts=counts)
    assert st3.excl.shape[0] > st2.excl.shape[0] and not bool(
        st3.nbr.overflow)
    assert torch.equal(st3.excl[:n_excl], st.excl[:n_excl])
