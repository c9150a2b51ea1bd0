"""Tabulated lookups, func-8 bonds and angles, dihedrals and 1-4 pairs:
the port against the reference on the same numpy inputs.

``interpolate`` and ``interpolate4`` take random queries (a third of them
off the grid, so the clamp runs) and must give the reference's bits when
both run op by op.  Under ``jax.jit`` XLA contracts the blend
``lo * (1 - t) + hi * t`` into a fused multiply-add, which rounds once
where the port rounds twice: there the difference is held to one rounding
of the two products, ``2**-23 * (|lo| (1 - t) + |hi| t)``.

The bonded terms run on the 40-tetramer chain melt
(``testsystems.build_chain_melt``) with seeded jitter, a few chain ends
turned to type F (so type lookups resolve F-B-B-E to func 12) and extra
dihedral rows of funcs 1, 8 and 12 at lambda 0.5, through the whole
``bonded_forces`` of both packages, on the flat and the dense legs.
Energies: ``2e-5 * (1 + |ref|)``; forces: ``2e-5 * (1 + max|F|)`` (f32
sums of a few terms per particle in another order, and the reference's
fused multiply-adds).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu.engine import bonded_forces as rbf
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import spec as rspec_mod
from chemlab_tpu.engine import state as rstate_mod
from chemlab_tpu.engine import tables as rtab
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import bonded_forces as pbf
from chemlab_tpu_torch.engine import bonded_dense as pbd
from chemlab_tpu_torch.engine import integrate as pint
from chemlab_tpu_torch.engine import tables as ptab
from chemlab_tpu_torch.engine.state import TermTable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_tree(cls, d):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if v is None:
            kw[f.name] = None
        elif isinstance(v, dict):
            sub = (rstate_mod.NeighborState if f.name == "nbr"
                   else rstate_mod.TermTable)
            kw[f.name] = _ref_tree(sub, v)
        else:
            kw[f.name] = jnp.asarray(v)
    return cls(**kw)


def reference_trees(cfg, spec, state, seed: int = 0):
    """The reference's (EngineConfig, SimSpec, MDState) holding the port's
    values (the inverse of ``bridge.from_trees``)."""
    rcfg = rspec_mod.EngineConfig(**bridge.config_to_dict(cfg))
    d = bridge.tree_to_numpy(state)
    d["key"] = jax.random.PRNGKey(seed)
    return (rcfg, _ref_tree(rspec_mod.SimSpec, bridge.tree_to_numpy(spec)),
            _ref_tree(rstate_mod.MDState, d))


# the reference's bonded pass, compiled (op by op it takes seconds)
ref_bonded_forces = jax.jit(rbf.bonded_forces, static_argnums=(1,))


def chain_melt(table_dir, n_mols: int = 40, **kw):
    """The port's chain melt on the CPU, tables in ``table_dir``."""
    pts.write_chain_tables(str(table_dir))
    built, systop, _ = pts.build_chain_melt(n_mols=n_mols, device="cpu",
                                            table_dir=str(table_dir), **kw)
    return built, systop


# ---- table lookups -----------------------------------------------------------

def _stack(seed: int = 0, n_tables: int = 3, n_bins: int = 257,
           n_q: int = 20000):
    rng = np.random.RandomState(seed)
    ef = rng.normal(size=(n_tables, n_bins, 2)).astype(np.float32)
    r0 = rng.uniform(0.0, 1.0, n_tables).astype(np.float32)
    dr = rng.uniform(0.01, 0.05, n_tables).astype(np.float32)
    ti = rng.randint(0, n_tables, n_q).astype(np.int32)
    lo = r0[ti] - 2.0
    hi = r0[ti] + dr[ti] * n_bins + 2.0
    r = (lo + (hi - lo) * rng.uniform(size=n_q)).astype(np.float32)
    return ef, r0, dr, ti, r


@pytest.mark.parametrize("fn", ["interpolate", "interpolate4"])
def test_interpolate_matches_reference(fn):
    ef, r0, dr, ti, r = _stack()
    stack = ptab.interleave4(ef) if fn == "interpolate4" else ef
    off = ((r < r0[ti]) | (r > r0[ti] + dr[ti] * (ef.shape[1] - 1))).mean()
    assert 0.2 < off < 0.5
    args_r = [jnp.asarray(a) for a in (stack, r0, dr, ti, r)]
    args_p = [torch.from_numpy(a) for a in (stack, r0, dr, ti, r)]
    got = getattr(ptab, fn)(*args_p)
    for g, ref in zip(got, getattr(rtab, fn)(*args_r)):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(ref).view(np.uint32))
    # jitted, XLA fuses the blend: one rounding of its two products
    _, i0, frac = ptab._lookup(ef.shape[1], *args_p[1:])
    t = frac[:, 0].numpy()
    lo = ef[ti, i0.numpy()]
    hi = ef[ti, np.minimum(i0.numpy() + 1, ef.shape[1] - 1)]
    bound = 2.0 ** -23 * (np.abs(lo) * (1 - t[:, None])
                          + np.abs(hi) * t[:, None])
    jitted = jax.jit(getattr(rtab, fn))(*args_r)
    for c, (g, ref) in enumerate(zip(got, jitted)):
        assert (np.abs(g.numpy() - np.asarray(ref)) <= bound[:, c]).all()


def test_table_force_is_the_gradient():
    """The straight-through table energy: its value is the table's E and
    its r-derivative is minus the table's F, not the interpolant's slope."""
    ef, r0, dr, ti, r = _stack(seed=1, n_q=64)
    args = [torch.from_numpy(a) for a in (ef, r0, dr)]
    rr = torch.from_numpy(r).requires_grad_(True)
    par0 = torch.from_numpy(ti.astype(np.float32))
    e = pbf.table_energy_st(*args, par0, rr)
    (g,) = torch.autograd.grad(e.sum(), rr)
    e_tab, f_tab = ptab.interpolate(*args, torch.from_numpy(ti),
                                    torch.from_numpy(r))
    assert torch.equal(e.detach(), e_tab)
    assert torch.equal(g, -f_tab)


# ---- bonded terms --------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    built, systop = chain_melt(tmp_path_factory.mktemp("chain_tables"))
    return built, systop


def _inputs(chain):
    """The chain melt's state with jitter, F ends and extra dihedrals."""
    built, systop = chain
    cfg, spec, st = built.cfg, built.spec, built.state
    rng = np.random.RandomState(3)
    pos = st.pos.numpy() + rng.normal(0.0, 0.08, st.pos.shape)
    pos = np.mod(pos, st.box.numpy()).astype(np.float32)
    tid = st.type_id.numpy().copy()
    f_type = systop.atomsym_atomtype["F"]
    tid[[0, 8, 15, 20]] = f_type           # ends of chains 0, 2, 3, 5
    d = bridge.tree_to_numpy(st.dihedrals)
    d = {k: np.array(v) for k, v in d.items()}
    n0 = int(d["count"])
    extra = [((16, 17, 18, 19), 1, [1.2, 0.4, 3.0]),
             ((24, 25, 26, 27), 8, [0.0]),
             ((28, 29, 30, 31), 12, [1.5, 0.2]),
             ((2, 5, 9, 14), 1, [0.7, -1.0, 2.0])]
    for k, (idx, func, par) in enumerate(extra):
        row = n0 + k
        d["idx"][row] = idx
        d["func"][row] = func
        d["params"][row] = 0.0
        d["params"][row, :len(par)] = par
        d["typelookup"][row] = False
        d["lam"][row] = 0.5
    d["count"] = np.asarray(n0 + len(extra), np.int32)
    st = dataclasses.replace(
        st, pos=torch.from_numpy(pos), type_id=torch.from_numpy(tid),
        dihedrals=TermTable(**{k: torch.from_numpy(v) for k, v in d.items()}))
    st = pbd.rederive(cfg, st)
    return cfg, spec, st


def _compare(terms_r, terms_p, f_r, f_p):
    assert sorted(terms_r) == sorted(terms_p)
    for k in terms_r:
        r, g = float(terms_r[k]), float(terms_p[k])
        assert abs(g - r) <= 2e-5 * (1.0 + abs(r)), (k, g, r)
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all()
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_r).max()))


@pytest.mark.parametrize("leg", ["flat", "dense"])
def test_bonded_terms_match_reference(chain, leg):
    cfg, spec, st = _inputs(chain)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    assert cfg.dihedral_funcs == (1, 3, 8, 12) and cfg.pair14_cap > 0
    assert set(cfg.bond_funcs) == {1, 8} and set(cfg.angle_funcs) == {1, 8}
    p_dense = pint._dense_of(cfg, st) if leg == "dense" else None
    r_dense = rint._dense_of(rcfg, rst) if leg == "dense" else None
    f_r, e_r = ref_bonded_forces(rspec, rcfg, rst.pos, rst.box, rst.type_id,
                                 rst.q, rst.bonds, rst.angles, rst.dihedrals,
                                 rst.pairs14, dense=r_dense)
    f_p, e_p = pbf.bonded_forces(spec, cfg, st.pos, st.box, st.type_id, st.q,
                                 st.bonds, st.angles, st.dihedrals,
                                 st.pairs14, dense=p_dense)
    # every family and form carries real terms
    for k in ("bond_f8", "angle_f8", "dihedral_f1", "dihedral_f3",
              "dihedral_f8", "dihedral_f12", "lj14"):
        assert float(e_r[k]) != 0.0, k
    _compare(e_r, e_p, f_r, f_p)


@pytest.mark.parametrize("family", ["dihedral", "pair14"])
def test_family_functions_match_reference(chain, family):
    """``dihedral_energies`` and ``pair14_energies`` alone, on the gathered
    rows, with forces by each package's autodiff."""
    cfg, spec, st = _inputs(chain)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    table = "dihedrals" if family == "dihedral" else "pairs14"

    def ref(pos):
        pos4 = jnp.concatenate(
            [pos, rst.type_id.astype(pos.dtype)[:, None]], axis=-1)
        t = getattr(rst, table)
        rows = pos4[jnp.maximum(t.idx, 0)]
        if family == "dihedral":
            out = rbf.dihedral_energies(rspec, rcfg.dihedral_funcs, rows,
                                        rst.box, t)
        else:
            out = rbf.pair14_energies(rspec, rows, rst.box, rst.q, t)
        return sum(out.values()), out

    (_, e_r), g_r = jax.jit(jax.value_and_grad(ref, has_aux=True))(rst.pos)
    p = st.pos.clone().requires_grad_(True)
    pos4 = torch.cat([p, st.type_id.to(p.dtype)[:, None]], dim=-1)
    t = getattr(st, table)
    rows = pos4[torch.clamp(t.idx, min=0).long()]
    if family == "dihedral":
        e_p = pbf.dihedral_energies(spec, cfg.dihedral_funcs, rows, st.box, t)
    else:
        e_p = pbf.pair14_energies(spec, rows, st.box, st.q, t)
    (g_p,) = torch.autograd.grad(sum(e_p.values()), p)
    _compare(e_r, {k: v.detach() for k, v in e_p.items()}, g_r, g_p)


def test_padding_rows_give_finite_forces(chain):
    """A dihedral table of padding rows (every endpoint particle 0) and
    one valid row: the forces are finite, and they equal the valid row's
    alone in both packages (the three distinct unit axes keep the padding
    rows' cross products nonzero)."""
    cfg, spec, st = _inputs(chain)
    rcfg, rspec, rst = reference_trees(cfg, spec, st)
    cfg1 = dataclasses.replace(cfg, bond_funcs=(), angle_funcs=(),
                               pair14_cap=0)
    rcfg1 = dataclasses.replace(rcfg, bond_funcs=(), angle_funcs=(),
                                pair14_cap=0)
    one = TermTable(**{k: torch.from_numpy(v) for k, v in
                       TermTable.create_numpy(
                           1, 4, [(0, 1, 2, 3)], [3],
                           [list(pts.CHAIN_RB)]).items()})
    padded = TermTable(**{k: torch.from_numpy(v) for k, v in
                          TermTable.create_numpy(
                              256, 4, [(0, 1, 2, 3)], [3],
                              [list(pts.CHAIN_RB)]).items()})
    forces = []
    for tab in (one, padded):
        f, e = pbf.bonded_forces(spec, cfg1, st.pos, st.box, st.type_id,
                                 st.q, st.bonds, st.angles, tab, st.pairs14)
        assert torch.isfinite(f).all() and float(e["dihedral_f3"]) != 0.0
        forces.append(f)
    assert torch.equal(forces[0], forces[1])
    r_tab = rstate_mod.TermTable(**{k: jnp.asarray(v.numpy()) for k, v
                                    in dataclasses.asdict(padded).items()})
    f_r, _ = ref_bonded_forces(rspec, rcfg1, rst.pos, rst.box, rst.type_id,
                               rst.q, rst.bonds, rst.angles, r_tab,
                               rst.pairs14)
    np.testing.assert_allclose(forces[1].numpy(), np.asarray(f_r), rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_r).max()))


def test_padding_slots_read_their_own_rows(chain):
    """The dihedrals' and 1-4 pairs' autograd pass gives each padding slot
    a zero row of its own past the particles (one shared row would be a
    serial run of equal indices in the card's backward): the forces are
    bit for bit those of a gather that clamps every padding index to
    particle 0."""
    cfg, spec, st = _inputs(chain)
    cfg = dataclasses.replace(cfg, bond_funcs=(), angle_funcs=())
    assert int((st.dihedrals.idx[:, 0] < 0).sum()) > 0
    assert int((st.pairs14.idx[:, 0] < 0).sum()) > 0
    p = st.pos.clone().requires_grad_(True)
    pos4 = torch.cat([p, st.type_id.to(p.dtype)[:, None]], dim=-1)
    d_rows = pos4[torch.clamp(st.dihedrals.idx, min=0).long()]
    p_rows = pos4[torch.clamp(st.pairs14.idx, min=0).long()]
    terms = {**pbf.dihedral_energies(spec, cfg.dihedral_funcs, d_rows, st.box,
                                     st.dihedrals),
             **pbf.pair14_energies(spec, p_rows, st.box, st.q, st.pairs14)}
    (g,) = torch.autograd.grad(sum(terms.values()), p)
    f, e = pbf.bonded_forces(spec, cfg, st.pos, st.box, st.type_id, st.q,
                             st.bonds, st.angles, st.dihedrals, st.pairs14)
    assert torch.equal(f, -g)
    assert {k: float(v) for k, v in e.items()} \
        == {k: float(v) for k, v in terms.items()}


def _dihedral_rows(pos, type_id, table):
    pos4 = torch.cat([pos, type_id.to(pos.dtype)[:, None]], dim=-1)
    return pos4[torch.clamp(table.idx, min=0).long()]


def test_dihedral_energy_goldens(chain):
    """Hand-computed energies for the harmonic n-cos, Ryckaert-Bellemans
    and harmonic dihedrals on a 90-degree geometry (the port's copy of the
    reference's ``test_hybrid_dihedral.py::test_dihedral_energy_goldens``)."""
    built, _ = chain
    spec, st = built.spec, built.state
    pos = torch.full(st.pos.shape, 2.0)
    # phi = 90 degrees: b1 = x, b2 = y, b3 = z
    pos[0] = torch.tensor([1.0, 0.0, 0.0])
    pos[1] = torch.tensor([2.0, 0.0, 0.0])
    pos[2] = torch.tensor([2.0, 1.0, 0.0])
    pos[3] = torch.tensor([2.0, 1.0, 1.0])
    phi = math.pi / 2

    def energy(func, params):
        t = TermTable(**{k: torch.from_numpy(v) for k, v in
                         TermTable.create_numpy(8, 4, [(0, 1, 2, 3)], [func],
                                                [params]).items()})
        e = pbf.dihedral_energies(spec, (func,),
                                  _dihedral_rows(pos, st.type_id, t),
                                  st.box, t)
        return float(e["dihedral_f%d" % func])

    # func 1: K (1 + cos(n phi - phi0)), K=2, phi0=0.3, n=2
    assert energy(1, [2.0, 0.3, 2.0]) == pytest.approx(
        2.0 * (1 + math.cos(2 * phi - 0.3)), rel=1e-5)
    # func 3: sum Cn cos(psi)^n with psi = phi - pi
    c = [1.0, 0.5, 0.25, 0.1, 0.05, 0.01]
    cpsi = math.cos(phi - math.pi)
    assert energy(3, c) == pytest.approx(
        sum(cn * cpsi**n for n, cn in enumerate(c)), rel=1e-4, abs=1e-5)
    # func 12: K wrap(phi - phi0)^2, K=1.5, phi0=0.2
    assert energy(12, [1.5, 0.2]) == pytest.approx(1.5 * (phi - 0.2) ** 2,
                                                   rel=1e-4)
    # func 8: the chain melt's table_d0, 0.75 (1 + cos(2 phi)) = 0 at 90
    assert energy(8, [0.0]) == pytest.approx(0.0, abs=1e-4)
