"""Bonded terms: energies and autograd forces against the reference's
``jax.value_and_grad``, on the flat (gathered) and the dense (rolled-plane)
legs, and the dense/irregular derivation integer for integer.

Inputs: the 70-trimer melt with seeded numpy jitter on the positions and a
few irregular (reaction-like) bonds and angles with fading lambdas, so both
legs carry real rows.  Energies are f32 sums of ~300 terms taken in another
order: ``1e-5`` relative.  Forces: ``1e-5 * (1 + max|F|)`` (f32 rounding of
a few terms per particle; autograd and jax differ in accumulation order).

FENE + WCA (bond func 9) is compared on the flat leg only, with sigma set
to 1 on the reference's rows of other functions (padding included) and in
its type-lookup table: the reference evaluates the WCA branch on every row
and masks it afterwards, and where sigma is 0 its gradient is 0 * NaN
(``jnp.minimum``'s JVP multiplies the NaN cotangent of 0/0 by 0; ROADMAP
Queue 3).  The port's gradient is finite there, since torch's ``minimum``
routes the cotangent with a select.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import bonded_dense as rbd
from chemlab_tpu.engine import bonded_forces as rbf
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import bonded_dense as pbd
from chemlab_tpu_torch.engine import bonded_forces as pbf

# rows rewritten to other functional forms for the "fene_cos" variant
FENE = [30.0, 0.0, 1.5, 0.0, 0.0, 0.0]
FENE_WCA = [30.0, 0.0, 1.5, 1.0, 1.0, 0.0]
COSINE = [2.5, np.pi, 0.0, 0.0, 0.0, 0.0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are tiny, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tables_np(st, variant: str):
    """The melt's bond/angle tables (numpy) with irregular rows appended."""
    bonds = bridge.tree_to_numpy(st.bonds)
    angles = bridge.tree_to_numpy(st.angles)
    bonds = {k: np.array(v) for k, v in bonds.items()}
    angles = {k: np.array(v) for k, v in angles.items()}
    nb, na = int(bonds["count"]), int(angles["count"])
    extra_b = [(0, 4), (7, 3), (10, 30), (31, 12)]
    extra_a = [(2, 0, 4), (9, 7, 3), (12, 31, 40)]
    for k, (i, j) in enumerate(extra_b):
        r = nb + k
        bonds["idx"][r] = (i, j)
        bonds["func"][r] = 1
        bonds["params"][r, :2] = (15.0, 0.97)
        bonds["lam"][r] = 0.25 * (k + 1)
        bonds["group"][r] = 0
        bonds["typelookup"][r] = k % 2 == 0
    for k, t in enumerate(extra_a):
        r = na + k
        angles["idx"][r] = t
        angles["func"][r] = 1
        angles["params"][r, :2] = (1.25, np.pi)
        angles["lam"][r] = 0.5
        angles["typelookup"][r] = False
    bonds["count"] = np.asarray(nb + len(extra_b), np.int32)
    angles["count"] = np.asarray(na + len(extra_a), np.int32)
    if variant in ("fene_cos", "fene_wca"):
        wca = variant == "fene_wca"
        for r in (1, 2, nb, nb + 1):
            bonds["func"][r] = 9 if wca and r % 2 == 0 else 7
            bonds["params"][r] = FENE_WCA if bonds["func"][r] == 9 else FENE
            bonds["typelookup"][r] = False
        for r in (0, 5, na):
            angles["func"][r] = 11
            angles["params"][r] = COSINE
            angles["typelookup"][r] = False
    return bonds, angles


@pytest.fixture(scope="module")
def melt():
    built, _, _ = rts.build_melt(n_mols=70, reactive=True, use_pallas=True)
    return built


def _inputs(melt, variant):
    rcfg, rspec, rst = melt.cfg, melt.spec, melt.state
    if variant != "harmonic":
        rcfg = dataclasses.replace(
            rcfg, bond_funcs=(1, 7, 9) if variant == "fene_wca" else (1, 7),
            angle_funcs=(1, 11))
    bonds, angles = _tables_np(rst, variant)
    rng = np.random.RandomState(2)
    pos = np.asarray(rst.pos) + rng.normal(0.0, 0.05, rst.pos.shape)
    pos = np.mod(pos, np.asarray(rst.box)).astype(np.float32)
    rst = dataclasses.replace(
        rst, pos=jnp.asarray(pos),
        bonds=type(rst.bonds)(**{k: jnp.asarray(v) for k, v in bonds.items()}),
        angles=type(rst.angles)(**{k: jnp.asarray(v)
                                   for k, v in angles.items()}))
    rst = rbd.rederive(rcfg, rst)
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, rst, "cpu")
    pst = pbd.rederive(cfg, pst)
    return rcfg, rspec, rst, cfg, spec, pst


@pytest.mark.parametrize("variant", ["harmonic", "fene_cos"])
def test_rederive_matches_reference(melt, variant):
    rcfg, _, rst, cfg, _, pst = _inputs(melt, variant)
    for name in ("bonds_dense", "bonds_irr", "angles_dense", "angles_irr"):
        ref = bridge.tree_to_numpy(getattr(rst, name))
        got = bridge.tree_to_numpy(getattr(pst, name))
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k],
                                          err_msg="%s.%s" % (name, k))
    assert int(pst.bonds_irr.count) > 0 and int(pst.angles_irr.count) > 0
    assert bool(pst.nbr.overflow) == bool(rst.nbr.overflow)


@pytest.mark.parametrize("variant", ["harmonic", "fene_cos"])
@pytest.mark.parametrize("leg", ["flat", "dense"])
def test_bonded_energies_and_forces_match(melt, leg, variant):
    rcfg, rspec, rst, cfg, spec, pst = _inputs(melt, variant)
    if leg == "dense":
        r_dense = (rst.bonds_dense, rst.bonds_irr, rst.angles_dense,
                   rst.angles_irr)
        p_dense = (pst.bonds_dense, pst.bonds_irr, pst.angles_dense,
                   pst.angles_irr)
    else:
        r_dense = p_dense = None
    f_r, e_r = rbf.bonded_forces(rspec, rcfg, rst.pos, rst.box, rst.type_id,
                                 rst.q, rst.bonds, rst.angles, rst.dihedrals,
                                 rst.pairs14, dense=r_dense)
    f_p, e_p = pbf.bonded_forces(spec, cfg, pst.pos, pst.box, pst.type_id,
                                 pst.bonds, pst.angles, dense=p_dense)
    assert sorted(e_r) == sorted(e_p)
    for k in e_r:
        r, g = float(e_r[k]), float(e_p[k])
        assert abs(g - r) <= 1e-5 * (1.0 + abs(r)), (k, g, r)
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all()
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(f_r).max()))


def test_fene_wca_forces_match_with_finite_padding(melt):
    rcfg, rspec, rst, cfg, spec, pst = _inputs(melt, "fene_wca")
    assert (np.asarray(rst.bonds.func) == 9).any()
    # sigma 1 on the reference's non-WCA rows (masked out either way)
    par = np.array(rst.bonds.params)
    par[np.asarray(rst.bonds.func) != 9, 3] = 1.0
    r_bonds = dataclasses.replace(rst.bonds, params=jnp.asarray(par))
    par_tt = np.array(rspec.bond_par_tt)
    par_tt[..., 3] = np.where(par_tt[..., 3] == 0.0, 1.0, par_tt[..., 3])
    rspec = dataclasses.replace(rspec, bond_par_tt=jnp.asarray(par_tt))
    f_r, e_r = rbf.bonded_forces(rspec, rcfg, rst.pos, rst.box, rst.type_id,
                                 rst.q, r_bonds, rst.angles, rst.dihedrals,
                                 rst.pairs14)
    f_p, e_p = pbf.bonded_forces(spec, cfg, pst.pos, pst.box, pst.type_id,
                                 pst.bonds, pst.angles)
    for k in e_r:
        assert abs(float(e_p[k]) - float(e_r[k])) \
            <= 1e-5 * (1.0 + abs(float(e_r[k]))), k
    f_r = np.asarray(f_r)
    assert np.isfinite(f_r).all() and np.isfinite(f_p.numpy()).all()
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=1e-5 * (1.0 + np.abs(f_r).max()))


def test_dense_and_flat_legs_agree(melt):
    """Inside the port: both legs give the same energies and forces."""
    _, _, _, cfg, spec, pst = _inputs(melt, "fene_wca")
    args = (spec, cfg, pst.pos, pst.box, pst.type_id, pst.bonds, pst.angles)
    f_flat, e_flat = pbf.bonded_forces(*args)
    f_dense, e_dense = pbf.bonded_forces(
        *args, dense=(pst.bonds_dense, pst.bonds_irr, pst.angles_dense,
                      pst.angles_irr))
    for k in e_flat:
        assert abs(float(e_dense[k]) - float(e_flat[k])) \
            <= 1e-5 * (1.0 + abs(float(e_flat[k])))
    torch.testing.assert_close(f_dense, f_flat, rtol=0,
                               atol=1e-5 * (1.0 + f_flat.abs().max().item()))


def test_dihedrals_are_outside_the_slice(melt):
    cfg, spec, st = bridge.from_trees(melt.cfg, melt.spec, melt.state, "cpu")
    cfg = dataclasses.replace(cfg, dihedral_funcs=(1,))
    with pytest.raises(NotImplementedError, match="M4"):
        pbf.bonded_energy_terms(spec, cfg, st.pos, st.box, st.type_id,
                                st.bonds, st.angles)
