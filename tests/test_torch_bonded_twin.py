"""The bonded kernel's plain twin (``bond_angle_forces_plain``, which the
port runs for CPU tensors and the card tests hold the kernel to) against
the reference's ``jax.value_and_grad`` of the bonds and angles, case by
case: each functional form the kernel evaluates, on the dense (rolled
planes and irregular remainder) and the flat legs.

Cases: the 70-trimer melt of ``test_torch_bonded`` (jitter, irregular rows
with type lookups and lambdas below 1) with harmonic bonds and angles
(func 1), FENE bonds and cosine angles (7, 11), and FENE + WCA bonds (9,
the flat leg, with the reference's sigma set to 1 where it would divide 0
by 0: see that file); the 40-tetramer chain melt of
``test_torch_bonded_tab`` (jitter, F ends turned) with tabulated bonds and
angles (8) beside func 1.  The reference runs with no dihedral or 1-4
term.  Tolerances are those of the two files: energies and forces within
``1e-5`` (melt) and ``2e-5`` (chain) of ``1 + |ref|``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_bonded as tb
import test_torch_bonded_tab as tt
from chemlab_tpu.engine import bonded_forces as rbf
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu_torch.engine import bonded_forces as pbf
from chemlab_tpu_torch.engine import integrate as pint

from test_torch_bonded import _one_torch_thread, melt  # noqa: F401
from test_torch_bonded_tab import chain  # noqa: F401

CASES = ["harmonic-dense", "harmonic-flat", "fene_cos-dense", "fene_cos-flat",
         "fene_wca-flat", "tab-dense", "tab-flat"]


def _melt_case(melt, variant, leg):
    rcfg, rspec, rst, cfg, spec, pst = tb._inputs(melt, variant)
    r_bonds = rst.bonds
    if variant == "fene_wca":
        par = np.array(rst.bonds.params)
        par[np.asarray(rst.bonds.func) != 9, 3] = 1.0
        r_bonds = dataclasses.replace(rst.bonds, params=jnp.asarray(par))
        par_tt = np.array(rspec.bond_par_tt)
        par_tt[..., 3] = np.where(par_tt[..., 3] == 0.0, 1.0, par_tt[..., 3])
        rspec = dataclasses.replace(rspec, bond_par_tt=jnp.asarray(par_tt))
    r_dense = p_dense = None
    if leg == "dense":
        r_dense = (rst.bonds_dense, rst.bonds_irr, rst.angles_dense,
                   rst.angles_irr)
        p_dense = pint._dense_of(cfg, pst)
    f_r, e_r = rbf.bonded_forces(rspec, rcfg, rst.pos, rst.box, rst.type_id,
                                 rst.q, r_bonds, rst.angles, rst.dihedrals,
                                 rst.pairs14, dense=r_dense)
    return cfg, spec, pst, p_dense, f_r, e_r, 1e-5


def _chain_case(chain, leg):
    cfg, spec, st = tt._inputs(chain)
    cfg = dataclasses.replace(cfg, dihedral_funcs=(), pair14_cap=0)
    rcfg, rspec, rst = tt.reference_trees(cfg, spec, st)
    p_dense = pint._dense_of(cfg, st) if leg == "dense" else None
    r_dense = rint._dense_of(rcfg, rst) if leg == "dense" else None
    f_r, e_r = tt.ref_bonded_forces(rspec, rcfg, rst.pos, rst.box,
                                    rst.type_id, rst.q, rst.bonds, rst.angles,
                                    rst.dihedrals, rst.pairs14, dense=r_dense)
    return cfg, spec, st, p_dense, f_r, e_r, 2e-5


@pytest.mark.parametrize("case", CASES)
def test_twin_matches_reference(melt, chain, case):  # noqa: F811
    variant, leg = case.rsplit("-", 1)
    if variant == "tab":
        cfg, spec, st, dense, f_r, e_r, tol = _chain_case(chain, leg)
    else:
        cfg, spec, st, dense, f_r, e_r, tol = _melt_case(melt, variant, leg)
    f_p, e_p = pbf.bond_angle_forces_plain(spec, cfg, st.pos, st.box,
                                           st.type_id, st.bonds, st.angles,
                                           dense)
    assert sorted(e_r) == sorted(e_p)
    forms = {"harmonic": {"bond_f1", "angle_f1"},
             "fene_cos": {"bond_f7", "angle_f11"},
             "fene_wca": {"bond_f9"}, "tab": {"bond_f8", "angle_f8"}}
    for k in e_r:
        r, g = float(e_r[k]), float(e_p[k])
        assert abs(g - r) <= tol * (1.0 + abs(r)), (k, g, r)
    for k in forms[variant]:
        assert float(e_r[k]) != 0.0, k
    f_r = np.asarray(f_r)
    assert np.isfinite(f_p.numpy()).all()
    np.testing.assert_allclose(f_p.numpy(), f_r, rtol=0,
                               atol=tol * (1.0 + np.abs(f_r).max()))
