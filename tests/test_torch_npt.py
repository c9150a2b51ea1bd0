"""Pressure and NPT on the kernel path: port vs reference.

``virial_pressure`` takes the pair virial from the kernel's own channel
(K2 on the 2x2x2 and cap-36 grids, K1c on the tabulated melt), subtracts the
excluded pairs' share and the bonded strain derivative; ``_barostat_step``
scales the box and the positions (Berendsen 'br', Langevin piston 'lv');
``md_step`` runs it once per step after the thermostat.  The reference runs
its Pallas kernels in interpret mode on the CPU, the port their plain
versions.  The Langevin barostat's draw is a ``jax.random`` threefry number
that torch cannot reproduce, so the tests hand the reference's draw to the
port.

Tolerances, each with its reason:
  - the virial W: ``2e-5 * (1 + |W_pair| + |W_bonded|)``, the f32 rounding
    of pair and bond sums taken in another order (W is a difference of
    terms of that size);
  - one barostat step: box and positions ``1e-6`` relative (mu is 1 to a
    few 1e-5, so a 1e-5 relative difference in P moves it below f32
    resolution), ``baro_v`` ``1e-5``;
  - 20 NVE steps under 'br': box ``1e-5`` relative, positions ``1e-4``
    (the force rounding integrated over 20 steps of dt 0.0025);
  - ``measure``: ``1e-4`` (as for the other observables).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import bonded_forces as rbf
from chemlab_tpu.engine import integrate as rint
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch import testsystems as pts
from chemlab_tpu_torch.engine import bonded_forces, cell_pair
from chemlab_tpu_torch.engine import integrate as pint
from chemlab_tpu_torch.engine import observables
from chemlab_tpu_torch.engine import runner as prun

NPT = dict(barostat="br", pressure=0.15, barostat_tau=2.0,
           store_pressure=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small, and pytest-xdist workers share the
    cores: one intra-op thread each avoids oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _default_kernel_choice(monkeypatch):
    monkeypatch.delenv("CHEMLAB_KERNEL", raising=False)
    monkeypatch.delenv("CHEMLAB_PACKET", raising=False)


def _reference(kind: str):
    if kind == "grid222":
        built, _, _ = rts.build_melt(n_mols=40, density=0.3, reactive=False,
                                     seed=3, use_pallas=True, **NPT)
    elif kind == "cap36":
        built, _, _ = rts.build_melt(n_mols=70, reactive=True,
                                     use_pallas=True, cell_cap=36)
    else:
        built, _, _ = rts.build_tabulated_melt(n_mols=70, reactive=True,
                                               use_pallas=True)
    st = rrun.initial_forces(built.spec, built.cfg, built.state)
    st = rts.warmup(built, st, steps=30, chunk=30)
    return built.cfg, built.spec, st


@pytest.fixture(scope="module")
def systems():
    return {k: _reference(k) for k in ("grid222", "cap36", "tab")}


def _port(ref):
    return bridge.from_trees(*ref, "cpu")


def _pieces(cfg, spec, st):
    """The port's (W_pair, W_bonded) of ``virial_pressure``."""
    obs_x = (observables.conversions(spec, st.type_id, st.chem_state,
                                     st.active) if cfg.cheb_mix else None)
    w_all = cell_pair.cell_pair_forces(
        st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
        st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types,
        uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj, want_virial=True,
        cheb_kw=cfg.cheb_kw if cfg.tab_cheb else 0, cheb_ko=cfg.cheb_ko,
        cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix, obs_x=obs_x)[3]
    w_ex = pint._excl_correction(spec, cfg, st, obs_x)[3]
    du = bonded_forces.bonded_strain_derivative(
        spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds, st.angles,
        st.dihedrals, st.pairs14, dense=pint._dense_of(cfg, st))
    return float(w_all - w_ex), -float(du)


@pytest.mark.parametrize("kind", ["grid222", "cap36", "tab"])
def test_virial_pressure_matches(systems, kind):
    rcfg, rspec, rst = systems[kind]
    cfg, spec, st = _port(systems[kind])
    if kind == "tab":
        assert cfg.tab_cheb and cell_pair.colt_legal(cfg.cell_cap,
                                                     cfg.cell_dims)
    else:
        assert not cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims)
    p_r = float(jax.jit(lambda s: rint.virial_pressure(rspec, rcfg, s))(rst))
    p_p = pint.virial_pressure(spec, cfg, st)
    w_pair, w_bond = _pieces(cfg, spec, st)
    assert w_pair != 0.0 and w_bond != 0.0
    vol = float(np.prod(np.asarray(rst.box, np.float64)))
    ekin = float(observables.kinetic_energy(st.mass, st.vel, st.active))
    w_ref = 3.0 * vol * p_r - 2.0 * ekin
    w_port = 3.0 * vol * float(p_p) - 2.0 * ekin
    assert abs((w_pair + w_bond) - w_port) <= 1e-5 * (1.0 + abs(w_port))
    assert abs(w_port - w_ref) <= 2e-5 * (1.0 + abs(w_pair) + abs(w_bond)), \
        (w_port, w_ref, w_pair, w_bond)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
def test_bonded_strain_derivative_matches(systems, dense):
    """dU_bonded/ds through the rolled-plane operands and through the flat
    tables, against ``jax.grad`` of the reference's bonded energy."""
    rcfg, rspec, rst = systems["cap36"]
    cfg, spec, st = _port(systems["cap36"])
    r_dense = rint._dense_of(rcfg, rst) if dense else None
    p_dense = pint._dense_of(cfg, st) if dense else None
    assert (r_dense is not None) == dense

    def u(s):
        terms = rbf.bonded_energy_terms(
            rspec, rcfg, rst.pos * s, rst.box * s, rst.type_id, rst.q,
            rst.bonds, rst.angles, rst.dihedrals, rst.pairs14, dense=r_dense)
        return sum(terms.values())

    ref = float(jax.grad(u)(jnp.asarray(1.0, jnp.float32)))
    got = bonded_forces.bonded_strain_derivative(
        spec, cfg, st.pos, st.box, st.type_id, st.q, st.bonds, st.angles,
        st.dihedrals, st.pairs14, dense=p_dense)
    assert got.shape == () and ref != 0.0
    assert abs(float(got) - ref) <= 1e-5 * (1.0 + abs(ref)), (float(got), ref)
    # no bonded term: 0, not None
    empty = dataclasses.replace(cfg, bond_funcs=(), angle_funcs=())
    zero = bonded_forces.bonded_strain_derivative(
        spec, empty, st.pos, st.box, st.type_id, st.q, st.bonds, st.angles,
        st.dihedrals, st.pairs14)
    assert float(zero) == 0.0


def _lv(cfg):
    return dataclasses.replace(cfg, barostat="lv")


@pytest.mark.parametrize("barostat", ["br", "lv"])
def test_barostat_step_matches(systems, barostat):
    rcfg, rspec, rst = systems["grid222"]
    cfg, spec, st = _port(systems["grid222"])
    assert rcfg.barostat == cfg.barostat == "br"
    if barostat == "lv":
        rcfg, cfg = _lv(rcfg), _lv(cfg)
        rst = dataclasses.replace(rst, baro_v=jnp.asarray(0.3, jnp.float32))
        st = dataclasses.replace(st, baro_v=torch.tensor(0.3))
    key = jax.random.PRNGKey(11)
    draw = float(jax.random.normal(key, ()))
    r = rint._barostat_step(rspec, rcfg, rst, key)
    p = pint._barostat_step(spec, cfg, st,
                            torch.tensor(draw) if barostat == "lv" else None)
    box_r = np.asarray(r.box)
    assert np.all(box_r != np.asarray(rst.box))
    np.testing.assert_allclose(p.box.numpy(), box_r, rtol=1e-6, atol=0)
    np.testing.assert_allclose(p.pos.numpy(), np.asarray(r.pos), rtol=0,
                               atol=1e-6 * float(box_r.max()))
    assert abs(float(p.baro_v) - float(r.baro_v)) <= 1e-5
    if barostat == "br":
        assert float(p.baro_v) == 0.0


def test_nve_20_steps_under_berendsen_match(systems):
    rcfg, rspec, rst = systems["grid222"]
    cfg, spec, pst = _port(systems["grid222"])
    rcfg = dataclasses.replace(rcfg, thermostat="no")
    cfg = dataclasses.replace(cfg, thermostat="no")
    step = jax.jit(lambda s: rint.md_step(rspec, rcfg, s))
    n0 = cell_pair.K2.launches
    for _ in range(20):
        rst = step(rst)
        pst = pint.md_step(spec, cfg, pst)
    assert cell_pair.K2.launches == n0     # plain version on the CPU
    box0 = np.asarray(systems["grid222"][2].box)
    box_r = np.asarray(rst.box)
    assert np.all(box_r != box0)
    np.testing.assert_allclose(pst.box.numpy(), box_r, rtol=1e-5, atol=0)
    np.testing.assert_allclose(pst.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(pst.image.numpy(), np.asarray(rst.image))


def test_measure_with_pressure_matches(systems):
    rcfg, rspec, rst = systems["grid222"]
    cfg, spec, st = _port(systems["grid222"])
    m_r = rrun.measure(rspec, rcfg, rst)
    m_p = prun.measure(spec, cfg, st)
    assert "P" in m_p and "boxL" in m_p
    assert sorted(m_p) == sorted(m_r)
    for k, v in m_r.items():
        v = np.asarray(v)
        if v.dtype.kind == "f":
            np.testing.assert_allclose(m_p[k].numpy(), v, rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(m_p[k].numpy(), v, err_msg=k)


def test_langevin_barostat_draws_after_the_thermostat(systems):
    """Under 'lv' with a generator, ``md_step`` draws the Langevin noise
    first and the barostat's scalar after it; without either it raises."""
    cfg, spec, st = _port(systems["grid222"])
    cfg = _lv(cfg)
    a = pint.md_step(spec, cfg, st, gen=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(st.vel.shape, generator=g)
    b = pint.md_step(spec, cfg, st, noise=noise,
                     baro_noise=torch.randn((), generator=g))
    for name in ("pos", "vel", "box", "baro_v"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=0)
    assert float(a.baro_v) != 0.0
    with pytest.raises(ValueError, match="Generator"):
        pint.md_step(spec, cfg, st, noise=noise)


def test_npt_runs_on_the_kernel_path():
    """The reference's ``test_npt_runs_on_pallas_fast_path`` on the port: a
    barostatted run on the K2 grid stays finite and moves the box."""
    built, _, _ = pts.build_melt(n_mols=40, density=0.3, reactive=False,
                                 seed=3, use_pallas=True, device="cpu", **NPT)
    spec, cfg = built.spec, built.cfg
    assert cfg.use_pallas and cfg.barostat == "br"
    st = prun.initial_forces(spec, cfg, built.state)
    st = pts.warmup(built, st, steps=60)
    box0 = float(st.box[0])
    st = prun.run_block(spec, cfg, st, 120, gen=prun.make_generator(0, "cpu"))
    assert np.isfinite(float(st.pos.sum()))
    assert np.isfinite(float(pint.virial_pressure(spec, cfg, st)))
    assert float(st.box[0]) != box0
