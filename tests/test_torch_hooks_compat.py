"""Reference-hooks compatibility on the port: the Python-2 translation, the
espressopp shim, the storage adapters and ``SimulationContext``, held to
the reference's ``hooks_compat`` on the same input (mirroring
``test_hooks_compat.py``)."""

import dataclasses
import os
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from chemlab_tpu import hooks_compat as rhooks
from chemlab_tpu import testsystems as rts
from chemlab_tpu.start_simulation import SimulationContext as RContext
from chemlab_tpu_torch import bridge, hooks_compat
from chemlab_tpu_torch.start_simulation import (SimulationContext,
                                                _call_hook, _load_hooks)

_ESPP = ("espressopp", "espressopp.analysis")


@pytest.fixture(autouse=True)
def _own_espp_shim():
    """Each package's hook path registers its own ``espressopp`` stand-in in
    ``sys.modules`` and keeps one it finds there: each test here starts
    without one and leaves the entries as it found them, so that no test
    hands one package's stand-in to the other's on the same worker."""
    saved = {k: sys.modules.pop(k, None) for k in _ESPP}
    yield
    for k, v in saved.items():
        if v is None:
            sys.modules.pop(k, None)
        else:
            sys.modules[k] = v


EXAMPLE_HOOKS = os.path.join(os.path.dirname(__file__), "..", "examples",
                             "atrp_melt", "hooks.py")


def test_py2_print_translation_matches():
    src = textwrap.dedent("""\
        def hook_end(system, integrator, ar, gt, args):
            xs = [1, 2]
            print xs
            print ('ok {}'.format(len(xs)))
            return True
    """)
    out = hooks_compat.py2_to_py3(src)
    assert out == rhooks.py2_to_py3(src)
    ns = {}
    exec(compile(out, "<t>", "exec"), ns)
    assert ns["hook_end"](None, None, None, None, None) is True
    assert hooks_compat.py2_to_py3("x = 1\n") == "x = 1\n"
    assert hooks_compat.py2_to_py3("def f(:\n") is None


def test_random_compat_sample_accepts_sets():
    rc = hooks_compat._RandomCompat()
    picked = rc.sample({10, 20, 30, 40}, 2)
    assert len(picked) == 2 and set(picked) <= {10, 20, 30, 40}
    assert rc.randint(1, 1) == 1


def test_espp_shim_importable():
    hooks_compat.install_espp_shim()
    import espressopp
    assert hasattr(espressopp.analysis, "MaxPID")
    assert hasattr(espressopp.analysis, "AngleDistribution")


@pytest.fixture(scope="module")
def melt():
    built, systop, _ = rts.build_melt(n_mols=40, reactive=True)
    _, _, st = bridge.from_trees(built.cfg, built.spec, built.state, "cpu")
    return built, systop, st


@pytest.fixture
def ctxs(melt):
    """A fresh (reference, port) pair of contexts on the same state."""
    built, systop, st = melt
    return (RContext(args=None, systop=systop, built=built,
                     state=built.state),
            SimulationContext(args=None, systop=systop, built=None,
                              state=st))


def test_storage_adapter_roundtrip_matches(ctxs):
    rctx, ctx = ctxs
    for mod, c in ((rhooks, rctx), (hooks_compat, ctx)):
        session = mod.HookSession(c)
        storage = session.system.storage
        assert storage.particleExists(1) and not storage.particleExists(0)
        p = storage.getParticle(1)
        storage.modifyParticle(1, "type", p.type + 1)
        storage.modifyParticle(1, "state", 7)
        storage.modifyParticle(1, "mass", 2.5)
        storage.modifyParticle(2, "pos", [0.5, 0.25, 0.125])
        session.commit()
    st = ctx.device_state
    assert isinstance(st.type_id, torch.Tensor)
    for name in ("type_id", "chem_state", "mass", "pos"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(rctx.state, name)),
                                      err_msg=name)
    assert st.type_id.dtype == torch.int32 and st.mass.dtype == torch.float32
    assert float(st.mass[0]) == pytest.approx(2.5)


def test_max_pid_and_angle_distribution_match(ctxs):
    rctx, ctx = ctxs
    rhooks.install_espp_shim()
    import espressopp
    got, ref = [], []
    for mod, c, out in ((rhooks, rctx, ref), (hooks_compat, ctx, got)):
        session = mod.HookSession(c)
        out.append(espressopp.analysis.MaxPID(session.system).compute())
        # the shim registered first serves both: compute with each
        # package's own adapter class
        obs = mod._AngleDistribution(session.system)
        obs.load_from_topology_manager(session.system.topology_manager)
        out.append(obs.compute(50))
    assert got[0] == ref[0] == int(ctx.device_state.active.sum())
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[1].sum() == int((ctx.device_state.angles.idx[:, 0]
                                >= 0).sum())


def test_host_view_and_modify_particle(ctxs):
    """Hooks read numpy arrays whatever the device; ``modify_particle``
    writes the state's own tensors."""
    _, ctx = ctxs
    before = ctx.device_state
    assert isinstance(ctx.state.type_id, np.ndarray)
    assert isinstance(ctx.state.bonds.idx, np.ndarray)
    ctx.modify_particle(3, type=5, state=3, lambda_adr=0.5)
    st = ctx.device_state
    assert int(st.type_id[2]) == 5 and int(st.chem_state[2]) == 3
    assert float(st.lam[2]) == 0.5
    assert st.type_id.dtype == torch.int32
    assert int(before.type_id[2]) != 5      # the old tensors are untouched
    np.testing.assert_array_equal(ctx.state.type_id, st.type_id.numpy())


@pytest.mark.parametrize("how", ["modify_particle", "modifyParticle"])
def test_charge_write_over_skipped_coulomb_raises(melt, how):
    """A build with a Coulomb cutoff over zero charges leaves the Coulomb
    term out (the kernel path), so a hook that charges an atom must raise,
    naming the row path, and one that writes a zero charge must not."""
    built, systop, st = melt
    _, spec, _ = bridge.from_trees(built.cfg, built.spec, built.state, "cpu")
    spec = dataclasses.replace(spec, qq_cutoff2=torch.tensor(0.81))
    ctx = SimulationContext(args=None, systop=systop,
                            built=types.SimpleNamespace(spec=spec), state=st)

    def write(q):
        if how == "modify_particle":
            ctx.modify_particle(3, q=q)
        else:
            session = hooks_compat.HookSession(ctx)
            session.system.storage.modifyParticle(3, "q", q)
            session.commit()

    write(0.0)
    assert float(ctx.device_state.q[2]) == 0.0
    with pytest.raises(NotImplementedError, match="left Coulomb out.*"
                       "use_pallas=False"):
        write(0.5)
    assert not bool(ctx.device_state.q.any())


def test_example_hook_runs_on_both(ctxs):
    """``examples/atrp_melt/hooks.py`` picks the same 20 rows on both."""
    rctx, ctx = ctxs
    args = types.SimpleNamespace(rng_seed=11)
    for c in (rctx, ctx):
        c.args = args
    from chemlab_tpu.start_simulation import _call_hook as rcall
    from chemlab_tpu.start_simulation import _load_hooks as rload
    assert rcall(rload(EXAMPLE_HOOKS), "hook_init_reaction", rctx)
    assert _call_hook(_load_hooks(EXAMPLE_HOOKS), "hook_init_reaction", ctx)
    for name in ("type_id", "chem_state"):
        np.testing.assert_array_equal(
            getattr(ctx.device_state, name).numpy(),
            np.asarray(getattr(rctx.state, name)), err_msg=name)
