"""The pair-kernel ladder (K1' and K3a-K3d) and the kernel choice: port vs
reference.

The reference runs its Pallas variants in interpret mode on the CPU
(``pallas_pair_variants``; colt1 through ``pallas_pair.cell_pair_forces``
under ``CHEMLAB_KERNEL=colt1``); the port runs the kernels' plain torch
versions (what ``cell_pair_variants.ladder_cells`` takes for CPU tensors).
The reference picks its kernel from ``CHEMLAB_KERNEL``; the port from the
``kernel`` (``pair_kernel``) keyword: each test sets the one to the name it
passes as the other.  This file holds each wrapper, the cancellation and
the step path on the first grid below; ``test_torch_ladder_grids.py``
(which takes its helpers from here) holds the dispatcher on all three, K3d
on the K2 grids, the plain versions against plain K2 and the pressure.
The grids:

  - "melt": the 70-trimer reactive melt (3x3x3 cells, cap 24), where every
    kernel is legal;
  - "cap36": the same melt at ``cell_cap=36`` (a K2 grid: only K3d of the
    ladder takes it);
  - "grid222": the 40-trimer melt at density 0.3 under the Berendsen
    barostat (2x2x2 cells, cap 40, S = 8).

Tolerances, each with its reason:
  - forces ``2e-5 * (1 + max|F_ref|)``: per-slot f32 sums of a few hundred
    terms in another order (the reference sums a lane tile, the port a
    vector reduction);
  - energies and virials ``1e-5`` relative: sums over ~10^4-10^5 pairs in
    another order;
  - the K3 plain versions against plain K2: bit for bit (the same pairs in
    the same order);
  - 30 NVE steps: positions ``1e-4`` (the force rounding above integrated
    over 30 steps), event lists exactly;
  - the pressure: ``2e-5 * (1 + |W_pair| + |W_bonded|)`` on W, as in
    ``test_torch_npt.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chemlab_tpu import testsystems as rts
from chemlab_tpu.engine import pallas_pair
from chemlab_tpu.engine import pallas_pair_variants as rvar
from chemlab_tpu.engine import runner as rrun
from chemlab_tpu_torch import bridge
from chemlab_tpu_torch.engine import cell_pair, neighbor
from chemlab_tpu_torch.engine import cell_pair_variants as variants
from chemlab_tpu_torch.engine import runner as prun
from chemlab_tpu_torch.engine.spec import PAIR_LJ

NPT = dict(barostat="br", pressure=0.15, barostat_tau=2.0,
           store_pressure=True)
GRIDS = ("melt", "cap36", "grid222")
# the kernel each name takes on each grid, by the reference's rule
# (pallas_pair.py:828-874)
ROUTES = {
    "melt": dict(auto="K1", cell="K2", colt="K1", colt1="K1p", colt2="K1",
                 packet="K3a", column="K3c", resident="K3b"),
    "cap36": dict(auto="K2", cell="K2", colt="K2", colt1="K2", colt2="K2",
                  packet="K2", column="K3d", resident="K2"),
    "grid222": dict(auto="K2", cell="K2", colt="K2", colt1="K2", colt2="K2",
                    packet="K3a", column="K3c", resident="K3b"),
}
KIND_OF = {"K3a": "packet", "K3b": "resident", "K3c": "colz",
           "K3d": "column", "K1p": "colt1"}


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
    """The reference reads its kernel from the environment: each test sets
    it explicitly, or finds it unset."""
    monkeypatch.delenv("CHEMLAB_KERNEL", raising=False)
    monkeypatch.delenv("CHEMLAB_PACKET", raising=False)


class _Reference:
    """The reference's melts and its dispatcher's results, each made once
    per module (colt1 in interpret mode takes ~10 s a call)."""

    def __init__(self):
        self._melts = {}
        self._calls = {}

    def melt(self, grid: str):
        if grid not in self._melts:
            if grid == "grid222":
                built, systop, _ = rts.build_melt(
                    n_mols=40, density=0.3, reactive=False, seed=3,
                    use_pallas=True, **NPT)
            else:
                built, systop, _ = rts.build_melt(
                    n_mols=70, reactive=True, use_pallas=True,
                    **(dict(cell_cap=36) if grid == "cap36" else {}))
            st = rrun.initial_forces(built.spec, built.cfg, built.state)
            st = rts.warmup(built, st, steps=30, chunk=30)
            self._melts[grid] = (built, systop, st)
        return self._melts[grid]

    def dispatch(self, grid: str, name: str):
        """``pallas_pair.cell_pair_forces`` with ``CHEMLAB_KERNEL=name``
        (unset for "auto"), as numpy."""
        if (grid, name) not in self._calls:
            built, _, st = self.melt(grid)
            cfg = built.cfg
            with pytest.MonkeyPatch.context() as mp:
                if name == "auto":
                    mp.delenv("CHEMLAB_KERNEL", raising=False)
                else:
                    mp.setenv("CHEMLAB_KERNEL", name)
                out = pallas_pair.cell_pair_forces(
                    st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
                    cfg.cell_dims, built.spec, cfg.n_types, cfg.cell_cap,
                    interpret=True, uniform_lj=cfg.uniform_lj,
                    all_lj=cfg.all_lj, slot_of=st.nbr.slot_of)
            self._calls[(grid, name)] = tuple(np.asarray(x) for x in out)
        return self._calls[(grid, name)]


@pytest.fixture(scope="module")
def ref():
    return _Reference()


def _port(built, st):
    return bridge.from_trees(built.cfg, built.spec, st, "cpu")


def _mixed(cfg, rspec, spec):
    """Per-type-pair sigma/epsilon (symmetric) and one non-LJ type pair on
    both sides, so the lookup and its is-LJ gate are exercised."""
    T = cfg.n_types
    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (T, T)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (T, T)).astype(np.float32)
    kind = np.full((T, T), PAIR_LJ, np.int32)
    kind[0, 1] = kind[1, 0] = 0
    new = {"pair_sig": ((s + s.T) / 2).reshape(-1),
           "pair_eps": ((e + e.T) / 2).reshape(-1),
           "pair_kind": kind.reshape(-1)}
    return (dataclasses.replace(rspec, **{k: jnp.asarray(v)
                                          for k, v in new.items()}),
            dataclasses.replace(spec, **{k: torch.from_numpy(v)
                                         for k, v in new.items()}))


def _assert_close(port, ref_out):
    """(force, e_lj, e_tab, w) of the port against the reference's."""
    f_r = np.asarray(ref_out[0])
    f_p = port[0].numpy()
    assert np.isfinite(f_p).all() and np.abs(f_r).max() > 0
    np.testing.assert_allclose(f_p, f_r, rtol=0,
                               atol=2e-5 * (1.0 + np.abs(f_r).max()))
    for k in (1, 2, 3):
        r, p = float(ref_out[k]), float(port[k])
        assert abs(p - r) <= 1e-5 * (1.0 + abs(r)), (k, p, r)


def _operands(cfg, spec, st):
    """The ladder's (cells, counts, box, params) of a port state."""
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    return cells, counts, st.box, cell_pair.pair_params(spec, cfg.n_types)


# ---- each wrapper against the reference's -----------------------------------

@pytest.mark.parametrize("kind", ["packet", "resident", "colz", "column",
                                  "colt1"])
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "lookup"])
def test_wrapper_matches_reference(ref, kind, uniform):
    """The port's wrapper of each ladder kernel against the reference's on
    the melt (3x3x3, cap 24): K3a, K3b, K3c (``z_unroll``), K3d
    (``z_unroll=False``) return (force, e, 0, w) in one pass; colt1 its
    energy (uniform) or its virial (the lookup, ``want_virial``)."""
    built, _, rst = ref.melt("melt")
    rcfg, rspec = built.cfg, built.spec
    cfg, spec, st = _port(built, rst)
    if not uniform:
        rspec, spec = _mixed(rcfg, rspec, spec)
    rargs = (rst.pos, rst.type_id, rst.active, rst.box, rst.nbr.buckets,
             rcfg.cell_dims, rspec, rcfg.n_types, rcfg.cell_cap)
    pargs = (st.pos, st.type_id, st.active, st.box, st.nbr.buckets,
             st.nbr.slot_of, cfg.cell_dims, spec, cfg.n_types)
    n0 = [k.launches for k in cell_pair.KERNELS]
    if kind == "colt1":
        if uniform:
            r = ref.dispatch("melt", "colt1")
        else:
            r = pallas_pair.cell_pair_forces_colt(
                *rargs, interpret=True, uniform_lj=False,
                slot_of=rst.nbr.slot_of, want_virial=True, impl="colt")
        p = variants.cell_pair_forces_colt1(*pargs, uniform_lj=uniform,
                                            want_virial=not uniform)
        assert (float(p[3]) != 0.0) == (not uniform)
    else:
        if kind == "packet":
            r = rvar.cell_pair_forces_packets(*rargs, interpret=True,
                                              uniform_lj=uniform)
            p = variants.cell_pair_forces_packets(*pargs, uniform_lj=uniform)
        elif kind == "resident":
            r = rvar.cell_pair_forces_resident(*rargs, interpret=True,
                                               uniform_lj=uniform)
            p = variants.cell_pair_forces_resident(*pargs,
                                                   uniform_lj=uniform)
        else:
            z_unroll = kind == "colz"
            r = rvar.cell_pair_forces_columns(*rargs, interpret=True,
                                              uniform_lj=uniform,
                                              z_unroll=z_unroll)
            p = variants.cell_pair_forces_columns(*pargs, uniform_lj=uniform,
                                                  z_unroll=z_unroll)
        assert float(p[1]) != 0.0 and float(p[3]) != 0.0
    assert [k.launches for k in cell_pair.KERNELS] == n0   # plain on the CPU
    _assert_close(p, r)


# ---- the wrappers on the CPU ------------------------------------------------

def test_ladder_wrappers_take_plain_versions_on_cpu_only(ref):
    """CPU tensors take the plain version and count no launch; the CUDA
    entry refuses CPU tensors, and each kernel has its own count."""
    built, _, rst = ref.melt("melt")
    cfg, spec, st = _port(built, rst)
    ops = _operands(cfg, spec, st)
    n0 = [k.launches for k in cell_pair.KERNELS]
    for kind in variants.KERNEL_OF:
        out = variants.ladder_cells(kind, *ops, cfg.cell_dims, True)
        assert out.shape[-1] == (4 if kind == "colt1" else 8)
        with pytest.raises(ValueError, match="CUDA tensors"):
            variants.ladder_kernel(kind, *ops, cfg.cell_dims, True)
    assert [k.launches for k in cell_pair.KERNELS] == n0
    assert len({id(k) for k in variants.KERNEL_OF.values()}) == 5
    assert all(cell_pair.BY_NAME[name] is variants.KERNEL_OF[kind]
               for name, kind in KIND_OF.items())


# ---- cancellation at short range --------------------------------------------

@pytest.mark.parametrize("name", ["packet", "resident", "column", "colt1"])
def test_cancellation_at_short_range(ref, name):
    """An excluded pair pushed to r = 0.05 sigma: the ladder's all-pairs sum
    minus the correction is finite and equals K1's (plain) minus the
    correction.  The clamped term (~2.4e3 eps/sigma x 0.05 sigma) sits in
    both sums before it cancels, so the tolerance scales with it."""
    built, _, rst = ref.melt("melt")
    cfg, spec, st = _port(built, rst)
    i, j = (int(x) for x in st.excl[0])
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
        pos, st.box, st.active, cfg.cell_dims, cfg.cell_cap)
    assert not bool(ovf)
    f_ex = cell_pair.excluded_pair_correction(
        spec, cfg.n_types, pos, st.box, st.type_id, st.excl,
        active=st.active)[0]
    out = {}
    for kernel in ("auto", name):
        f_all = cell_pair.cell_pair_forces(
            pos, st.type_id, st.active, st.box, buckets, slot_of,
            cfg.cell_dims, spec, cfg.n_types, uniform_lj=cfg.uniform_lj,
            all_lj=cfg.all_lj, kernel=kernel)[0]
        out[kernel] = f_all - f_ex
    got = out[name]
    assert torch.isfinite(got).all()
    big = max(out["auto"].abs().max().item(), f_ex.abs().max().item())
    assert big > 1e3
    torch.testing.assert_close(got, out["auto"], rtol=0,
                               atol=2e-5 * (1.0 + big))


# ---- the step path ----------------------------------------------------------

@pytest.mark.parametrize("name", ["packet", "colt1"])
def test_short_run_matches_reference(ref, name, monkeypatch):
    """30 NVE steps of the reactive melt with a reaction step every 10:
    the port under ``pair_kernel=name`` against the reference under
    ``CHEMLAB_KERNEL=name`` (its step traced afresh, so no earlier trace of
    another kernel is reused): positions to f32 rounding, the same event
    list."""
    built, systop, rst = ref.melt("melt")
    rst = rts.activate_initiators(built, systop, rst, n=20)
    rst = dataclasses.replace(rst, reaction_rates=rst.reaction_rates * 40.0)
    rcfg = dataclasses.replace(built.cfg, thermostat="no",
                               reaction_interval=10)
    rspec = built.spec
    cfg, spec, pst = bridge.from_trees(rcfg, rspec, rst, "cpu")
    monkeypatch.setenv("CHEMLAB_KERNEL", name)
    step = jax.jit(lambda s: rrun.step_with_extensions(rspec, rcfg, s))
    for _ in range(30):
        rst = step(rst)
    n0 = int(np.asarray(built.state.reaction_counts).sum())
    pst = prun.run_block(spec, cfg, pst, 30, pair_kernel=name)
    assert int(pst.step) == int(rst.step)
    assert int(pst.reaction_counts.sum()) > n0
    np.testing.assert_allclose(pst.pos.numpy(), np.asarray(rst.pos), rtol=0,
                               atol=1e-4)
    for field in ("reaction_counts", "ev_log_a", "ev_log_b", "ev_log_r",
                  "ev_log_step", "type_id", "n_excl"):
        np.testing.assert_array_equal(getattr(pst, field).numpy(),
                                      np.asarray(getattr(rst, field)),
                                      err_msg=field)
