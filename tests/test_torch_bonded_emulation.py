"""The bonded kernel's CUDA source, run on the CPU, and its plain twin.

``chemlab_tpu_torch/csrc/bonded.cu`` is compiled with the host's g++
against the stand-in for the CUDA runtime of ``test_torch_cheb_emulation``
(with ``atomicExch`` and ``cudaMemsetAsync`` added: the fibers of a block
run in turns on one OS thread, so an exchange is a read and a write), and
its entry point is called through ctypes on CPU tensors, on the operands
``bonded_forces.kernel_operands`` prepares.  It must agree with the plain
twin (``bond_angle_forces_plain``): bit for bit where the terms use no
transcendental function (harmonic bonds, where the twin's torch ops and
the kernel's IEEE ops are the same operations in the same order), else
within ``2e-5 (1 + max|F|)`` (glibc's ``acosf``, ``logf``, ``cosf`` against
torch's vectorised ones) and energies within ``2e-5 (1 + |E|)`` (sums in
another order).  The twin's per-particle sums are held to their stated
order bit for bit and to a float64 ``index_add_`` of the same rows, and a
fully padded irregular table adds nothing, in both.

Inputs: the 70-trimer ATRP melt (bond and angle func 1, type lookups)
with seeded jitter, irregular rows appended (some looked up by type,
lambdas 0.25-1), some particles' types turned, and rows rewritten to FENE
(7), FENE + WCA (9) and cosine (11); the 40-tetramer chain melt for the
tabulated forms (func 8, two angles rewritten to func 1).  Skips without
g++.  No jax here: the twin is held to the reference in
``test_torch_bonded_twin.py``.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_cheb_emulation import (_one_torch_thread,  # noqa: F401
                                       compile_for_host)

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import bonded_dense, bonded_forces, integrate
from chemlab_tpu_torch.engine.state import TermTable

# what bonded.cu needs beyond the stand-in
RUNTIME_EXTRA = r"""
inline int atomicExch(int* p, int v) {
  const int old = *p;
  *p = v;
  return old;
}
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n);
  return 0;
}
"""

FENE = [30.0, 0.0, 1.5, 0.0, 0.0, 0.0]
FENE_WCA = [30.0, 0.0, 1.5, 1.0, 1.0, 0.0]
COSINE = [2.5, np.pi, 0.0, 0.0, 0.0, 0.0]


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    so = compile_for_host(bonded_forces.BOND_ANGLE.source,
                          tmp_path_factory.mktemp("bonded_emu"),
                          RUNTIME_EXTRA)
    fn = so.bonded_bond_angle
    fn.argtypes = bonded_forces.BOND_ANGLE.argtypes
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def melt():
    built, _, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                         device="cpu")
    return built


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp("chain_tables")
    testsystems.write_chain_tables(str(d))
    built, _, _ = testsystems.build_chain_melt(n_mols=40, device="cpu",
                                               table_dir=str(d))
    return built


def _append(table, rows):
    """``table`` with ``rows`` [(idx, func, params, typelookup, lam)]
    written after its valid rows."""
    d = {k: v.clone() for k, v in dataclasses.asdict(table).items()}
    n0 = int(d["count"])
    for r, (idx, func, par, tl, lam) in enumerate(rows, start=n0):
        d["idx"][r] = torch.tensor(idx, dtype=torch.int32)
        d["func"][r] = func
        d["params"][r] = 0.0
        d["params"][r, :len(par)] = torch.tensor(par)
        d["typelookup"][r] = tl
        d["lam"][r] = lam
        d["group"][r] = 0
    d["count"] = torch.tensor(n0 + len(rows), dtype=torch.int32)
    return TermTable(**d)


def _rewrite(table, rows, func, par):
    d = {k: v.clone() for k, v in dataclasses.asdict(table).items()}
    for r in rows:
        d["func"][r] = func
        d["params"][r] = torch.tensor(par)
        d["typelookup"][r] = False
    return TermTable(**d)


def _jitter(st, seed):
    rng = np.random.RandomState(seed)
    pos = st.pos.numpy() + rng.normal(0.0, 0.05, st.pos.shape)
    return torch.from_numpy(np.mod(pos, st.box.numpy()).astype(np.float32))


def _melt_inputs(built, forms: bool, reacted: bool = True):
    """The melt with jitter; ``reacted``: irregular rows appended (a type
    lookup on every other bond, lambdas below 1) and types turned;
    ``forms``: FENE, FENE + WCA and cosine rows."""
    cfg, spec, st = built.cfg, built.spec, built.state
    st = dataclasses.replace(st, pos=_jitter(st, 2))
    if reacted:
        bonds = _append(st.bonds, [((0, 4), 1, [15.0, 0.97], True, 0.25),
                                   ((7, 3), 1, [15.0, 0.97], False, 0.5),
                                   ((10, 30), 1, [15.0, 0.97], True, 0.75),
                                   ((31, 12), 1, [15.0, 0.97], False, 1.0)])
        angles = _append(st.angles,
                         [((2, 0, 4), 1, [1.25, np.pi], False, 0.5),
                          ((9, 7, 3), 1, [1.25, np.pi], True, 0.5),
                          ((12, 31, 40), 1, [1.25, np.pi], False, 0.5)])
        tid = st.type_id.clone()
        tid[[0, 4, 10, 31, 40, 41]] = torch.tensor([2, 6, 3, 4, 5, 6],
                                                   dtype=tid.dtype)
        st = dataclasses.replace(st, bonds=bonds, angles=angles, type_id=tid)
    if forms:
        nb, na = int(st.bonds.count), int(st.angles.count)
        bonds = _rewrite(st.bonds, (1, nb - 3), 7, FENE)
        bonds = _rewrite(bonds, (2, nb - 4), 9, FENE_WCA)
        angles = _rewrite(st.angles, (0, 5, na - 1), 11, COSINE)
        st = dataclasses.replace(st, bonds=bonds, angles=angles)
        cfg = dataclasses.replace(cfg, bond_funcs=(1, 7, 9),
                                  angle_funcs=(1, 11))
    return cfg, spec, bonded_dense.rederive(cfg, st)


def _full(table):
    """The table cut to its valid rows: every slot live."""
    n = int(table.valid.sum())
    return TermTable(**{k: v[:n] if v.dim() else torch.tensor(n, dtype=v.dtype)
                        for k, v in dataclasses.asdict(table).items()})


def _empty(table):
    return TermTable(**{k: v[:0] if v.dim() else torch.zeros_like(v)
                        for k, v in dataclasses.asdict(table).items()})


def _case(melt, chain, case):
    """(cfg, spec, state, dense operands or None) of one case."""
    name, leg = case.rsplit("-", 1)
    if name == "tab":
        cfg, spec, st = chain.cfg, chain.spec, chain.state
        angles = _rewrite(st.angles, (0, 3), 1, [1.25, 2.0, 0, 0, 0, 0])
        st = dataclasses.replace(st, pos=_jitter(st, 3), angles=angles)
        st = bonded_dense.rederive(cfg, st)
    else:
        cfg, spec, st = _melt_inputs(melt, forms=name == "forms",
                                     reacted=name != "padded")
    if name == "bonds":
        cfg = dataclasses.replace(cfg, angle_funcs=())
    if name == "full":
        st = dataclasses.replace(st, bonds=_full(st.bonds),
                                 angles=_full(st.angles))
    dense = integrate._dense_of(cfg, st) if leg == "dense" else None
    return cfg, spec, st, dense


def _emulated(fn, cfg, spec, st, dense):
    args, force, energy, _scratch = bonded_forces.kernel_operands(
        spec, cfg, st.pos, st.box, st.type_id, st.bonds, st.angles, dense)
    force.fill_(float("nan"))
    energy.fill_(float("nan"))
    assert fn(*args, None) == 0
    return force, bonded_forces._energy_terms(cfg, lambda c: energy[c])


def _twin(cfg, spec, st, dense, parts=None):
    return bonded_forces.bond_angle_forces_plain(
        spec, cfg, st.pos, st.box, st.type_id, st.bonds, st.angles, dense,
        parts=parts)


CASES = ["bonds-dense", "bonds-flat", "forms-dense", "forms-flat",
         "padded-dense", "full-flat", "tab-dense", "tab-flat"]


@pytest.mark.parametrize("case", CASES)
def test_emulated_kernel_matches_twin(emu, melt, chain, case):
    """The kernel's source on the CPU against the twin: forces bit for bit
    on harmonic bonds, within f32 rounding elsewhere; energies within f32
    rounding; a second call gives the same bits."""
    cfg, spec, st, dense = _case(melt, chain, case)
    f_k, e_k = _emulated(emu, cfg, spec, st, dense)
    f_t, e_t = _twin(cfg, spec, st, dense)
    assert sorted(e_k) == sorted(e_t)
    for k in e_t:
        assert float(e_t[k]) != 0.0, k
        assert abs(float(e_k[k]) - float(e_t[k])) \
            <= 2e-5 * (1.0 + abs(float(e_t[k]))), k
    assert torch.isfinite(f_k).all()
    if case.startswith("bonds"):
        assert torch.equal(f_k, f_t)
    else:
        torch.testing.assert_close(
            f_k, f_t, rtol=0, atol=2e-5 * (1.0 + f_t.abs().max().item()))
    f_k2, _ = _emulated(emu, cfg, spec, st, dense)
    assert torch.equal(f_k, f_k2)


@pytest.mark.parametrize("leg", ["dense", "flat"])
def test_twin_sums_in_its_stated_order(melt, leg):
    """Each particle's force is, bit for bit, the f32 sum from 0 of dense
    bond rows p and p-1, dense angle rows p, p-1 and p-2, then its listed
    entries in ascending id; and it is within f32 rounding of a float64
    ``index_add_`` of the same rows."""
    cfg, spec, st, dense = _case(melt, None, "forms-" + leg)
    parts = {}
    force, _ = _twin(cfg, spec, st, dense, parts)
    n = st.pos.shape[0]
    ids = torch.arange(n)
    ref = torch.zeros((n, 3), dtype=torch.float64)
    want = torch.zeros((n, 3), dtype=torch.float32)
    per = [[] for _ in range(n)]
    for name, arity in (("bonds_dense", 2), ("angles_dense", 3)):
        if name in parts:
            f = parts[name]
            for k in range(arity):
                ref.index_add_(0, (ids + k) % n, f[:, k].double())
                for p in range(n):
                    per[p].append(f[(p - k) % n, k])
    keys, rows = parts["keys"], parts["listed"]
    live = keys < n
    assert int(live.sum()) > 0
    ref.index_add_(0, keys[live], rows[live].double())
    for e in torch.nonzero(live).flatten().tolist():    # ascending ids
        per[int(keys[e])].append(rows[e])
    for p in range(n):
        acc = torch.zeros(3, dtype=torch.float32)
        for row in per[p]:
            acc = acc + row
        want[p] = acc
    assert torch.equal(force, want)
    torch.testing.assert_close(force.double(), ref, rtol=0,
                               atol=1e-6 * (1.0 + ref.abs().max().item()))


def test_padded_irregular_adds_nothing(emu, melt):
    """The unreacted melt's irregular tables are all padding: the twin
    and the kernel give exactly the forces and energies of the dense legs
    alone (irregular tables of no rows)."""
    cfg, spec, st, dense = _case(melt, None, "padded-dense")
    assert int(st.bonds_irr.valid.sum()) == 0
    assert int(st.angles_irr.valid.sum()) == 0
    assert st.bonds_irr.capacity > 0 and st.angles_irr.capacity > 0
    alone = (dense[0], _empty(dense[1]), dense[2], _empty(dense[3]))
    for run in (lambda d: _twin(cfg, spec, st, d),
                lambda d: _emulated(emu, cfg, spec, st, d)):
        f_pad, e_pad = run(dense)
        f_one, e_one = run(alone)
        assert torch.equal(f_pad, f_one)
        assert {k: float(v) for k, v in e_pad.items()} \
            == {k: float(v) for k, v in e_one.items()}
