"""The port on a card: the CUDA K1 (LJ), K1c/K1d/K1e (Chebyshev tabulated),
K2 (per-cell LJ, any grid) and the ladder (K1', K3a-K3d) against their
plain versions, K2 against K1 on a full grid and K3a-K3d against K2 bit
for bit, the LJ and Chebyshev column-segment kernels against their
cellwise baselines bit for bit, the cancellation at r -> 0, and short
runs on the card against the CPU path: LJ, tabulated, and NPT on the K2
grid; the bonded layer of the step-growth chain melt (dihedrals, 1-4 pairs,
func-8 bonds and angles) and its full-row reaction step against the CPU;
one reaction step of the break and release melts (the sequential event
scan, dissociation, restrict, releases, joins) and the ATRP,
ChangeParticleType and FreezeRegion steps against the CPU; the Verlet
row path (every nonbonded variant, Coulomb, the virial, reactions on the
persistent rows) against the CPU; two gloo ranks on one card (the row
split, an extension block on K1f) against one rank.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no jax, so it also runs on a machine without it:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest`` skips ``tests/conftest.py``, which configures jax.)
Tolerance, kernel vs plain: ``2e-5 * (1 + max|ref|)``, the f32 rounding of
per-slot sums of a few hundred terms taken in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import cell_pair, integrate, neighbor, runner
from chemlab_tpu_torch.engine import cell_pair_variants as variants

MODES = [(True, True), (False, True), (False, False)]   # (uniform, all_lj)
CH3 = (cell_pair.CH3_NONE, cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL)


def _tol(ref):
    return 2e-5 * (1.0 + ref.abs().max().item())


@pytest.fixture(scope="module")
def melt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    built, systop, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                              thermostat="no", device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=50)
    return built, systop, st


def _mixed(spec, n_types, islj_gate):
    """Per-type-pair sigma/epsilon, optionally one non-LJ type pair."""
    rng = np.random.RandomState(5)
    s = rng.uniform(0.9, 1.1, (n_types, n_types)).astype(np.float32)
    e = rng.uniform(0.7, 1.3, (n_types, n_types)).astype(np.float32)
    kind = spec.pair_kind.reshape(n_types, n_types).clone()
    if islj_gate:
        kind[0, 1] = kind[1, 0] = 0
    return dataclasses.replace(
        spec, pair_sig=torch.from_numpy(((s + s.T) / 2).reshape(-1)),
        pair_eps=torch.from_numpy(((e + e.T) / 2).reshape(-1)),
        pair_kind=kind.reshape(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
def test_cuda_k1_matches_plain(melt, uniform, all_lj):
    built, _, st = melt
    cfg, spec = built.cfg, built.spec
    if not uniform:
        spec = _mixed(spec, cfg.n_types, not all_lj)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(spec, cfg.n_types)
    dev = [t.cuda() for t in (cells, counts, st.box, params)]
    for mode in CH3:
        # the virial channel (K1b) has its own launch count
        kern = (cell_pair.K1B if mode == cell_pair.CH3_VIRIAL
                else cell_pair.K1)
        n0 = kern.launches
        got = cell_pair.colt_cells(*dev, cfg.cell_dims, uniform, all_lj, mode)
        assert kern.launches == n0 + 1
        ref = cell_pair.cell_pair_forces_colt_ref(
            cells, counts, st.box, params, cfg.cell_dims, uniform, all_lj,
            mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_tol(ref))
        if mode == cell_pair.CH3_NONE:
            assert (got[..., 3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [8, 40])
def test_cuda_k1_ragged_cells(cap):
    """Random occupancy per cell (holes past each count), and a cap that is
    not a multiple of the warp (40 slots: 64 threads per block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    rng = np.random.RandomState(cap)
    dims = (3, 4, 5)
    n_cells = int(np.prod(dims))
    box = np.array([3.3, 4.4, 5.5], np.float32)
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, cap + 1, n_cells).astype(np.int32)
    for c in range(n_cells):
        cx, cy, cz = c // 20, (c // 5) % 4, c % 5
        lo = np.array([cx, cy, cz]) * 1.1
        k = counts[c]
        cells[c, :k, :3] = lo + rng.uniform(0, 1.1, (k, 3))
        cells[c, :k, 3] = rng.randint(1, 3, k)
    params = np.zeros((5, 2, 2), np.float32)
    params[0], params[1], params[2] = 0.35, 1.0, 1.1 ** 2
    params[3], params[4] = 0.01, 1.0
    ops = [torch.from_numpy(a) for a in (cells, counts, box, params)]
    for uniform, all_lj in MODES:
        for mode in CH3:
            got = cell_pair.colt_cells(*(t.cuda() for t in ops), dims,
                                       uniform, all_lj, mode)
            ref = cell_pair.cell_pair_forces_colt_ref(*ops, dims, uniform,
                                                      all_lj, mode)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.cpu(), ref, rtol=0,
                                       atol=_tol(ref))


@pytest.mark.cuda
def test_cuda_cancellation_at_short_range(melt):
    """An excluded pair at r = 0.05 sigma: kernel minus correction is finite
    and equals plain minus correction.  The clamped term (~2.4e3 eps/sigma
    times 0.05 sigma) sits in both sums before it cancels, so the tolerance
    scales with it."""
    built, _, st = melt
    cfg, spec = built.cfg, built.spec
    i, j = (int(x) for x in st.excl[0].tolist())
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    out = []
    for dev in ("cpu", "cuda"):
        p = pos.to(dev)
        sp = spec.to(dev)
        buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
            p, st.box.to(dev), st.active.to(dev), cfg.cell_dims,
            cfg.cell_cap)
        assert not bool(ovf)
        f_all = cell_pair.cell_pair_forces(
            p, st.type_id.to(dev), st.active.to(dev), st.box.to(dev),
            buckets, slot_of, cfg.cell_dims, sp, cfg.n_types,
            uniform_lj=cfg.uniform_lj, all_lj=cfg.all_lj)[0]
        f_ex = cell_pair.excluded_pair_correction(
            sp, cfg.n_types, p, st.box.to(dev), st.type_id.to(dev),
            st.excl.to(dev), active=st.active.to(dev))[0]
        out.append((f_all - f_ex).cpu())
        big = f_ex.abs().max().item()
    plain, kern = out
    assert torch.isfinite(kern).all()
    torch.testing.assert_close(kern, plain, rtol=0, atol=2e-5 * (1.0 + big))


@pytest.mark.cuda
def test_cuda_run_matches_cpu(melt):
    """20 NVE steps with a reaction step every 10, on the card and on the
    CPU from one state: events identical, positions to f32 rounding."""
    built, systop, st = melt
    cfg = dataclasses.replace(built.cfg, reaction_interval=10)
    st = testsystems.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    c = runner.run_block(built.spec, cfg, st, 20)
    g = runner.run_block(built.spec.to("cuda"), cfg, st.to("cuda"), 20)
    assert int(c.reaction_counts.sum()) > 0
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-5)
    for name in ("ev_log_a", "ev_log_b", "ev_log_r", "type_id", "n_excl"):
        torch.testing.assert_close(getattr(g, name).cpu(), getattr(c, name),
                                   rtol=0, atol=0)
    torch.testing.assert_close(g.bonds.idx.cpu(), c.bonds.idx, rtol=0, atol=0)
    f, _, _ = integrate.compute_forces(built.spec.to("cuda"), cfg, g)
    assert torch.isfinite(f).all()


@pytest.mark.cuda
def test_cuda_wrapper_checks_its_inputs(melt):
    built, _, st = melt
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    args = [t.cuda() for t in (cells, counts, st.box, params)]
    k = cell_pair.cell_pair_forces_colt_kernel
    with pytest.raises(TypeError):
        k(args[0].double(), *args[1:], cfg.cell_dims, True, True, 0)
    with pytest.raises(ValueError):
        k(args[0].transpose(0, 1), *args[1:], cfg.cell_dims, True, True, 0)
    with pytest.raises(ValueError):
        k(*args, (3, 3, 2), True, True, 0)
    with pytest.raises(ValueError):
        k(args[0], args[1].cpu(), *args[2:], cfg.cell_dims, True, True, 0)


@pytest.fixture(scope="module")
def tab_melts():
    """The tabulated and the blended tabulated 70-trimer melts, warmed on
    the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    out = {}
    for kind, fn in (("tab", testsystems.build_tabulated_melt),
                     ("mixed", testsystems.build_mixed_tab_melt)):
        built, systop, _ = fn(n_mols=70, reactive=True, thermostat="no",
                              device="cpu")
        st = runner.initial_forces(built.spec, built.cfg, built.state)
        out[kind] = (built, systop, testsystems.warmup(built, st, steps=50))
    return out


def _cheb_args(built, st, ntab, obs_x):
    cfg, spec = built.cfg, built.spec
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko, ntab,
                                  cfg.cheb_mix and ntab > 0, obs_x)
    return cells, counts, st.box, ops


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["K1c", "K1d", "K1e"])
def test_cuda_cheb_matches_plain(tab_melts, mode):
    built, _, st = tab_melts["mixed" if mode == "K1d" else "tab"]
    cfg = built.cfg
    ntab = 0 if mode == "K1e" else cfg.cheb_ntab
    x = torch.tensor([0.4])
    cells, counts, box, ops = _cheb_args(built, st, ntab, x)
    kern = {"K1c": cell_pair.K1C, "K1d": cell_pair.K1D,
            "K1e": cell_pair.K1E}[mode]
    for ch3 in CH3:
        n0 = kern.launches
        got = cell_pair.cheb_cells(
            *(t.cuda() for t in (cells, counts, box)),
            *(None if t is None else t.cuda() for t in ops), cfg.cell_dims,
            cfg.cheb_kw, cfg.cheb_ko, ch3, ntab)
        assert kern.launches == n0 + 1
        ref = cell_pair.cell_pair_forces_cheb_ref(
            cells, counts, box, *ops, cfg.cell_dims, cfg.cheb_kw,
            cfg.cheb_ko, ch3)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_tol(ref))
        if ch3 != cell_pair.CH3_NONE:
            assert ref[..., 3].abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tab", "mixed"])
def test_cuda_cheb_cancellation_at_short_range(tab_melts, kind):
    """An excluded pair at r = 0.05 sigma, inside the wall clamp: the
    kernel's and the plain version's all-pairs sums minus the correction
    agree, and for the two endpoints the kernel's pair term equals the
    correction's bit for bit (the op sequences are the same)."""
    built, _, st = tab_melts[kind]
    cfg, spec = built.cfg, built.spec
    i, j = (int(x) for x in st.excl[0].tolist())
    pos = st.pos.clone()
    pos[j] = pos[i] + torch.tensor([0.05, 0.0, 0.0])
    pos = pos - torch.floor(pos / st.box) * st.box
    x = torch.tensor([0.4])
    out = []
    for dev in ("cpu", "cuda"):
        p, sp = pos.to(dev), spec.to(dev)
        box, act, tid = (t.to(dev) for t in (st.box, st.active, st.type_id))
        buckets, _, ovf, slot_of = neighbor.build_cell_buckets(
            p, box, act, cfg.cell_dims, cfg.cell_cap)
        assert not bool(ovf)
        f_all = cell_pair.cell_pair_forces(
            p, tid, act, box, buckets, slot_of, cfg.cell_dims, sp,
            cfg.n_types, cheb_kw=cfg.cheb_kw, cheb_ko=cfg.cheb_ko,
            cheb_ntab=cfg.cheb_ntab, cheb_mix=cfg.cheb_mix,
            obs_x=x.to(dev))[0]
        f_ex = cell_pair.excluded_pair_correction(
            sp, cfg.n_types, p, box, tid, st.excl.to(dev), active=act,
            cheb=(cfg.cheb_kw, cfg.cheb_ko), cheb_mix=cfg.cheb_mix,
            obs_x=x.to(dev))[0]
        out.append((f_all - f_ex).cpu())
        big = f_ex.abs().max().item()
    plain, kern = out
    assert big > 100.0 and torch.isfinite(kern).all()
    torch.testing.assert_close(kern, plain, rtol=0, atol=2e-5 * (1.0 + big))


@pytest.mark.cuda
def test_cuda_tab_run_matches_cpu(tab_melts):
    """20 NVE steps of the tabulated melt with a reaction step every 10, on
    the card and on the CPU from one state: events identical, positions to
    f32 rounding."""
    built, systop, st = tab_melts["tab"]
    cfg = dataclasses.replace(built.cfg, reaction_interval=10)
    st = testsystems.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    n0 = cell_pair.K1C.launches
    c = runner.run_block(built.spec, cfg, st, 20)
    g = runner.run_block(built.spec.to("cuda"), cfg, st.to("cuda"), 20)
    assert cell_pair.K1C.launches >= n0 + 20
    assert int(c.reaction_counts.sum()) > 0
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-5)
    for name in ("ev_log_a", "ev_log_b", "ev_log_r", "type_id", "n_excl"):
        torch.testing.assert_close(getattr(g, name).cpu(), getattr(c, name),
                                   rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_builders_default_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    built, _, _ = testsystems.build_melt(n_mols=70, reactive=False)
    assert built.state.pos.device.type == "cuda"
    assert built.spec.pair_sig.device.type == "cuda"


@pytest.mark.cuda
def test_cuda_cheb_pack_above_48k_opts_in(tab_melts):
    """A plane-mode coefficient pack above the default 48 KiB of shared
    memory takes the opt-in path and still matches the plain version; a
    pack above the card's 227 KiB raises."""
    built, _, st = tab_melts["tab"]
    cfg = built.cfg
    cells, counts, box, (cut2, tmap, _, _, coef) = _cheb_args(
        built, st, 0, torch.zeros(1))
    args = dict(dims=cfg.cell_dims, kw=cfg.cheb_kw, ko=cfg.cheb_ko,
                ch3_mode=cell_pair.CH3_VIRIAL)
    for rows, fits in ((700, True), (3000, False)):
        big = coef.repeat(-(-rows // coef.shape[0]), 1).contiguous()
        dev = [t.cuda() for t in (cells, counts, box, cut2, tmap, big)]
        if not fits:
            with pytest.raises(ValueError, match="227 KiB"):
                cell_pair.cheb_cells(*dev[:5], None, None, dev[5], ntab=0,
                                     **args)
            continue
        assert big.numel() * 4 > 48 * 1024
        got = cell_pair.cheb_cells(*dev[:5], None, None, dev[5], ntab=0,
                                   **args)
        ref = cell_pair.cell_pair_forces_cheb_ref(
            cells, counts, box, cut2, tmap, None, None, big, **args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_tol(ref))


# ---- K2 (per-cell kernel, any grid) and the NPT path -------------------------

@pytest.fixture(scope="module")
def k2_melts():
    """The 70-trimer melt at cell_cap=36 (3x3x3, S = 27) and the 40-trimer
    melt at density 0.3 under the Berendsen barostat (2x2x2, S = 8), warmed
    on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    out = {}
    for name, kw in (("cap36", dict(n_mols=70, reactive=True, cell_cap=36)),
                     ("grid222", dict(n_mols=40, density=0.3, seed=3,
                                      reactive=False, barostat="br",
                                      pressure=0.15, barostat_tau=2.0))):
        built, systop, _ = testsystems.build_melt(thermostat="no",
                                                  device="cpu", **kw)
        st = runner.initial_forces(built.spec, built.cfg, built.state)
        out[name] = (built, systop, testsystems.warmup(built, st, steps=50))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["cap36", "grid222"])
@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
def test_cuda_k2_matches_plain(k2_melts, grid, uniform, all_lj):
    built, _, st = k2_melts[grid]
    cfg, spec = built.cfg, built.spec
    assert not cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims)
    if not uniform:
        spec = _mixed(spec, cfg.n_types, not all_lj)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(spec, cfg.n_types)
    dev = [t.cuda() for t in (cells, counts, st.box, params)]
    for mode in CH3:
        n0 = cell_pair.K2.launches
        got = cell_pair.cell_cells(*dev, cfg.cell_dims, uniform, all_lj, mode)
        assert cell_pair.K2.launches == n0 + 1
        ref = cell_pair.cell_pair_forces_cell_ref(
            cells, counts, st.box, params, cfg.cell_dims, uniform, all_lj,
            mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_tol(ref))


@pytest.mark.cuda
def test_cuda_k2_against_k1_on_a_full_grid(melt):
    """On a colt2 grid both kernels take the same operands and sum in the
    same order (stencil, then slot)."""
    built, _, st = melt
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    dev = [t.cuda() for t in (cells, counts, st.box, params)]
    for mode in CH3:
        k1 = cell_pair.colt_cells(*dev, cfg.cell_dims, True, True, mode)
        k2 = cell_pair.cell_cells(*dev, cfg.cell_dims, True, True, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(k2, k1, rtol=0, atol=_tol(k1))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((2, 3, 1), 13), ((3, 3, 3), 120),
                                      ((2, 2, 2), 400)])
def test_cuda_k2_ragged_cells(dims, cap):
    """Random occupancy per cell on small and odd grids and caps: 13 slots
    (one warp), 120 slots at S = 27 (a 51 840-byte stage: the opt-in above
    48 KiB), and 400 slots at S = 8 (51 200 bytes); a stage above the
    card's 227 KiB raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    rng = np.random.RandomState(cap)
    n_cells = int(np.prod(dims))
    edge = 1.1
    box = np.array(dims, np.float32) * edge
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, min(cap, 40) + 1, n_cells).astype(np.int32)
    for c in range(n_cells):
        cx, cy, cz = c // (dims[1] * dims[2]), (c // dims[2]) % dims[1], \
            c % dims[2]
        k = counts[c]
        cells[c, :k, :3] = np.array([cx, cy, cz]) * edge \
            + rng.uniform(0, edge, (k, 3))
        cells[c, :k, 3] = rng.randint(1, 3, k)
    params = np.zeros((5, 2, 2), np.float32)
    params[0], params[1], params[2] = 0.35, 1.0, 1.1 ** 2
    params[3], params[4] = 0.01, 1.0
    ops = [torch.from_numpy(a) for a in (cells, counts, box, params)]
    for uniform, all_lj in MODES:
        for mode in CH3:
            got = cell_pair.cell_cells(*(t.cuda() for t in ops), dims,
                                       uniform, all_lj, mode)
            ref = cell_pair.cell_pair_forces_cell_ref(*ops, dims, uniform,
                                                      all_lj, mode)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.cpu(), ref, rtol=0,
                                       atol=_tol(ref))
    big = torch.zeros((27, 600, 4), device="cuda")
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.cell_cells(big, torch.zeros(27, dtype=torch.int32,
                                              device="cuda"),
                             ops[2].cuda(), ops[3].cuda(), (3, 3, 3), True,
                             True, 0)


@pytest.mark.cuda
def test_cuda_npt_run_matches_cpu(k2_melts):
    """20 NVE steps under the Berendsen barostat on the 2x2x2 grid (K2 in
    its force and virial modes), on the card and on the CPU from one
    state: the box and the positions agree to f32 rounding."""
    built, _, st = k2_melts["grid222"]
    cfg = built.cfg
    assert cfg.barostat == "br"
    n0 = cell_pair.K2.launches
    c, g = st, st.to("cuda")
    spec_g = built.spec.to("cuda")
    for _ in range(20):
        c = integrate.md_step(built.spec, cfg, c)
        g = integrate.md_step(spec_g, cfg, g)
    assert cell_pair.K2.launches == n0 + 40
    assert not torch.equal(c.box, st.box)
    torch.testing.assert_close(g.box.cpu(), c.box, rtol=1e-5, atol=0)
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-4)
    p = integrate.virial_pressure(spec_g, cfg, g)
    assert torch.isfinite(p) and p.device.type == "cuda"


# ---- K1f (the slab mode) and the deterministic correction ------------------

def _slab_operands(built, st, n_ranks, rank):
    from chemlab_tpu_torch.engine import cell_pair_halo

    cfg = built.cfg
    nx, ny, nz = cfg.cell_dims
    ids = cell_pair_halo.slab_cells(tuple(cfg.cell_dims), n_ranks, rank,
                                    st.pos.device)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active),
        st.nbr.buckets[ids], ids.numel())
    return cells, counts, (nx // n_ranks + 2, ny, nz)


def _k1f_modes(built, st):
    """(name, plain rows, kernel rows, launch count) of K1f on each slab of
    3 ranks, in LJ (every parameter mode) or in the melt's Chebyshev mode
    and plane mode, for every ch3 channel; and the full-grid kernel's."""
    cfg, spec = built.cfg, built.spec
    x = torch.tensor([0.4])
    for ch3 in CH3:
        if cfg.tab_cheb:
            modes = [("cheb", cfg.cheb_ntab)] + (
                [] if cfg.cheb_mix else [("plane", 0)])
        else:
            modes = [("lj", m) for m in MODES]
        for name, m in modes:
            def run(cells, counts, dims, x_halo, dev):
                if name == "lj":
                    sp = spec if m[0] else _mixed(spec, cfg.n_types, not m[1])
                    return cell_pair.colt_cells(
                        cells.to(dev), counts.to(dev), st.box.to(dev),
                        cell_pair.pair_params(sp, cfg.n_types).to(dev), dims,
                        m[0], m[1], ch3, x_halo)
                ops = cell_pair.cheb_operands(spec, cfg.n_types, cfg.cheb_ko,
                                              m, cfg.cheb_mix and m > 0, x)
                return cell_pair.cheb_cells(
                    cells.to(dev), counts.to(dev), st.box.to(dev),
                    *(None if t is None else t.to(dev) for t in ops), dims,
                    cfg.cheb_kw, cfg.cheb_ko, ch3, m, x_halo)
            yield (name, m, ch3), run


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lj", "tab", "mixed"])
def test_cuda_k1f_matches_plain_and_slabs_equal_k1(melt, tab_melts, kind):
    """K1f on each slab of 3 ranks (w = 1) against its plain version, and
    the slabs laid side by side against the full-grid kernel (K1, K1c,
    K1d, K1e) bit for bit; K1f counts its own launches."""
    built, _, st = melt if kind == "lj" else tab_melts[kind]
    cfg = built.cfg
    assert cfg.cell_dims[0] == 3
    full_cells, full_counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    kern = (cell_pair.K1F if kind == "lj" else cell_pair.K1F_CHEB_MIX
            if kind == "mixed" else cell_pair.K1F_CHEB)
    for label, run in _k1f_modes(built, st):
        slabs = []
        for r in range(3):
            cells, counts, dims = _slab_operands(built, st, 3, r)
            n0 = kern.launches
            got = run(cells, counts, dims, True, "cuda")
            assert kern.launches == n0 + 1
            ref = run(cells, counts, dims, True, "cpu")
            torch.cuda.synchronize()
            torch.testing.assert_close(got.cpu(), ref, rtol=0,
                                       atol=_tol(ref))
            slabs.append(got)
        full = run(full_cells, full_counts, cfg.cell_dims, False, "cuda")
        torch.cuda.synchronize()
        assert torch.equal(torch.cat(slabs), full), label


@pytest.mark.cuda
def test_cuda_correction_scatter_gives_the_same_bits_twice(melt):
    """The flat excluded-pair correction over a list with many duplicate
    destinations (every particle in ~60 pairs): two calls on the card give
    the same bits, and agree with the CPU to f32 rounding."""
    built, _, st = melt
    cfg, spec = built.cfg, built.spec
    n = int(st.active.sum())
    rng = np.random.RandomState(3)
    i = rng.randint(0, n, 30 * n)
    j = (i + rng.randint(1, 40, i.size)) % n
    excl = torch.from_numpy(np.stack([i, j], 1).astype(np.int32))
    args = (cfg.n_types, st.pos, st.box, st.type_id, excl)
    out = []
    for _ in range(2):
        out.append(cell_pair.excluded_pair_correction(
            spec.to("cuda"), cfg.n_types, *(t.cuda() for t in args[1:]),
            active=st.active.cuda())[0].cpu())
    assert torch.equal(out[0], out[1])
    ref = cell_pair.excluded_pair_correction(spec, *args, active=st.active)[0]
    torch.testing.assert_close(out[0], ref, rtol=0,
                               atol=2e-5 * (1.0 + ref.abs().max().item()))


# ---- the ladder: K1' (colt1) and K3a-K3d ---------------------------------------

LADDER = ("packet", "resident", "colz", "column", "colt1")


def _random_cells(dims, cap, seed, fill=None, n_types=2):
    """Random occupancy per cell (at most ``fill``), particles inside their
    cell of edge 1.1, types 1..n_types: (cells, counts, box, params)."""
    rng = np.random.RandomState(seed)
    n_cells = int(np.prod(dims))
    edge = 1.1
    box = np.array(dims, np.float32) * edge
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, min(cap, fill or cap) + 1,
                         n_cells).astype(np.int32)
    for c in range(n_cells):
        cx, cy, cz = c // (dims[1] * dims[2]), (c // dims[2]) % dims[1], \
            c % dims[2]
        k = counts[c]
        cells[c, :k, :3] = np.array([cx, cy, cz]) * edge \
            + rng.uniform(0, edge, (k, 3))
        cells[c, :k, 3] = rng.randint(1, n_types + 1, k)
    params = np.zeros((5, n_types, n_types), np.float32)
    params[0], params[1], params[2] = 0.35, 1.0, 1.1 ** 2
    params[3], params[4] = 0.01, 1.0
    params[4, 0, 1] = params[4, 1, 0] = 0.0       # one non-LJ type pair
    return [torch.from_numpy(a) for a in (cells, counts, box, params)]


@pytest.fixture(scope="module")
def melt32():
    """The 70-trimer melt built at cell_cap=32 (3x3x3: a grid every ladder
    kernel takes), warmed on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    built, systop, _ = testsystems.build_melt(n_mols=70, reactive=True,
                                              thermostat="no", cell_cap=32,
                                              device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    return built, systop, testsystems.warmup(built, st, steps=50)


def _melt_ops(built, st, spec=None):
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    params = cell_pair.pair_params(spec or built.spec, cfg.n_types)
    return [cells, counts, st.box, params]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LADDER)
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "islj"])
def test_cuda_ladder_matches_plain(melt32, kind, uniform):
    """Each ladder kernel against its plain version on the melt, in both
    parameter modes (K1' in both of its channels), one launch counted."""
    built, _, st = melt32
    cfg = built.cfg
    spec = built.spec if uniform else _mixed(built.spec, cfg.n_types, True)
    ops = _melt_ops(built, st, spec)
    modes = ((cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL) if kind == "colt1"
             else (cell_pair.CH3_ENERGY,))
    for mode in modes:
        kern = variants.KERNEL_OF[kind]
        n0 = kern.launches
        got = variants.ladder_cells(kind, *(t.cuda() for t in ops),
                                    cfg.cell_dims, uniform, mode)
        assert kern.launches == n0 + 1
        ref = variants.ladder_ref(kind, *ops, cfg.cell_dims, uniform, mode)
        torch.cuda.synchronize()
        assert got.shape == ref.shape
        torch.testing.assert_close(got.cpu(), ref, rtol=0, atol=_tol(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("uniform", [True, False], ids=["uniform", "islj"])
def test_cuda_k3_equal_k2_bit_for_bit(melt32, uniform):
    """K3a-K3d on identical cap-32 operands: every channel equals K2's
    (forces and energy from its energy mode, the virial from its virial
    mode) bit for bit, K2 equals K1 there, and K1' agrees with K1 to f32
    rounding."""
    built, _, st = melt32
    cfg = built.cfg
    spec = built.spec if uniform else _mixed(built.spec, cfg.n_types, True)
    dev = [t.cuda() for t in _melt_ops(built, st, spec)]
    dims = cfg.cell_dims
    k2_e = cell_pair.cell_cells(*dev, dims, uniform, False,
                                cell_pair.CH3_ENERGY)
    k2_w = cell_pair.cell_cells(*dev, dims, uniform, False,
                                cell_pair.CH3_VIRIAL)
    k1_e = cell_pair.colt_cells(*dev, dims, uniform, False,
                                cell_pair.CH3_ENERGY)
    for kind in ("packet", "resident", "colz", "column"):
        got = variants.ladder_cells(kind, *dev, dims, uniform)
        torch.cuda.synchronize()
        assert torch.equal(got[..., :4], k2_e), kind
        assert torch.equal(got[..., 4], k2_w[..., 3]), kind
        assert torch.equal(got[..., :3], k1_e[..., :3]), kind
    k1p = variants.ladder_cells("colt1", *dev, dims, uniform)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1p, k1_e, rtol=0, atol=_tol(k1_e))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", LADDER)
def test_cuda_ladder_gives_the_same_bits_twice(melt32, kind):
    built, _, st = melt32
    dev = [t.cuda() for t in _melt_ops(built, st)]
    a, b = (variants.ladder_cells(kind, *dev, built.cfg.cell_dims, True)
            for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((2, 2, 2), 24),
                                      ((2, 3, 1), 13)])
def test_cuda_ladder_ragged_cells(dims, cap):
    """Random occupancy on odd and small grids: every kernel the geometry
    takes (K1' needs a full stencil, all but K3d a cap that is a multiple
    of 8) against its plain version, both parameter modes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    ops = _random_cells(dims, cap, cap)
    kinds = [k for k in LADDER
             if (k == "column" or cap % 8 == 0)
             and (k != "colt1" or cell_pair.colt_legal(cap, dims))]
    assert "column" in kinds
    for kind in kinds:
        for uniform in (True, False):
            got = variants.ladder_cells(kind, *(t.cuda() for t in ops), dims,
                                        uniform)
            ref = variants.ladder_ref(kind, *ops, dims, uniform)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.cpu(), ref, rtol=0,
                                       atol=_tol(ref), msg=kind)


@pytest.mark.cuda
def test_cuda_ladder_opts_in_at_the_100k_grid():
    """The 100k melt's grid (24^3 cells) at cap 40, and 48 after a
    capacity regrowth: K3c's plan (its stage of whole columns 138 240 and
    165 888 bytes) and K1''s at a segment of nz (one block per xy column)
    take the opt-in above 48 KiB; K3a-K3d equal K2 bit for bit and K1'
    agrees with K1 under its default plan and that one.  A stage above 227
    KiB raises with its size, naming the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims = (24, 24, 24)
    for cap in (40, 48):
        dev = [t.cuda() for t in _random_cells(dims, cap, 7, fill=12)]
        n_types = dev[3].shape[1]
        column = variants.colt1_launch_plan(dims, cap, n_types, seg=24)
        assert variants.colz_launch_plan(cap, dims).smem > 48 * 1024
        assert column.smem > 48 * 1024
        k2_e = cell_pair.cell_cells(*dev, dims, False, False,
                                    cell_pair.CH3_ENERGY)
        k2_w = cell_pair.cell_cells(*dev, dims, False, False,
                                    cell_pair.CH3_VIRIAL)
        for kind in ("packet", "resident", "colz", "column"):
            got = variants.ladder_cells(kind, *dev, dims, False)
            torch.cuda.synchronize()
            assert torch.equal(got[..., :4], k2_e), (kind, cap)
            assert torch.equal(got[..., 4], k2_w[..., 3]), (kind, cap)
        k1 = cell_pair.colt_cells(*dev, dims, False, False,
                                  cell_pair.CH3_ENERGY)
        for plan in (None, column):
            k1p = variants.ladder_kernel("colt1", *dev, dims, False,
                                         plan=plan)
            torch.cuda.synchronize()
            torch.testing.assert_close(k1p, k1, rtol=0, atol=_tol(k1))
    big = torch.zeros((24 * 24 * 24, 104, 4), device="cuda")
    with pytest.raises(ValueError, match="K3c: shared memory .* 227 KiB"):
        variants.ladder_cells("colz", big, dev[1], dev[2], dev[3], dims,
                              False)
    with pytest.raises(ValueError, match="K1': shared-memory stage .* "
                                         "227 KiB"):
        variants.ladder_kernel("colt1", big, dev[1], dev[2], dev[3], dims,
                               False, plan=variants.colt1_launch_plan(
                                   dims, 104, n_types, seg=24))


@pytest.mark.cuda
@pytest.mark.parametrize("name,kernel", [("colt1", "K1p"), ("packet", "K3a"),
                                         ("resident", "K3b"),
                                         ("column", "K3c")])
def test_cuda_run_block_with_a_ladder_kernel(melt32, name, kernel):
    """20 NVE steps with a reaction step every 10 through
    ``run_block(pair_kernel=name)`` on the card: the named kernel launched
    on every step and K1 never, the positions within f32 rounding of the
    CPU run with the same kernel name, the same events."""
    built, systop, st = melt32
    cfg = dataclasses.replace(built.cfg, reaction_interval=10)
    st = testsystems.activate_initiators(built, systop, st, n=20)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0)
    c = runner.run_block(built.spec, cfg, st, 20, pair_kernel=name)
    n_k, n_1 = cell_pair.BY_NAME[kernel].launches, cell_pair.K1.launches
    g = runner.run_block(built.spec.to("cuda"), cfg, st.to("cuda"), 20,
                         pair_kernel=name)
    torch.cuda.synchronize()
    assert cell_pair.BY_NAME[kernel].launches == n_k + 20
    assert cell_pair.K1.launches == n_1
    assert int(c.reaction_counts.sum()) > 0
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-5)
    for name_ in ("ev_log_a", "ev_log_b", "ev_log_r", "type_id"):
        torch.testing.assert_close(getattr(g, name_).cpu(),
                                   getattr(c, name_), rtol=0, atol=0)


# ---- the column-segment Chebyshev kernel against the cellwise kernel --------

# (label, melt, table-scalar mode, x_halo) of each Chebyshev mode
CHEB_MODES = [("K1c", "tab", True, False), ("K1e", "tab", False, False),
              ("K1d", "mixed", True, False), ("K1f-cheb", "tab", True, True),
              ("K1f-cheb-plane", "tab", False, True),
              ("K1f-cheb-mix", "mixed", True, True)]


def _new_and_cellwise(cells, counts, box, ops, dims, kw, ko, ch3, ntab,
                      x_halo=False):
    """The column-segment kernel's and the cellwise kernel's rows on the
    card, from the same operands, each launch counted once."""
    dev = [t.cuda() for t in (cells, counts, box)]
    ops = [None if t is None else t.cuda() for t in ops]
    kern = cell_pair.cheb_kernel_for(ops[2], ntab, x_halo)
    old_k = (cell_pair.K1C_CELLWISE if ops[2] is None
             else cell_pair.K1D_CELLWISE)
    n0, o0 = kern.launches, old_k.launches
    new = cell_pair.cheb_cells(*dev, *ops, dims, kw, ko, ch3, ntab, x_halo)
    old = cell_pair.cell_pair_forces_cheb_cellwise(*dev, *ops, dims, kw, ko,
                                                   ch3, x_halo)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1 and old_k.launches == o0 + 1
    return new, old


@pytest.mark.cuda
@pytest.mark.parametrize("label,kind,scalar,x_halo", CHEB_MODES,
                         ids=[m[0] for m in CHEB_MODES])
def test_cuda_cheb_equals_cellwise_bit_for_bit(tab_melts, label, kind,
                                               scalar, x_halo):
    """K1c, K1e, K1d and the K1f modes (each slab of 3 ranks): the
    column-segment kernel equals the cellwise kernel bit for bit in every
    ch3 channel, and the plain version to f32 rounding."""
    built, _, st = tab_melts[kind]
    cfg = built.cfg
    ntab = cfg.cheb_ntab if scalar else 0
    cells, counts, box, ops = _cheb_args(built, st, ntab, torch.tensor([0.4]))
    operands = ([_slab_operands(built, st, 3, r) for r in range(3)] if x_halo
                else [(cells, counts, cfg.cell_dims)])
    for cells, counts, dims in operands:
        for ch3 in CH3:
            new, old = _new_and_cellwise(cells, counts, box, ops, dims,
                                         cfg.cheb_kw, cfg.cheb_ko, ch3, ntab,
                                         x_halo)
            assert torch.equal(new, old), (label, ch3)
            ref = cell_pair.cell_pair_forces_cheb_ref(
                cells, counts, box, *ops, dims, cfg.cheb_kw, cfg.cheb_ko,
                ch3, x_halo)
            torch.testing.assert_close(new.cpu(), ref, rtol=0,
                                       atol=_tol(ref))


def _random_cheb_ops(coef, blend):
    """Two types on random cells: cutoff 1.1, one type pair without a table
    (and, with ``blend``, a second table with weights), ``coef`` rows."""
    cut2 = torch.full((2, 2), 1.21)
    tmap = torch.tensor([[1, 0], [0, coef.shape[0]]], dtype=torch.int32)
    if not blend:
        return cut2, tmap, None, None, coef
    tmap_b = torch.tensor([[coef.shape[0], 1], [0, 1]], dtype=torch.int32)
    return cut2, tmap, tmap_b, torch.tensor([[0.3, 1.0], [1.0, 0.7]]), coef


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((5, 3, 7), 24)])
@pytest.mark.parametrize("blend", [False, True], ids=["scalar", "blend"])
def test_cuda_cheb_equals_cellwise_on_ragged_cells(tab_melts, dims, cap,
                                                   blend):
    """Random occupancy on grids K1c takes, the full grid and a slab: the
    column-segment kernel equals the cellwise kernel bit for bit, with the
    default plan and with plans of other segments, batches and list depths
    (lists of one and two passes fill and are emptied within a row)."""
    built, _, st = tab_melts["tab"]
    cfg = built.cfg
    coef = _cheb_args(built, st, cfg.cheb_ntab, None)[3][4]
    cells, counts, box, _ = _random_cells(dims, cap, cap + int(blend))
    ops = _random_cheb_ops(coef, blend)
    for x_halo in (False, True):
        for plan in ({}, dict(seg=2, rows=3, threads=64, depth=1),
                     dict(seg=3, rows=32, threads=32, depth=2)):
            p = cell_pair.cheb_launch_plan(dims, cap, 2, coef.shape[0],
                                           cfg.cheb_kw, cfg.cheb_ko, blend,
                                           x_halo, **plan)
            dev = [t.cuda() for t in (cells, counts, box)]
            dops = [None if t is None else t.cuda() for t in ops]
            args = (*dev, *dops, dims, cfg.cheb_kw, cfg.cheb_ko,
                    cell_pair.CH3_ENERGY)
            new = cell_pair.cell_pair_forces_cheb_kernel(
                *args, x_halo=x_halo, plan=p)
            old = cell_pair.cell_pair_forces_cheb_cellwise(*args, x_halo)
            torch.cuda.synchronize()
            assert torch.equal(new, old), (x_halo, plan)


@pytest.mark.cuda
def test_cuda_cheb_equals_cellwise_at_the_100k_grid(tab_melts):
    """24^3 cells at cap 40: equal bits with the tabulated pack, and with a
    plane-mode pack of 700 rows that takes the opt-in above 48 KiB; a plan
    above 227 KiB raises with its size, and the launcher refuses a plan
    whose bytes are not its layout's."""
    built, _, st = tab_melts["tab"]
    cfg = built.cfg
    dims, cap = (24, 24, 24), 40
    coef = _cheb_args(built, st, cfg.cheb_ntab, None)[3][4]
    cells, counts, box, _ = _random_cells(dims, cap, 7, fill=12)
    big = coef.repeat(700, 1).contiguous()
    for pack in (coef, big):
        ops = _random_cheb_ops(pack, False)
        plan = cell_pair.cheb_launch_plan(dims, cap, 2, pack.shape[0],
                                          cfg.cheb_kw, cfg.cheb_ko, False)
        assert plan.smem > 48 * 1024 or pack is not big
        new, old = _new_and_cellwise(cells, counts, box, ops, dims,
                                     cfg.cheb_kw, cfg.cheb_ko,
                                     cell_pair.CH3_VIRIAL, 1)
        assert torch.equal(new, old)
    dev = [t.cuda() for t in (cells, counts, box)]
    ops = [t.cuda() for t in _random_cheb_ops(coef, False) if t is not None]
    args = (*dev, ops[0], ops[1], None, None, ops[2], dims, cfg.cheb_kw,
            cfg.cheb_ko, cell_pair.CH3_NONE)
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.cell_pair_forces_cheb_kernel(
            *dev, ops[0], ops[1], None, None, coef.repeat(3000, 1).cuda(),
            dims, cfg.cheb_kw, cfg.cheb_ko, cell_pair.CH3_NONE)
    plan = cell_pair.cheb_launch_plan(dims, cap, 2, 1, cfg.cheb_kw,
                                      cfg.cheb_ko, False)
    with pytest.raises(RuntimeError, match="launch failed"):
        cell_pair.cell_pair_forces_cheb_kernel(
            *args, plan=plan._replace(smem=plan.smem + 16))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tab", "mixed"])
def test_cuda_cheb_gives_the_same_bits_twice(tab_melts, kind):
    built, _, st = tab_melts[kind]
    cfg = built.cfg
    cells, counts, box, ops = _cheb_args(built, st, cfg.cheb_ntab,
                                         torch.tensor([0.4]))
    dev = [t.cuda() for t in (cells, counts, box)]
    ops = [None if t is None else t.cuda() for t in ops]
    a, b = (cell_pair.cheb_cells(*dev, *ops, cfg.cell_dims, cfg.cheb_kw,
                                 cfg.cheb_ko, cell_pair.CH3_ENERGY,
                                 cfg.cheb_ntab) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# ---- the LJ column-segment kernel against the cellwise kernel ---------------

def _colt_new_and_cellwise(cells, counts, box, params, dims, uniform, all_lj,
                           ch3, x_halo=False, plan=None):
    """The LJ column-segment kernel's and the cellwise kernel's rows on the
    card, from the same operands, each launch counted once."""
    dev = [t.cuda() for t in (cells, counts, box, params)]
    kern = (cell_pair.K1F if x_halo else cell_pair.K1B
            if ch3 == cell_pair.CH3_VIRIAL else cell_pair.K1)
    n0, o0 = kern.launches, cell_pair.K1_CELLWISE.launches
    new = cell_pair.cell_pair_forces_colt_kernel(*dev, dims, uniform, all_lj,
                                                 ch3, x_halo, plan=plan)
    old = cell_pair.cell_pair_forces_colt_cellwise(*dev, dims, uniform,
                                                   all_lj, ch3, x_halo)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 1
    assert cell_pair.K1_CELLWISE.launches == o0 + 1
    return new, old


@pytest.mark.cuda
@pytest.mark.parametrize("plan_kw", [{}, dict(depth=1)],
                         ids=["default", "one-pass-lists"])
@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
def test_cuda_colt_equals_cellwise_bit_for_bit(melt, uniform, all_lj,
                                               plan_kw):
    """K1, K1b and K1f (each slab of 3 ranks) on the 70-trimer melt: the
    column-segment kernel equals the cellwise kernel bit for bit in every
    ch3 channel, under the default plan and under lists of one pass, and
    the plain version to f32 rounding; the slabs laid side by side equal
    the full grid's rows."""
    built, _, st = melt
    cfg = built.cfg
    spec = built.spec if uniform else _mixed(built.spec, cfg.n_types,
                                             not all_lj)
    params = cell_pair.pair_params(spec, cfg.n_types)
    full = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    for ch3 in CH3:
        rows = {}
        for x_halo, operands in (
                (False, [(*full, cfg.cell_dims)]),
                (True, [_slab_operands(built, st, 3, r) for r in range(3)])):
            rows[x_halo] = []
            for cells, counts, dims in operands:
                plan = cell_pair.colt_launch_plan(dims, cfg.cell_cap,
                                                  cfg.n_types, x_halo,
                                                  **plan_kw)
                new, old = _colt_new_and_cellwise(
                    cells, counts, st.box, params, dims, uniform, all_lj,
                    ch3, x_halo, plan)
                assert torch.equal(new, old), (ch3, x_halo)
                ref = cell_pair.cell_pair_forces_colt_ref(
                    cells, counts, st.box, params, dims, uniform, all_lj,
                    ch3, x_halo)
                torch.testing.assert_close(new.cpu(), ref, rtol=0,
                                           atol=_tol(ref))
                rows[x_halo].append(new)
        assert torch.equal(torch.cat(rows[True]), rows[False][0]), ch3


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((5, 3, 7), 24)])
def test_cuda_colt_equals_cellwise_on_ragged_cells(dims, cap):
    """Random occupancy on grids K1 takes, the full grid and a slab, every
    parameter mode and channel: the column-segment kernel equals the
    cellwise kernel bit for bit with the default plan and with plans of
    other segments, batches and list depths (lists of one and two passes
    fill and are emptied within a row)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    cells, counts, box, params = _random_cells(dims, cap, cap)
    for x_halo in (False, True):
        for kw in ({}, dict(seg=2, rows=3, threads=64, depth=1),
                   dict(seg=3, rows=32, threads=32, depth=2),
                   dict(seg=1, rows=1, threads=96)):
            plan = cell_pair.colt_launch_plan(dims, cap, 2, x_halo, **kw)
            for uniform, all_lj in MODES:
                for ch3 in CH3:
                    new, old = _colt_new_and_cellwise(
                        cells, counts, box, params, dims, uniform, all_lj,
                        ch3, x_halo, plan)
                    assert torch.equal(new, old), (x_halo, kw, ch3)


@pytest.mark.cuda
def test_cuda_colt_at_the_100k_grid():
    """24^3 cells at cap 40: equal bits under the default plan and under a
    plan that takes the shared-memory opt-in above 48 KiB; a plan above 227
    KiB raises with its size, and the launcher refuses a plan whose bytes
    are not its layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims, cap = (24, 24, 24), 40
    cells, counts, box, params = _random_cells(dims, cap, 7, fill=12)
    big = cell_pair.colt_launch_plan(dims, cap, 2, seg=4, threads=256,
                                     depth=8)
    assert big.smem > 48 * 1024
    for plan in (None, big):
        for ch3 in (cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL):
            new, old = _colt_new_and_cellwise(cells, counts, box, params,
                                              dims, False, False, ch3,
                                              plan=plan)
            assert torch.equal(new, old), (plan, ch3)
    with pytest.raises(ValueError, match="227 KiB"):
        cell_pair.colt_launch_plan(dims, cap, 2, threads=1024, depth=16)
    dev = [t.cuda() for t in (cells, counts, box, params)]
    plan = cell_pair.colt_launch_plan(dims, cap, 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        cell_pair.cell_pair_forces_colt_kernel(
            *dev, dims, False, False, cell_pair.CH3_NONE,
            plan=plan._replace(smem=plan.smem + 16))


@pytest.mark.cuda
def test_cuda_colt_box_change_under_one_plan(melt):
    """The box (and every position with it) shrinks between two calls under
    one cached plan, as under a barostat: the cull reads the box on the
    device, and the kernel equals the cellwise kernel on each box."""
    built, _, st = melt
    cfg = built.cfg
    params = cell_pair.pair_params(built.spec, cfg.n_types)
    plan = cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                      cfg.n_types)
    outs = []
    for scale in (1.0, 0.97, 1.02):
        cells, counts = cell_pair.colt_operands(
            cell_pair.pack_rows(st.pos * scale, st.type_id, st.active),
            st.nbr.buckets, int(np.prod(cfg.cell_dims)))
        assert cell_pair.colt_launch_plan(cfg.cell_dims, cfg.cell_cap,
                                          cfg.n_types) is plan
        new, old = _colt_new_and_cellwise(
            cells, counts, st.box * scale, params, cfg.cell_dims, True, True,
            cell_pair.CH3_VIRIAL)
        assert torch.equal(new, old), scale
        outs.append(new)
    assert not torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_cuda_colt_gives_the_same_bits_twice(melt):
    built, _, st = melt
    cfg = built.cfg
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    dev = [t.cuda() for t in (cells, counts, st.box,
                              cell_pair.pair_params(built.spec, cfg.n_types))]
    a, b = (cell_pair.colt_cells(*dev, cfg.cell_dims, True, True,
                                 cell_pair.CH3_ENERGY) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# ---- K2's column-segment kernel against its cellwise kernel ------------------

def _k2_new_and_cellwise(cells, counts, box, params, dims, uniform, all_lj,
                         ch3, plan=None):
    """The column-segment K2's and the cellwise K2's rows on the card, from
    the same operands, each launch counted once."""
    dev = [t.cuda() for t in (cells, counts, box, params)]
    n0, o0 = cell_pair.K2.launches, cell_pair.K2_CELLWISE.launches
    new = cell_pair.cell_pair_forces_cell_kernel(*dev, dims, uniform, all_lj,
                                                 ch3, plan=plan)
    old = cell_pair.cell_pair_forces_cell_cellwise(*dev, dims, uniform,
                                                   all_lj, ch3)
    torch.cuda.synchronize()
    assert cell_pair.K2.launches == n0 + 1
    assert cell_pair.K2_CELLWISE.launches == o0 + 1
    return new, old


def _k2_same_bits(cells, counts, box, params, dims, plans=({},),
                  modes=MODES, plain=True):
    for kw in plans:
        plan = cell_pair.k2_launch_plan(dims, cells.shape[1],
                                        params.shape[1], **kw)
        for uniform, all_lj in modes:
            for ch3 in CH3:
                new, old = _k2_new_and_cellwise(cells, counts, box, params,
                                                dims, uniform, all_lj, ch3,
                                                plan)
                assert torch.equal(new, old), (kw, uniform, all_lj, ch3)
                if plain:
                    ref = cell_pair.cell_pair_forces_cell_ref(
                        cells.cpu(), counts.cpu(), box.cpu(), params.cpu(),
                        dims, uniform, all_lj, ch3)
                    torch.testing.assert_close(new.cpu(), ref, rtol=0,
                                               atol=_tol(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", ["cap36", "grid222"])
@pytest.mark.parametrize("uniform,all_lj", MODES,
                         ids=["uniform", "all_lj", "islj"])
def test_cuda_k2_equals_cellwise_on_the_small_melts(k2_melts, grid, uniform,
                                                    all_lj):
    """The 70-trimer melt at cap 36 (3^3) and the 2x2x2 melt: the new K2
    equals the cellwise K2 bit for bit in every channel, under the default
    plan and under lists of one pass, and the plain version to f32
    rounding."""
    built, _, st = k2_melts[grid]
    cfg = built.cfg
    spec = built.spec if uniform else _mixed(built.spec, cfg.n_types,
                                             not all_lj)
    cells, counts, box, params = _melt_ops(built, st, spec)
    _k2_same_bits(cells, counts, box, params, cfg.cell_dims,
                  plans=({}, dict(depth=1)), modes=[(uniform, all_lj)])


@pytest.mark.cuda
def test_cuda_k2_equals_cellwise_at_10k_cap36():
    """The 10k melt at cap 36 (11^3, S = 27, the K2 main path's grid),
    built and warmed on the card: the same bits in every mode and channel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    built, _, _ = testsystems.build_melt(n_mols=3334, cell_cap=36,
                                         device="cuda")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=100)
    cfg = built.cfg
    assert not cell_pair.colt_legal(cfg.cell_cap, cfg.cell_dims)
    for uniform, all_lj in MODES:
        spec = built.spec if uniform else _mixed(built.spec.to("cpu"),
                                                 cfg.n_types, not all_lj)
        cells, counts, box, params = _melt_ops(built, st, spec)
        _k2_same_bits(cells, counts, box, params.cuda(), cfg.cell_dims,
                      modes=[(uniform, all_lj)], plain=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 2, 4), 13), ((4, 3, 1), 20),
                                      ((2, 1, 2), 9), ((1, 3, 2), 36),
                                      ((2, 3, 1), 13), ((2, 2, 2), 400)])
def test_cuda_k2_equals_cellwise_on_ragged_grids(dims, cap):
    """Random occupancy on grids with an axis of 1 or 2 cells and caps
    that are no multiple of 8 (cap 400: the stage's opt-in above 48 KiB):
    the same bits under the default plan and plans of other segments,
    batches and list depths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    cells, counts, box, params = _random_cells(dims, cap, cap, fill=40)
    # a segment of 2 stages 4 cells a column: more than 227 KiB at cap 400
    _k2_same_bits(cells, counts, box, params, dims,
                  plans=({}, dict(seg=1, rows=5, threads=32, depth=1),
                         dict(seg=2 if cap < 200 else 1, rows=32,
                              threads=128, depth=2)))


@pytest.mark.cuda
def test_cuda_k2_equals_cellwise_on_the_film():
    """The film (32 x 32 x 2 cells, ~13.5k particles, S = 18; the kernel
    matrix's operand) with the melt's parameters: the same bits in every
    mode and channel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    from chemlab_tpu_torch import kernel_matrix

    built, _, _ = testsystems.build_melt(n_mols=70, device="cuda")
    cells, counts, box, dims = kernel_matrix.film_operands(built)
    assert len(neighbor.neighbor_cell_offsets(dims)) == 18
    for uniform, all_lj in MODES:
        spec = built.spec if uniform else _mixed(built.spec.to("cpu"),
                                                 built.cfg.n_types,
                                                 not all_lj)
        params = cell_pair.pair_params(spec, built.cfg.n_types)
        _k2_same_bits(cells, counts, box, params, dims,
                      modes=[(uniform, all_lj)], plain=False)


# ---- K3b's warp-per-row kernel against its baseline -------------------------

def _resident_same_bits(cells, counts, box, params, dims, plans=({},)):
    """In both parameter modes: K3b's baseline against the cellwise K2 (both
    channels) and the new K3b under each plan against the baseline, each
    launch counted once."""
    dev = [t.cuda() for t in (cells, counts, box, params)]
    for uniform in (True, False):
        o0 = cell_pair.K3B_CELLWISE.launches
        old = variants.resident_packet_kernel(*dev, dims, uniform)
        k2_e = cell_pair.cell_pair_forces_cell_cellwise(
            *dev, dims, uniform, False, cell_pair.CH3_ENERGY)
        k2_w = cell_pair.cell_pair_forces_cell_cellwise(
            *dev, dims, uniform, False, cell_pair.CH3_VIRIAL)
        torch.cuda.synchronize()
        assert cell_pair.K3B_CELLWISE.launches == o0 + 1
        assert torch.equal(old[..., :4], k2_e) and torch.equal(
            old[..., 4], k2_w[..., 3])
        for kw in plans:
            plan = variants.resident_launch_plan(cells.shape[1], **kw)
            n0 = cell_pair.K3B.launches
            new = variants.ladder_kernel("resident", *dev, dims, uniform,
                                         plan=plan)
            torch.cuda.synchronize()
            assert cell_pair.K3B.launches == n0 + 1
            assert torch.equal(new, old), (uniform, plan)


@pytest.mark.cuda
def test_cuda_resident_equals_baseline_on_the_melt(melt32):
    """The 70-trimer melt at cap 32, the melt's parameters and per-pair
    ones: the same bits as the baseline (and K2) under the default plan,
    batches of 8 and 32 slots, and under lists of one pass."""
    built, _, st = melt32
    cfg = built.cfg
    for spec in (built.spec, _mixed(built.spec, cfg.n_types, True)):
        _resident_same_bits(*_melt_ops(built, st, spec), cfg.cell_dims,
                            plans=({}, dict(rows=8),
                                   dict(rows=1, depth=1),
                                   dict(rows=32, threads=256, depth=2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((2, 3, 4), 16), ((3, 4, 2), 40),
                                      ((2, 2, 2), 24)])
def test_cuda_resident_equals_baseline_on_ragged_grids(dims, cap):
    """Random occupancy on grids with an axis of 2 at caps that are
    multiples of 8: the same bits as the baseline and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    _resident_same_bits(*_random_cells(dims, cap, cap), dims,
                        plans=({}, dict(rows=8), dict(rows=3,
                                                      threads=160,
                                                      depth=1)))


@pytest.mark.cuda
def test_cuda_resident_equals_baseline_at_the_100k_grid():
    """24^3 cells at cap 40: the same bits as the baseline and K2; a plan
    above 227 KiB raises with its size, and the launcher refuses a plan
    whose bytes are not its layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims, cap = (24, 24, 24), 40
    ops = _random_cells(dims, cap, 7, fill=12)
    _resident_same_bits(*ops, dims, plans=({}, dict(rows=32, depth=2)))
    with pytest.raises(ValueError, match="227 KiB"):
        variants.resident_launch_plan(cap, threads=1024, depth=12)
    dev = [t.cuda() for t in ops]
    plan = variants.resident_launch_plan(cap)
    with pytest.raises(RuntimeError, match="launch failed"):
        variants.ladder_kernel("resident", *dev, dims, False,
                               plan=plan._replace(smem=plan.smem + 20))


# ---- the ladder's redesigns against their first designs ---------------------

# each redesigned ladder kind: its first design's wrapper and handle, and
# its launch plan from (cap, dims, n_types, **overrides)
BASELINES = {
    "packet": (variants.packet_baseline_kernel, cell_pair.K3A_CELLWISE,
               lambda cap, dims, n_types, **kw: variants.packet_launch_plan(
                   cap, **kw)),
    "colz": (variants.colz_baseline_kernel, cell_pair.K3C_CELLWISE,
             lambda cap, dims, n_types, **kw: variants.colz_launch_plan(
                 cap, dims, **kw)),
    "column": (variants.column_baseline_kernel, cell_pair.K3D_CELLWISE,
               lambda cap, dims, n_types, **kw: variants.column_launch_plan(
                   cap, dims, **kw)),
    "colt1": (variants.colt1_baseline_kernel, cell_pair.K1P_CELLWISE,
              lambda cap, dims, n_types, **kw: variants.colt1_launch_plan(
                  dims, cap, n_types, **kw))}


def _ladder_same_bits(kind, cells, counts, box, params, dims, plans=({},)):
    """In both parameter modes (and, for K1', both of its channels): the
    first design of ``kind`` ("packet" K3a, "colz" K3c, "column" K3d) against
    the cellwise K2 (both channels) bit for bit, K1''s against K1 to f32
    rounding, and the new kernel under each plan (dicts of its
    ``*_launch_plan``'s overrides) against the first design, each launch
    counted once."""
    old_fn, old_k, make_plan = BASELINES[kind]
    new_k = variants.KERNEL_OF[kind]
    dev = [t.cuda() for t in (cells, counts, box, params)]
    cap, n_types = cells.shape[1], params.shape[1]
    modes = ((cell_pair.CH3_ENERGY, cell_pair.CH3_VIRIAL) if kind == "colt1"
             else (cell_pair.CH3_ENERGY,))
    for uniform in (True, False):
        for mode in modes:
            o0 = old_k.launches
            old = old_fn(*dev, dims, uniform, mode)
            torch.cuda.synchronize()
            assert old_k.launches == o0 + 1
            if kind == "colt1":
                k1 = cell_pair.colt_cells(*dev, dims, uniform, False, mode)
                torch.cuda.synchronize()
                torch.testing.assert_close(old, k1, rtol=0, atol=_tol(k1))
            else:
                k2_e = cell_pair.cell_pair_forces_cell_cellwise(
                    *dev, dims, uniform, False, cell_pair.CH3_ENERGY)
                k2_w = cell_pair.cell_pair_forces_cell_cellwise(
                    *dev, dims, uniform, False, cell_pair.CH3_VIRIAL)
                torch.cuda.synchronize()
                assert torch.equal(old[..., :4], k2_e) and torch.equal(
                    old[..., 4], k2_w[..., 3])
            for kw in plans:
                plan = make_plan(cap, dims, n_types, **kw)
                n0 = new_k.launches
                new = variants.ladder_kernel(kind, *dev, dims, uniform, mode,
                                             plan=plan)
                torch.cuda.synchronize()
                assert new_k.launches == n0 + 1
                assert torch.equal(new, old), (kind, uniform, mode, plan)


@pytest.mark.cuda
def test_cuda_packet_equals_baseline_on_the_melt(melt32):
    """The 70-trimer melt at cap 32, the melt's parameters and per-pair
    ones: the same bits as K3a's first design (and K2) under the default
    plan, one warp a block, and lists of one pass."""
    built, _, st = melt32
    cfg = built.cfg
    for spec in (built.spec, _mixed(built.spec, cfg.n_types, True)):
        _ladder_same_bits("packet", *_melt_ops(built, st, spec),
                          cfg.cell_dims,
                          plans=({}, dict(threads=32, depth=1),
                                 dict(threads=128, depth=2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((2, 3, 4), 16), ((3, 4, 2), 40),
                                      ((2, 2, 2), 24)])
def test_cuda_packet_equals_baseline_on_ragged_grids(dims, cap):
    """Random occupancy (cells filled past one packet) on grids with an
    axis of 2 at caps that are multiples of 8: the same bits as the first
    design and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    _ladder_same_bits("packet", *_random_cells(dims, cap, cap), dims,
                      plans=({}, dict(threads=32, depth=1),
                             dict(threads=96, depth=2)))


@pytest.mark.cuda
def test_cuda_packet_equals_baseline_at_the_100k_grid():
    """24^3 cells at cap 40 and 48: the same bits as the first design and
    K2; a plan above 227 KiB raises naming K3a with its size, and the
    launcher refuses a plan whose bytes are not its layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims = (24, 24, 24)
    for cap in (40, 48):
        _ladder_same_bits("packet", *_random_cells(dims, cap, 7, fill=12),
                          dims, plans=({}, dict(threads=128, depth=2)))
    with pytest.raises(ValueError, match="K3a: shared memory"):
        variants.packet_launch_plan(48, threads=1024, depth=12)
    dev = [t.cuda() for t in _random_cells(dims, 40, 7, fill=12)]
    plan = variants.packet_launch_plan(40)
    with pytest.raises(RuntimeError, match="launch failed"):
        variants.ladder_kernel("packet", *dev, dims, False,
                               plan=plan._replace(smem=plan.smem + 20))


@pytest.mark.cuda
def test_cuda_column_equals_baseline_on_the_melts(melt32, k2_melts):
    """The 70-trimer melt at cap 32 and the K2 melts (cap 36 and the 2x2x2
    grid), the melt's parameters and per-pair ones: the same bits as K3d's
    first design (and K2) under the default plan, batches of 1 and 32
    slots, and lists of one pass."""
    melts = [melt32[0::2]] + [(b, s) for b, _, s in k2_melts.values()]
    for built, st in melts:
        cfg = built.cfg
        for spec in (built.spec, _mixed(built.spec, cfg.n_types, True)):
            _ladder_same_bits("column", *_melt_ops(built, st, spec),
                              cfg.cell_dims,
                              plans=({}, dict(rows=1, threads=32, depth=1),
                                     dict(rows=32, threads=256, depth=2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((3, 2, 4), 20),
                                      ((4, 3, 1), 13), ((2, 2, 2), 36)])
def test_cuda_column_equals_baseline_on_ragged_grids(dims, cap):
    """Random occupancy on grids with axes of 2 and 1 (a window of 2 cells,
    or 1) at any cap: the same bits as the first design and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    _ladder_same_bits("column", *_random_cells(dims, cap, cap), dims,
                      plans=({}, dict(rows=3, threads=96, depth=1)))


@pytest.mark.cuda
def test_cuda_column_equals_baseline_on_the_film():
    """The film (32 x 32 x 2 cells, ~13.5k particles, S = 18, windows of 2
    cells) with the melt's parameters and per-pair ones: the same bits as
    the first design and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    from chemlab_tpu_torch import kernel_matrix

    built, _, _ = testsystems.build_melt(n_mols=70, device="cuda")
    cells, counts, box, dims = kernel_matrix.film_operands(built)
    for spec in (built.spec, _mixed(built.spec.to("cpu"), built.cfg.n_types,
                                    True)):
        _ladder_same_bits("column", cells, counts, box,
                          cell_pair.pair_params(spec, built.cfg.n_types),
                          dims)


@pytest.mark.cuda
def test_cuda_column_equals_baseline_at_the_100k_grid():
    """24^3 cells at cap 40 and 48: the same bits as the first design and
    K2; a plan above 227 KiB raises naming K3d with its size, and the
    launcher refuses a plan whose bytes are not its layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims = (24, 24, 24)
    for cap in (40, 48):
        _ladder_same_bits("column", *_random_cells(dims, cap, 7, fill=12),
                          dims, plans=({}, dict(rows=8, threads=256,
                                                depth=2)))
    with pytest.raises(ValueError, match="K3d: shared memory"):
        variants.column_launch_plan(48, dims, threads=1024, depth=12)
    dev = [t.cuda() for t in _random_cells(dims, 40, 7, fill=12)]
    plan = variants.column_launch_plan(40, dims)
    with pytest.raises(RuntimeError, match="launch failed"):
        variants.ladder_kernel("column", *dev, dims, False,
                               plan=plan._replace(smem=plan.smem + 20))


@pytest.mark.cuda
def test_cuda_colz_equals_baseline_on_the_melt(melt32):
    """The 70-trimer melt at cap 32, the melt's parameters and per-pair
    ones: the same bits as K3c's first design (and K2) under the default
    plan, one warp a block with lists of one pass, and batches of 3 rows."""
    built, _, st = melt32
    cfg = built.cfg
    for spec in (built.spec, _mixed(built.spec, cfg.n_types, True)):
        _ladder_same_bits("colz", *_melt_ops(built, st, spec), cfg.cell_dims,
                          plans=({}, dict(rows=1, threads=32, depth=1),
                                 dict(rows=3, threads=896, depth=2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 2, 4), 16), ((4, 3, 1), 8),
                                      ((2, 2, 2), 24), ((5, 4, 3), 32)])
def test_cuda_colz_equals_baseline_on_ragged_grids(dims, cap):
    """Random occupancy on grids with axes of 2 and 1 (U < 9 columns, a
    column of fewer than 3 distinct cells) at caps that are multiples of 8:
    the same bits as the first design and K2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    _ladder_same_bits("colz", *_random_cells(dims, cap, cap), dims,
                      plans=({}, dict(rows=3, threads=96, depth=1)))


@pytest.mark.cuda
def test_cuda_colz_equals_baseline_at_the_100k_grid():
    """24^3 cells at cap 40 and 48: the same bits as the first design and
    K2; the default plan's warps shrink to fit the stage, a plan above 227
    KiB raises naming K3c with its size, and the launcher refuses a plan
    whose bytes are not its layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims = (24, 24, 24)
    for cap in (40, 48):
        _ladder_same_bits("colz", *_random_cells(dims, cap, 7, fill=12),
                          dims, plans=({}, dict(rows=1, threads=256,
                                                depth=2)))
    with pytest.raises(ValueError, match="K3c: shared memory"):
        variants.colz_launch_plan(48, dims, threads=896, depth=4)
    dev = [t.cuda() for t in _random_cells(dims, 40, 7, fill=12)]
    plan = variants.colz_launch_plan(40, dims)
    with pytest.raises(RuntimeError, match="launch failed"):
        variants.ladder_kernel("colz", *dev, dims, False,
                               plan=plan._replace(smem=plan.smem + 20))


@pytest.mark.cuda
def test_cuda_colt1_equals_baseline_on_the_melt(melt32):
    """The 70-trimer melt at cap 32, the melt's parameters and per-pair
    ones, ch3 modes 1 and 2: the same bits as K1''s first design (within
    f32 rounding of K1) under the default plan, segments of 1 and nz, and
    lists of one pass."""
    built, _, st = melt32
    cfg = built.cfg
    for spec in (built.spec, _mixed(built.spec, cfg.n_types, True)):
        _ladder_same_bits("colt1", *_melt_ops(built, st, spec),
                          cfg.cell_dims,
                          plans=({}, dict(seg=1, rows=1, threads=32, depth=1),
                                 dict(seg=3, rows=4, threads=128, depth=2)))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((4, 3, 3), 24),
                                      ((3, 3, 6), 8)])
def test_cuda_colt1_equals_baseline_on_ragged_grids(dims, cap):
    """Random occupancy on odd grids of at least 3 cells an axis: the same
    bits as the first design, segments of 1, 3 and nz."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    _ladder_same_bits("colt1", *_random_cells(dims, cap, cap), dims,
                      plans=({}, dict(seg=1), dict(seg=3, rows=3, threads=64,
                                                   depth=1),
                             dict(seg=dims[2])))


@pytest.mark.cuda
def test_cuda_colt1_equals_baseline_at_the_100k_grid():
    """24^3 cells at cap 40 and 48: the same bits as the first design under
    the default plan and a segment of nz (one block per xy column, ~205 KB
    of shared memory at cap 48); a plan above 227 KiB raises naming K1'
    with its size, and the launcher refuses a plan whose bytes are not its
    layout's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    dims = (24, 24, 24)
    for cap in (40, 48):
        _ladder_same_bits("colt1", *_random_cells(dims, cap, 7, fill=12),
                          dims, plans=({}, dict(seg=24)))
    with pytest.raises(ValueError, match="K1': shared-memory stage"):
        variants.colt1_launch_plan(dims, 56, 2, seg=24)
    dev = [t.cuda() for t in _random_cells(dims, 40, 7, fill=12)]
    plan = variants.colt1_launch_plan(dims, 40, 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        variants.ladder_kernel("colt1", *dev, dims, False,
                               plan=plan._replace(smem=plan.smem + 20))


# ---- the bonded layer: the step-growth chain melt ---------------------------

@pytest.fixture(scope="module")
def chain_melt(tmp_path_factory):
    """The 40-tetramer chain melt (3x3x3 cells, K1), built and warmed on
    the CPU: func-8 bonds and angles, Ryckaert-Bellemans dihedrals, 1-4
    pairs and the full-row E + E link."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU build)")
    table_dir = str(tmp_path_factory.mktemp("chain_tables"))
    testsystems.write_chain_tables(table_dir)
    built, _, _ = testsystems.build_chain_melt(
        n_mols=40, density=0.22, device="cpu", table_dir=table_dir)
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=50)
    return built, st


@pytest.mark.cuda
def test_cuda_chain_bonded_matches_cpu(chain_melt):
    """Bonded forces, every energy term (dihedral funcs 1, 3, 8, 12, the
    1-4 pairs, func-8 bonds and angles) and the bonded strain derivative
    on the card against the CPU, the F ends turned so the type lookups
    run; a second call on the card gives the same bits."""
    from chemlab_tpu_torch.engine import bonded_forces

    built, st = chain_melt
    cfg = built.cfg
    tid = st.type_id.clone()
    tid[[0, 8, 15]] = int(built.spec.r_new_type1[0])
    st = dataclasses.replace(st, type_id=tid)
    out = {}
    for dev in ("cpu", "cuda"):
        s, spec = st.to(dev), built.spec.to(dev)
        args = (spec, cfg, s.pos, s.box, s.type_id, s.q, s.bonds, s.angles,
                s.dihedrals, s.pairs14)
        dense = integrate._dense_of(cfg, s)
        f, e = bonded_forces.bonded_forces(*args, dense=dense)
        w = bonded_forces.bonded_strain_derivative(*args, dense=dense)
        out[dev] = (f.cpu(), {k: float(v) for k, v in e.items()}, float(w))
        if dev == "cuda":
            f2, _ = bonded_forces.bonded_forces(*args, dense=dense)
            assert torch.equal(f, f2)
    (f_c, e_c, w_c), (f_g, e_g, w_g) = out["cpu"], out["cuda"]
    assert e_c["dihedral_f12"] != 0.0 and e_c["lj14"] != 0.0
    for k in e_c:
        assert abs(e_g[k] - e_c[k]) <= 2e-5 * (1.0 + abs(e_c[k])), k
    torch.testing.assert_close(f_g, f_c, rtol=0, atol=_tol(f_c))
    assert abs(w_g - w_c) <= 2e-5 * (1.0 + abs(w_c))


@pytest.mark.cuda
def test_cuda_fullrow_events_equal_cpu(chain_melt):
    """One full-row reaction step on the card and on the CPU from one
    state: the same event lists and the same tables after them."""
    from chemlab_tpu_torch.engine import reactions

    built, st = chain_melt
    st = dataclasses.replace(
        st, step=torch.full_like(st.step, 200),
        reactions_on=torch.ones((), dtype=torch.bool),
        reaction_rates=st.reaction_rates * 2.5)
    assert not built.cfg.rx_compact
    outs = [reactions.reaction_step(built.spec.to(dev), built.cfg,
                                    st.to(dev), 0) for dev in ("cpu", "cuda")]
    assert int((outs[0].ev_log_a >= 0).sum()) > 0
    for name in ("ev_log_a", "ev_log_b", "ev_log_r", "excl", "adj",
                 "mol_id", "type_id"):
        assert torch.equal(getattr(outs[1], name).cpu(),
                           getattr(outs[0], name)), name
    for t in ("bonds", "angles", "dihedrals"):
        for k in ("idx", "func", "params", "lam"):
            assert torch.equal(getattr(getattr(outs[1], t), k).cpu(),
                               getattr(getattr(outs[0], t), k)), (t, k)


# ---- the reaction extensions: the break and release melts -------------------

EXT_FIELDS = ("ev_log_a", "ev_log_b", "ev_log_r", "excl", "n_excl", "adj",
              "mol_id", "type_id", "chem_state", "fixd_host", "fixd_dummy",
              "active", "lam", "reaction_counts", "atrp_stats",
              "atrp_ratios", "freeze_count")


def _ext_state(built, systop, seed):
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=30)
    st = testsystems.activate_initiators(built, systop, st, n=12, seed=seed)
    return dataclasses.replace(st, step=torch.full_like(st.step, 200),
                               reaction_rates=st.reaction_rates * 5.0)


def _assert_ext_equal(card, cpu):
    for name in EXT_FIELDS:
        assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name)), \
            name
    for t in ("bonds", "angles", "dihedrals"):
        for k in ("idx", "func", "params", "lam", "group"):
            assert torch.equal(getattr(getattr(card, t), k).cpu(),
                               getattr(getattr(cpu, t), k)), (t, k)
    assert bool(card.nbr.overflow) == bool(cpu.nbr.overflow)


@pytest.mark.cuda
def test_cuda_break_reaction_step_equals_cpu(tmp_path):
    """The break melt (40 trimers): one reaction step with the sequential
    scan (ChangeNeighboursProperty, RemoveNeighboursBonds), the restricted
    chain growth and the dissociation, on the card and on the CPU from one
    state: the same events, tables, molecules and lambdas."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chemlab_tpu_torch.engine import reactions

    built, systop, _ = testsystems.build_break_melt(
        n_mols=40, density=0.4, seed=5, table_dir=str(tmp_path),
        diss_rate=2.0, device="cpu", max_events=16)
    st = _ext_state(built, systop, 1)
    outs = [reactions.reaction_step(built.spec.to(dev), built.cfg,
                                    st.to(dev), 0) for dev in ("cpu", "cuda")]
    counts = outs[0].reaction_counts.tolist()
    assert counts[0] > 0 and counts[2] > 0, counts
    _assert_ext_equal(outs[1], outs[0])


@pytest.mark.cuda
def test_cuda_release_reaction_step_equals_cpu():
    """The release melt (80 trimers and 160 dummies): one reaction step
    (releases and joins), then the ATRP, ChangeParticleType and
    FreezeRegion steps under the same draws (removal included), on the
    card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chemlab_tpu_torch.engine import reactions

    built, systop, _ = testsystems.build_release_melt(
        n_mols=80, density=0.3, seed=3, freeze_width=1.5, freeze_prob=0.5,
        device="cpu", max_events=16)
    cfg = built.cfg
    st = _ext_state(built, systop, 2)
    gen = torch.Generator().manual_seed(9)
    n = st.pos.shape[0]
    atrp = (torch.randint(0, 12, (cfg.atrp_num,), generator=gen),
            torch.rand(cfg.atrp_num, generator=gen))
    u_cpt, u_fr = torch.rand(n, generator=gen), torch.rand(n, generator=gen)
    outs = []
    for dev in ("cpu", "cuda"):
        spec, s = built.spec.to(dev), st.to(dev)
        s = reactions.reaction_step(spec, cfg, s, 0)
        s = reactions.atrp_step(spec, cfg, s, draws=atrp)
        s = reactions.freeze_region_step(spec, cfg, s, u=u_fr)
        s = reactions.change_particle_type_step(spec, cfg, s, u=u_cpt)
        outs.append(s)
    assert int((outs[0].ev_log_a >= 0).sum()) > 0
    assert int(outs[0].atrp_stats.sum()) > 0 and int(outs[0].freeze_count)
    _assert_ext_equal(outs[1], outs[0])


@pytest.mark.cuda
def test_cuda_row_path_matches_cpu():
    """The row melt at 70 trimers (funcs 8 and 13-17, LJ, Coulomb between
    charges, all on the Verlet row path): pair forces, energies and the
    virial on the card against the CPU on one state, then 20 NVE steps
    with a reaction step every 10 from one state: rows, births and events
    identical, positions to f32 rounding; no cell kernel is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    built, systop, _ = testsystems.build_row_melt(n_mols=70, thermostat="no",
                                                  device="cpu")
    cfg = dataclasses.replace(built.cfg, reaction_interval=10)
    assert not cfg.use_pallas and not cfg.lazy_rows
    st = runner.initial_forces(built.spec, cfg, built.state)
    st = testsystems.warmup(built, st, steps=30)
    st = testsystems.activate_initiators(built, systop, st, n=10)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 40.0,
                             step=torch.full_like(st.step, 50))
    spec_g, st_g = built.spec.to("cuda"), st.to("cuda")
    before = {k: c.launches for k, c in cell_pair.BY_NAME.items()}
    f_c, e_c, _ = integrate.compute_forces(built.spec, cfg, st)
    f_g, e_g, _ = integrate.compute_forces(spec_g, cfg, st_g)
    torch.testing.assert_close(f_g.cpu(), f_c, rtol=0, atol=_tol(f_c))
    for k in ("lj", "lj-tab", "coulomb"):
        torch.testing.assert_close(e_g[k].cpu(), e_c[k], rtol=0,
                                   atol=2e-5 * (1.0 + abs(float(e_c[k]))))
    w_c = integrate.row_strain_derivative(built.spec, cfg, st)
    w_g = integrate.row_strain_derivative(spec_g, cfg, st_g)
    assert abs(float(w_g) - float(w_c)) <= 2e-5 * (1.0 + abs(float(w_c)))
    c = runner.run_block(built.spec, cfg, st, 20)
    g = runner.run_block(spec_g, cfg, st_g, 20)
    assert int(c.reaction_counts.sum()) > 0
    torch.testing.assert_close(g.pos.cpu(), c.pos, rtol=0, atol=1e-5)
    for name in ("ev_log_a", "ev_log_b", "ev_log_r", "type_id", "q",
                 "n_excl"):
        torch.testing.assert_close(getattr(g, name).cpu(), getattr(c, name),
                                   rtol=0, atol=0)
    for name in ("idx", "birth", "excl_mask", "n_rebuilds"):
        torch.testing.assert_close(getattr(g.nbr, name).cpu(),
                                   getattr(c.nbr, name), rtol=0, atol=0)
    assert before == {k: c_.launches for k, c_ in cell_pair.BY_NAME.items()}


@pytest.mark.cuda
def test_cuda_native_builds_and_tune_skin_counts_k1():
    """The host library builds and reads the example's .gro as the Python
    reader does; ``tune_skin`` on the card runs K1 for every step of its
    two blocks and the initial forces of each candidate."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from chemlab_tpu_torch import files_io, native
    from chemlab_tpu_torch.engine import build, tuning

    assert native.available()
    conf = str(Path(__file__).resolve().parent.parent
               / "examples" / "atrp_melt" / "conf.gro")
    fast, slow = files_io.read_gro_native(conf), files_io.read_gro(conf)
    assert fast.atom_names == slow.atom_names
    np.testing.assert_array_equal(fast.pos, slow.pos)
    _, systop, coords = testsystems.build_melt(n_mols=70, reactive=False,
                                               device="cpu")
    opts = build.SimOptions(**testsystems.melt_options())
    k1 = cell_pair.BY_NAME["K1"]
    before = k1.launches
    best, res = tuning.tune_skin(systop, coords, opts,
                                 candidates=(0.3, 0.4), block_steps=10,
                                 verbose=False)
    assert sorted(res) == [0.3, 0.4] and best in res
    assert k1.launches - before == 2 * (2 * 10 + 1)


def _two_ranks_on_the_card(jobs, tmp_path):
    from chemlab_tpu_torch.parallel import launch

    return launch.run_jobs(jobs, 2, tmp_path, backend="gloo",
                           device="cuda:0", timeout=600)


@pytest.mark.cuda
def test_cuda_row_split_on_two_ranks(tmp_path):
    """The row melt (160 trimers, ``slab_devices=2``) on 2 gloo ranks of
    cuda:0, each its block of rows, against one rank on the card: the
    ranks agree bit for bit; forces to ``2e-5 (1 + max|F|)`` (a block's
    row sums may reduce in another order than the whole plane's on the
    card), energies and the virial pressure to 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chemlab_tpu_torch import bridge

    built, systop, _ = testsystems.build_row_melt(
        n_mols=160, slab_devices=2, device="cpu")
    st = runner.initial_forces(built.spec, built.cfg, built.state)
    st = testsystems.warmup(built, st, steps=30)
    (res,) = _two_ranks_on_the_card(
        [("forces", dict(system=bridge.to_numpy(built.cfg, built.spec,
                                                st)))], tmp_path / "store")
    spec, sg = built.spec.to("cuda"), st.to("cuda")
    f, e, _ = integrate.compute_forces(spec, built.cfg, sg)
    p = float(integrate.virial_pressure(spec, built.cfg, sg))
    f = f.cpu()
    for r in res:
        assert r["force"].tobytes() == res[0]["force"].tobytes()
        assert r["P"].tobytes() == res[0]["P"].tobytes()
        torch.testing.assert_close(torch.from_numpy(r["force"]), f, rtol=0,
                                   atol=_tol(f))
        for k in ("lj", "lj-tab", "coulomb"):
            assert float(r["energies"][k]) == pytest.approx(
                float(e[k]), rel=1e-5, abs=1e-6), k
        assert float(r["P"]) == pytest.approx(p, rel=1e-5, abs=1e-6)


@pytest.mark.cuda
def test_cuda_extension_block_on_two_ranks(tmp_path):
    """The release melt (160 trimers and 320 dummies, ``slab_devices=2``:
    4 x-layers) over a reaction interval with ATRP, ChangeParticleType
    and a removing FreezeRegion, on 2 gloo ranks of cuda:0 (K1f) against
    one rank on the card (K1): every leaf of the final state bit for bit
    on both ranks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from chemlab_tpu_torch import bridge

    built, systop, _ = testsystems.build_release_melt(
        n_mols=160, freeze_width=0.5, freeze_prob=0.05, max_events=16,
        slab_devices=2, device="cpu")
    cfg = dataclasses.replace(built.cfg, reaction_interval=10)
    st = runner.initial_forces(built.spec, cfg, built.state)
    st = testsystems.warmup(built, st, steps=30)
    st = testsystems.activate_initiators(built, systop, st, n=16)
    st = dataclasses.replace(st, reaction_rates=st.reaction_rates * 10.0)
    (res,) = _two_ranks_on_the_card(
        [("run_blocks", dict(system=bridge.to_numpy(cfg, built.spec, st),
                             n_blocks=1, block_steps=25, seed=5))],
        tmp_path / "store")
    one = runner.run_block(built.spec.to("cuda"), cfg, st.to("cuda"), 25,
                           gen=runner.make_generator(5, "cuda"))
    ref = bridge.tree_to_numpy(one)
    assert int(one.reaction_counts.sum()) > 0 and int(one.atrp_stats.sum())

    def leaves(tree, path=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, path + k + ".")
            else:
                yield path + k, v

    for r in res:
        assert r["launches"]["K1f"] == 25
        got = dict(leaves(r["state"]))
        for p, v in leaves(ref):
            assert (v is None and got[p] is None) or \
                got[p].tobytes() == v.tobytes(), p
