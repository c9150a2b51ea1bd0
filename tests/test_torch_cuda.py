"""The port on a card: the CUDA K1 (LJ), K1c/K1d/K1e (Chebyshev tabulated)
and K2 (per-cell LJ, any grid) against their plain versions, K2 against K1
on a full grid, the cancellation at r -> 0, and short runs on the card
against the CPU path: LJ, tabulated, and NPT on the K2 grid.

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
