"""Packaging rules of the port: no jax and nothing of the JAX package, the
card as the default device, a kernel build that keeps the cancellation
contract, and wrappers that never fall back on a card.

These run without a GPU; the card's own tests are in ``test_torch_cuda.py``.
"""

import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chemlab_tpu_torch
from chemlab_tpu_torch.engine import _kernels, bonded_forces, cell_pair

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        chemlab_tpu_torch.__path__, "chemlab_tpu_torch."))


def test_every_module_imports_without_jax():
    """Every module of the port and ``chip_smoke`` import, in a fresh
    interpreter, neither jax nor any module of the JAX package."""
    mods = _modules()
    assert "chemlab_tpu_torch.engine.cell_pair" in mods and len(mods) >= 28
    for m in ("topfile", "topology", "reaction_parser", "files_io",
              "engine.tab_cheb", "engine.cell_pair_halo", "parallel",
              "parallel.sharding", "parallel.launch", "parallel.jobs",
              "engine.cell_pair_variants", "kernel_matrix", "__main__",
              "start_simulation", "app_args", "tools", "units", "writers",
              "checkpoint", "hooks_compat", "engine.perf", "native",
              "table_tools", "lammps_io", "analysis", "nve_drift",
              "engine.tuning"):
        assert "chemlab_tpu_torch." + m in mods
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "ref = sorted(m for m in sys.modules if m == 'chemlab_tpu' "
            "or m.startswith('chemlab_tpu.'))\n"
            "print('JAX', bad)\n"
            "print('REF', ref)\n" % (mods,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "JAX []" in out.stdout, out.stdout
    assert "REF []" in out.stdout, out.stdout


def test_no_jax_import_in_sources():
    paths = list((REPO / "chemlab_tpu_torch").rglob("*.py"))
    assert REPO / "chemlab_tpu_torch" / "parallel" / "launch.py" in paths
    assert REPO / "chemlab_tpu_torch" / "engine" / "cell_pair_halo.py" \
        in paths
    assert REPO / "chemlab_tpu_torch" / "engine" / "cell_pair_variants.py" \
        in paths
    assert REPO / "chemlab_tpu_torch" / "kernel_matrix.py" in paths
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), \
                (path, line)


def test_no_reference_package_import_in_sources():
    """No line of the port or of ``chip_smoke.py`` imports the JAX package
    (``chemlab_tpu_torch`` itself is allowed)."""
    paths = list((REPO / "chemlab_tpu_torch").rglob("*.py"))
    assert REPO / "chemlab_tpu_torch" / "parallel" / "jobs.py" in paths
    assert REPO / "chemlab_tpu_torch" / "engine" / "cell_pair_variants.py" \
        in paths
    assert REPO / "chemlab_tpu_torch" / "kernel_matrix.py" in paths
    paths.append(REPO / "chip_smoke.py")
    for path in paths:
        for line in path.read_text().splitlines():
            s = line.strip()
            for head in ("import chemlab_tpu", "from chemlab_tpu"):
                if s.startswith(head):
                    assert s[len(head):].startswith("_torch"), (path, line)


def test_builders_default_to_the_card():
    """Without ``device`` the builders build on ``cuda``: where there is no
    card that raises, never falls back to the CPU."""
    import inspect

    from chemlab_tpu_torch import testsystems
    from chemlab_tpu_torch.engine import build
    for fn in (build.build_system, testsystems.build_melt,
               testsystems.build_tabulated_melt,
               testsystems.build_mixed_tab_melt,
               testsystems.build_chain_melt, testsystems.build_break_melt,
               testsystems.build_release_melt, testsystems.build_row_melt,
               testsystems.build_exchange_melt):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU (the card test covers it)")
    with pytest.raises((RuntimeError, AssertionError)):
        testsystems.build_melt(n_mols=70, reactive=False)


def test_kernel_build_flags():
    sources = {k.source for k in cell_pair.KERNELS}
    assert {s.name for s in sources} == {"cell_pair.cu", "cell_pair_cheb.cu",
                                         "cell_pair_cell.cu",
                                         "cell_pair_ladder.cu"}
    for source in sources:
        cmd = _kernels.nvcc_command("nvcc", source, Path("x.so"))
        flags = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in flags
        assert "--fmad=false" in cmd
        for bad in ("fast_math", "fast-math", "--ftz=true",
                    "--prec-div=false", "--prec-sqrt=false"):
            assert bad not in flags
    for k in cell_pair.KERNELS:
        assert k.source.is_file()
        assert k.library_path().parent == _kernels.BUILD_DIR
        assert 'extern "C" int %s(' % k.symbol in k.source.read_text()
    # one launch count per mode: K1, its virial channel K1b and its slab
    # mode K1f on one entry point, K1c, K1e and K1f-cheb on another, K1d
    # and K1f-cheb-mix on a third, K2 its own, and the ladder's five (K1p,
    # K3a-K3d) one entry point each
    assert len({id(k) for k in cell_pair.KERNELS}) == 14
    ladder = (cell_pair.K1P, cell_pair.K3A, cell_pair.K3B, cell_pair.K3C,
              cell_pair.K3D)
    assert {k.source.name for k in ladder} == {"cell_pair_ladder.cu"}
    assert len({k.symbol for k in ladder}) == 5
    assert cell_pair.K1.symbol == cell_pair.K1B.symbol \
        == cell_pair.K1F.symbol
    assert cell_pair.K1C.symbol == cell_pair.K1E.symbol \
        == cell_pair.K1F_CHEB.symbol
    assert cell_pair.K1D.symbol == cell_pair.K1F_CHEB_MIX.symbol
    assert cell_pair.K2.source.name == "cell_pair_cell.cu"


def test_kernel_source_rounds_half_to_even():
    """``jnp.round`` rounds half to even: the kernel's minimum image must use
    rintf, never roundf (half away from zero)."""
    for k in (cell_pair.K1, cell_pair.K1C, cell_pair.K2, cell_pair.K3A):
        # the source and the headers it includes (cell_pair_packed.cuh)
        src = "".join(p.read_text() for p in _kernels.source_files(k.source))
        assert "rintf(" in src and "roundf(" not in src
        assert "rsqrtf(" not in src and "__fdividef" not in src
    # the well piece's r is the correctly rounded sqrtf, never rsqrtf
    src = cell_pair.K1C.source.read_text()
    assert "sqrtf(r2)" in src and "rsqrtf(" not in src
    # and the plain version's torch.round agrees with numpy's half-to-even
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.round(x))


def test_bonded_kernel_source_and_flags():
    """The bonded kernel builds by the same route and flags, exports its
    entry point, rounds half to even, divides and takes square roots in
    IEEE, writes no FMA and adds no float atomically (its sums have one
    order)."""
    k = bonded_forces.BOND_ANGLE
    assert k.source.name == "bonded.cu" and k.source.is_file()
    assert _kernels.source_files(k.source) == [k.source]
    assert k.library_path().parent == _kernels.BUILD_DIR
    cmd = _kernels.nvcc_command("nvcc", k.source, Path("x.so"))
    assert "arch=compute_90a,code=sm_90a" in " ".join(cmd)
    assert "--fmad=false" in cmd
    src = k.source.read_text()
    assert 'extern "C" int %s(' % k.symbol in src
    assert "rintf(" in src and "sqrtf(" in src
    for bad in ("roundf(", "rsqrtf(", "__fdividef", "fmaf(", "__fma",
                "atomicAdd", "asm volatile"):
        assert bad not in src, bad
    assert len(k.argtypes) == 52


def test_every_header_is_in_the_source_scan():
    """The ladder's source reaches both headers it includes (the bulk-copy
    helpers and the packed layout), so they are hashed into its library's
    name and scanned: no FMA written out (``--fmad=false`` keeps a*b + c
    two roundings), no rsqrtf or __fdividef, and PTX only in the bulk-copy
    header's named helpers."""
    files = _kernels.source_files(cell_pair.K3A.source)
    assert {f.name for f in files} == {"cell_pair_ladder.cu",
                                       "cell_pair_bulk.cuh",
                                       "cell_pair_packed.cuh"}
    for k in cell_pair.KERNELS:
        for f in _kernels.source_files(k.source):
            src = f.read_text()
            for bad in ("fmaf(", "__fma", "rsqrtf(", "__fdividef",
                        "roundf("):
                assert bad not in src, (f.name, bad)
            assert ("asm volatile" in src) == (f.name == "cell_pair_bulk.cuh")


def _tiny_operands(device="cpu"):
    rng = np.random.RandomState(0)
    dims = (3, 3, 3)
    cap = 8
    cells = np.zeros((27, cap, 4), np.float32)
    counts = rng.randint(0, cap + 1, 27).astype(np.int32)
    for c in range(27):
        k = counts[c]
        cells[c, :k, :3] = rng.uniform(0, 3.0, (k, 3))
        cells[c, :k, 3] = 1.0
    box = np.array([3.0, 3.0, 3.0], np.float32)
    params = np.zeros((5, 1, 1), np.float32)
    params[:, 0, 0] = (0.3, 1.0, 0.81, 0.0, 1.0)
    return [torch.from_numpy(a).to(device) for a in
            (cells, counts, box, params)], dims


def test_wrapper_takes_plain_version_on_cpu_only():
    (cells, counts, box, params), dims = _tiny_operands()
    n0 = cell_pair.K1.launches
    out = cell_pair.colt_cells(cells, counts, box, params, dims, True, True,
                               cell_pair.CH3_ENERGY)
    assert out.shape == cells.shape and torch.isfinite(out).all()
    assert cell_pair.K1.launches == n0      # no kernel launch on the CPU
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_colt_kernel(cells, counts, box, params,
                                               dims, True, True, 0)
    with pytest.raises(ValueError, match="no version"):
        cell_pair.colt_cells(cells.to("meta"), counts, box, params, dims,
                             True, True, 0)


def test_k2_wrapper_takes_plain_version_on_cpu_only():
    """K2: CPU tensors take the plain version (no launch counted), the CUDA
    entry refuses CPU tensors; on a full grid plain K2 is plain K1."""
    (cells, counts, box, params), dims = _tiny_operands()
    n0 = cell_pair.K2.launches
    out = cell_pair.cell_cells(cells, counts, box, params, dims, True, True,
                               cell_pair.CH3_VIRIAL)
    assert out.shape == cells.shape and torch.isfinite(out).all()
    assert cell_pair.K2.launches == n0
    torch.testing.assert_close(out, cell_pair.colt_cells(
        cells, counts, box, params, dims, True, True, cell_pair.CH3_VIRIAL),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_cell_kernel(cells, counts, box, params,
                                               dims, True, True, 0)
    with pytest.raises(ValueError, match="no version"):
        cell_pair.cell_cells(cells.to("meta"), counts, box, params, dims,
                             True, True, 0)


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the smoke would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_cheb_wrapper_takes_plain_version_on_cpu_only():
    """K1c/K1d/K1e: CPU tensors take the plain version (no launch counted),
    the CUDA entry refuses CPU tensors, and each mode has its own count."""
    (cells, counts, box, _), dims = _tiny_operands()
    kw, ko = 2, 0
    coef = torch.zeros((1, 2 * kw + 2 * ko + 6))
    coef[0, :kw] = torch.tensor([1.0, 0.5])
    coef[0, 2 * kw + 5] = 0.25                       # rcap2
    cut2 = torch.full((1, 1), 0.81)
    tmap = torch.ones((1, 1), dtype=torch.int32)
    n0 = [k.launches for k in cell_pair.KERNELS]
    out = cell_pair.cheb_cells(cells, counts, box, cut2, tmap, None, None,
                               coef, dims, kw, ko, cell_pair.CH3_VIRIAL)
    assert out.shape == cells.shape and torch.isfinite(out).all()
    assert out[..., :3].abs().max() > 0
    assert [k.launches for k in cell_pair.KERNELS] == n0
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_cheb_kernel(
            cells, counts, box, cut2, tmap, None, None, coef, dims, kw, ko, 0)
    assert cell_pair.cheb_kernel_for(None, 1) is cell_pair.K1C
    assert cell_pair.cheb_kernel_for(tmap, 2) is cell_pair.K1D
    assert cell_pair.cheb_kernel_for(None, 0) is cell_pair.K1E


def test_k1f_wrapper_takes_plain_version_on_cpu_only():
    """K1f (``x_halo``): CPU tensors take the plain version and count no
    launch, the CUDA entry refuses CPU tensors, and the slab of 3 layers
    returns the rows of its one inner layer."""
    (cells, counts, box, params), dims = _tiny_operands()
    n0 = [k.launches for k in cell_pair.KERNELS]
    out = cell_pair.colt_cells(cells, counts, box, params, dims, True, True,
                               cell_pair.CH3_ENERGY, x_halo=True)
    assert out.shape == (9,) + tuple(cells.shape[1:])
    assert [k.launches for k in cell_pair.KERNELS] == n0
    with pytest.raises(ValueError, match="CUDA tensors"):
        cell_pair.cell_pair_forces_colt_kernel(cells, counts, box, params,
                                               dims, True, True, 0, True)
    assert cell_pair.cheb_kernel_for(None, 1, True) is cell_pair.K1F_CHEB
    assert cell_pair.cheb_kernel_for(None, 0, True) is cell_pair.K1F_CHEB
    assert cell_pair.cheb_kernel_for(params, 1, True) \
        is cell_pair.K1F_CHEB_MIX


def test_launched_ranks_import_no_jax(tmp_path):
    """``parallel.launch``'s ranks are fresh interpreters: started from
    this process, which has jax imported, they import neither jax nor the
    JAX package."""
    import sys

    from chemlab_tpu_torch.parallel import launch

    assert "jax" in sys.modules
    res = launch.run_jobs([("imported_modules", {})], 2, tmp_path,
                          backend="gloo", device="cpu", timeout=120)
    assert res == [[{"modules": []}, {"modules": []}]]
