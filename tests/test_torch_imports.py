"""Packaging rules of the port: no jax, a kernel build that keeps the
cancellation contract, and wrappers that never fall back on a card.

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
from chemlab_tpu_torch.engine import _kernels, cell_pair

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        chemlab_tpu_torch.__path__, "chemlab_tpu_torch."))


def test_every_module_imports_without_jax():
    mods = _modules()
    assert "chemlab_tpu_torch.engine.cell_pair" in mods and len(mods) >= 18
    code = ("import importlib, sys\n"
            "for m in %r: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('jaxlib'))\n"
            "print('JAX', bad)\n" % (mods,))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "JAX []" in out.stdout, out.stdout


def test_no_jax_import_in_sources():
    for path in (REPO / "chemlab_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), \
                (path, line)


def test_kernel_build_flags():
    cmd = _kernels.nvcc_command("nvcc", cell_pair.K1.source, Path("x.so"))
    flags = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "--fmad=false" in cmd
    for bad in ("fast_math", "fast-math", "--ftz=true", "--prec-div=false",
                "--prec-sqrt=false"):
        assert bad not in flags
    assert cell_pair.K1.source.is_file()
    assert cell_pair.K1.library_path().parent == _kernels.BUILD_DIR


def test_kernel_source_rounds_half_to_even():
    """``jnp.round`` rounds half to even: the kernel's minimum image must use
    rintf, never roundf (half away from zero)."""
    src = cell_pair.K1.source.read_text()
    assert "rintf(" in src and "roundf(" not in src
    # and the plain version's torch.round agrees with numpy's half-to-even
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(x)).numpy(),
                                  np.round(x))


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


def test_chip_smoke_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the smoke would run for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
