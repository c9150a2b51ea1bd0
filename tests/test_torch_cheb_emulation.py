"""The Chebyshev pair kernels' CUDA source, run on the CPU: the file
``chemlab_tpu_torch/csrc/cell_pair_cheb.cu`` (and the header it includes,
``cell_pair_packed.cuh``) is compiled with the host's g++ against a small
stand-in for the CUDA runtime (one fiber per CUDA thread, a block's
fibers run in turns by one thread and meeting at barriers, blocks one
after another, IEEE single precision without contraction, as
``--fmad=false`` keeps it on the card), and its entry points are called
through ctypes on CPU tensors.  The column-segment kernel
(``cell_pair_cheb``, ``cell_pair_cheb_mix``) must equal the cellwise kernel
(``*_cellwise``) bit for bit in every mode and channel, under the default
launch plan and under plans whose lists fill and take several rounds; the
cellwise kernel must agree with the plain torch version to f32 rounding.
This holds the new kernel's sum order on every run of the tests; the card
tests (``test_torch_cuda.py``) hold the compiled kernel.

Skips without g++.  No jax here: the reference's numbers are held by
``test_torch_tab.py`` and ``test_torch_k1f.py``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from chemlab_tpu_torch import testsystems
from chemlab_tpu_torch.engine import (_kernels, cell_pair, cell_pair_halo,
                                     runner)

# the stand-in for cuda_runtime.h: only what the source uses
RUNTIME = r"""
#pragma once
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <map>
#include <vector>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
// a block's static shared arrays: one instance, as the blocks run in turn
#define __shared__ static
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() {}
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline dim3 threadIdx, blockIdx, blockDim;
alignas(16) inline float4 emu_smem[1 << 16];
// A block's CUDA threads are fibers that one OS thread runs in turns: a
// fiber runs until it waits at a barrier that has not opened, or ends; a
// barrier opens when its last fiber arrives.  So the lanes of a warp meet
// at every shuffle without the operating system's scheduler in between.
struct emu_barrier {
  int n = 0, count = 0, gen = 0;
  void arrive_and_wait();
};
struct emu_fiber {
  ucontext_t ctx;
  std::vector<char> stack;
  const emu_barrier* wait_on;  // the barrier it waits at, or none
  int wait_gen;
  bool done;
};
inline std::vector<emu_fiber> emu_fibers;
inline ucontext_t emu_main;
inline int emu_cur = 0;
inline std::function<void()> emu_body;
inline void emu_barrier::arrive_and_wait() {
  if (++count == n) {
    count = 0;
    ++gen;
    return;
  }
  emu_fiber& f = emu_fibers[emu_cur];
  f.wait_on = this;
  f.wait_gen = gen;
  swapcontext(&f.ctx, &emu_main);  // back when the barrier has opened
}
inline emu_barrier emu_bar, emu_wbar[32];
inline void __syncthreads() { emu_bar.arrive_and_wait(); }
inline void __syncwarp() { emu_wbar[threadIdx.x / 32].arrive_and_wait(); }
// the warp's values pass through a per-warp array between two barriers
inline int emu_wx[32][32];
inline int emu_swap(int v, int src) {
  const int w = threadIdx.x / 32;
  emu_wx[w][threadIdx.x % 32] = v;
  emu_wbar[w].arrive_and_wait();
  const int r = emu_wx[w][src & 31];
  emu_wbar[w].arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) { return emu_swap(v, src); }
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int lane = threadIdx.x % 32;
  const int r = emu_swap(v, lane - d);
  return lane >= d ? r : v;
}
inline unsigned __ballot_sync(unsigned, int p) {
  const int w = threadIdx.x / 32;
  emu_wx[w][threadIdx.x % 32] = p != 0;
  emu_wbar[w].arrive_and_wait();
  unsigned m = 0;
  for (int l = 0; l < 32; ++l) m |= unsigned(emu_wx[w][l]) << l;
  emu_wbar[w].arrive_and_wait();
  return m;
}
inline int __popc(unsigned m) { return __builtin_popcount(m); }
inline int __ffs(unsigned m) { return __builtin_ffs(m); }
typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0, cudaErrorInvalidValue = 1;
const int cudaFuncAttributeMaxDynamicSharedMemorySize = 0;
template <class F> int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
// cuda_pipeline.h: the copies done at once, the waits empty
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
// give the other fibers a turn (a spin-wait's step)
inline void emu_yield() {
  emu_fibers[emu_cur].wait_on = nullptr;
  swapcontext(&emu_fibers[emu_cur].ctx, &emu_main);
}
// cell_pair_bulk.cuh: a bulk copy done at once; an mbarrier's phase
// completes when its arrivals are in and no byte is outstanding, and a
// wait yields until then
struct emu_mbar {
  int arrivals = 0, count = 0;
  long tx = 0;
  unsigned phase = 0;
};
inline std::map<const void*, emu_mbar> emu_mbars;
namespace bulk {
inline void emu_settle(emu_mbar& m) {
  if (m.arrivals == 0 && m.tx == 0) {
    ++m.phase;
    m.arrivals = m.count;
  }
}
inline void mbar_init(unsigned long long* bar, unsigned arrivals) {
  emu_mbars[bar] = emu_mbar{int(arrivals), int(arrivals), 0, 0};
}
inline void fence_mbar_init() {}
inline void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  emu_mbar& m = emu_mbars.at(bar);
  m.tx += bytes;
  --m.arrivals;
  emu_settle(m);
}
inline void copy(void* dst, const void* src, unsigned bytes,
                 unsigned long long* bar) {
  std::memcpy(dst, src, bytes);
  emu_mbar& m = emu_mbars.at(bar);
  m.tx -= bytes;
  emu_settle(m);
}
inline void mbar_wait(unsigned long long* bar, unsigned parity) {
  while ((emu_mbars.at(bar).phase & 1u) == parity) emu_yield();
}
}  // namespace bulk
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
inline int __float_as_int(float f) {
  int v;
  std::memcpy(&v, &f, 4);
  return v;
}
inline void emu_entry() {
  emu_body();
  emu_fibers[emu_cur].done = true;
  swapcontext(&emu_fibers[emu_cur].ctx, &emu_main);
}
template <class K, class... A>
void emu_launch(dim3 grid, dim3 block, size_t shmem, cudaStream_t, K kernel,
                A... args) {
  if (shmem > sizeof(emu_smem)) throw 1;
  blockDim = block;
  const int n = block.x * block.y;
  emu_fibers.resize(n);
  emu_body = [&]() { kernel(args...); };
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    blockIdx = dim3(b % grid.x, b / grid.x);
    emu_bar.n = n;
    emu_bar.count = 0;
    for (int w = 0; w < (n + 31) / 32; ++w) {
      emu_wbar[w].n = std::min(32, n - 32 * w);
      emu_wbar[w].count = 0;
    }
    for (auto& f : emu_fibers) {
      f.stack.resize(1 << 16);
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = f.stack.data();
      f.ctx.uc_stack.ss_size = f.stack.size();
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, emu_entry, 0);
      f.wait_on = nullptr;
      f.done = false;
    }
    // run every fiber that can go on, in turns, until all have ended
    for (bool live = true; live;) {
      live = false;
      for (int t = 0; t < n; ++t) {
        emu_fiber& f = emu_fibers[t];
        if (f.done) continue;
        live = true;
        if (f.wait_on && f.wait_on->gen == f.wait_gen) continue;
        f.wait_on = nullptr;
        emu_cur = t;
        threadIdx = dim3(t % block.x, t / block.x);
        swapcontext(&emu_main, &f.ctx);
      }
    }
  }
}
"""


def _host_source(text: str) -> str:
    """The CUDA source with the runtime stand-in: its header (which also
    stands in for ``cuda_pipeline.h`` and ``cell_pair_bulk.cuh``), the
    dynamic shared array, and each ``k<<<grid, block, shmem,
    stream>>>(args)`` as ``emu_launch(grid, block, shmem, stream, k,
    args)``."""
    text = text.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    text = text.replace("#include <cuda_pipeline.h>\n", "")
    text = text.replace('#include "cell_pair_bulk.cuh"\n', "")
    text = text.replace("extern __shared__ float4 smem[];",
                        "float4* smem = emu_smem;")
    return re.sub(r"(\w+(?:<\w+>)?)<<<(.*?)>>>\(",
                  lambda m: "emu_launch(%s, %s, " % (m.group(2), m.group(1)),
                  text, flags=re.S)


def compile_for_host(source, d):
    """Compile the CUDA ``source`` and the headers it includes (the
    kernels' ``csrc/``) with g++ against the stand-in, in directory ``d``;
    skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA source for the CPU")
    (d / "emu.h").write_text(RUNTIME)
    for header in _kernels.source_files(source)[1:]:
        (d / header.name).write_text(_host_source(header.read_text()))
    src = d / (source.stem + ".cpp")
    src.write_text(_host_source(source.read_text()))
    lib = d / ("lib%s.so" % source.stem)
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-shared", "-fPIC", "-I", str(d), "-o",
                    str(lib), str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    so = compile_for_host(cell_pair.K1C.source,
                          tmp_path_factory.mktemp("cheb_emu"))
    for name, n_int in (("cell_pair_cheb", 15), ("cell_pair_cheb_mix", 15),
                        ("cell_pair_cheb_cellwise", 10),
                        ("cell_pair_cheb_mix_cellwise", 10)):
        fn = getattr(so, name)
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return so


def _run(so, cells, counts, box, ops, dims, kw, ko, ch3, x_halo, plan=None):
    """One emulated launch on CPU tensors: the cellwise kernel, or the
    column-segment kernel with ``plan``; every row written (the output
    starts as NaN)."""
    cut2, tmap, tmap_b, xmat, coef = ops
    out = cell_pair._out_rows(cells, dims, x_halo).fill_(float("nan"))
    args = cell_pair._cheb_pointers(cells, counts, box, cut2, tmap, tmap_b,
                                    xmat, coef, out, dims, kw, ko, ch3,
                                    x_halo)
    mix = "_mix" if tmap_b is not None else ""
    if plan is None:
        rc = getattr(so, "cell_pair_cheb%s_cellwise" % mix)(*args, None)
    else:
        rc = getattr(so, "cell_pair_cheb%s" % mix)(
            *args, plan.seg, plan.rows, plan.threads, plan.depth, plan.smem,
            None)
    assert rc == 0
    return out


# launch plans besides the default: lists of one and two passes of 32
# candidates (emptied within a row), batches of 1 to 32 rows, segments
# longer than nz
PLANS = [dict(seg=2, rows=3, threads=64, depth=1),
         dict(seg=5, rows=32, threads=96, depth=2),
         dict(seg=3, rows=1, threads=32, depth=1)]


def _same_bits(so, cells, counts, box, ops, dims, kw, ko, x_halo=False,
               channels=(0, 1, 2), plans=PLANS):
    plain = cell_pair.cell_pair_forces_cheb_ref
    for ch3 in channels:
        old = _run(so, cells, counts, box, ops, dims, kw, ko, ch3, x_halo)
        ref = plain(cells, counts, box, *ops, dims, kw, ko, ch3, x_halo)
        torch.testing.assert_close(old, ref, rtol=0,
                                   atol=2e-5 * (1 + ref.abs().max().item()))
        for kw_plan in [{}] + list(plans):
            plan = cell_pair.cheb_launch_plan(
                dims, cells.shape[1], ops[0].shape[0], ops[4].shape[0], kw,
                ko, ops[2] is not None, x_halo, **kw_plan)
            new = _run(so, cells, counts, box, ops, dims, kw, ko, ch3,
                       x_halo, plan)
            assert torch.equal(new, old), (ch3, plan)


@pytest.fixture(scope="module")
def melts():
    out = {}
    for kind, fn in (("tab", testsystems.build_tabulated_melt),
                     ("mixed", testsystems.build_mixed_tab_melt)):
        built, _, _ = fn(n_mols=70, reactive=True, thermostat="no",
                         device="cpu")
        st = runner.initial_forces(built.spec, built.cfg, built.state)
        out[kind] = (built, testsystems.warmup(built, st, steps=50))
    return out


@pytest.mark.parametrize("mode", ["K1c", "K1e", "K1d", "K1f-cheb",
                                  "K1f-cheb-mix"])
def test_emulated_kernel_equals_cellwise(emu, melts, mode):
    """The 70-trimer tabulated and blended melts (3^3 cells, cap 24), the
    full grid and the middle slab of 3: the same bits in all channels."""
    built, st = melts["mixed" if mode in ("K1d", "K1f-cheb-mix") else "tab"]
    cfg = built.cfg
    ntab = 0 if mode == "K1e" else cfg.cheb_ntab
    ops = cell_pair.cheb_operands(built.spec, cfg.n_types, cfg.cheb_ko, ntab,
                                  cfg.cheb_mix and ntab > 0,
                                  torch.tensor([0.4]))
    packed = cell_pair.pack_rows(st.pos, st.type_id, st.active)
    if mode.startswith("K1f"):
        nx, ny, nz = cfg.cell_dims
        ids = cell_pair_halo.slab_cells(tuple(cfg.cell_dims), 3, 1, "cpu")
        cells, counts = cell_pair.colt_operands(packed, st.nbr.buckets[ids],
                                                ids.numel())
        dims, x_halo = (nx // 3 + 2, ny, nz), True
    else:
        cells, counts = cell_pair.colt_operands(
            packed, st.nbr.buckets, int(np.prod(cfg.cell_dims)))
        dims, x_halo = cfg.cell_dims, False
    _same_bits(emu, cells, counts, st.box, ops, dims, cfg.cheb_kw,
               cfg.cheb_ko, x_halo)


@pytest.mark.parametrize("dims,cap", [((3, 4, 5), 16), ((5, 3, 7), 8)])
@pytest.mark.parametrize("blend", [False, True], ids=["scalar", "blend"])
def test_emulated_kernel_on_ragged_cells(emu, melts, dims, cap, blend):
    """Random occupancy with inactive rows inside the counts (type 0), one
    type pair without a table, on the full grid and as a slab."""
    built, _ = melts["tab"]
    cfg = built.cfg
    coef = cell_pair.cheb_operands(built.spec, cfg.n_types, cfg.cheb_ko,
                                   cfg.cheb_ntab, False)[4]
    rng = np.random.RandomState(cap + int(blend))
    n_cells, edge = int(np.prod(dims)), 1.1
    cells = np.zeros((n_cells, cap, 4), np.float32)
    counts = rng.randint(0, cap + 1, n_cells).astype(np.int32)
    for c in range(n_cells):
        at = np.array([c // (dims[1] * dims[2]), (c // dims[2]) % dims[1],
                       c % dims[2]])
        k = counts[c]
        cells[c, :k, :3] = at * edge + rng.uniform(0, edge, (k, 3))
        cells[c, :k, 3] = rng.randint(0, 3, k)
    box = torch.tensor(dims, dtype=torch.float32) * edge
    cut2 = torch.full((2, 2), 1.21)
    tmap = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    ops = ((cut2, tmap, torch.tensor([[1, 1], [0, 1]], dtype=torch.int32),
            torch.tensor([[0.3, 1.0], [1.0, 0.7]]), coef) if blend
           else (cut2, tmap, None, None, coef))
    for x_halo in (False, True):
        _same_bits(emu, torch.from_numpy(cells), torch.from_numpy(counts),
                   box, ops, dims, cfg.cheb_kw, cfg.cheb_ko, x_halo,
                   channels=(1, 2), plans=PLANS[:1])


def test_emulated_launcher_refuses_a_plan_of_other_bytes(emu, melts):
    """The launcher checks the plan against its own layout: bytes that
    differ, a batch wider than a warp or a block of part of a warp give
    cudaErrorInvalidValue, and nothing runs."""
    built, st = melts["tab"]
    cfg = built.cfg
    ops = cell_pair.cheb_operands(built.spec, cfg.n_types, cfg.cheb_ko,
                                  cfg.cheb_ntab, False)
    cells, counts = cell_pair.colt_operands(
        cell_pair.pack_rows(st.pos, st.type_id, st.active), st.nbr.buckets,
        int(np.prod(cfg.cell_dims)))
    plan = cell_pair.cheb_launch_plan(cfg.cell_dims, cells.shape[1],
                                      cfg.n_types, ops[4].shape[0],
                                      cfg.cheb_kw, cfg.cheb_ko, False)
    out = cell_pair._out_rows(cells, cfg.cell_dims, False).fill_(7.0)
    args = cell_pair._cheb_pointers(cells, counts, st.box, *ops, out,
                                    cfg.cell_dims, cfg.cheb_kw, cfg.cheb_ko,
                                    0, False)
    odd = plan._replace(threads=48, smem=cell_pair.cheb_smem(
        cells.shape[1], cfg.n_types, ops[4].shape[0], cfg.cheb_kw,
        cfg.cheb_ko, False, plan.seg, 48, plan.depth))
    for bad in (plan._replace(smem=plan.smem + 16),
                plan._replace(rows=33), odd):
        assert emu.cell_pair_cheb(*args, bad.seg, bad.rows, bad.threads,
                                  bad.depth, bad.smem, None) == 1
    assert bool((out == 7.0).all())
