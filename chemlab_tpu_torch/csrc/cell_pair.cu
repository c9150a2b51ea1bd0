// K1 / K1b / K1f: cell-tile Lennard-Jones pair sum over all pairs on a
// periodic cell grid.
//
// Replaces the TPU kernel chemlab_tpu/engine/pallas_pair.py::_colt2_kernel
// (LJ mode: uniform_lj, all_lj and the general per-type-pair lookup with the
// is-LJ gate; the energy and virial channels).  Excluded pairs are included;
// the torch correction (chemlab_tpu_torch/engine/cell_pair.py::_pair_eval)
// subtracts them with the same per-pair f32 op sequence, so this file is
// compiled with --fmad=false and without fast math, and rounds with rintf
// (half to even, as jnp.round) rather than roundf.
//
// What bounds it on an H100: at 10k particles the operands are ~680 KB
// (1331 cells x 32 slots x 16 B of packed rows, plus counts and a 5 x T x T
// parameter table), all of it resident in the 50 MB L2; a call visits ~2.07
// M candidate pairs (~22 f32 operations each up to the cut) and ~0.2 M pairs
// inside the cutoff (~24 operations and one IEEE division each), so it is
// bound by latency and by how many lanes issue useful work, not by bytes.
// The TPU kernel's one-hot MXU parameter lookup is replaced by a direct read
// of the T x T tables staged in shared memory.
//
// Two kernels, the same sums bit for bit:
//
//   colt_cellwise_kernel (cell_pair_colt_cellwise; the first design, kept
//   as the baseline the other is held and timed against, which no step
//   runs): one block per cell and one thread per slot; each of the 27
//   neighbour cells staged once in shared memory between two barriers and
//   read by every thread of the block; each thread owns its output row and
//   sums in a fixed order.  At ~7.5 particles a cell and cap 32 only ~23 %
//   of the lanes work, and a warp runs the pair term whenever any of its
//   lanes has a pair in the cut.
//
//   colt_packed_kernel (cell_pair_colt, every step runs it; the launch plan
//   is cell_pair.colt_launch_plan's): the column-segment design of
//   cell_pair_cheb.cu's cheb_packed_kernel, with the stage, the rows'
//   candidate layout and the LJ body (lj_rows, which K2 in
//   cell_pair_cell.cu launches too, over its deduplicated stencil) of
//   cell_pair_packed.cuh: one block per (xy column, z
//   segment), the 9 neighbour z-columns staged once with cp.async, a warp
//   per row with its candidates over the 32 lanes in stencil order, then
//   slot order, and cells beyond the row's largest cutoff culled by their
//   bounding boxes.  A ballot appends the in-cut pairs to the warp's list in
//   candidate order; the terms are evaluated over the list, 32 at a time,
//   and each row's lane adds its terms in list order.  (The LJ term is
//   short, ~24 operations against 43-85 for a Clenshaw chain, so evaluating
//   it in the pass by the candidate's lane and gathering each ballot's terms
//   with __shfl_sync was built and measured too; it was slower on every
//   operand, PERF.md.)
//   Each slot adds its in-cut terms in stencil order, then slot
//   order, with K1's per-pair op sequence, so the sums equal the cellwise
//   kernel's bit for bit (and, through it, K2's and K3a-K3d's).  No atomics
//   and no order that depends on timing: each slot is written once by one
//   thread.
//
// Layout (all float32 unless noted, contiguous):
//   cells  (C, cap, 4)   [x, y, z, type+1 | 0] rows; empty slots are zero
//   counts (C,) int32    occupied rows per cell (rows [0, count))
//   box    (3,)
//   params (5, T, T)     sigma, epsilon, cutoff^2, shift, is_lj
//   out    (C, cap, 4)   [fx, fy, fz, ch3]; ch3 = 0 (mode 0), half the pair
//                        energy (mode 1) or half the pair virial (mode 2)
// Shared memory of the column-segment kernel, bytes: 16 * (9 ((L + 2) cap
// + 1) + threads * depth) (stage and lists) + 4 * (5 T^2 + 9 (L + 3) + 9 (L + 2) 8 + T)
// (parameters, prefixes, counts, offsets, boxes, cutoffs); above 48 KiB
// the launch opts in, and the plan raises above 227 KiB.  The launcher
// refuses a plan whose bytes differ from this layout's.
//
// K1f, the x_halo mode (pallas_pair.py:682-699, 755-756, run per slab by
// chemlab_tpu/engine/pallas_halo.py): cells holds a slab of nx = w + 2
// x-layers, the w inner layers with one halo layer on each side.  The grid
// runs over the w * ny * nz inner cells only, the x neighbour is cx + dx
// with no wrap (the halo layers already hold the periodic neighbours), y
// and z still wrap, and out is (w * ny * nz, cap, 4), one row per inner
// slot.  The 27 cells are visited in K1's order and each pair runs K1's
// op sequence, so the D slabs' outputs laid side by side equal K1's output
// on the full grid bit for bit.

#include <cuda_runtime.h>

#include "cell_pair_packed.cuh"

namespace {

__global__ void colt_cellwise_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int all_lj, int ch3_mode, int x_halo) {
  extern __shared__ float4 smem[];
  float4* rows = smem;                                   // cap rows
  float* par = reinterpret_cast<float*>(smem + cap);    // 5 * T * T
  const int tt = n_types * n_types;
  for (int k = threadIdx.x; k < 5 * tt; k += blockDim.x) par[k] = params[k];

  const int c = blockIdx.x;                  // output cell
  const int ci = x_halo ? c + ny * nz : c;   // the same cell in `cells`
  const int i = threadIdx.x;
  const int cx = ci / (ny * nz);
  const int cy = (ci / nz) % ny;
  const int cz = ci % nz;
  const float bx = box[0], by = box[1], bz = box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;

  const bool own = i < cap;
  const float4 xi = own ? cells[ci * cap + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const bool vi = xi.w > 0.5f;
  const int ti = max(static_cast<int>(xi.w) - 1, 0);

  float fx = 0.f, fy = 0.f, fz = 0.f, acc = 0.f;
  for (int dx = -1; dx <= 1; ++dx) {
    for (int dy = -1; dy <= 1; ++dy) {
      for (int dz = -1; dz <= 1; ++dz) {
        const int ncx = x_halo ? cx + dx : (cx + dx + nx) % nx;
        const int nc = (ncx * ny + (cy + dy + ny) % ny) * nz
                       + (cz + dz + nz) % nz;
        const int cnt = counts[nc];
        __syncthreads();  // previous cell's rows are no longer read
        for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
          rows[k] = cells[nc * cap + k];
        }
        __syncthreads();
        if (!vi) continue;
        for (int j = 0; j < cnt; ++j) {
          const float4 xj = rows[j];
          float ddx = xi.x - xj.x;
          ddx = ddx - bx * rintf(ddx * ibx);
          float ddy = xi.y - xj.y;
          ddy = ddy - by * rintf(ddy * iby);
          float ddz = xi.z - xj.z;
          ddz = ddz - bz * rintf(ddz * ibz);
          float r2 = ddx * ddx;
          r2 = r2 + ddy * ddy;
          r2 = r2 + ddz * ddz;
          const bool valid = (xj.w > 0.5f) && (r2 > 1e-12f);
          const float r2s = valid ? r2 : 1.0f;
          float sig, eps, cut2, shift;
          bool in_cut;
          if (uniform_lj) {
            sig = par[0];
            eps = par[tt];
            cut2 = par[2 * tt];
            shift = par[3 * tt];
            in_cut = valid && (r2s < cut2);
          } else {
            const int p = ti * n_types + max(static_cast<int>(xj.w) - 1, 0);
            sig = par[p];
            eps = par[tt + p];
            cut2 = par[2 * tt + p];
            shift = par[3 * tt + p];
            in_cut = valid && (r2s < cut2) && (all_lj || par[4 * tt + p] > 0.5f);
          }
          if (!in_cut) continue;  // contributes exactly zero in the reference
          const float sig2 = sig * sig;
          const float r2c = fmaxf(r2s, 0.5625f * sig2);
          const float inv_r2c = 1.0f / r2c;
          const float s2 = sig2 * inv_r2c;
          const float s6 = s2 * s2 * s2;
          const float f = 48.0f * eps * (s6 * s6 - 0.5f * s6) * inv_r2c;
          fx = fx + f * ddx;
          fy = fy + f * ddy;
          fz = fz + f * ddz;
          if (ch3_mode == 1) {
            acc = acc + (4.0f * eps * (s6 * s6 - s6) - shift);
          } else if (ch3_mode == 2) {
            acc = acc + f * r2s;
          }
        }
      }
    }
  }
  if (own) out[c * cap + i] = make_float4(fx, fy, fz, 0.5f * acc);
}


// ---- the column-segment kernel ---------------------------------------------

// K1's wrapper of the column-segment body (cell_pair_packed.cuh), under a
// name of its own so that a trace tells K1 from K2
__global__ void colt_packed_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int all_lj, int ch3_mode, int x_halo, unsigned mask,
    int seg, int rows_w, int depth) {
  packed::lj_rows(cells, counts, box, params, out, nx, ny, nz, cap, n_types,
                  uniform_lj, all_lj, ch3_mode, x_halo, mask, seg, rows_w,
                  depth);
}

}  // namespace

// K1, K1b (ch3_mode 2) and K1f (x_halo) with the launch plan (seg, rows_w,
// threads, depth, smem_bytes: cell_pair.colt_launch_plan)
extern "C" int cell_pair_colt(const void* cells, const void* counts,
                              const void* box, const void* params, void* out,
                              int nx, int ny, int nz, int cap, int n_types,
                              int uniform_lj, int all_lj, int ch3_mode,
                              int x_halo, int seg, int rows_w, int threads,
                              int depth, int smem_bytes, void* stream) {
  return packed::lj_launch(colt_packed_kernel, cells, counts, box, params,
                           out, nx, ny, nz, cap, n_types, uniform_lj, all_lj,
                           ch3_mode, x_halo, packed::kStencil27, seg, rows_w,
                           threads, depth, smem_bytes, stream);
}

// The cellwise kernel (one block per cell, one thread per slot, 27
// stages), kept as the baseline the column-segment kernel is held and
// timed against; no step reaches this entry point
extern "C" int cell_pair_colt_cellwise(const void* cells, const void* counts,
                                       const void* box, const void* params,
                                       void* out, int nx, int ny, int nz,
                                       int cap, int n_types, int uniform_lj,
                                       int all_lj, int ch3_mode, int x_halo,
                                       void* stream) {
  const int n_cells = (x_halo ? nx - 2 : nx) * ny * nz;
  const int threads = ((cap + 31) / 32) * 32;
  const size_t shmem = static_cast<size_t>(cap) * sizeof(float4)
                       + 5 * static_cast<size_t>(n_types) * n_types * sizeof(float);
  colt_cellwise_kernel<<<n_cells, threads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj, all_lj,
      ch3_mode, x_halo);
  return static_cast<int>(cudaGetLastError());
}
