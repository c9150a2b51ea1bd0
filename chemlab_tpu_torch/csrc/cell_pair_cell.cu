// K2: per-cell Lennard-Jones pair sum over all pairs on a periodic cell grid
// of any shape, against a deduplicated stencil of S <= 27 neighbour cells.
//
// Replaces the TPU kernel chemlab_tpu/engine/pallas_pair.py::_kernel (one
// program per cell, the full (cap, S*cap) candidate tile; the reference runs
// it whenever colt2 (K1) cannot take the grid: a grid axis with fewer than 3
// cells, or cell_cap % 8 != 0).  On a grid with 2 cells on an axis the
// offsets -1 and +1 name the same cell, so the stencil is the deduplicated
// list of neighbor.neighbor_cell_offsets (each offset stored mod dims), in
// that order; on a full grid it is the 27 offsets in K1's loop order.
// Parameters: uniform_lj, or the per-type-pair lookup with the is-LJ gate
// (all_lj skips the gate, as in K1); the TPU's one-hot MXU lookup is a plain
// read of the (5, T, T) table staged in shared memory.  ch3 takes K1's
// modes: 0 none, 1 half the pair energy, 2 half the pair virial.
//
// Excluded pairs are included; the torch correction
// (chemlab_tpu_torch/engine/cell_pair.py::_pair_eval) subtracts them with
// the same per-pair f32 op sequence, so this file is compiled with
// --fmad=false and without fast math, and rounds with rintf (half to even,
// as jnp.round) rather than roundf.
//
// Two kernels, the same sums bit for bit:
//
//   cell_packed_kernel (cell_pair_cell, every K2 step runs it; the launch
//   plan is cell_pair.k2_launch_plan's): K1's column-segment body
//   (cell_pair_packed.cuh's lj_rows: one block per xy column and z
//   segment, the 9 neighbour z-columns staged once, a warp per row, the
//   in-cut pairs filtered into the warp's list and evaluated over it, cells
//   beyond the row's largest cutoff culled), over the lanes of a 27-bit
//   stencil mask: a lane whose offset residue repeats an earlier lane's
//   is dropped, so a row visits the deduplicated stencil in its order, then
//   slot order.  The mask comes from cell_pair.stencil_mask (made once per
//   grid on the host, passed as an int).  The stage wraps every axis, so on
//   an axis of 2 cells a cell is staged twice and on an axis of 1 three
//   times; the mask keeps the first of them, the one whose offset the
//   deduplicated stencil keeps (on nz = 1 that is dz = -1).
//
//   cell_cellwise_kernel (cell_pair_cell_cellwise; K2's first design, kept
//   as the baseline the other is held and timed against, which no step
//   runs): one block per cell, one thread per slot (blockDim = cap rounded
//   up to a warp).  The first S threads compute the neighbour cell ids and
//   occupancies once (shared), the block loads the parameter table, then
//   after one barrier every thread takes part in one cooperative load of
//   the S x cap rows, then one more barrier and a loop over the S x cap
//   candidates, each staged cell stopped at its occupancy.  At cap 36 and
//   ~7.5 particles a cell ~12 % of its lanes work, and a warp runs the pair
//   term whenever any of its lanes has a pair in the cut.  Above 48 KB of
//   dynamic shared memory the launch opts in with cudaFuncSetAttribute.
//
// Each slot adds its in-cut terms in stencil order, then slot order (K1's
// order on a full grid, so K1 and K2 agree bit for bit there): no atomics,
// deterministic.
//
// What bounds it on an H100: at 10k particles (1331 cells x 36 slots) the
// operands are ~0.8 MB and stay in the 50 MB L2; the work is S x ~7.5
// candidates per slot, ~22 f32 operations each up to the cut and ~24 more
// with one division inside it, so the kernel is bound by latency and by how
// many lanes issue useful work, not by bytes.
//
// Layout (all float32 unless noted, contiguous):
//   cells   (C, cap, 4)  [x, y, z, type+1 | 0] rows; empty slots are zero
//   counts  (C,) int32   occupied rows per cell (rows [0, count))
//   box     (3,)
//   params  (5, T, T)    sigma, epsilon, cutoff^2, shift, is_lj
//   offsets (S, 3) int32 stencil offsets, each in [0, dims) (cellwise only)
//   out     (C, cap, 4)  [fx, fy, fz, ch3]

#include <cuda_runtime.h>

#include "cell_pair_packed.cuh"

namespace {

__global__ void cell_cellwise_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ offsets, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int uniform_lj, int all_lj,
    int ch3_mode) {
  extern __shared__ float4 smem[];
  float4* rows = smem;                                           // S * cap
  float* par = reinterpret_cast<float*>(smem + n_stencil * cap);  // 5 * T * T
  const int tt = n_types * n_types;
  int* cnt_s = reinterpret_cast<int*>(par + 5 * tt);             // S

  const int c = blockIdx.x;
  const int i = threadIdx.x;
  const int cx = c / (ny * nz);
  const int cy = (c / nz) % ny;
  const int cz = c % nz;

  __shared__ int nc_s[27];                                       // S

  const float4 xi = i < cap ? cells[c * cap + i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  if (i < n_stencil) {
    const int nc = (((cx + offsets[3 * i]) % nx) * ny
                    + (cy + offsets[3 * i + 1]) % ny) * nz
                   + (cz + offsets[3 * i + 2]) % nz;
    nc_s[i] = nc;
    cnt_s[i] = counts[nc];
  }
  for (int k = threadIdx.x; k < 5 * tt; k += blockDim.x) par[k] = params[k];
  __syncthreads();
  // the one cooperative load of every neighbour row
  for (int s = 0; s < n_stencil; ++s) {
    const float4* src = cells + nc_s[s] * cap;
    for (int slot = threadIdx.x; slot < cnt_s[s]; slot += blockDim.x) {
      rows[s * cap + slot] = src[slot];
    }
  }
  __syncthreads();

  if (i >= cap) return;
  float fx = 0.f, fy = 0.f, fz = 0.f, acc = 0.f;
  if (xi.w > 0.5f) {
    const float bx = box[0], by = box[1], bz = box[2];
    const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
    const int ti = max(static_cast<int>(xi.w) - 1, 0);
    for (int s = 0; s < n_stencil; ++s) {
      const float4* cell = rows + s * cap;
      const int cnt = cnt_s[s];
      for (int j = 0; j < cnt; ++j) {
        const float4 xj = cell[j];
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
  out[c * cap + i] = make_float4(fx, fy, fz, 0.5f * acc);
}

// K2's wrapper of the column-segment body (cell_pair_packed.cuh), under a
// name of its own so that a trace tells K2 from K1
__global__ void cell_packed_kernel(
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

// K2 over the stencil mask (cell_pair.stencil_mask) with the launch plan
// (seg, rows_w, threads, depth, smem_bytes: cell_pair.k2_launch_plan)
extern "C" int cell_pair_cell(const void* cells, const void* counts,
                              const void* box, const void* params, void* out,
                              int nx, int ny, int nz, int cap, int n_types,
                              int uniform_lj, int all_lj, int ch3_mode,
                              int mask, int seg, int rows_w, int threads,
                              int depth, int smem_bytes, void* stream) {
  return packed::lj_launch(cell_packed_kernel, cells, counts, box, params,
                           out, nx, ny, nz, cap, n_types, uniform_lj, all_lj,
                           ch3_mode, 0, static_cast<unsigned>(mask), seg,
                           rows_w, threads, depth, smem_bytes, stream);
}

// The cellwise kernel (one block per cell, one thread per slot, the S cells
// staged at once), kept as the baseline the column-segment kernel is held
// and timed against; no step reaches this entry point
extern "C" int cell_pair_cell_cellwise(const void* cells, const void* counts,
                                       const void* box, const void* params,
                                       const void* offsets, void* out, int nx,
                                       int ny, int nz, int cap, int n_types,
                                       int n_stencil, int uniform_lj,
                                       int all_lj, int ch3_mode,
                                       void* stream) {
  const int n_cells = nx * ny * nz;
  const int threads = ((cap + 31) / 32) * 32;
  const size_t shmem =
      static_cast<size_t>(n_stencil) * cap * sizeof(float4)
      + 5 * static_cast<size_t>(n_types) * n_types * sizeof(float)
      + static_cast<size_t>(n_stencil) * sizeof(int);
  if (shmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cell_cellwise_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cell_cellwise_kernel<<<n_cells, threads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(offsets), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, uniform_lj, all_lj, ch3_mode);
  return static_cast<int>(cudaGetLastError());
}
