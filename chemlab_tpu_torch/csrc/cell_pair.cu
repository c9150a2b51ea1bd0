// K1: cell-tile Lennard-Jones pair sum over all pairs on a periodic cell grid.
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
// parameter table), all of it resident in the 50 MB L2, so the kernel is
// compute- and launch-bound: 27 x cap candidate pairs per slot, ~30 flops
// each, one division.  Design for that: one block per cell and one thread
// per slot; each of the 27 neighbour cells is staged once in shared memory
// (cap x 16 B) and read by every thread of the block; the loop stops at the
// cell's occupancy; each thread owns its output row and sums in a fixed
// order, so there are no atomics and the result is deterministic.  The
// TPU kernel's one-hot MXU parameter lookup is replaced by a direct read of
// the T x T tables staged in shared memory.
//
// Layout (all float32 unless noted, contiguous):
//   cells  (C, cap, 4)   [x, y, z, type+1 | 0] rows; empty slots are zero
//   counts (C,) int32    occupied rows per cell (rows [0, count))
//   box    (3,)
//   params (5, T, T)     sigma, epsilon, cutoff^2, shift, is_lj
//   out    (C, cap, 4)   [fx, fy, fz, ch3]; ch3 = 0 (mode 0), half the pair
//                        energy (mode 1) or half the pair virial (mode 2)
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

namespace {

__global__ void cell_pair_colt_kernel(
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

}  // namespace

extern "C" int cell_pair_colt(const void* cells, const void* counts,
                              const void* box, const void* params, void* out,
                              int nx, int ny, int nz, int cap, int n_types,
                              int uniform_lj, int all_lj, int ch3_mode,
                              int x_halo, void* stream) {
  const int n_cells = (x_halo ? nx - 2 : nx) * ny * nz;
  const int threads = ((cap + 31) / 32) * 32;
  const size_t shmem = static_cast<size_t>(cap) * sizeof(float4)
                       + 5 * static_cast<size_t>(n_types) * n_types * sizeof(float);
  cell_pair_colt_kernel<<<n_cells, threads, shmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj, all_lj,
      ch3_mode, x_halo);
  return static_cast<int>(cudaGetLastError());
}
