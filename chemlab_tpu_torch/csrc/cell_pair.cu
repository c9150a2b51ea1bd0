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
//   cell_pair_cheb.cu's cheb_packed_kernel, with the stage and the rows'
//   candidate layout of cell_pair_packed.cuh: one block per (xy column, z
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

using packed::kAll;

// The type pair of row type ti and a candidate row's type plane value.
__device__ __forceinline__ int type_pair(int ti, float wj, int n_types) {
  return ti * n_types + max(static_cast<int>(wj) - 1, 0);
}

// K1's pair term for a pair inside the cut, in colt_cellwise_kernel's op
// sequence: returns the force scalar f; w is the ch3 term, the shifted pair
// energy (mode 1) or f r2s (mode 2).
__device__ __forceinline__ float lj_force(float r2s, float sig, float eps,
                                          float shift, int ch3_mode,
                                          float& w) {
  const float sig2 = sig * sig;
  const float r2c = fmaxf(r2s, 0.5625f * sig2);
  const float inv_r2c = 1.0f / r2c;
  const float s2 = sig2 * inv_r2c;
  const float s6 = s2 * s2 * s2;
  const float f = 48.0f * eps * (s6 * s6 - 0.5f * s6) * inv_r2c;
  w = ch3_mode == 1 ? 4.0f * eps * (s6 * s6 - s6) - shift : f * r2s;
  return f;
}

// One block per (xy column, z segment of `seg` cells) of the output grid;
// the block's occupied rows in batches of `rows_w`, one batch per warp at a
// time, each row of the batch in turn taken by the whole warp: its
// candidates (packed::row_cands) 32 a pass through the candidate ops up to
// the cut, the in-cut ones appended to the warp's list and evaluated over
// it (the source's head comment).  Lane r of the batch holds row r's sums
// and writes its slot.
__global__ void colt_packed_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int all_lj, int ch3_mode, int x_halo, int seg,
    int rows_w, int depth) {
  extern __shared__ float4 smem[];
  const int tt = n_types * n_types;
  const int hz = seg + 2;
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  packed::Stage s;
  s.rows = smem;                                                // 9 cstride
  float4* ent = s.rows + 9 * (hz * cap + 1);                    // depth nthr
  float* par = reinterpret_cast<float*>(ent + depth * nthr);    // 5 T T
  s.cnt = reinterpret_cast<int*>(par + 5 * tt);                 // 9 hz
  s.cpre = s.cnt + 9 * hz;                                      // 9 (hz + 1)
  s.base_g = s.cpre + 9 * (hz + 1);                             // 9 hz
  s.bbox = reinterpret_cast<float*>(s.base_g + 9 * hz);         // 9 hz 6
  float* cmax = s.bbox + 9 * hz * 6;                            // T

  for (int k = t; k < 5 * tt; k += nthr) par[k] = params[k];
  packed::stage_block(cells, counts, out, s, nx, ny, nz, cap, x_halo, seg);
  // the largest cutoff^2 of a row of each type
  for (int a = t; a < n_types; a += nthr) {
    float m = par[2 * tt];
    if (!uniform_lj) {
      m = par[2 * tt + a * n_types];
      for (int k = 1; k < n_types; ++k) {
        m = fmaxf(m, par[2 * tt + a * n_types + k]);
      }
    }
    cmax[a] = m;
  }
  __syncthreads();

  const float bx = box[0], by = box[1], bz = box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float gm = packed::cull_margin(bx, by, bz);
  const float4* own_rows = s.rows + 4 * s.cstride + s.row0;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  const int cap_w = 32 * depth;               // entries of a warp's list
  float4* wl = ent + (t - lane) * depth;      // this warp's list

  for (int b0 = (t >> 5) * rows_w; b0 < s.n_own;
       b0 += (nthr >> 5) * rows_w) {
    const int nb = min(rows_w, s.n_own - b0);  // rows of this batch
    float fx = 0.f, fy = 0.f, fz = 0.f, acc = 0.f;  // lane r: row b0 + r
    int lo = 0, hi = 0;  // lane r's entries in the list
    int n = 0;           // entries in the list

    // evaluate the list's entries, then each lane sums its row's terms
    auto flush = [&]() {
      __syncwarp();  // the list's entries, from every lane
      for (int k = lane; k < n; k += 32) {
        const float4 en = wl[k];
        const float4 xi = own_rows[b0 + __float_as_int(en.x)];
        const float4 xj = s.rows[__float_as_int(en.w)];
        float ddx, ddy, ddz;
        const float r2s = packed::pair_r2(xi, xj, bx, by, bz, ibx, iby, ibz,
                                          ddx, ddy, ddz);
        const int p = uniform_lj ? 0
            : type_pair(max(static_cast<int>(xi.w) - 1, 0), xj.w, n_types);
        float w;
        const float f = lj_force(r2s, par[p], par[tt + p], par[3 * tt + p],
                                 ch3_mode, w);
        wl[k] = make_float4(f * ddx, f * ddy, f * ddz, w);
      }
      __syncwarp();
      for (int k = lo; k < hi; ++k) {
        const float4 en = wl[k];
        fx = fx + en.x;
        fy = fy + en.y;
        fz = fz + en.z;
        if (ch3_mode != 0) acc = acc + en.w;
      }
      __syncwarp();
      lo = hi = n = 0;
    };

    for (int r = 0; r < nb; ++r) {
      const float4 xi = own_rows[b0 + r];
      if (!(xi.w > 0.5f)) continue;  // an inactive row has no pairs
      const int ti = max(static_cast<int>(xi.w) - 1, 0);
      const packed::RowCands rc = packed::row_cands(
          s, xi, packed::row_cell(s, s.row0 + b0 + r), cmax[ti], bx, by, bz,
          ibx, iby, ibz, gm, lane);
      if (lane == r) lo = hi = n;
      for (int k0 = 0; k0 < rc.total; k0 += 32) {
        if (n + 32 > cap_w) flush();
        const int k = k0 + lane;
        const int f = packed::cand_row(rc, k);
        bool in = false;
        if (k < rc.total) {
          const float4 xj = s.rows[f];
          float ddx, ddy, ddz;
          const float r2 = packed::pair_r2(xi, xj, bx, by, bz, ibx, iby, ibz,
                                           ddx, ddy, ddz);
          const bool valid = (xj.w > 0.5f) && (r2 > 1e-12f);
          const float r2s = valid ? r2 : 1.0f;
          if (uniform_lj) {
            in = valid && (r2s < par[2 * tt]);
          } else {
            const int p = type_pair(ti, xj.w, n_types);
            in = valid && (r2s < par[2 * tt + p])
                 && (all_lj || par[4 * tt + p] > 0.5f);
          }
        }
        const unsigned m = __ballot_sync(kAll, in);
        if (in) {
          wl[n + __popc(m & below)] =
              make_float4(__int_as_float(r), 0.f, 0.f, __int_as_float(f));
        }
        n += __popc(m);
        if (lane == r) hi = n;
      }
    }
    flush();
    if (lane < nb) {
      const int row = s.row0 + b0 + lane;
      const int oz = packed::row_cell(s, row);
      out[(s.out0 + oz) * cap + row - s.cpre[4 * (hz + 1) + oz + 1]] =
          make_float4(fx, fy, fz, 0.5f * acc);
    }
  }
}

// Shared-memory bytes of colt_packed_kernel's layout (the Python plan,
// cell_pair.colt_launch_plan, computes the same).
size_t colt_smem(int cap, int n_types, int seg, int threads, int depth) {
  const size_t hz = static_cast<size_t>(seg + 2);
  return (9 * (hz * cap + 1) + static_cast<size_t>(threads) * depth)
             * sizeof(float4)
         + (5 * static_cast<size_t>(n_types) * n_types
            + packed::stage_words(seg) + n_types) * sizeof(float);
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
  // the plan must describe this layout: whole warps, a batch's rows one
  // lane each, a list of at least one pass of 32 candidates a warp
  if (seg < 1 || rows_w < 1 || rows_w > 32 || threads < 32 || threads > 1024
      || threads % 32 != 0 || depth < 1
      || colt_smem(cap, n_types, seg, threads, depth)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (x_halo ? nx - 2 : nx) * ny * ((nz + seg - 1) / seg);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        colt_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  colt_packed_kernel<<<n_blocks, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj, all_lj,
      ch3_mode, x_halo, seg, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
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
