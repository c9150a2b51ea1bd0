// The pair-kernel ladder: K1' (colt1) and K3a-K3d, Lennard-Jones pair sums
// over all pairs on a periodic cell grid, each a launch layout of the same
// per-pair arithmetic, selectable by name (cell_pair.cell_pair_forces'
// `kernel`) so that one card can choose among them by measurement.
//
// Replaces the TPU kernels of chemlab_tpu/engine/pallas_pair_variants.py:
//   K3a ladder_packet   <- _packet_kernel (:23): grid (cells, cap/8), 8 rows
//                          of a cell against its S*cap candidates, packets
//                          past the cell's fill skipped
//   K3b ladder_resident <- _resident_kernel (:131): as K3a with the whole
//                          cell array resident, nothing streamed (here: a
//                          warp per row, every candidate read from global
//                          memory, which sits in L2)
//   K3c ladder_colz     <- _colz_kernel (:510): one program per xy column,
//                          all nz cells, packets gated on each cell's fill
//   K3d ladder_column   <- _column_kernel (:420): grid (xy column, z), the
//                          per-cell (cap, S*cap) tile read from columns
//   K1' ladder_colt1    <- _colt_kernel (:617), reached through
//                          pallas_pair.cell_pair_forces_colt(impl="colt"):
//                          one program per xy column over the 9 haloed
//                          z-columns, per-column partial sums
//
// Operand (all five): the port's (C, cap, 4) [x, y, z, type+1 | 0] rows and
// the (C,) int32 occupancy (cell_pair.colt_operands), not the reference's
// 8-channel rows, which exist for the TPU's lane layout: valid is w > 0.5,
// the type is w - 1.  Parameters are the (5, T, T) [sigma, eps, cutoff^2,
// shift, is_lj] table, a plain read where the TPU did a one-hot MXU lookup;
// the is-LJ gate applies unless uniform_lj (the variants take no all_lj,
// which is set only when every pair is LJ and so changes nothing).
//
// One __device__ function, pair_term, holds the per-pair f32 op sequence
// of K2 (cell_pair_cell.cu): minimum image with rintf (half to even, as
// jnp.round), r2 summed x, y, z, the self-pair drop at r2 > 1e-12, the
// 0.75-sigma soft core, and the accumulation f*d, e and f*r2s.  All five
// kernels call it, so each keeps the cancellation contract with the torch
// correction (cell_pair._pair_eval), which subtracts the excluded pairs with
// the same sequence; this file is compiled like the other sources with
// --fmad=false, without fast math, IEEE division and sqrtf.
//
// Summation order.  K3a-K3d sum each slot in K2's order: the deduplicated
// stencil of neighbor.neighbor_cell_offsets in order, then slot order within
// each neighbour cell.  Their forces therefore equal K2's (and K1's on a
// full grid) bit for bit, and so do their e/2 and w/2 rows, which are K2's
// energy and virial channels.  K1' reproduces the reference colt1's
// grouping: per xy column (dx, dy in -1, 0, 1) a partial sum over the
// column's three cells z-1, z, z+1, added to the running total after each
// column, and half of each column's energy or virial added to ch3; it
// agrees with K1 to f32 rounding, not bitwise, as colt1 does with colt2.
//
// Outputs.  K3a-K3d write both channels in one pass and ignore the
// energy/virial choice (as the reference's variants do): 8 floats per slot,
// [fx, fy, fz, e/2, w/2, 0, 0, 0], the layout of the reference's _colz_kernel
// output; the wrapper gathers the forces through slot_of and sums e and w.
// K1' writes K1's (C, cap, 4) [fx, fy, fz, ch3] with ch3 = e/2 (ch3_mode 1)
// or w/2 (ch3_mode 2).  No atomics: each thread owns its output rows, so
// every launch gives the same bits.
//
// Layouts of each block, and what bounds them on an H100.  At 10k (11^3
// cells, cap 32, ~7.5 particles a cell) the operands are ~0.68 MB and stay
// in the 50 MB L2; the work is ~S*7.5 candidates per live slot at ~30 f32
// operations each, so every kernel here is bound by its dependent chain and
// by how many lanes do work, not by bytes.  These are simple and right
// first; making them fast is later work.
//   K3a: one block of 32 threads per (cell, 8-row packet).  A packet that
//        starts past the cell's fill writes its 8 zero rows and returns; a
//        live one stages the S neighbour cells (S*cap*16 B) with all 32
//        threads, then 8 threads run one row each.
//   K3b: a warp per (cell, batch of rows_w slots), blocks of at least 4
//        warps, no row of the operand staged: lanes o < S hold the
//        neighbour cells of the stencil table, a prefix over the lanes lays
//        a row's candidates out in stencil order, then slot order (found as
//        cell_pair_packed.cuh's cand_row finds a stage row), and each
//        candidate is read from global memory (the whole cell array, 0.68
//        MB at 10k, sits in L2: the Hopper counterpart of "resident in
//        VMEM"); a ballot files the in-cut pairs into the warp's list
//        (shared-memory scratch), the terms are evaluated over it, and lane
//        r adds row r's terms in list order, K2's order, so both channels
//        equal K2's bit for bit.  Its first design,
//        ladder_resident_packet (one block of 8 threads per cell and 8-row
//        packet, each thread walking its row's S cells alone, at most 256
//        of an SM's 2048 thread slots filled), stays as the baseline it is
//        held and timed against; no step reaches it.
//   K3c: one block per xy column, blockDim (cap rounded to a warp, zpar);
//        the block stages the U <= 9 distinct xy-neighbour z-columns once
//        (U*nz*cap*16 B) and its threads loop over the nz cells, zpar at a
//        time; a slot computes only when its 8-row packet is live.
//   K3d: one block per cell, grid (nz, nx*ny) so that consecutive blocks
//        are the z-neighbours of one column and share its rows in L2; the
//        block stages its S cells as K2 does, one thread per slot.
//   K1': one block per xy column, blockDim (cap rounded to a warp, zpar);
//        the 9 haloed z-columns ((nz+2)*cap rows each: cell nz-1, the
//        column, cell 0) are staged once, then the threads loop over z and
//        packets as in K3c.
// Shared memory (dynamic, bytes; K3b's lists 20*threads*depth, its
// baseline none): K3a and K3d S*cap*16 +
// 20*T*T + 4*S; K3c 16*U*nz*cap + 20*T*T + 4*U*(nz+1); K1' 16*9*(nz+2)*cap
// + 20*T*T + 4*9*(nz+3).  The melt has T = 7 types.  At 10k (11^3 cells,
// S = 27, U = 9, cap 32): K3a and K3d 14 912, K3c 52 100, K1' 61 388.  At
// the 100k melt (24^3 cells, cap 40, or 48 after a capacity regrowth): K3a
// and K3d 18 368 (21 824), K3c 140 120 (167 768), K1' 151 712 (181 664);
// all within the 232 448 (227 KiB) a block may opt in to.  Above 48 KiB the
// launch opts in with cudaFuncSetAttribute; the wrapper raises above 227
// KiB with the size.
//
// Arguments (one signature for the five entry points and K3b's baseline;
// K3b takes its plan after it: rows_w, threads, depth, smem_bytes):
//   cells  (C, cap, 4) float32, counts (C,) int32, box (3,) float32,
//   params (5, T, T) float32,
//   table  int32 (2U + 2S,): the U distinct (dx, dy) xy columns of the
//          deduplicated stencil (residues mod dims, in first-appearance
//          order), then each stencil entry's column index, then its dz
//          residue (unused by K1', which takes the full 27-cell stencil),
//   out    (C, cap, 8) float32 for K3a-K3d, (C, cap, 4) for K1'.

#include <cuda_runtime.h>

#include "cell_pair_packed.cuh"

namespace {

struct Acc {
  float fx, fy, fz, e, w;
};

struct Box {
  float bx, by, bz, ibx, iby, ibz;
};

__device__ __forceinline__ Box load_box(const float* box) {
  Box b;
  b.bx = box[0];
  b.by = box[1];
  b.bz = box[2];
  b.ibx = 1.0f / b.bx;
  b.iby = 1.0f / b.by;
  b.ibz = 1.0f / b.bz;
  return b;
}

// K2's terms of a pair inside the cut: returns the force scalar f; e is the
// shifted pair energy (the virial term is f * r2s).
__device__ __forceinline__ float lj_terms(const float r2s, const float sig,
                                          const float eps, const float shift,
                                          float& e) {
  const float sig2 = sig * sig;
  const float r2c = fmaxf(r2s, 0.5625f * sig2);
  const float inv_r2c = 1.0f / r2c;
  const float s2 = sig2 * inv_r2c;
  const float s6 = s2 * s2 * s2;
  e = 4.0f * eps * (s6 * s6 - s6) - shift;
  return 48.0f * eps * (s6 * s6 - 0.5f * s6) * inv_r2c;
}

// One candidate xj of row xi (type ti): K2's per-pair op sequence, both
// channels accumulated into a.
__device__ __forceinline__ void pair_term(const float4 xi, const int ti,
                                          const float4 xj,
                                          const float* par, const int tt,
                                          const int n_types,
                                          const int uniform_lj, const Box& b,
                                          Acc& a) {
  float ddx = xi.x - xj.x;
  ddx = ddx - b.bx * rintf(ddx * b.ibx);
  float ddy = xi.y - xj.y;
  ddy = ddy - b.by * rintf(ddy * b.iby);
  float ddz = xi.z - xj.z;
  ddz = ddz - b.bz * rintf(ddz * b.ibz);
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
    in_cut = valid && (r2s < cut2) && (par[4 * tt + p] > 0.5f);
  }
  if (!in_cut) return;  // contributes exactly zero in the reference
  float e;
  const float f = lj_terms(r2s, sig, eps, shift, e);
  a.fx = a.fx + f * ddx;
  a.fy = a.fy + f * ddy;
  a.fz = a.fz + f * ddz;
  a.e = a.e + e;
  a.w = a.w + f * r2s;
}

__device__ __forceinline__ int row_type(const float4 x) {
  return max(static_cast<int>(x.w) - 1, 0);
}

// The 8-float row [fx, fy, fz, e/2, w/2, 0, 0, 0] of slot `slot`.
__device__ __forceinline__ void write_both(float4* out, const int slot,
                                           const Acc& a) {
  out[2 * slot] = make_float4(a.fx, a.fy, a.fz, 0.5f * a.e);
  out[2 * slot + 1] = make_float4(0.5f * a.w, 0.f, 0.f, 0.f);
}

// Global id of the neighbour cell of stencil entry s of cell (cx, cy, cz).
__device__ __forceinline__ int stencil_cell(const int* tab, const int n_cols,
                                            const int n_stencil, const int s,
                                            const int cx, const int cy,
                                            const int cz, const int nx,
                                            const int ny, const int nz) {
  const int u = tab[2 * n_cols + s];
  const int dz = tab[2 * n_cols + n_stencil + s];
  return (((cx + tab[2 * u]) % nx) * ny + (cy + tab[2 * u + 1]) % ny) * nz
         + (cz + dz) % nz;
}

__device__ __forceinline__ void load_params(float* par, const float* params,
                                            const int n, const int tid,
                                            const int nthreads) {
  for (int k = tid; k < n; k += nthreads) par[k] = params[k];
}

// ---- K3a: packets, the S neighbour cells staged per packet -------------------

__global__ void ladder_packet_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols,
    int uniform_lj) {
  const int c = blockIdx.x;
  const int row0 = 8 * blockIdx.y;
  const int t = threadIdx.x;
  if (row0 >= counts[c]) {  // a dead packet: its 8 rows are zero
    if (t < 16) out[2 * (c * cap + row0) + t] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  extern __shared__ float4 smem[];
  float4* rows = smem;                                           // S * cap
  float* par = reinterpret_cast<float*>(smem + n_stencil * cap);  // 5 T T
  const int tt = n_types * n_types;
  int* cnt_s = reinterpret_cast<int*>(par + 5 * tt);             // S
  __shared__ int nc_s[27];

  if (t < n_stencil) {
    const int nc = stencil_cell(tab, n_cols, n_stencil, t, c / (ny * nz),
                                (c / nz) % ny, c % nz, nx, ny, nz);
    nc_s[t] = nc;
    cnt_s[t] = counts[nc];
  }
  load_params(par, params, 5 * tt, t, blockDim.x);
  __syncthreads();
  for (int s = 0; s < n_stencil; ++s) {
    const float4* src = cells + nc_s[s] * cap;
    for (int slot = t; slot < cnt_s[s]; slot += blockDim.x) {
      rows[s * cap + slot] = src[slot];
    }
  }
  __syncthreads();
  if (t >= 8) return;
  const int i = row0 + t;
  const float4 xi = cells[c * cap + i];
  Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (xi.w > 0.5f) {
    const Box b = load_box(box);
    const int ti = row_type(xi);
    for (int s = 0; s < n_stencil; ++s) {
      const float4* cell = rows + s * cap;
      const int cnt = cnt_s[s];
      for (int j = 0; j < cnt; ++j) {
        pair_term(xi, ti, cell[j], par, tt, n_types, uniform_lj, b, a);
      }
    }
  }
  write_both(out, c * cap + i, a);
}

// ---- K3b's baseline: packets of 8 threads, nothing staged -------------------

__global__ void ladder_resident_packet_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols,
    int uniform_lj) {
  const int c = blockIdx.x;
  const int row0 = 8 * blockIdx.y;
  const int i = row0 + threadIdx.x;
  Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (row0 < counts[c]) {
    const float4 xi = cells[c * cap + i];
    if (xi.w > 0.5f) {
      const Box b = load_box(box);
      const int ti = row_type(xi);
      const int tt = n_types * n_types;
      const int cx = c / (ny * nz), cy = (c / nz) % ny, cz = c % nz;
      for (int s = 0; s < n_stencil; ++s) {
        const int nc = stencil_cell(tab, n_cols, n_stencil, s, cx, cy, cz, nx,
                                    ny, nz);
        const float4* cell = cells + nc * cap;
        const int cnt = counts[nc];
        for (int j = 0; j < cnt; ++j) {
          pair_term(xi, ti, cell[j], params, tt, n_types, uniform_lj, b, a);
        }
      }
    }
  }
  write_both(out, c * cap + i, a);
}

// ---- K3b: a warp per row, nothing staged -----------------------------------

// One warp per (cell, batch of rows_w slots): lanes o < S hold stencil entry
// o's neighbour cell (its first global row and its fill); each live row of
// the batch in turn takes the whole warp, its candidates laid out over the
// lanes' prefix in stencil order, then slot order, and read from global
// memory (L2) 32 a pass; a ballot appends the in-cut pairs to the warp's
// list (shared-memory scratch, depth * 32 entries: no row of the operand is
// staged), whose terms are evaluated 32 at a time; lane r adds row r's
// terms in list order and writes its slot's 8 floats.  (A bounding-box
// cull, each lane's cell box read from its rows once a batch, was built and
// measured too: it lost at the fastest plan, PERF.md.)
__global__ void ladder_resident_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols, int uniform_lj,
    int rows_w, int depth) {
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_batch = (cap + rows_w - 1) / rows_w;
  const int item = blockIdx.x * n_warps + warp;
  if (item >= nx * ny * nz * n_batch) return;
  const int c = item / n_batch;
  const int b0 = (item % n_batch) * rows_w;
  const int fill = counts[c];
  // the batch's slots past the cell's fill are zero rows
  const int k_zero = b0 + lane;
  if (lane < rows_w && k_zero < cap && k_zero >= fill) {
    write_both(out, c * cap + k_zero, Acc{0.f, 0.f, 0.f, 0.f, 0.f});
  }
  const int nb = min(rows_w, fill - b0);  // live rows of the batch
  if (nb <= 0) return;

  const int cap_w = 32 * depth;                       // entries of a list
  float4* wl = smem + warp * cap_w;                   // f d and e, or (r, g)
  float* wv = reinterpret_cast<float*>(smem + n_warps * cap_w)
              + warp * cap_w;                         // f r2s
  const int tt = n_types * n_types;
  const Box b = load_box(box);
  // lane o < S: stencil entry o's first global row and its fill
  int start = 0, c_o = 0;
  if (lane < n_stencil) {
    const int nc = stencil_cell(tab, n_cols, n_stencil, lane, c / (ny * nz),
                                (c / nz) % ny, c % nz, nx, ny, nz);
    start = nc * cap;
    c_o = counts[nc];
  }
  // the candidates' layout over the lanes, the same for every row
  packed::RowCands rc;
  rc.pre = c_o;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(packed::kAll, rc.pre, d);
    if (lane >= d) rc.pre += v;
  }
  rc.first = rc.pre - c_o;
  rc.start = start;
  rc.total = __shfl_sync(packed::kAll, rc.pre, 31);
  const unsigned below = (1u << lane) - 1u;
  const float4* own = cells + c * cap + b0;
  Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};  // lane r: row b0 + r
  int lo = 0, hi = 0;                 // lane r's entries in the list
  int n = 0;                          // entries in the list

  // evaluate the list's entries, then each lane sums its row's terms
  auto flush = [&]() {
    __syncwarp();
    for (int k = lane; k < n; k += 32) {
      const float4 en = wl[k];
      const float4 xi = own[__float_as_int(en.x)];
      const float4 xj = cells[__float_as_int(en.w)];
      float ddx, ddy, ddz;
      const float r2s = packed::pair_r2(xi, xj, b.bx, b.by, b.bz, b.ibx,
                                        b.iby, b.ibz, ddx, ddy, ddz);
      const int p = uniform_lj ? 0 : row_type(xi) * n_types + row_type(xj);
      float e;
      const float f = lj_terms(r2s, params[p], params[tt + p],
                               params[3 * tt + p], e);
      wl[k] = make_float4(f * ddx, f * ddy, f * ddz, e);
      wv[k] = f * r2s;
    }
    __syncwarp();
    for (int k = lo; k < hi; ++k) {
      const float4 en = wl[k];
      a.fx = a.fx + en.x;
      a.fy = a.fy + en.y;
      a.fz = a.fz + en.z;
      a.e = a.e + en.w;
      a.w = a.w + wv[k];
    }
    __syncwarp();
    lo = hi = n = 0;
  };

  for (int r = 0; r < nb; ++r) {
    const float4 xi = own[r];
    if (!(xi.w > 0.5f)) continue;  // an inactive row has no pairs
    const int ti = row_type(xi);
    if (lane == r) lo = hi = n;
    for (int k0 = 0; k0 < rc.total; k0 += 32) {
      if (n + 32 > cap_w) flush();
      const int k = k0 + lane;
      const int g = packed::cand_row(rc, k);
      bool in = false;
      if (k < rc.total) {
        const float4 xj = cells[g];
        float ddx, ddy, ddz;
        const float r2 = packed::pair_r2(xi, xj, b.bx, b.by, b.bz, b.ibx,
                                         b.iby, b.ibz, ddx, ddy, ddz);
        const bool valid = (xj.w > 0.5f) && (r2 > 1e-12f);
        const float r2s = valid ? r2 : 1.0f;
        if (uniform_lj) {
          in = valid && (r2s < params[2 * tt]);
        } else {
          const int p = ti * n_types + row_type(xj);
          in = valid && (r2s < params[2 * tt + p])
               && (params[4 * tt + p] > 0.5f);
        }
      }
      const unsigned m = __ballot_sync(packed::kAll, in);
      if (in) {
        wl[n + __popc(m & below)] =
            make_float4(__int_as_float(r), 0.f, 0.f, __int_as_float(g));
      }
      n += __popc(m);
      if (lane == r) hi = n;
    }
  }
  flush();
  if (lane < nb) write_both(out, c * cap + b0 + lane, a);
}

// ---- K3c: one block per xy column, z loop, packets -----------------------------

__global__ void __launch_bounds__(512) ladder_colz_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols,
    int uniform_lj) {
  extern __shared__ float4 smem[];
  const int col_rows = nz * cap;
  const int tt = n_types * n_types;
  float4* rows = smem;                                          // U nz cap
  float* par = reinterpret_cast<float*>(smem + n_cols * col_rows);  // 5 T T
  int* cnt_s = reinterpret_cast<int*>(par + 5 * tt);            // U * nz
  int* col_s = cnt_s + n_cols * nz;                             // U

  const int col = blockIdx.x;  // cx * ny + cy
  const int cx = col / ny, cy = col % ny;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < n_cols) {
    col_s[tid] = ((cx + tab[2 * tid]) % nx) * ny + (cy + tab[2 * tid + 1]) % ny;
  }
  load_params(par, params, 5 * tt, tid, nthreads);
  __syncthreads();
  for (int k = tid; k < n_cols * col_rows; k += nthreads) {
    rows[k] = cells[col_s[k / col_rows] * col_rows + k % col_rows];
  }
  for (int k = tid; k < n_cols * nz; k += nthreads) {
    cnt_s[k] = counts[col_s[k / nz] * nz + k % nz];
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= cap) return;
  int self = 0;
  for (int u = 0; u < n_cols; ++u) {
    if (tab[2 * u] == 0 && tab[2 * u + 1] == 0) self = u;
  }
  const Box b = load_box(box);
  const int* col_of = tab + 2 * n_cols;
  const int* dz_of = col_of + n_stencil;
  for (int z = threadIdx.y; z < nz; z += blockDim.y) {
    const float4 xi = rows[self * col_rows + z * cap + i];
    Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};
    // the slot computes only when its 8-row packet starts inside the fill
    if ((i & ~7) < cnt_s[self * nz + z] && xi.w > 0.5f) {
      const int ti = row_type(xi);
      for (int s = 0; s < n_stencil; ++s) {
        const int u = col_of[s];
        const int zz = (z + dz_of[s]) % nz;
        const float4* cell = rows + u * col_rows + zz * cap;
        const int cnt = cnt_s[u * nz + zz];
        for (int j = 0; j < cnt; ++j) {
          pair_term(xi, ti, cell[j], par, tt, n_types, uniform_lj, b, a);
        }
      }
    }
    write_both(out, (col * nz + z) * cap + i, a);
  }
}

// ---- K3d: one block per cell, read from the columns ----------------------------

__global__ void ladder_column_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols,
    int uniform_lj) {
  extern __shared__ float4 smem[];
  const int tt = n_types * n_types;
  float4* rows = smem;                                           // S * cap
  float* par = reinterpret_cast<float*>(smem + n_stencil * cap);  // 5 T T
  int* cnt_s = reinterpret_cast<int*>(par + 5 * tt);             // S
  __shared__ int nc_s[27];

  const int z = blockIdx.x;
  const int col = blockIdx.y;  // cx * ny + cy
  const int c = col * nz + z;
  const int t = threadIdx.x;
  if (t < n_stencil) {
    const int nc = stencil_cell(tab, n_cols, n_stencil, t, col / ny,
                                col % ny, z, nx, ny, nz);
    nc_s[t] = nc;
    cnt_s[t] = counts[nc];
  }
  load_params(par, params, 5 * tt, t, blockDim.x);
  __syncthreads();
  for (int s = 0; s < n_stencil; ++s) {
    const float4* src = cells + nc_s[s] * cap;
    for (int slot = t; slot < cnt_s[s]; slot += blockDim.x) {
      rows[s * cap + slot] = src[slot];
    }
  }
  __syncthreads();
  if (t >= cap) return;
  const float4 xi = cells[c * cap + t];
  Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (xi.w > 0.5f) {
    const Box b = load_box(box);
    const int ti = row_type(xi);
    for (int s = 0; s < n_stencil; ++s) {
      const float4* cell = rows + s * cap;
      const int cnt = cnt_s[s];
      for (int j = 0; j < cnt; ++j) {
        pair_term(xi, ti, cell[j], par, tt, n_types, uniform_lj, b, a);
      }
    }
  }
  write_both(out, c * cap + t, a);
}

// ---- K1': one block per xy column, 9 haloed z-columns, per-column sums ---------

__global__ void __launch_bounds__(512) ladder_colt1_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int ch3_mode) {
  extern __shared__ float4 smem[];
  const int hz_n = nz + 2;        // haloed cells per column
  const int hrows = hz_n * cap;   // haloed rows per column
  const int tt = n_types * n_types;
  float4* rows = smem;                                        // 9 * hrows
  float* par = reinterpret_cast<float*>(smem + 9 * hrows);    // 5 T T
  int* cnt_s = reinterpret_cast<int*>(par + 5 * tt);          // 9 * hz_n
  int* col_s = cnt_s + 9 * hz_n;                              // 9

  const int col = blockIdx.x;  // cx * ny + cy
  const int cx = col / ny, cy = col % ny;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid < 9) {
    col_s[tid] = ((cx + tid / 3 - 1 + nx) % nx) * ny
                 + (cy + tid % 3 - 1 + ny) % ny;
  }
  load_params(par, params, 5 * tt, tid, nthreads);
  __syncthreads();
  // haloed cell h of a column is cell (h - 1) mod nz
  for (int k = tid; k < 9 * hrows; k += nthreads) {
    const int u = k / hrows, r = k % hrows;
    const int zc = (r / cap - 1 + nz) % nz;
    rows[k] = cells[(col_s[u] * nz + zc) * cap + r % cap];
  }
  for (int k = tid; k < 9 * hz_n; k += nthreads) {
    cnt_s[k] = counts[col_s[k / hz_n] * nz + (k % hz_n - 1 + nz) % nz];
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= cap) return;
  const Box b = load_box(box);
  for (int z = threadIdx.y; z < nz; z += blockDim.y) {
    const float4 xi = rows[4 * hrows + (z + 1) * cap + i];  // column (0, 0)
    float fx = 0.f, fy = 0.f, fz = 0.f, es = 0.f, ws = 0.f;
    if ((i & ~7) < cnt_s[4 * hz_n + z + 1] && xi.w > 0.5f) {
      const int ti = row_type(xi);
      for (int u = 0; u < 9; ++u) {
        // the column's window: haloed cells z, z+1, z+2 = cells z-1, z, z+1
        Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};
        for (int h = z; h < z + 3; ++h) {
          const float4* cell = rows + u * hrows + h * cap;
          const int cnt = cnt_s[u * hz_n + h];
          for (int j = 0; j < cnt; ++j) {
            pair_term(xi, ti, cell[j], par, tt, n_types, uniform_lj, b, a);
          }
        }
        fx = fx + a.fx;
        fy = fy + a.fy;
        fz = fz + a.fz;
        es = es + 0.5f * a.e;
        ws = ws + 0.5f * a.w;
      }
    }
    out[(col * nz + z) * cap + i] =
        make_float4(fx, fy, fz, ch3_mode == 2 ? ws : es);
  }
}

size_t params_bytes(int n_types) {
  return 5 * static_cast<size_t>(n_types) * n_types * sizeof(float);
}

int opt_in(const void* kernel, size_t shmem) {
  if (shmem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shmem)));
}

// blockDim of the column kernels: a warp-rounded row of slots times as many
// z cells as fit 512 threads
dim3 column_block(int cap, int nz) {
  const int lanes = ((cap + 31) / 32) * 32;
  const int zpar = max(1, min(nz, 512 / lanes));
  return dim3(lanes, zpar);
}

}  // namespace

extern "C" int ladder_packet(const void* cells, const void* counts,
                             const void* box, const void* params,
                             const void* table, void* out, int nx, int ny,
                             int nz, int cap, int n_types, int n_stencil,
                             int n_cols, int uniform_lj, int ch3_mode,
                             void* stream) {
  (void)ch3_mode;
  const size_t shmem = static_cast<size_t>(n_stencil) * cap * sizeof(float4)
                       + params_bytes(n_types) + n_stencil * sizeof(int);
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_packet_kernel),
                        shmem);
  if (rc) return rc;
  ladder_packet_kernel<<<dim3(nx * ny * nz, cap / 8), 32, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

// K3b with its launch plan (rows_w, threads, depth, smem_bytes:
// cell_pair_variants.resident_launch_plan); ch3_mode is ignored (both
// channels are written)
extern "C" int ladder_resident(const void* cells, const void* counts,
                               const void* box, const void* params,
                               const void* table, void* out, int nx, int ny,
                               int nz, int cap, int n_types, int n_stencil,
                               int n_cols, int uniform_lj, int ch3_mode,
                               int rows_w, int threads, int depth,
                               int smem_bytes, void* stream) {
  (void)ch3_mode;
  // the plan must describe this layout: blocks of at least 4 whole warps,
  // a batch's rows one lane each, depth * 32 list entries (20 B each) a warp
  if (rows_w < 1 || rows_w > 32 || threads < 128 || threads > 1024
      || threads % 32 != 0 || depth < 1
      || static_cast<size_t>(threads) * depth
                 * (sizeof(float4) + sizeof(float))
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = opt_in(
      reinterpret_cast<const void*>(ladder_resident_kernel), smem_bytes);
  if (rc) return rc;
  const long n_items =
      static_cast<long>(nx) * ny * nz * ((cap + rows_w - 1) / rows_w);
  const int warps = threads / 32;
  const int n_blocks = static_cast<int>((n_items + warps - 1) / warps);
  ladder_resident_kernel<<<n_blocks, threads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
}

// K3b's first design (one block of 8 threads per cell and 8-row packet,
// each thread walking its row's neighbour cells alone), kept as the
// baseline the warp-per-row kernel is held and timed against; no step
// reaches this entry point
extern "C" int ladder_resident_packet(const void* cells, const void* counts,
                                      const void* box, const void* params,
                                      const void* table, void* out, int nx,
                                      int ny, int nz, int cap, int n_types,
                                      int n_stencil, int n_cols,
                                      int uniform_lj, int ch3_mode,
                                      void* stream) {
  (void)ch3_mode;
  ladder_resident_packet_kernel<<<dim3(nx * ny * nz, cap / 8), 8, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ladder_colz(const void* cells, const void* counts,
                           const void* box, const void* params,
                           const void* table, void* out, int nx, int ny,
                           int nz, int cap, int n_types, int n_stencil,
                           int n_cols, int uniform_lj, int ch3_mode,
                           void* stream) {
  (void)ch3_mode;
  const size_t shmem =
      static_cast<size_t>(n_cols) * nz * cap * sizeof(float4)
      + params_bytes(n_types)
      + static_cast<size_t>(n_cols) * (nz + 1) * sizeof(int);
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_colz_kernel),
                        shmem);
  if (rc) return rc;
  ladder_colz_kernel<<<nx * ny, column_block(cap, nz), shmem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ladder_column(const void* cells, const void* counts,
                             const void* box, const void* params,
                             const void* table, void* out, int nx, int ny,
                             int nz, int cap, int n_types, int n_stencil,
                             int n_cols, int uniform_lj, int ch3_mode,
                             void* stream) {
  (void)ch3_mode;
  const size_t shmem = static_cast<size_t>(n_stencil) * cap * sizeof(float4)
                       + params_bytes(n_types) + n_stencil * sizeof(int);
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_column_kernel),
                        shmem);
  if (rc) return rc;
  ladder_column_kernel<<<dim3(nz, nx * ny), ((cap + 31) / 32) * 32, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ladder_colt1(const void* cells, const void* counts,
                            const void* box, const void* params,
                            const void* table, void* out, int nx, int ny,
                            int nz, int cap, int n_types, int n_stencil,
                            int n_cols, int uniform_lj, int ch3_mode,
                            void* stream) {
  (void)table;
  (void)n_stencil;
  (void)n_cols;
  const size_t shmem =
      9 * static_cast<size_t>(nz + 2) * cap * sizeof(float4)
      + params_bytes(n_types) + 9 * static_cast<size_t>(nz + 3) * sizeof(int);
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_colt1_kernel),
                        shmem);
  if (rc) return rc;
  ladder_colt1_kernel<<<nx * ny, column_block(cap, nz), shmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj,
      ch3_mode);
  return static_cast<int>(cudaGetLastError());
}
