// The pair-kernel ladder: K1' (colt1) and K3a-K3d, Lennard-Jones pair sums
// over all pairs on a periodic cell grid, each a launch layout of the same
// per-pair arithmetic, selectable by name (cell_pair.cell_pair_forces'
// `kernel`) so that one card can choose among them by measurement.
//
// Replaces the TPU kernels of chemlab_tpu/engine/pallas_pair_variants.py:
//   K3a ladder_packet   <- _packet_kernel (:23): grid (cells, cap/8), 8 rows
//                          of a cell against its S*cap candidates, packets
//                          past the cell's fill skipped (here: a block per
//                          cell, its candidates staged once for every
//                          packet, a warp per live packet)
//   K3b ladder_resident <- _resident_kernel (:131): as K3a with the whole
//                          cell array resident, nothing streamed (here: a
//                          warp per row, every candidate read from global
//                          memory, which sits in L2)
//   K3c ladder_colz     <- _colz_kernel (:510): one program per xy column,
//                          all nz cells, packets gated on each cell's fill
//                          (here: a block per xy column, its neighbour
//                          columns staged whole by the bulk copy engine, a
//                          warp per batch of rows)
//   K3d ladder_column   <- _column_kernel (:420): grid (xy column, z), the
//                          per-cell (cap, S*cap) tile read from whole
//                          z-columns (here: each neighbour column's window
//                          staged by the bulk copy engine, a warp per row)
//   K1' ladder_colt1    <- _colt_kernel (:617), reached through
//                          pallas_pair.cell_pair_forces_colt(impl="colt"):
//                          one program per xy column over the 9 haloed
//                          z-columns, per-column partial sums (here: K1's
//                          column-segment body, cell_pair_packed.cuh's
//                          lj_rows, under its per-column sum policy)
//
// Operand (all five): the port's (C, cap, 4) [x, y, z, type+1 | 0] rows and
// the (C,) int32 occupancy (cell_pair.colt_operands), not the reference's
// 8-channel rows, which exist for the TPU's lane layout: valid is w > 0.5,
// the type is w - 1.  Parameters are the (5, T, T) [sigma, eps, cutoff^2,
// shift, is_lj] table, a plain read where the TPU did a one-hot MXU lookup;
// the is-LJ gate applies unless uniform_lj (the variants take no all_lj,
// which is set only when every pair is LJ and so changes nothing).
//
// The per-pair f32 op sequence is K2's (cell_pair_cell.cu): minimum image
// with rintf (half to even, as jnp.round), r2 summed x, y, z, the self-pair
// drop at r2 > 1e-12, the 0.75-sigma soft core, and the accumulation f*d, e
// and f*r2s.  The first designs take it from pair_term; the warp-per-row
// body warp_rows (K3a, K3b, K3c, K3d) splits it into the filter up to the
// cut and lj_terms over the filtered list, the same operations.  So
// each keeps the cancellation contract with the torch correction
// (cell_pair._pair_eval), which subtracts the excluded pairs with the same
// sequence; this file is compiled like the other sources with --fmad=false,
// without fast math, IEEE division and sqrtf.  K1' runs K1's body and its
// LJ term (lj_force), the same operations again.
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
// Each redesigned kernel equals its first design bit for bit.
//
// Outputs.  K3a-K3d write both channels in one pass and ignore the
// energy/virial choice (as the reference's variants do): 8 floats per slot,
// [fx, fy, fz, e/2, w/2, 0, 0, 0], the layout of the reference's _colz_kernel
// output; the wrapper gathers the forces through slot_of and sums e and w.
// K1' writes K1's (C, cap, 4) [fx, fy, fz, ch3] with ch3 = e/2 (ch3_mode 1)
// or w/2 (ch3_mode 2).  No atomics: each output row is written by one
// thread, so every launch gives the same bits.
//
// Layouts of each block, and what bounds them on an H100.  At 10k (11^3
// cells, cap 32, ~7.5 particles a cell) the operands are ~0.68 MB and stay
// in the 50 MB L2; the work is ~S*7.5 candidates per live slot at ~30 f32
// operations each, so every kernel here is bound by its dependent chain and
// by how many lanes do work, not by bytes.
//   warp_rows, the body of K3a, K3b, K3c and K3d: a warp takes a batch of rows
//        of one cell; lanes o < S hold stencil entry o's first row in the
//        candidates' array (global memory for K3b, the block's stage for
//        K3a and K3d) and its fill; each live row in turn takes the whole
//        warp, its candidates laid out over the lanes' prefix in stencil
//        order, then slot order, 32 a pass; a ballot files the in-cut
//        pairs into the warp's list (shared memory), the terms are
//        evaluated over it, and lane r adds row r's terms in list order,
//        K2's order, so both channels equal K2's bit for bit.  Where
//        candidate k lies is each kernel's own: K3b searches the lanes'
//        prefix (as cell_pair_packed.cuh's cand_row finds a stage row, ~7
//        dependent shuffles a pass), K3a's packed stage holds it at row k,
//        K3d reads it from a table the block writes once, K3c from a table
//        each warp writes once per cell.
//   K3a: one block per cell of W warps (packet_launch_plan); the block
//        stages the occupied rows of its S neighbour cells once, packed
//        cell after cell in stencil order (cp.async, every copy in flight
//        at once), for every packet of the cell, so a row's candidate k is
//        stage row k; warp w takes the live 8-row packets w,
//        w + W, ... (the reference's packet axis moved into the block), a
//        packet's rows through warp_rows, and the block writes the zero
//        rows of the packets past the fill.  Its first design,
//        ladder_packet_cellwise (a block of 32 threads per cell and packet,
//        each live packet staging the S cells again, then 8 threads walking
//        a row each), stays as the baseline it is held and timed against;
//        no step reaches it.
//   K3b: a warp per (cell, batch of rows_w slots), blocks of at least 4
//        warps, no row of the operand staged: warp_rows reads each
//        candidate from global memory (the whole cell array, 0.68 MB at
//        10k, sits in L2: the Hopper counterpart of "resident in VMEM").
//        Its first design, ladder_resident_packet (one block of 8 threads
//        per cell and 8-row packet, each thread walking its row's S cells
//        alone, at most 256 of an SM's 2048 thread slots filled), stays as
//        the baseline it is held and timed against; no step reaches it.
//   K3c: one block per xy column (nx*ny blocks: 121 at 10k, one on each
//        of 121 of the 132 SMs), W warps (colz_launch_plan).  The U <= 9
//        distinct neighbour columns of the deduplicated stencil are each
//        one contiguous run of nz*cap rows of `cells`, so the block stages
//        each whole (padding included) with one bulk copy against one
//        mbarrier, every cell exactly once; the live batches of rows_w rows
//        (z-major) are cut into W equal runs, a run a warp; for its current
//        cell z, lane o < S holds stencil entry o's first stage row (its
//        column's cell (z + dz_o) mod nz: a window wraps by index, with no
//        second copy) and fill, the warp writes each candidate's stage row
//        into its 16-bit table once per z, and warp_rows takes the batch.
//        (The search over the lanes' prefix in place of the table was
//        built and measured too: it lost by 13-18 %, PERF.md.)  Its first
//        design, ladder_colz_cellwise (blockDim (cap rounded to a warp,
//        zpar), a thread per slot walking its row's S cells alone, the
//        stage copied element by element), stays as the baseline it is
//        held and timed against; no step reaches it.
//   K3d: one block per cell, grid (nz, nx*ny) so that consecutive blocks
//        are the z-neighbours of one column and share its rows in L2.  The
//        stencil visits each neighbour column's window (its distinct cells
//        (z + dz) mod nz, dz fastest in the table) in turn, so stencil entry
//        s's cell is stage cell s: the block stages every window whole (cap
//        rows a cell, padding included) with one bulk copy per run of
//        entries whose cells are consecutive in the array (one a column
//        where the window does not wrap, two where it does), issued by the
//        first warp against one mbarrier (cell_pair_bulk.cuh), which while
//        the rows land writes each candidate's stage row into a table;
//        then W warps (column_launch_plan) take the cell's batches of
//        rows_w rows through warp_rows, and a batch past the fill writes
//        zero rows.
//        Its first design, ladder_column_cellwise (one thread per slot,
//        each walking all S cells alone), stays as the baseline it is held
//        and timed against; no step reaches it.
//   K1': K1's column-segment kernel (cell_pair_packed.cuh's lj_rows: a
//        block per xy column and z segment, the 9 neighbour z-columns
//        staged once, a warp per row, a ballot filter into the warp's
//        list, the terms over the list) under its kColumns sum policy:
//        each list entry keeps its xy column in a byte, and lane r sums
//        each column's terms apart and folds them in at the column's end,
//        colt1's grouping (colt1_launch_plan, K1's rule; the grouping does
//        not depend on the segment), in blocks of at most 256 threads held
//        to 64 registers a thread, so that 4 fit an SM as K1's do.  Its
//        first design, ladder_colt1_cellwise (one
//        block per xy column, blockDim (cap rounded to a warp, zpar), the
//        9 haloed z-columns of (nz+2)*cap rows staged element by element,
//        a thread per slot walking the 9 columns' windows alone), stays as
//        the baseline it is held and timed against; no step reaches it.
// Shared memory (dynamic, bytes; lists 20*threads*depth): K3a 16*27*cap +
// lists; K3b lists; K3c 16*U*nz*cap + lists + 4*U*nz + 2*(threads/32)*S*cap
// (the stage, the counts and the warps' tables); K3d 20*S*cap + lists (the
// stage and its table); K1' K1's layout (cell_pair.cu) + threads*depth
// (the entries' columns); the first designs of K3a and K3d 16*S*cap +
// 20*T*T + 4*S, K3b's none, K3c's 16*U*nz*cap + 20*T*T + 4*U*(nz+1), K1''s
// 16*9*(nz+2)*cap + 20*T*T + 4*9*(nz+3).  The melt has T = 7 types.  At
// 10k (11^3 cells, S = 27, U = 9, cap 32) under the default plans: K3a
// 24 064, K3c 171 148 (896 threads; its stage 50 688), K3d 39 920 at cap
// 36, K1' 43 256 (segments of 3; 82 712 at a segment of nz); the first
// designs of K3c and K1' 52 100 and 61 388.  At the 100k melt (24^3 cells,
// cap 40, or 48 after a capacity regrowth): K3a 27 520 (30 976), K3c
// 228 784 at 608 threads (228 576 at 384: the stage of 138 240, 165 888
// bytes leaves room for fewer warps), K3d 42 080 (46 400), K1' 49 016
// (54 776; 176 780, 206 732 at a segment of nz); the first designs of K3c
// and K1' 140 120 (167 768) and 151 712 (181 664); all within the 232 448
// (227 KiB) a block may opt in to.  Above 48 KiB the launch opts in with
// cudaFuncSetAttribute; the wrapper raises above 227 KiB with the size.
//
// Arguments (one signature for the five entry points and the first
// designs; each of the five takes its plan after it: K3a threads, depth,
// smem_bytes; K3b, K3c and K3d rows_w, threads, depth, smem_bytes; K1' seg,
// rows_w, threads, depth, smem_bytes):
//   cells  (C, cap, 4) float32, counts (C,) int32, box (3,) float32,
//   params (5, T, T) float32,
//   table  int32 (2U + 2S,): the U distinct (dx, dy) xy columns of the
//          deduplicated stencil (residues mod dims, in first-appearance
//          order), then each stencil entry's column index, then its dz
//          residue (unused by K1', which takes the full 27-cell stencil),
//   out    (C, cap, 8) float32 for K3a-K3d, (C, cap, 4) for K1'.

#include <cuda_runtime.h>

#include <cstdint>

#include "cell_pair_bulk.cuh"
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

// ---- K3a's baseline: packets, the S neighbour cells staged per packet --------

__global__ void ladder_packet_cellwise_kernel(
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

// ---- the warp-per-row body of K3a, K3b, K3c and K3d -------------------------

// Where a row's candidate k lies in the candidates' array (every lane of
// the warp calls it, each with its own k; meaningful for k < rc.total):
// found over the lanes' prefix (K3b: each neighbour cell's rows where the
// cell array holds them), the candidate's own index (K3a: the occupied
// rows packed in stencil order), or read from a table of stage rows (K3d:
// the block's, K3c: the warp's, 16-bit).
struct SearchRows {
  __device__ __forceinline__ int operator()(const packed::RowCands& rc,
                                            int k) const {
    return packed::cand_row(rc, k);
  }
};
struct PackedRows {
  __device__ __forceinline__ int operator()(const packed::RowCands&,
                                            int k) const {
    return k;
  }
};
template <class T>
struct TableRows {
  const T* tab;
  __device__ __forceinline__ int operator()(const packed::RowCands& rc,
                                            int k) const {
    return k < rc.total ? static_cast<int>(tab[k]) : 0;
  }
};

// One warp over the rows own[0 .. nb - 1] of one cell: lane o < S holds
// stencil entry o's first row in `rows` (start) and its fill (c_o); each
// live row in turn takes the whole warp, its candidates laid out over the
// lanes' prefix in stencil order, then slot order, found by `find` and
// read from `rows` 32 a pass; a ballot appends the in-cut pairs to the
// warp's list (wl, wv: cap_w entries), whose terms are evaluated 32 at a
// time; lane r adds row r's terms in list order.  Returns lane r's sums
// (zero for an inactive row and for lanes r >= nb).  Every lane of the
// warp calls it.
template <class Find>
__device__ __forceinline__ Acc warp_rows(
    const float4* __restrict__ rows, const float4* __restrict__ own,
    const int nb, const int start, const int c_o, const Find find,
    const float* __restrict__ params, const int n_types,
    const int uniform_lj, const Box& b, float4* wl, float* wv,
    const int cap_w, const int lane) {
  const int tt = n_types * n_types;
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
  Acc a = {0.f, 0.f, 0.f, 0.f, 0.f};  // lane r: row r
  int lo = 0, hi = 0;                 // lane r's entries in the list
  int n = 0;                          // entries in the list

  // evaluate the list's entries, then each lane sums its row's terms
  auto flush = [&]() {
    __syncwarp();
    for (int k = lane; k < n; k += 32) {
      const float4 en = wl[k];
      const float4 xi = own[__float_as_int(en.x)];
      const float4 xj = rows[__float_as_int(en.w)];
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
      const int g = find(rc, k);
      bool in = false;
      if (k < rc.total) {
        const float4 xj = rows[g];
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
  return a;
}

// ---- K3a: a warp per live 8-row packet over one stage per cell -------------

// One block per cell, W warps: lane o < S of every warp holds stencil entry
// o's cell, its fill and its first row in the stage (the occupied rows of
// the S cells packed cell after cell, so a row's candidate k is stage row
// k); warp 0 hands them to the block, every warp copies a share of the
// rows (cp.async, all in flight at once) while the block writes the zero
// rows of the dead packets; then warp w takes live packets w, w + W, ...
// through warp_rows, the list of depth * 32 entries its own.
__global__ void ladder_packet_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols, int uniform_lj,
    int depth) {
  extern __shared__ float4 smem[];
  __shared__ int nc_s[27], cnt_s[27], pre_s[27];
  const int c = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cap_w = 32 * depth;                       // entries of a list
  float4* stage = smem;                               // 27 cap
  float4* wl = smem + 27 * cap + warp * cap_w;        // f d and e, or (r, g)
  float* wv = reinterpret_cast<float*>(smem + 27 * cap + n_warps * cap_w)
              + warp * cap_w;                         // f r2s
  int nc = 0, c_o = 0;
  if (lane < n_stencil) {
    nc = stencil_cell(tab, n_cols, n_stencil, lane, c / (ny * nz),
                      (c / nz) % ny, c % nz, nx, ny, nz);
    c_o = counts[nc];
  }
  int pre = c_o;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(packed::kAll, pre, d);
    if (lane >= d) pre += v;
  }
  const int start = pre - c_o;
  if (warp == 0 && lane < n_stencil) {
    nc_s[lane] = nc;
    cnt_s[lane] = c_o;
    pre_s[lane] = start;
  }
  __syncthreads();
  for (int s = warp; s < n_stencil; s += n_warps) {
    const float4* src = cells + nc_s[s] * cap;
    float4* dst = stage + pre_s[s];
    for (int slot = lane; slot < cnt_s[s]; slot += 32) {
      __pipeline_memcpy_async(dst + slot, src + slot, sizeof(float4));
    }
  }
  __pipeline_commit();
  const int fill = counts[c];
  // the packets past the fill are zero rows
  for (int k = ((fill + 7) & ~7) + t; k < cap; k += blockDim.x) {
    write_both(out, c * cap + k, Acc{0.f, 0.f, 0.f, 0.f, 0.f});
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  const Box b = load_box(box);
  for (int row0 = 8 * warp; row0 < fill; row0 += 8 * n_warps) {
    const Acc a = warp_rows(stage, cells + c * cap + row0,
                            min(8, fill - row0), start, c_o, PackedRows(),
                            params, n_types, uniform_lj, b, wl, wv, cap_w,
                            lane);
    if (lane < 8) write_both(out, c * cap + row0 + lane, a);
  }
}

// ---- K3b: a warp per row, nothing staged -----------------------------------

// One warp per (cell, batch of rows_w slots): lane o < S holds stencil
// entry o's first global row and its fill, and warp_rows reads every
// candidate from global memory (L2); the list (depth * 32 entries a warp)
// is the only shared memory.  (A bounding-box cull, each lane's cell box
// read from its rows once a batch, was built and measured too: it lost at
// the fastest plan, PERF.md.)
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
  const Box b = load_box(box);
  // lane o < S: stencil entry o's first global row and its fill
  int start = 0, c_o = 0;
  if (lane < n_stencil) {
    const int nc = stencil_cell(tab, n_cols, n_stencil, lane, c / (ny * nz),
                                (c / nz) % ny, c % nz, nx, ny, nz);
    start = nc * cap;
    c_o = counts[nc];
  }
  const Acc a = warp_rows(cells, cells + c * cap + b0, nb, start, c_o,
                          SearchRows(), params, n_types, uniform_lj, b, wl,
                          wv, cap_w, lane);
  if (lane < nb) write_both(out, c * cap + b0 + lane, a);
}

// ---- K3c's baseline: one block per xy column, a thread per slot -------------

__global__ void __launch_bounds__(512) ladder_colz_cellwise_kernel(
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

// ---- K3d's baseline: one block per cell, one thread per slot ------------------

__global__ void ladder_column_cellwise_kernel(
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

// ---- K3d: the column windows staged by bulk copies, a warp per row ---------

// One block per cell (grid (nz, nx*ny)), W warps: lane o < S of every warp
// holds stencil entry o's cell and fill; stage cell o holds entry o's cell
// (the windows of the U neighbour columns in stencil order), cap rows each.
// Warp 0 finds the runs of entries whose cells are consecutive in the
// array, lane 0 arrives on the mbarrier with the stage's bytes, and the
// first lane of each run issues its bulk copy; while the rows land, warp 0
// writes the stage row of each of a row's candidates (a table: the search
// over the lanes' prefix would cost each pass ~7 dependent shuffles);
// every thread waits on the phase.  Then warp w takes the cell's batches
// w, w + W, ... of rows_w rows through warp_rows.  (The same stage copied
// by cp.async, 16 bytes a thread and copy, was built and measured too: it
// lost by 5-7 %, PERF.md.)
__global__ void ladder_column_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols, int uniform_lj,
    int rows_w, int depth) {
  extern __shared__ float4 smem[];
  __shared__ unsigned long long bar;
  const int z = blockIdx.x;
  const int col = blockIdx.y;  // cx * ny + cy
  const int c = col * nz + z;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int cap_w = 32 * depth;                       // entries of a list
  float4* stage = smem;                               // S cap
  float4* wl = smem + n_stencil * cap + warp * cap_w;
  float* wv_all = reinterpret_cast<float*>(smem + n_stencil * cap
                                           + n_warps * cap_w);
  float* wv = wv_all + warp * cap_w;
  int* ctab = reinterpret_cast<int*>(wv_all + n_warps * cap_w);  // S cap
  int nc = 0, c_o = 0;
  if (lane < n_stencil) {
    nc = stencil_cell(tab, n_cols, n_stencil, lane, col / ny, col % ny, z,
                      nx, ny, nz);
    c_o = counts[nc];
  }
  if (t == 0) {
    bulk::mbar_init(&bar, 1);
    bulk::fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0) {
    // a run starts where an entry's cell does not follow the previous one
    const int prev = __shfl_up_sync(packed::kAll, nc, 1);
    const bool first = lane < n_stencil && (lane == 0 || nc != prev + 1);
    const unsigned starts = __ballot_sync(packed::kAll, first);
    if (lane == 0) {
      bulk::mbar_expect_tx(&bar, static_cast<unsigned>(
                                     n_stencil * cap * sizeof(float4)));
    }
    __syncwarp();
    if (first) {
      const unsigned later = (starts >> lane) >> 1;
      const int end = later ? lane + __ffs(later) : n_stencil;
      bulk::copy(stage + lane * cap, cells + nc * cap,
                 static_cast<unsigned>((end - lane) * cap * sizeof(float4)),
                 &bar);
    }
    // while the rows land: the stage row of each of a row's candidates
    int pre = c_o;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(packed::kAll, pre, d);
      if (lane >= d) pre += v;
    }
    for (int j = 0; j < c_o; ++j) ctab[pre - c_o + j] = lane * cap + j;
  }
  __syncthreads();
  bulk::mbar_wait(&bar, 0);
  const int fill = counts[c];
  const Box b = load_box(box);
  for (int b0 = warp * rows_w; b0 < cap; b0 += n_warps * rows_w) {
    // the batch's slots past the cell's fill are zero rows
    const int k_zero = b0 + lane;
    if (lane < rows_w && k_zero < cap && k_zero >= fill) {
      write_both(out, c * cap + k_zero, Acc{0.f, 0.f, 0.f, 0.f, 0.f});
    }
    const int nb = min(rows_w, fill - b0);  // live rows of the batch
    if (nb <= 0) continue;
    const Acc a = warp_rows(stage, cells + c * cap + b0, nb, lane * cap, c_o,
                            TableRows<int>{ctab}, params, n_types, uniform_lj, b,
                            wl, wv, cap_w, lane);
    if (lane < nb) write_both(out, c * cap + b0 + lane, a);
  }
}

// ---- K1''s baseline: one block per xy column, 9 haloed z-columns ------------

__global__ void __launch_bounds__(512) ladder_colt1_cellwise_kernel(
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

// ---- K3c: whole neighbour columns by bulk copies, a warp per row -----------

// One block per xy column (the reference's program), W warps.  Each of the
// U distinct neighbour columns of the deduplicated stencil is one run of
// nz * cap rows in `cells` (cell c = column * nz + z), so the block stages
// every one whole, padding included, with one bulk copy against one
// mbarrier, and each staged row serves all nz cells of the block; lane 0
// of warp 0 arrives with the stage's bytes (U nz cap 16 <= 227 KiB, far
// under the barrier's 2^20 - 1) and lanes u < U issue the copies.  While the
// rows land the block stages the U nz counts and writes the zero rows past
// each cell's fill.  Then the live items (cell z, batch of rows_w rows
// inside its fill), z-major, are cut into W runs of equal length, a run a
// warp: for its current z, lane o < S holds stencil entry o's first stage
// row, column col_of[o] at cell (z + dz_o) mod nz (a window that wraps is
// read by index, so it costs no second copy), and its fill, and the warp
// writes each candidate's stage row into its own table once per z, which
// the next items of the run (the same z) read again; warp_rows takes the
// batch, in K2's order.  Stage rows stay below 2^16 (the stage holds at
// most 14 528), so the tables are 16-bit.  (The search over the lanes'
// prefix in place of the table was built and timed too: it lost by
// 13-18 %, PERF.md.)
__global__ void ladder_colz_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    const int* __restrict__ tab, float4* __restrict__ out, int nx, int ny,
    int nz, int cap, int n_types, int n_stencil, int n_cols, int uniform_lj,
    int rows_w, int depth) {
  extern __shared__ float4 smem[];
  __shared__ unsigned long long bar;
  __shared__ int col_s[9], self_s;
  const int col = blockIdx.x;  // cx * ny + cy
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n_warps = blockDim.x >> 5;
  const int col_rows = nz * cap;
  const int cap_w = 32 * depth;                       // entries of a list
  float4* stage = smem;                               // U nz cap
  float4* wl_all = stage + n_cols * col_rows;
  float* wv_all = reinterpret_cast<float*>(wl_all + n_warps * cap_w);
  int* cnt_s = reinterpret_cast<int*>(wv_all + n_warps * cap_w);  // U nz
  uint16_t* rtab = reinterpret_cast<uint16_t*>(cnt_s + n_cols * nz)
                   + warp * n_stencil * cap;          // S cap a warp
  float4* wl = wl_all + warp * cap_w;
  float* wv = wv_all + warp * cap_w;
  if (t < n_cols) {
    col_s[t] = ((col / ny + tab[2 * t]) % nx) * ny
               + (col % ny + tab[2 * t + 1]) % ny;
    if (tab[2 * t] == 0 && tab[2 * t + 1] == 0) self_s = t;
  }
  if (t == 0) {
    bulk::mbar_init(&bar, 1);
    bulk::fence_mbar_init();
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0) {
      bulk::mbar_expect_tx(&bar, static_cast<unsigned>(
                                     n_cols * col_rows * sizeof(float4)));
    }
    __syncwarp();
    if (lane < n_cols) {
      bulk::copy(stage + lane * col_rows, cells + col_s[lane] * col_rows,
                 static_cast<unsigned>(col_rows * sizeof(float4)), &bar);
    }
  }
  for (int k = t; k < n_cols * nz; k += blockDim.x) {
    cnt_s[k] = counts[col_s[k / nz] * nz + k % nz];
  }
  // the slots past each cell's fill are zero rows
  for (int k = t; k < col_rows; k += blockDim.x) {
    if (k % cap >= counts[col * nz + k / cap]) {
      write_both(out, col * col_rows + k, Acc{0.f, 0.f, 0.f, 0.f, 0.f});
    }
  }
  __syncthreads();
  bulk::mbar_wait(&bar, 0);

  const float4* own_col = stage + self_s * col_rows;
  const int* own_cnt = cnt_s + self_s * nz;
  int u_o = 0, dz_o = 0;  // lane o < S: stencil entry o's column and dz
  if (lane < n_stencil) {
    u_o = tab[2 * n_cols + lane];
    dz_o = tab[2 * n_cols + n_stencil + lane];
  }
  int n_items = 0;
  for (int z = 0; z < nz; ++z) n_items += (own_cnt[z] + rows_w - 1) / rows_w;
  const int i1 = n_items * (warp + 1) / n_warps;
  const Box b = load_box(box);
  int z = 0, z_item = 0;  // the cell of item i, and its first item
  int z_cur = -1, start = 0, c_o = 0;
  for (int i = n_items * warp / n_warps; i < i1; ++i) {
    while (i >= z_item + (own_cnt[z] + rows_w - 1) / rows_w) {
      z_item += (own_cnt[z] + rows_w - 1) / rows_w;
      ++z;
    }
    if (z != z_cur) {
      z_cur = z;
      const int zz = (z + dz_o) % nz;
      start = u_o * col_rows + zz * cap;
      c_o = lane < n_stencil ? cnt_s[u_o * nz + zz] : 0;
      int pre = c_o;
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(packed::kAll, pre, d);
        if (lane >= d) pre += v;
      }
      __syncwarp();  // the previous cell's table is no longer read
      for (int j = 0; j < c_o; ++j) {
        rtab[pre - c_o + j] = static_cast<uint16_t>(start + j);
      }
      __syncwarp();
    }
    const int b0 = (i - z_item) * rows_w;
    const int nb = min(rows_w, own_cnt[z] - b0);
    const Acc a = warp_rows(stage, own_col + z * cap + b0, nb, start, c_o,
                            TableRows<uint16_t>{rtab}, params, n_types,
                            uniform_lj, b, wl, wv, cap_w, lane);
    if (lane < nb) write_both(out, col * col_rows + z * cap + b0 + lane, a);
  }
}

// ---- K1': K1's column-segment body with colt1's per-column sums ----------

// K1's body (cell_pair_packed.cuh's lj_rows) under the kColumns policy: the
// same stage, candidates and order as K1 (the lanes o < 27 in (dx, dy, dz)
// order, dz fastest, which is colt1's column-major order), each xy column's
// terms summed apart and folded in as colt1 does, under a name of its own
// so that a trace tells K1' from K1.  The partials take the body from K1's
// 62 registers a thread to 71, which leaves room for 3 blocks of 256
// threads an SM, and K1's rule (484 blocks at 10k) for 4: the launch
// bounds (at most 256 threads, 4 blocks an SM) hold it to 64 (61, no
// spill), and it runs K1's rule in one wave (PERF.md).
__global__ void __launch_bounds__(256, 4) ladder_colt1_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int all_lj, int ch3_mode, int x_halo, unsigned mask,
    int seg, int rows_w, int depth) {
  packed::lj_rows<packed::Sums::kColumns>(
      cells, counts, box, params, out, nx, ny, nz, cap, n_types, uniform_lj,
      all_lj, ch3_mode, x_halo, mask, seg, rows_w, depth);
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

// The list bytes of a plan: depth entries a thread, a float4 and a float
// each (cell_pair_variants' *_launch_plan compute the same).
size_t list_bytes(int threads, int depth) {
  return static_cast<size_t>(threads) * depth
         * (sizeof(float4) + sizeof(float));
}

// whole warps, at most a block's 1024 threads, a list of at least one pass
bool warps_ok(int threads, int depth) {
  return threads >= 32 && threads <= 1024 && threads % 32 == 0 && depth >= 1;
}

// The shared-memory bytes of K3c's layout (cell_pair_variants.colz_smem
// computes the same): the stage of U whole columns, the warps' lists, the
// U nz counts and each warp's 16-bit table of S cap stage rows.
size_t colz_smem(int nz, int cap, int n_stencil, int n_cols, int threads,
                 int depth) {
  return static_cast<size_t>(n_cols) * nz * cap * sizeof(float4)
         + list_bytes(threads, depth)
         + static_cast<size_t>(n_cols) * nz * sizeof(int)
         + static_cast<size_t>(threads / 32) * n_stencil * cap
               * sizeof(uint16_t);
}

}  // namespace

// K3a with its launch plan (threads, depth, smem_bytes:
// cell_pair_variants.packet_launch_plan); ch3_mode is ignored (both
// channels are written)
extern "C" int ladder_packet(const void* cells, const void* counts,
                             const void* box, const void* params,
                             const void* table, void* out, int nx, int ny,
                             int nz, int cap, int n_types, int n_stencil,
                             int n_cols, int uniform_lj, int ch3_mode,
                             int threads, int depth, int smem_bytes,
                             void* stream) {
  (void)ch3_mode;
  // the plan must describe this layout: 8-row packets, whole warps, the
  // stage of 27 cells of cap rows and the warps' lists
  if (cap % 8 != 0 || !warps_ok(threads, depth)
      || 27 * static_cast<size_t>(cap) * sizeof(float4)
                 + list_bytes(threads, depth)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_packet_kernel),
                        smem_bytes);
  if (rc) return rc;
  ladder_packet_kernel<<<nx * ny * nz, threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj, depth);
  return static_cast<int>(cudaGetLastError());
}

// K3a's first design (a block of 32 threads per cell and 8-row packet, the
// S cells staged by each live packet, 8 threads walking a row each), kept
// as the baseline the warp-per-packet kernel is held and timed against; no
// step reaches this entry point
extern "C" int ladder_packet_cellwise(const void* cells, const void* counts,
                                      const void* box, const void* params,
                                      const void* table, void* out, int nx,
                                      int ny, int nz, int cap, int n_types,
                                      int n_stencil, int n_cols,
                                      int uniform_lj, int ch3_mode,
                                      void* stream) {
  (void)ch3_mode;
  const size_t shmem = static_cast<size_t>(n_stencil) * cap * sizeof(float4)
                       + params_bytes(n_types) + n_stencil * sizeof(int);
  const int rc = opt_in(
      reinterpret_cast<const void*>(ladder_packet_cellwise_kernel), shmem);
  if (rc) return rc;
  ladder_packet_cellwise_kernel<<<dim3(nx * ny * nz, cap / 8), 32, shmem,
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
  if (rows_w < 1 || rows_w > 32 || threads < 128 || !warps_ok(threads, depth)
      || list_bytes(threads, depth) != static_cast<size_t>(smem_bytes)) {
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

// K3c with its launch plan (rows_w, threads, depth, smem_bytes:
// cell_pair_variants.colz_launch_plan); ch3_mode is ignored (both channels
// are written)
extern "C" int ladder_colz(const void* cells, const void* counts,
                           const void* box, const void* params,
                           const void* table, void* out, int nx, int ny,
                           int nz, int cap, int n_types, int n_stencil,
                           int n_cols, int uniform_lj, int ch3_mode,
                           int rows_w, int threads, int depth,
                           int smem_bytes, void* stream) {
  (void)ch3_mode;
  // the plan must describe this layout: a batch's rows one lane each,
  // whole warps, colz_smem's bytes
  if (rows_w < 1 || rows_w > 32 || !warps_ok(threads, depth)
      || colz_smem(nz, cap, n_stencil, n_cols, threads, depth)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_colz_kernel),
                        smem_bytes);
  if (rc) return rc;
  ladder_colz_kernel<<<nx * ny, threads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
}

// K3c's first design (one block per xy column, a thread per slot walking
// its row's S cells alone, the U columns staged element by element), kept
// as the baseline the new kernel is held and timed against; no step
// reaches this entry point
extern "C" int ladder_colz_cellwise(const void* cells, const void* counts,
                                    const void* box, const void* params,
                                    const void* table, void* out, int nx,
                                    int ny, int nz, int cap, int n_types,
                                    int n_stencil, int n_cols,
                                    int uniform_lj, int ch3_mode,
                                    void* stream) {
  (void)ch3_mode;
  const size_t shmem =
      static_cast<size_t>(n_cols) * nz * cap * sizeof(float4)
      + params_bytes(n_types)
      + static_cast<size_t>(n_cols) * (nz + 1) * sizeof(int);
  const int rc = opt_in(
      reinterpret_cast<const void*>(ladder_colz_cellwise_kernel), shmem);
  if (rc) return rc;
  ladder_colz_cellwise_kernel<<<nx * ny, column_block(cap, nz), shmem,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

// K3d with its launch plan (rows_w, threads, depth, smem_bytes:
// cell_pair_variants.column_launch_plan); ch3_mode is ignored (both
// channels are written)
extern "C" int ladder_column(const void* cells, const void* counts,
                             const void* box, const void* params,
                             const void* table, void* out, int nx, int ny,
                             int nz, int cap, int n_types, int n_stencil,
                             int n_cols, int uniform_lj, int ch3_mode,
                             int rows_w, int threads, int depth,
                             int smem_bytes, void* stream) {
  (void)ch3_mode;
  // the plan must describe this layout: a batch's rows one lane each,
  // whole warps, the stage of S cells of cap rows, the warps' lists and
  // the stage row of each candidate
  if (rows_w < 1 || rows_w > 32 || !warps_ok(threads, depth)
      || static_cast<size_t>(n_stencil) * cap * (sizeof(float4) + sizeof(int))
                 + list_bytes(threads, depth)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rc = opt_in(reinterpret_cast<const void*>(ladder_column_kernel),
                        smem_bytes);
  if (rc) return rc;
  ladder_column_kernel<<<dim3(nz, nx * ny), threads, smem_bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
}

// K3d's first design (one block per cell, one thread per slot, each
// walking its row's S cells alone), kept as the baseline the warp-per-row
// kernel is held and timed against; no step reaches this entry point
extern "C" int ladder_column_cellwise(const void* cells, const void* counts,
                                      const void* box, const void* params,
                                      const void* table, void* out, int nx,
                                      int ny, int nz, int cap, int n_types,
                                      int n_stencil, int n_cols,
                                      int uniform_lj, int ch3_mode,
                                      void* stream) {
  (void)ch3_mode;
  const size_t shmem = static_cast<size_t>(n_stencil) * cap * sizeof(float4)
                       + params_bytes(n_types) + n_stencil * sizeof(int);
  const int rc = opt_in(
      reinterpret_cast<const void*>(ladder_column_cellwise_kernel), shmem);
  if (rc) return rc;
  ladder_column_cellwise_kernel<<<dim3(nz, nx * ny), ((cap + 31) / 32) * 32,
                                  shmem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<const int*>(table), static_cast<float4*>(out), nx, ny, nz,
      cap, n_types, n_stencil, n_cols, uniform_lj);
  return static_cast<int>(cudaGetLastError());
}

// K1' with its launch plan (seg, rows_w, threads, depth, smem_bytes:
// cell_pair_variants.colt1_launch_plan; at most 256 threads, the kernel's
// launch bounds), on a grid of at least 3 cells an axis (a full 27-cell
// stencil); ch3 is e/2 (ch3_mode 1) or w/2 (2), and mode 0 gives e/2 as
// the first design does
extern "C" int ladder_colt1(const void* cells, const void* counts,
                            const void* box, const void* params,
                            const void* table, void* out, int nx, int ny,
                            int nz, int cap, int n_types, int n_stencil,
                            int n_cols, int uniform_lj, int ch3_mode, int seg,
                            int rows_w, int threads, int depth,
                            int smem_bytes, void* stream) {
  (void)table;
  (void)n_stencil;
  (void)n_cols;
  if (nx < 3 || ny < 3 || nz < 3 || threads > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return packed::lj_launch(ladder_colt1_kernel, cells, counts, box, params,
                           out, nx, ny, nz, cap, n_types, uniform_lj, 0,
                           ch3_mode == 2 ? 2 : 1, 0, packed::kStencil27, seg,
                           rows_w, threads, depth, smem_bytes, stream,
                           packed::Sums::kColumns);
}

// K1''s first design (one block per xy column, a thread per slot walking
// the 9 columns' windows alone, the 9 haloed columns staged element by
// element), kept as the baseline the new kernel is held and timed against;
// no step reaches this entry point
extern "C" int ladder_colt1_cellwise(const void* cells, const void* counts,
                                     const void* box, const void* params,
                                     const void* table, void* out, int nx,
                                     int ny, int nz, int cap, int n_types,
                                     int n_stencil, int n_cols,
                                     int uniform_lj, int ch3_mode,
                                     void* stream) {
  (void)table;
  (void)n_stencil;
  (void)n_cols;
  const size_t shmem =
      9 * static_cast<size_t>(nz + 2) * cap * sizeof(float4)
      + params_bytes(n_types) + 9 * static_cast<size_t>(nz + 3) * sizeof(int);
  const int rc = opt_in(
      reinterpret_cast<const void*>(ladder_colt1_cellwise_kernel), shmem);
  if (rc) return rc;
  ladder_colt1_cellwise_kernel<<<nx * ny, column_block(cap, nz), shmem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj,
      ch3_mode);
  return static_cast<int>(cudaGetLastError());
}
