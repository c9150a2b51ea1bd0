// The column-segment stage and the packed row layout of the pair kernels
// that give each row a whole warp: the LJ body lj_rows (at the end of this
// file), which cell_pair.cu launches as colt_packed_kernel (K1/K1b/K1f),
// cell_pair_cell.cu as cell_packed_kernel (K2, over a stencil mask) and
// cell_pair_ladder.cu as ladder_colt1_kernel (K1', colt1's per-column
// sums), and cell_pair_cheb.cu's cheb_packed_kernel (Chebyshev tables, K1c/K1d/K1e
// and their K1f modes), which keeps its own pair term, parameter tables
// and sums.  What is here decides which candidates a row visits and in
// which order, the same for all; cell_pair_ladder.cu's K3b finds its
// candidates in global memory with cand_row and culls with min_gap2.
//
// A block takes one xy column of the output grid and a z segment of `seg`
// cells (z0 .. z0 + lb - 1).  stage_block stages the 9 xy-neighbour
// z-columns for z in [z0 - 1, z0 + lb] (hz = seg + 2 cells each, staged by
// index with a wrap, so a grid of 3 cells on an axis stages one cell twice
// and a row still visits 3 distinct cells), each column's occupied rows
// packed cell after cell (cpre: the rows before each cell; a column every
// hz * cap + 1 rows), so that the neighbours a row finds in one cell are
// one contiguous run; and each staged cell's bounding box, from its rows.
// Every copy is in flight at once (cp.async), then one barrier.
//
// A row's candidates (row_cands, cand_row): lane o < 27 takes stencil offset
// o (dx, dy, dz from -1 to 1, dz fastest: the cellwise kernels' order) and
// drops its cell when the cell's bounding box lies beyond the row's largest
// cutoff (none of its pairs could pass the cut; a margin keeps the test
// clear of rounding, also on a box that shrinks: the box is read on the
// device every launch), or when bit o of the stencil mask is clear; a scan
// of the 27 counts lays the row's candidates out in stencil order, then
// slot order, and candidate k of the row is found by a binary search over
// the lanes' prefixes.  A kernel that adds a row's in-cut terms in
// candidate order adds them as the cellwise kernel does: the same operands
// in the same sequence, the same bits.
//
// The stencil mask: on a full grid (at least 3 cells an axis) every offset
// names its own cell and the mask is kStencil27.  On an axis of 2 cells
// the offsets -1 and +1 name one cell, on an axis of 1 all three do; K2's
// mask keeps the lanes whose offset residue (dx mod nx, dy mod ny, dz mod
// nz) appears for the first time in lane order, which is the deduplicated
// stencil of neighbor.neighbor_cell_offsets in its order.  The staged cell
// of a kept lane is the neighbour that offset names (the stage wraps every
// axis), so K2 visits its S cells in its cellwise kernel's order.
//
// Staged cell (u, h): xy column u = (dx + 1) * 3 + dy + 1, z = z0 - 1 + h;
// cells past the segment's lb + 2 stay empty.  The block's own rows are
// column (0, 0), cells 1 .. lb, contiguous in the stage.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace packed {

constexpr unsigned kAll = 0xffffffffu;
// every lane of the 27-offset stencil (the full grid)
constexpr unsigned kStencil27 = (1u << 27) - 1u;

// Minimum image and r2 of one candidate in the cellwise kernels' op order.
__device__ __forceinline__ float pair_r2(const float4 xi, const float4 xj,
                                         const float bx, const float by,
                                         const float bz, const float ibx,
                                         const float iby, const float ibz,
                                         float& ddx, float& ddy, float& ddz) {
  ddx = xi.x - xj.x;
  ddx = ddx - bx * rintf(ddx * ibx);
  ddy = xi.y - xj.y;
  ddy = ddy - by * rintf(ddy * iby);
  ddz = xi.z - xj.z;
  ddz = ddz - bz * rintf(ddz * ibz);
  float r2 = ddx * ddx;
  r2 = r2 + ddy * ddy;
  r2 = r2 + ddz * ddz;
  return r2;
}

__device__ __forceinline__ int wrap(int v, int n) { return ((v % n) + n) % n; }

// Periodic distance |d - b * rint(d / b)| at least, over d in [lo, hi]:
// zero when the interval holds a multiple of b, else the nearer end's.
__device__ __forceinline__ float axis_gap(float lo, float hi, float b,
                                          float ib) {
  if (ceilf(lo * ib) * b <= hi) return 0.f;
  return fminf(fabsf(lo - b * rintf(lo * ib)), fabsf(hi - b * rintf(hi * ib)));
}

// A lower bound, less a margin gm on each axis, of the squared minimum-image
// distance from xi to any point of the box c = [x0, y0, z0, x1, y1, z1]:
// no pair of xi with a row in the box has r2 below it.
__device__ __forceinline__ float min_gap2(const float4 xi, const float* c,
                                          float bx, float by, float bz,
                                          float ibx, float iby, float ibz,
                                          float gm) {
  const float gx = fmaxf(axis_gap(xi.x - c[3], xi.x - c[0], bx, ibx) - gm, 0.f);
  const float gy = fmaxf(axis_gap(xi.y - c[4], xi.y - c[1], by, iby) - gm, 0.f);
  const float gz = fmaxf(axis_gap(xi.z - c[5], xi.z - c[2], bz, ibz) - gm, 0.f);
  return gx * gx + gy * gy + gz * gz;
}

// The cull's margin on each axis' gap, far above the f32 rounding of a
// minimum-image difference.
__device__ __forceinline__ float cull_margin(float bx, float by, float bz) {
  return 1e-5f * (bx + by + bz) + 1e-6f;
}

// A block's stage in shared memory (the kernel lays the arrays out) and
// where its own rows are.
struct Stage {
  float4* rows;   // 9 cstride packed rows
  int* cnt;       // 9 hz staged counts
  int* cpre;      // 9 (hz + 1) rows before each staged cell, per column
  int* base_g;    // 9 hz first global row of each staged cell
  float* bbox;    // 9 hz 6 bounding boxes [x0, y0, z0, x1, y1, z1]
  int hz;         // staged cells per column
  int cstride;    // stage rows per column
  int lb;         // output cells of the block
  int out0;       // the first of them
  int row0;       // the block's first row in the stage
  int n_own;      // the block's rows
};

// Shared-memory words (4 bytes) of the stage's bookkeeping besides the
// rows: cnt, cpre, base_g and bbox (the launchers' layout checks).
inline size_t stage_words(int seg) {
  const size_t hz = static_cast<size_t>(seg + 2);
  return 9 * hz + 9 * (hz + 1) + 9 * hz + 9 * hz * 6;
}

// Stage the block's 9 z-columns, write zero rows to the output slots past
// each output cell's occupancy, and leave every staged cell's bounding box;
// ends with a barrier.  s.rows, s.cnt, s.cpre, s.base_g and s.bbox must
// point at the kernel's arrays; the rest is filled in here.
__device__ __forceinline__ void stage_block(const float4* __restrict__ cells,
                                            const int* __restrict__ counts,
                                            float4* __restrict__ out,
                                            Stage& s, int nx, int ny, int nz,
                                            int cap, int x_halo, int seg) {
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  const int hz = seg + 2;
  s.hz = hz;
  s.cstride = hz * cap + 1;
  const int n_seg = (nz + seg - 1) / seg;
  const int col = blockIdx.x / n_seg;          // cx_out * ny + cy
  const int z0 = (blockIdx.x % n_seg) * seg;
  s.lb = min(seg, nz - z0);
  const int cy = col % ny;
  const int cx = col / ny + (x_halo ? 1 : 0);  // the column's x in `cells`
  s.out0 = col * nz + z0;
  for (int k = t; k < 9 * hz; k += nthr) {
    const int u = k / hz, h = k % hz;
    const int ncx = x_halo ? cx + u / 3 - 1 : wrap(cx + u / 3 - 1, nx);
    const int nc = (ncx * ny + wrap(cy + u % 3 - 1, ny)) * nz
                   + wrap(z0 - 1 + h, nz);
    s.cnt[k] = h < s.lb + 2 ? counts[nc] : 0;
    s.base_g[k] = nc * cap;
  }
  __syncthreads();
  if (t < 9) {
    int acc = 0;
    for (int h = 0; h < hz; ++h) {
      s.cpre[t * (hz + 1) + h] = acc;
      acc += s.cnt[t * hz + h];
    }
    s.cpre[t * (hz + 1) + hz] = acc;
  }
  __syncthreads();
  // the rows, a warp to a staged cell, every copy in flight at once
  for (int sc = t >> 5; sc < 9 * hz; sc += nthr >> 5) {
    const int u = sc / hz;
    float4* dst = s.rows + u * s.cstride + s.cpre[sc + u];
    const float4* src = cells + s.base_g[sc];
    for (int slot = t & 31; slot < s.cnt[sc]; slot += 32) {
      __pipeline_memcpy_async(dst + slot, src + slot, sizeof(float4));
    }
  }
  __pipeline_commit();
  // the slots past each output cell's occupancy are zero rows
  for (int k = t; k < s.lb * cap; k += nthr) {
    if (k % cap >= s.cnt[4 * hz + k / cap + 1]) {
      out[s.out0 * cap + k] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int sc = t; sc < 9 * hz; sc += nthr) {
    const int u = sc / hz;
    const float4* r = s.rows + u * s.cstride + s.cpre[sc + u];
    float b[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY,
                  -INFINITY};
    for (int k = 0; k < s.cnt[sc]; ++k) {
      b[0] = fminf(b[0], r[k].x);
      b[1] = fminf(b[1], r[k].y);
      b[2] = fminf(b[2], r[k].z);
      b[3] = fmaxf(b[3], r[k].x);
      b[4] = fmaxf(b[4], r[k].y);
      b[5] = fmaxf(b[5], r[k].z);
    }
    for (int k = 0; k < 6; ++k) s.bbox[sc * 6 + k] = b[k];
  }
  __syncthreads();
  // the block's rows: column (0, 0), cells 1 .. lb
  const int* own_pre = s.cpre + 4 * (hz + 1);
  s.row0 = own_pre[1];
  s.n_own = own_pre[s.lb + 1] - s.row0;
}

// The segment cell (0 .. lb - 1) of the block's stage row `row`.
__device__ __forceinline__ int row_cell(const Stage& s, int row) {
  const int* own_pre = s.cpre + 4 * (s.hz + 1);
  int zl = 0;
  while (row >= own_pre[zl + 2]) ++zl;
  return zl;
}

// Where one row's candidates lie; lane o < 27 holds offset o's part.
struct RowCands {
  int pre;    // inclusive prefix of the offsets' candidates
  int first;  // the row's first candidate in offset o
  int start;  // offset o's first stage row
  int total;  // the row's candidates (every lane)
};

// Lay out the candidates of row xi (segment cell zl) over the lanes of
// `mask`, culling the cells whose bounding box lies beyond cmax (the row's
// largest cutoff^2).  Every lane of the warp calls it.
__device__ __forceinline__ RowCands row_cands(const Stage& s, const float4 xi,
                                              int zl, float cmax, float bx,
                                              float by, float bz, float ibx,
                                              float iby, float ibz, float gm,
                                              int lane, unsigned mask) {
  int c_o = 0, start = 0;
  if (lane < 27) {
    const int u = lane / 3, sc = u * s.hz + zl + lane % 3;
    start = u * s.cstride + s.cpre[sc + u];
    c_o = (mask >> lane) & 1u ? s.cnt[sc] : 0;
    if (c_o > 0 && min_gap2(xi, s.bbox + sc * 6, bx, by, bz, ibx, iby, ibz,
                            gm) >= cmax) {
      c_o = 0;
    }
  }
  int pre = c_o;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kAll, pre, d);
    if (lane >= d) pre += v;
  }
  RowCands rc;
  rc.pre = pre;
  rc.first = pre - c_o;
  rc.start = start;
  rc.total = __shfl_sync(kAll, pre, 31);
  return rc;
}

// The stage row of the row's candidate k (meaningful for k < total), and
// in `o` the lane (stencil offset) that holds it.  Every lane of the warp
// calls it, each with its own k.
__device__ __forceinline__ int cand_row(const RowCands& rc, int k, int& o) {
  // the offset holding candidate k: the lanes whose prefix is <= k
  o = 0;
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kAll, rc.pre, o + step - 1) <= k) o += step;
  }
  const int o_start = __shfl_sync(kAll, rc.start, o & 31);
  const int o_first = __shfl_sync(kAll, rc.first, o & 31);
  return o_start + k - o_first;
}

__device__ __forceinline__ int cand_row(const RowCands& rc, int k) {
  int o;
  return cand_row(rc, k, o);
}

// ---- the LJ column-segment kernel's body (K1 in cell_pair.cu, K2 in
// cell_pair_cell.cu; each source wraps it in a __global__ of its own name) --

// The type pair of row type ti and a candidate row's type plane value.
__device__ __forceinline__ int type_pair(int ti, float wj, int n_types) {
  return ti * n_types + max(static_cast<int>(wj) - 1, 0);
}

// The LJ pair term for a pair inside the cut, in the cellwise kernels' op
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

// How lj_rows adds a row's terms, chosen at compile time.
//   kPlain (K1, K1b, K1f, K2): running sums in list order, fx = fx + term,
//     ch3 halved once at the write.
//   kColumns (K1', the reference's colt1): per xy column of the stencil a
//     partial sum over the column's cells in list order, folded into the
//     running sums when the next entry's column differs and after the row's
//     last entry (fx = fx + px, ..., acc = acc + 0.5 pacc, colt1's order);
//     acc is written as it is.  colt1 adds all 9 partials, the empty ones
//     too, where this folds only the columns that have in-cut pairs; the bits
//     agree: an empty partial is +0.0, a sum that starts at +0.0 is never
//     -0.0 under round-to-nearest, so adding +0.0 to it changes nothing, and
//     the bounding-box cull drops only cells without an in-cut pair.  Each
//     list entry keeps its column (its stencil offset over 3, dz fastest) in
//     a byte beside it, since the flush overwrites the entry with its terms;
//     the partial and its column live in registers across flushes, as a
//     flush can fall inside a column.
enum class Sums { kPlain, kColumns };

// One block per (xy column, z segment of `seg` cells) of the output grid;
// the block's occupied rows in batches of `rows_w`, one batch per warp at a
// time, each row of the batch in turn taken by the whole warp: its
// candidates over the lanes of `mask` (row_cands) 32 a pass through the
// candidate ops up to the cut, the in-cut ones appended to the warp's list
// in candidate order by a ballot, then the terms evaluated over the list 32
// at a time.  Lane r of the batch holds row r's sums, adds its terms in list
// order (by the policy kSums) and writes its slot.
template <Sums kSums = Sums::kPlain>
__device__ __forceinline__ void lj_rows(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ params,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int uniform_lj, int all_lj, int ch3_mode, int x_halo, unsigned mask,
    int seg, int rows_w, int depth) {
  constexpr bool kCols = kSums == Sums::kColumns;
  extern __shared__ float4 smem[];
  const int tt = n_types * n_types;
  const int hz = seg + 2;
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  Stage s;
  s.rows = smem;                                                // 9 cstride
  float4* ent = s.rows + 9 * (hz * cap + 1);                    // depth nthr
  float* par = reinterpret_cast<float*>(ent + depth * nthr);    // 5 T T
  s.cnt = reinterpret_cast<int*>(par + 5 * tt);                 // 9 hz
  s.cpre = s.cnt + 9 * hz;                                      // 9 (hz + 1)
  s.base_g = s.cpre + 9 * (hz + 1);                             // 9 hz
  s.bbox = reinterpret_cast<float*>(s.base_g + 9 * hz);         // 9 hz 6
  float* cmax = s.bbox + 9 * hz * 6;                            // T
  // kColumns: each list entry's column, a byte each       // depth nthr
  unsigned char* ecol = reinterpret_cast<unsigned char*>(cmax + n_types);

  for (int k = t; k < 5 * tt; k += nthr) par[k] = params[k];
  stage_block(cells, counts, out, s, nx, ny, nz, cap, x_halo, seg);
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
  const float gm = cull_margin(bx, by, bz);
  const float4* own_rows = s.rows + 4 * s.cstride + s.row0;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  const int cap_w = 32 * depth;               // entries of a warp's list
  float4* wl = ent + (t - lane) * depth;      // this warp's list
  unsigned char* wc = ecol + (t - lane) * depth;  // its entries' columns

  for (int b0 = (t >> 5) * rows_w; b0 < s.n_own;
       b0 += (nthr >> 5) * rows_w) {
    const int nb = min(rows_w, s.n_own - b0);  // rows of this batch
    float fx = 0.f, fy = 0.f, fz = 0.f, acc = 0.f;  // lane r: row b0 + r
    float px = 0.f, py = 0.f, pz = 0.f, pacc = 0.f;  // kColumns: a partial
    int pcol = -1;                                    // and its column
    int lo = 0, hi = 0;  // lane r's entries in the list
    int n = 0;           // entries in the list
    // kColumns: add the partial to the running sums and start another
    auto fold = [&]() {
      fx = fx + px;
      fy = fy + py;
      fz = fz + pz;
      acc = acc + 0.5f * pacc;
      px = py = pz = pacc = 0.f;
    };

    // evaluate the list's entries, then each lane sums its row's terms
    auto flush = [&]() {
      __syncwarp();  // the list's entries, from every lane
      for (int k = lane; k < n; k += 32) {
        const float4 en = wl[k];
        const float4 xi = own_rows[b0 + __float_as_int(en.x)];
        const float4 xj = s.rows[__float_as_int(en.w)];
        float ddx, ddy, ddz;
        const float r2s = pair_r2(xi, xj, bx, by, bz, ibx, iby, ibz, ddx,
                                  ddy, ddz);
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
        if constexpr (kCols) {
          if (wc[k] != pcol) {
            fold();
            pcol = wc[k];
          }
          px = px + en.x;
          py = py + en.y;
          pz = pz + en.z;
          pacc = pacc + en.w;
        } else {
          fx = fx + en.x;
          fy = fy + en.y;
          fz = fz + en.z;
          if (ch3_mode != 0) acc = acc + en.w;
        }
      }
      __syncwarp();
      lo = hi = n = 0;
    };

    for (int r = 0; r < nb; ++r) {
      const float4 xi = own_rows[b0 + r];
      if (!(xi.w > 0.5f)) continue;  // an inactive row has no pairs
      const int ti = max(static_cast<int>(xi.w) - 1, 0);
      const RowCands rc = row_cands(s, xi, row_cell(s, s.row0 + b0 + r),
                                    cmax[ti], bx, by, bz, ibx, iby, ibz, gm,
                                    lane, mask);
      if (lane == r) lo = hi = n;
      for (int k0 = 0; k0 < rc.total; k0 += 32) {
        if (n + 32 > cap_w) flush();
        const int k = k0 + lane;
        int o;  // the candidate's stencil offset; its xy column is o / 3
        const int f = cand_row(rc, k, o);
        bool in = false;
        if (k < rc.total) {
          const float4 xj = s.rows[f];
          float ddx, ddy, ddz;
          const float r2 = pair_r2(xi, xj, bx, by, bz, ibx, iby, ibz, ddx,
                                   ddy, ddz);
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
          if constexpr (kCols) {
            wc[n + __popc(m & below)] = static_cast<unsigned char>(o / 3);
          }
        }
        n += __popc(m);
        if (lane == r) hi = n;
      }
    }
    flush();
    if constexpr (kCols) fold();
    if (lane < nb) {
      const int row = s.row0 + b0 + lane;
      const int oz = row_cell(s, row);
      out[(s.out0 + oz) * cap + row - s.cpre[4 * (hz + 1) + oz + 1]] =
          make_float4(fx, fy, fz, kCols ? acc : 0.5f * acc);
    }
  }
}

// Shared-memory bytes of lj_rows' layout under the policy `sums` (the
// Python plans, cell_pair.colt_launch_plan, cell_pair.k2_launch_plan and,
// with kColumns' byte an entry, cell_pair_variants.colt1_launch_plan,
// compute the same).
inline size_t lj_smem(int cap, int n_types, int seg, int threads, int depth,
                      Sums sums = Sums::kPlain) {
  const size_t hz = static_cast<size_t>(seg + 2);
  const size_t entries = static_cast<size_t>(threads) * depth;
  return (9 * (hz * cap + 1) + entries) * sizeof(float4)
         + (5 * static_cast<size_t>(n_types) * n_types + stage_words(seg)
            + n_types) * sizeof(float)
         + (sums == Sums::kColumns ? entries : 0);
}

// The signature of the __global__ wrappers of lj_rows.
using LjKernel = void (*)(const float4*, const int*, const float*,
                          const float*, float4*, int, int, int, int, int, int,
                          int, int, int, unsigned, int, int, int);

// Launch an lj_rows wrapper with the launch plan (seg, rows_w, threads,
// depth, smem_bytes), after checking that the plan describes this layout:
// whole warps, a batch's rows one lane each, a list of at least one pass of
// 32 candidates a warp, the bytes of lj_smem under the wrapper's `sums`.
inline int lj_launch(LjKernel kernel, const void* cells, const void* counts,
                     const void* box, const void* params, void* out, int nx,
                     int ny, int nz, int cap, int n_types, int uniform_lj,
                     int all_lj, int ch3_mode, int x_halo, unsigned mask,
                     int seg, int rows_w, int threads, int depth,
                     int smem_bytes, void* stream,
                     Sums sums = Sums::kPlain) {
  if (seg < 1 || rows_w < 1 || rows_w > 32 || threads < 32 || threads > 1024
      || threads % 32 != 0 || depth < 1 || (mask & ~kStencil27) != 0
      || lj_smem(cap, n_types, seg, threads, depth, sums)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (x_halo ? nx - 2 : nx) * ny * ((nz + seg - 1) / seg);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  kernel<<<n_blocks, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(params),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, uniform_lj, all_lj,
      ch3_mode, x_halo, mask, seg, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace packed
