// The column-segment stage and the packed row layout of the pair kernels
// that give each row a whole warp: cell_pair.cu's colt_packed_kernel (LJ,
// K1/K1b/K1f) and cell_pair_cheb.cu's cheb_packed_kernel (Chebyshev tables,
// K1c/K1d/K1e and their K1f modes).  Each source keeps its own pair term,
// parameter tables and sums; what is here decides which candidates a row
// visits and in which order, the same for both.
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
// device every launch); a scan of the 27 counts lays the row's candidates
// out in stencil order, then slot order, and candidate k of the row is
// found by a binary search over the lanes' prefixes.  A kernel that adds a
// row's in-cut terms in candidate order adds them as the cellwise kernel
// does: the same operands in the same sequence, the same bits.
//
// Staged cell (u, h): xy column u = (dx + 1) * 3 + dy + 1, z = z0 - 1 + h;
// cells past the segment's lb + 2 stay empty.  The block's own rows are
// column (0, 0), cells 1 .. lb, contiguous in the stage.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace packed {

constexpr unsigned kAll = 0xffffffffu;

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

// Lay out the candidates of row xi (segment cell zl), culling the cells
// whose bounding box lies beyond cmax (the row's largest cutoff^2).  Every
// lane of the warp calls it.
__device__ __forceinline__ RowCands row_cands(const Stage& s, const float4 xi,
                                              int zl, float cmax, float bx,
                                              float by, float bz, float ibx,
                                              float iby, float ibz, float gm,
                                              int lane) {
  int c_o = 0, start = 0;
  if (lane < 27) {
    const int u = lane / 3, sc = u * s.hz + zl + lane % 3;
    start = u * s.cstride + s.cpre[sc + u];
    c_o = s.cnt[sc];
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

// The stage row of the row's candidate k (meaningful for k < total).  Every
// lane of the warp calls it, each with its own k.
__device__ __forceinline__ int cand_row(const RowCands& rc, int k) {
  // the offset holding candidate k: the lanes whose prefix is <= k
  int o = 0;
  for (int step = 16; step > 0; step >>= 1) {
    if (__shfl_sync(kAll, rc.pre, o + step - 1) <= k) o += step;
  }
  const int o_start = __shfl_sync(kAll, rc.start, o & 31);
  const int o_first = __shfl_sync(kAll, rc.first, o & 31);
  return o_start + k - o_first;
}

}  // namespace packed
