// K1c / K1d / K1e: cell-tile pair sum of Chebyshev-fitted tabulated pairs
// over all pairs on a periodic cell grid.
//
// Replaces the Chebyshev modes of the TPU kernel
// chemlab_tpu/engine/pallas_pair.py:211 _colt2_kernel (its Chebyshev
// branches at :405-458 and :469-520, its pallas_call at :740):
//   K1c  table-scalar mode (cheb_ntab > 0): per-table fit scalars in SMEM,
//        one Clenshaw chain per distinct table, selected by a table-id plane;
//   K1d  the same with cheb_mix: x * T_a + (1 - x) * T_b per type pair
//        (func 10 / func 12 two-table blends);
//   K1e  coefficient-plane mode (cheb_ntab = 0): per-type-pair coefficient
//        planes gathered through one-hot MXU products.
// On the TPU the split between "scalars in SMEM" and "coefficient planes"
// exists because Mosaic has no vector gather.  Here all three are one
// kernel: a (T, T) map gives each type pair a row of a coefficient pack
// staged in shared memory (K1c/K1d: the deduplicated table rows; K1e: the
// per-table rows through the table id), and the pair evaluates that row.
// K1d evaluates a second row and blends as the excluded-pair correction
// does (pallas_pair.py:1052), x * g_a + (1 - x) * g_b.
//
// Excluded pairs are included; the torch correction
// (chemlab_tpu_torch/engine/cell_pair.py::_pair_eval, through
// tab_cheb.eval_planes) subtracts them with the same per-pair f32 op
// sequence.  Bonded neighbours sit at ~0.97 sigma, deep in the wall where
// G ~ 1e3, so any op-order difference would become bond-force noise.  So
// this file is compiled with --fmad=false and without fast math (IEEE
// division and sqrtf), rounds the minimum image with rintf (half to even,
// as torch.round), sums r2 as x, y, z in that order, and evaluates the
// series in eval_planes' order: r2w = max(r2, rcap2),
// yw = clamp(ay / r2w + by, -1, 1), g = c0 + c1 * yw,
// t_n = 2 * yw * t_k - t_k-1, g = g + c_k * t_n; the well piece (ko > 0)
// uses r = sqrtf(r2) (not rsqrtf, which is approximate) and selects it
// where r2 >= rs2.
//
// What bounds it on an H100: at 10k particles (11^3 cells, cap 32, ~7.5
// particles a cell) the operands are ~0.7 MB and stay in the 50 MB L2; a
// call visits ~2.07 M candidate pairs (~22 f32 operations each up to the
// cut) and ~0.2 M pairs inside the cutoff (a Clenshaw chain each: ~43
// operations at kw = 8, ~85 for the blend, and one IEEE division), so it is
// bound by latency and by how many lanes issue useful work, not by bytes.
//
// Two kernels, the same sums bit for bit:
//
//   cheb_cellwise_kernel (the entry points *_cellwise; the first design,
//   kept as the baseline the other is held and timed against): one block
//   per cell, one thread per slot, the 27 neighbour cells staged one at a
//   time between two barriers.  Only the ~7.5 occupied slots of a warp
//   work (~23 % of the lanes at cap 32), and the chain runs inside the
//   candidate loop, so a warp runs it whenever any of its lanes has a pair
//   in the cutoff: ~5x the chains the pairs need.
//
//   cheb_packed_kernel (cell_pair_cheb, cell_pair_cheb_mix; the launch plan
//   is cell_pair.cheb_launch_plan's; every step runs it):
//   - columns: one block per (xy column, z segment of L cells); the 9
//     xy-neighbour z-columns for z in [z0 - 1, z0 + L] are staged once,
//     with every copy in flight at once (cp.async), then one barrier: the
//     ladder's lesson (cell_pair_ladder.cu's K3c and K1': one stage per
//     column beats 27 per cell);
//   - packed lanes: a warp takes a batch of the block's occupied rows and
//     gives each row in turn all 32 lanes: lane o < 27 takes stencil offset
//     o, a scan of the 27 counts lays the row's candidates out in stencil
//     order and slot order, and the lanes take 32 consecutive candidates a
//     pass, so a lane idles only in a row's last pass;
//   - filter, then evaluate: a pass runs the candidate ops up to the cut
//     and a ballot appends the in-cut pairs, in order, to the warp's list;
//     the chains then run over the list, 32 pairs at a time, and each
//     row's lane adds its terms in list order.  That is the cellwise order
//     per slot (stencil order, then slot order, in-cut pairs only), with
//     the same operands in the same sequence, so the sums are the same
//     bits, and a chain runs only for a pair inside the cutoff;
//   - a cell whose bounding box lies beyond the row's largest cutoff (with
//     a margin far above rounding) is dropped before its candidates are
//     laid out: none of its pairs could pass the cut.
//   No atomics and no order that depends on timing: each slot is written by
//   one thread, which adds its terms in a fixed order.
//   Measured on an H100 (PERF.md, chemlab_tpu_torch.kernel_matrix --tab):
//   designs with 1, 3 or 9 lanes a row, each lane a range of offsets and a
//   list of its own, ran at 0.070-0.09 ms on the 10k melt (a warp
//   followed its slowest lane through rows of uneven candidates and chain
//   counts) against the cellwise kernel's 0.086; the warp per row runs it
//   at ~0.03 ms.  The choices of L, rows per batch, threads and list depth
//   are cell_pair.py's CHEB_* constants, from that sweep.
//
// Layout (all float32 unless noted, contiguous):
//   cells  (C, cap, 4)      [x, y, z, type+1 | 0] rows; empty slots are zero
//   counts (C,) int32       occupied rows per cell (rows [0, count))
//   box    (3,)
//   cut2   (T, T)           cutoff^2 per type pair
//   tmap   (T, T) int32     coefficient row + 1 of table a (0: no table)
//   tmap_b (T, T) int32     coefficient row + 1 of table b (K1d only)
//   xmat   (T, T)           blend weight x of table a (K1d only)
//   coef   (n_rows, P)      P = 2 kw + 2 ko + 6: [wall_g(kw), wall_e(kw),
//                           well_g(ko), well_e(ko), ay, by, ax, bx, rs2,
//                           rcap2]
//   out    (C, cap, 4)      [fx, fy, fz, ch3]; ch3 = 0 (mode 0), half the
//                           tabulated pair energy (mode 1) or half the pair
//                           virial (mode 2)
// Shared memory of the column-segment kernel, bytes: 16 * (9 ((L + 2) cap
// + 1) + threads * depth) (stage and lists) + 4 * (n_rows P + T^2 (2, or 4
// with the blend) + 9 (L + 3) + 9 (L + 2) 8 + T) (pack, maps, prefixes,
// counts, offsets, boxes, cutoffs); above 48 KiB the launch opts in, and
// the wrapper raises above 227 KiB.  The launcher refuses a plan whose
// bytes differ from this layout's.
//
// K1f in these modes (x_halo, as in cell_pair.cu): cells holds a slab of
// nx = w + 2 x-layers; the grid runs over the w * ny * nz inner cells, the
// x neighbour is cx + dx with no wrap, y and z wrap, and out has one row
// per inner slot.  Same visiting order and op sequence as the full grid,
// so the slabs laid side by side equal K1c/K1d/K1e's output bit for bit.

#include <cuda_runtime.h>

#include "cell_pair_packed.cuh"

namespace {

__device__ __forceinline__ float clamp1(float v) {
  return fminf(fmaxf(v, -1.0f), 1.0f);
}

// tab_cheb.eval_planes for one pair and one coefficient row
__device__ __forceinline__ void cheb_eval(const float* __restrict__ c,
                                          float r2, int kw, int ko,
                                          bool want_e, float& g, float& e) {
  const float* wg = c;
  const float* we = c + kw;
  const float* og = c + 2 * kw;
  const float* oe = c + 2 * kw + ko;
  const float* sc = c + 2 * kw + 2 * ko;
  const float r2w = fmaxf(r2, sc[5]);
  const float yw = clamp1(sc[0] / r2w + sc[1]);
  g = wg[0] + wg[1] * yw;
  e = want_e ? we[0] + we[1] * yw : 0.0f;
  float tkm1 = 1.0f, tk = yw;
  for (int k = 2; k < kw; ++k) {
    const float tn = 2.0f * yw * tk - tkm1;
    g = g + wg[k] * tn;
    if (want_e) e = e + we[k] * tn;
    tkm1 = tk;
    tk = tn;
  }
  if (ko > 0 && !(r2 < sc[4])) {
    const float r = sqrtf(r2);
    const float xo = clamp1(sc[2] * r + sc[3]);
    float go = og[0] + og[1] * xo;
    float eo = want_e ? oe[0] + oe[1] * xo : 0.0f;
    float ukm1 = 1.0f, uk = xo;
    for (int k = 2; k < ko; ++k) {
      const float un = 2.0f * xo * uk - ukm1;
      go = go + og[k] * un;
      if (want_e) eo = eo + oe[k] * un;
      ukm1 = uk;
      uk = un;
    }
    g = go;
    e = eo;
  }
}

template <bool MIX>
__global__ void cheb_cellwise_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ cut2_g,
    const int* __restrict__ tmap_g, const int* __restrict__ tmap_b_g,
    const float* __restrict__ xmat_g, const float* __restrict__ coef_g,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int n_rows, int kw, int ko, int ch3_mode, int x_halo) {
  extern __shared__ float4 smem[];
  const int tt = n_types * n_types;
  const int n_p = 2 * kw + 2 * ko + 6;
  float4* rows = smem;                                        // cap rows
  float* coef = reinterpret_cast<float*>(smem + cap);        // n_rows * P
  float* cut2 = coef + n_rows * n_p;                          // T * T
  int* tmap = reinterpret_cast<int*>(cut2 + tt);              // T * T
  int* tmap_b = tmap + tt;                                    // T * T (MIX)
  float* xmat = reinterpret_cast<float*>(tmap_b + tt);        // T * T (MIX)
  for (int k = threadIdx.x; k < n_rows * n_p; k += blockDim.x) {
    coef[k] = coef_g[k];
  }
  for (int k = threadIdx.x; k < tt; k += blockDim.x) {
    cut2[k] = cut2_g[k];
    tmap[k] = tmap_g[k];
    if (MIX) {
      tmap_b[k] = tmap_b_g[k];
      xmat[k] = xmat_g[k];
    }
  }

  const int c = blockIdx.x;                  // output cell
  const int ci = x_halo ? c + ny * nz : c;   // the same cell in `cells`
  const int i = threadIdx.x;
  const int cx = ci / (ny * nz);
  const int cy = (ci / nz) % ny;
  const int cz = ci % nz;
  const float bx = box[0], by = box[1], bz = box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const bool want_e = ch3_mode == 1;

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
          const int p = ti * n_types + max(static_cast<int>(xj.w) - 1, 0);
          if (!(valid && (r2s < cut2[p]))) continue;  // exactly zero there
          const int sa = tmap[p];
          float g = 0.f, e = 0.f;
          if (sa > 0) cheb_eval(coef + (sa - 1) * n_p, r2s, kw, ko, want_e, g, e);
          if (MIX) {
            const int sb = tmap_b[p];
            float gb = 0.f, eb = 0.f;
            if (sb > 0) {
              cheb_eval(coef + (sb - 1) * n_p, r2s, kw, ko, want_e, gb, eb);
            }
            const float x = xmat[p];
            g = x * g + (1.0f - x) * gb;
            e = x * e + (1.0f - x) * eb;
          } else if (sa == 0) {
            continue;  // no table: zero
          }
          fx = fx + g * ddx;
          fy = fy + g * ddy;
          fz = fz + g * ddz;
          if (ch3_mode == 1) {
            acc = acc + e;
          } else if (ch3_mode == 2) {
            acc = acc + g * r2s;
          }
        }
      }
    }
  }
  if (own) out[c * cap + i] = make_float4(fx, fy, fz, 0.5f * acc);
}

template <bool MIX>
int launch_cellwise(const void* cells, const void* counts, const void* box,
                    const void* cut2, const void* tmap, const void* tmap_b,
                    const void* xmat, const void* coef, void* out, int nx,
                    int ny, int nz, int cap, int n_types, int n_rows, int kw,
                    int ko, int ch3_mode, int x_halo, void* stream) {
  const int n_cells = (x_halo ? nx - 2 : nx) * ny * nz;
  const int threads = ((cap + 31) / 32) * 32;
  const size_t tt = static_cast<size_t>(n_types) * n_types;
  const size_t shmem = static_cast<size_t>(cap) * sizeof(float4)
      + (static_cast<size_t>(n_rows) * (2 * kw + 2 * ko + 6) + tt) * sizeof(float)
      + tt * sizeof(int) + (MIX ? tt * (sizeof(int) + sizeof(float)) : 0);
  if (shmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cheb_cellwise_kernel<MIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cheb_cellwise_kernel<MIX><<<n_cells, threads, shmem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(cut2),
      static_cast<const int*>(tmap), static_cast<const int*>(tmap_b),
      static_cast<const float*>(xmat), static_cast<const float*>(coef),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, n_rows, kw, ko,
      ch3_mode, x_halo);
  return static_cast<int>(cudaGetLastError());
}

// ---- the column-segment kernel: packed lanes, filter then evaluate ----------

using packed::kAll;

// One block per (xy column, z segment of `seg` cells) of the output grid;
// the stage and the rows' candidate layout are cell_pair_packed.cuh's.
//
// Work: the block's occupied rows (contiguous in column (0, 0)) in batches
// of `rows_w`, one batch per warp at a time.  For each row of the batch in
// turn, the whole warp:
//   filters: the row's candidates (packed::row_cands: stencil order, then
//   slot order, culled cells dropped), 32 consecutive ones a pass, through
//   the candidate ops up to the cut; a ballot appends the in-cut ones, in
//   that order, to the warp's list (row, stage index).
// When the list is full and after the batch's last row:
//   evaluates: the lanes take the list's entries in turn, run the Clenshaw
//   chains and leave the pair's terms (g dx, g dy, g dz, and e or g r2) in
//   the entry;
//   sums: lane r adds the terms of row r of the batch in list order.
// So every slot adds its in-cut pairs in stencil order and then slot order,
// as the cellwise kernel does, with the same operands: the same bits.  A
// row whose pairs span two fills of the list adds the first fill's terms,
// then the second's.
template <bool MIX>
__global__ void cheb_packed_kernel(
    const float4* __restrict__ cells, const int* __restrict__ counts,
    const float* __restrict__ box, const float* __restrict__ cut2_g,
    const int* __restrict__ tmap_g, const int* __restrict__ tmap_b_g,
    const float* __restrict__ xmat_g, const float* __restrict__ coef_g,
    float4* __restrict__ out, int nx, int ny, int nz, int cap, int n_types,
    int n_rows, int kw, int ko, int ch3_mode, int x_halo, int seg,
    int rows_w, int depth) {
  extern __shared__ float4 smem[];
  const int tt = n_types * n_types;
  const int n_p = 2 * kw + 2 * ko + 6;
  const int hz = seg + 2;
  const int nthr = blockDim.x;
  const int t = threadIdx.x;
  packed::Stage s;
  s.rows = smem;                                                // 9 cstride
  float4* ent = s.rows + 9 * (hz * cap + 1);                    // depth nthr
  float* coef = reinterpret_cast<float*>(ent + depth * nthr);   // n_rows P
  float* cut2 = coef + n_rows * n_p;                            // T T
  int* tmap = reinterpret_cast<int*>(cut2 + tt);                // T T
  int* tmap_b = tmap + tt;                                      // T T (MIX)
  float* xmat = reinterpret_cast<float*>(tmap_b + (MIX ? tt : 0));
  s.cnt = reinterpret_cast<int*>(xmat + (MIX ? tt : 0));        // 9 hz
  s.cpre = s.cnt + 9 * hz;                                      // 9 (hz + 1)
  s.base_g = s.cpre + 9 * (hz + 1);                             // 9 hz
  s.bbox = reinterpret_cast<float*>(s.base_g + 9 * hz);         // 9 hz 6
  float* cmax = s.bbox + 9 * hz * 6;                            // T

  for (int k = t; k < n_rows * n_p; k += nthr) coef[k] = coef_g[k];
  for (int k = t; k < tt; k += nthr) {
    cut2[k] = cut2_g[k];
    tmap[k] = tmap_g[k];
    if (MIX) {
      tmap_b[k] = tmap_b_g[k];
      xmat[k] = xmat_g[k];
    }
  }
  packed::stage_block(cells, counts, out, s, nx, ny, nz, cap, x_halo, seg);
  // the largest cutoff^2 of a row of each type
  for (int a = t; a < n_types; a += nthr) {
    float m = cut2[a * n_types];
    for (int k = 1; k < n_types; ++k) m = fmaxf(m, cut2[a * n_types + k]);
    cmax[a] = m;
  }
  __syncthreads();

  const float bx = box[0], by = box[1], bz = box[2];
  const float ibx = 1.0f / bx, iby = 1.0f / by, ibz = 1.0f / bz;
  const float gm = packed::cull_margin(bx, by, bz);
  const bool want_e = ch3_mode == 1;
  const float4* own_rows = s.rows + 4 * s.cstride + s.row0;
  const int lane = t & 31;
  const unsigned below = (1u << lane) - 1u;
  const int cap_w = 32 * depth;               // entries of a warp's list
  float4* wl = ent + (t - lane) * depth;      // this warp's list

  for (int b0 = (t >> 5) * rows_w; b0 < s.n_own;
       b0 += (nthr >> 5) * rows_w) {
    const int nb = min(rows_w, s.n_own - b0);  // rows of this batch
    float fx = 0.f, fy = 0.f, fz = 0.f, acc = 0.f;  // lane r: row b0 + r
    int lo = 0, hi = 0;  // lane r: its row's entries in the list
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
        const int p = max(static_cast<int>(xi.w) - 1, 0) * n_types
                      + max(static_cast<int>(xj.w) - 1, 0);
        const int sa = tmap[p];
        float g = 0.f, e = 0.f;
        if (sa > 0) {
          cheb_eval(coef + (sa - 1) * n_p, r2s, kw, ko, want_e, g, e);
        }
        if (MIX) {
          const int sb = tmap_b[p];
          float gb = 0.f, eb = 0.f;
          if (sb > 0) {
            cheb_eval(coef + (sb - 1) * n_p, r2s, kw, ko, want_e, gb, eb);
          }
          const float x = xmat[p];
          g = x * g + (1.0f - x) * gb;
          e = x * e + (1.0f - x) * eb;
        }
        wl[k] = make_float4(g * ddx, g * ddy, g * ddz, want_e ? e : g * r2s);
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
          ibx, iby, ibz, gm, lane, packed::kStencil27);
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
          const int p = ti * n_types + max(static_cast<int>(xj.w) - 1, 0);
          in = valid && (r2s < cut2[p]) && (MIX || tmap[p] != 0);
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

// Shared-memory bytes of cheb_packed_kernel's layout (the Python plan,
// cell_pair.cheb_launch_plan, computes the same).
size_t packed_smem(int cap, int n_types, int n_rows, int kw, int ko, bool mix,
                   int seg, int threads, int depth) {
  const size_t tt = static_cast<size_t>(n_types) * n_types;
  const size_t hz = static_cast<size_t>(seg + 2);
  return (9 * (hz * cap + 1) + static_cast<size_t>(threads) * depth)
             * sizeof(float4)
         + (static_cast<size_t>(n_rows) * (2 * kw + 2 * ko + 6)
            + tt * (mix ? 4 : 2) + packed::stage_words(seg) + n_types)
               * sizeof(float);
}

template <bool MIX>
int launch_packed(const void* cells, const void* counts, const void* box,
                  const void* cut2, const void* tmap, const void* tmap_b,
                  const void* xmat, const void* coef, void* out, int nx,
                  int ny, int nz, int cap, int n_types, int n_rows, int kw,
                  int ko, int ch3_mode, int x_halo, int seg, int rows_w,
                  int threads, int depth, int smem_bytes, void* stream) {
  // the plan must describe this layout: whole warps, a batch's rows one
  // lane each, a warp's list room for one pass of 32 candidates
  if (seg < 1 || rows_w < 1 || rows_w > 32 || threads < 32 || threads > 1024
      || threads % 32 != 0 || depth < 1
      || packed_smem(cap, n_types, n_rows, kw, ko, MIX, seg, threads, depth)
             != static_cast<size_t>(smem_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_blocks = (x_halo ? nx - 2 : nx) * ny * ((nz + seg - 1) / seg);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cheb_packed_kernel<MIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cheb_packed_kernel<MIX><<<n_blocks, threads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(cut2),
      static_cast<const int*>(tmap), static_cast<const int*>(tmap_b),
      static_cast<const float*>(xmat), static_cast<const float*>(coef),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, n_rows, kw, ko,
      ch3_mode, x_halo, seg, rows_w, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1c (table-scalar mode: deduplicated table rows) and K1e
// (coefficient-plane mode: per-table rows through the table id); the
// wrapper builds the map and the pack of each mode, and the launch plan
// (seg, rows_w, threads, depth, smem_bytes: cell_pair.cheb_launch_plan)
extern "C" int cell_pair_cheb(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, int seg, int rows_w,
    int threads, int depth, int smem_bytes, void* stream) {
  return launch_packed<false>(cells, counts, box, cut2, tmap, tmap_b, xmat,
                              coef, out, nx, ny, nz, cap, n_types, n_rows, kw,
                              ko, ch3_mode, x_halo, seg, rows_w, threads,
                              depth, smem_bytes, stream);
}

// K1d: table-scalar mode with the two-table blend
extern "C" int cell_pair_cheb_mix(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, int seg, int rows_w,
    int threads, int depth, int smem_bytes, void* stream) {
  return launch_packed<true>(cells, counts, box, cut2, tmap, tmap_b, xmat,
                             coef, out, nx, ny, nz, cap, n_types, n_rows, kw,
                             ko, ch3_mode, x_halo, seg, rows_w, threads,
                             depth, smem_bytes, stream);
}

// The cellwise kernel of K1c/K1e and of K1d (one block per cell, one
// thread per slot, 27 stages), kept as the baseline the column-segment
// kernel is held and timed against; no step reaches these entry points
extern "C" int cell_pair_cheb_cellwise(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, void* stream) {
  return launch_cellwise<false>(cells, counts, box, cut2, tmap, tmap_b, xmat,
                                coef, out, nx, ny, nz, cap, n_types, n_rows,
                                kw, ko, ch3_mode, x_halo, stream);
}

extern "C" int cell_pair_cheb_mix_cellwise(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, void* stream) {
  return launch_cellwise<true>(cells, counts, box, cut2, tmap, tmap_b, xmat,
                               coef, out, nx, ny, nz, cap, n_types, n_rows,
                               kw, ko, ch3_mode, x_halo, stream);
}
