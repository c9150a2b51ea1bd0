// K1c / K1d / K1e: cell-tile pair sum of Chebyshev-fitted tabulated pairs
// over all pairs on a periodic cell grid.
//
// Replaces the Chebyshev modes of the TPU kernel
// chemlab_tpu/engine/pallas_pair.py::_colt2_kernel:
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
// What bounds it on an H100: at 10k particles (1331 cells x 32 slots) the
// operands are ~0.7 MB and stay in the 50 MB L2; the work is ~27 x 32
// candidates per slot, ~2 M pair evaluations within the cutoff per call,
// each ~(kw + 10) flops plus one division, so the kernel is bound by
// latency and issue, not by memory.  Design for that: one block per cell
// and one thread per slot; the coefficient pack, the cutoffs and the
// type-pair maps are staged in shared memory once per block; each of the
// 27 neighbour cells is staged once (cap x 16 B) and read by every thread;
// the loop stops at the cell's occupancy; each thread owns its output row
// and sums in a fixed order, so there are no atomics and the result is
// deterministic.  A pack above 48 KB opts in to more dynamic shared memory.
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
//
// K1f in these modes (x_halo, as in cell_pair.cu): cells holds a slab of
// nx = w + 2 x-layers; the grid runs over the w * ny * nz inner cells, the
// x neighbour is cx + dx with no wrap, y and z wrap, and out has one row
// per inner slot.  Same visiting order and op sequence as the full grid,
// so the slabs laid side by side equal K1c/K1d/K1e's output bit for bit.

#include <cuda_runtime.h>

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
__global__ void cell_pair_cheb_kernel(
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
int launch(const void* cells, const void* counts, const void* box,
           const void* cut2, const void* tmap, const void* tmap_b,
           const void* xmat, const void* coef, void* out, int nx, int ny,
           int nz, int cap, int n_types, int n_rows, int kw, int ko,
           int ch3_mode, int x_halo, void* stream) {
  const int n_cells = (x_halo ? nx - 2 : nx) * ny * nz;
  const int threads = ((cap + 31) / 32) * 32;
  const size_t tt = static_cast<size_t>(n_types) * n_types;
  const size_t shmem = static_cast<size_t>(cap) * sizeof(float4)
      + (static_cast<size_t>(n_rows) * (2 * kw + 2 * ko + 6) + tt) * sizeof(float)
      + tt * sizeof(int) + (MIX ? tt * (sizeof(int) + sizeof(float)) : 0);
  if (shmem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        cell_pair_cheb_kernel<MIX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cell_pair_cheb_kernel<MIX><<<n_cells, threads, shmem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(cells), static_cast<const int*>(counts),
      static_cast<const float*>(box), static_cast<const float*>(cut2),
      static_cast<const int*>(tmap), static_cast<const int*>(tmap_b),
      static_cast<const float*>(xmat), static_cast<const float*>(coef),
      static_cast<float4*>(out), nx, ny, nz, cap, n_types, n_rows, kw, ko,
      ch3_mode, x_halo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1c (table-scalar mode: deduplicated table rows) and K1e
// (coefficient-plane mode: per-table rows through the table id); the
// wrapper builds the map and the pack of each mode
extern "C" int cell_pair_cheb(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, void* stream) {
  return launch<false>(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, out,
                       nx, ny, nz, cap, n_types, n_rows, kw, ko, ch3_mode,
                       x_halo, stream);
}

// K1d: table-scalar mode with the two-table blend
extern "C" int cell_pair_cheb_mix(
    const void* cells, const void* counts, const void* box, const void* cut2,
    const void* tmap, const void* tmap_b, const void* xmat, const void* coef,
    void* out, int nx, int ny, int nz, int cap, int n_types, int n_rows,
    int kw, int ko, int ch3_mode, int x_halo, void* stream) {
  return launch<true>(cells, counts, box, cut2, tmap, tmap_b, xmat, coef, out,
                      nx, ny, nz, cap, n_types, n_rows, kw, ko, ch3_mode,
                      x_halo, stream);
}
