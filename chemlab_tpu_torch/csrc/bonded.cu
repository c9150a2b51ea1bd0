// Bonds and angles: each term's endpoint forces, computed analytically, summed
// per particle in a fixed order, and the energy of each functional form.
//
// Replaces no TPU kernel: the JAX package evaluates its bonded terms without
// Pallas (jax.value_and_grad over chemlab_tpu/engine/bonded_forces.py).  The
// port took -torch.autograd.grad of the same energies through one gather of
// [x, y, z, type] rows; on the card that graph is a few hundred small
// launches, and its backward is a sorted index_put_ that sums each run of
// equal indices serially, so every padding slot of the irregular tables
// (clamped to particle 0) landed in one long run.  At 400k particles that
// was most of a step.  This file takes its place for bonds and angles; the
// dihedrals and 1-4 pairs stay on autograd (bonded_forces.py).
//
// Semantics: chemlab_tpu_torch/engine/bonded_forces.py's bond_energies and
// angle_energies.  Bond funcs 1 (harmonic), 7 (FENE), 8 (tabulated,
// straight-through: dU/dr is minus the table's force column), 9 (FENE + WCA);
// angle funcs 1, 8 and 11 (cosine).  typelookup rows re-resolve by the
// endpoints' current types (a lookup miss, func 0, keeps the static row),
// each term is scaled by its lambda, the minimum image rounds with rintf
// (half to even, as torch.round) and the rounding is a constant, and only
// functions set in the family's mask are evaluated (cfg.bond_funcs,
// cfg.angle_funcs).  A slot whose first index is < 0 is padding: one read
// and one predicate, nothing added anywhere.
//
// Arithmetic: float32, compiled with --fmad=false and no fast math, each
// term in the chain of intermediates of the autograd path: the cosine clamped
// to +-(1 - 1e-7) and the FENE argument to [1e-6, 1] with zero gradient
// outside (bounds inclusive, as torch.clamp's backward), arccos's derivative
// as -1/sqrt(1 - c*c) (IEEE sqrtf and division, not rsqrtf), the constants
// rounded from double as torch rounds a Python float.  The plain twin in
// bonded_forces.py (bond_angle_forces_plain) repeats the arithmetic and the
// order of the sums; the tests hold the twin to the JAX package on the CPU
// and this kernel to the twin on the card.
//
// Layout: the dense legs (cfg.bonded_dense) hold one row per particle, row b
// owning the term with endpoints (b, b+1[, b+2]) mod n (the plane rolled by
// k, bonded_dense.roll_rows); only their first index column is read, for
// validity.  The listed tables (the irregular remainders, or the flat tables
// without bonded_dense) name their endpoints; an endpoint index < 0 of a live
// slot reads particle 0, as the gather's clamp does.
//
// One call, four device operations on the caller's stream, no host read:
//
//   1. cudaMemsetAsync head[] = -1 (only where a listed table has rows).
//   2. bonded_listed_kernel: a thread per listed slot, bonds then angles.  A
//      live slot writes each endpoint's force row to entry_f[e] (entry e =
//      2 s + k for bond slot s, 2 rows_b + 3 s + k for angle slot s) and
//      pushes e on its particle's list (next[e] = atomicExch(head + p, e):
//      integer atomics, which order the list but not the sums).  The block's
//      energies per channel go to one partial row.
//   3. bonded_particle_kernel: a thread per particle p.  It evaluates the
//      dense terms that touch p (bond rows p and p-1, angle rows p, p-1 and
//      p-2; each dense term is evaluated by each of its 2 or 3 endpoints'
//      threads, which is cheaper than a round trip of its force rows through
//      memory) and walks its list, taking the entries in ascending order, 16
//      at a time.  The sum, from 0: dense bond row p (endpoint 0), row p-1
//      (endpoint 1), dense angle rows p, p-1, p-2 (endpoints 0, 1, 2), then
//      the listed entries in ascending e.  Row p's dense energies go to the
//      block's partial row.
//   4. bonded_energy_kernel: one block sums the partial rows in a fixed order
//      into the 7 channels (bond funcs 1, 7, 8, 9; angle funcs 1, 8, 11).
//
// No float atomics: every sum has one order, so a repeated call gives the
// same bits.
//
// What bounds it on an H100: bytes.  At 400 002 particles the dense tables
// (first index column, func, 6 params, typelookup, lambda: ~36 bytes a row
// for each of the two families), the positions and types (16 bytes a
// particle), the irregular tables and their entry rows (~0.1M slots) and the
// forces written (12 bytes a particle) come to ~40 MB, ~12 us at 3.35 TB/s;
// the arithmetic (~100 f32 operations a term, dense terms 2-3 times) is
// ~0.2 GFLOP, ~3 us at 67 TFLOP/s.  The design reads each dense row's
// operands from neighbouring threads (coalesced, the repeats served from L1
// and L2), keeps the dense force rows out of memory, and leaves the listed
// slots, a quarter of the rows at most, the one round trip through entry_f.
// The list walk is a chain of dependent loads, a few entries long for the
// particles that have any.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChannels = 7;   // bond funcs 1, 7, 8, 9; angle funcs 1, 8, 11
constexpr int kPartial = 8;    // floats a partial row (the channels, a pad)
constexpr int kParams = 6;     // state.N_BOND_PARAMS
constexpr int kSorted = 16;    // listed entries a particle sorts at a time

// torch.clamp's bounds and factors are Python floats, rounded to float32
constexpr float kCosHi = static_cast<float>(1.0 - 1e-7);
constexpr float kCosLo = static_cast<float>(-1.0 + 1e-7);
constexpr float kArgLo = static_cast<float>(1e-6);
constexpr float kTiny = static_cast<float>(1e-30);
constexpr float kWcaCut = static_cast<float>(1.122462048309373);  // 2**(1/6)

struct Table {                     // one TermTable (rows 0: absent)
  const int* idx;                  // (rows, arity), -1 padded
  const int* func;                 // (rows,)
  const float* params;             // (rows, kParams)
  const unsigned char* typelookup;  // (rows,) bool
  const float* lam;                // (rows,)
  int rows;
};

struct Stack {                     // a table stack: (n_tab, n_bins, 2) E/F
  const float* ef;
  const float* r0;
  const float* dr;
  int n_tab;
  int n_bins;
};

struct Args {
  const float* pos;                // (n, 3)
  const int* type_id;              // (n,)
  const float* box;                // (3,)
  int n;
  int n_types;
  Table bd, ad, bl, al;            // dense bonds, dense angles, listed both
  const int* bond_func_tt;         // (T, T)
  const float* bond_par_tt;        // (T, T, kParams)
  const int* angle_func_tt;        // (T, T, T)
  const float* angle_par_tt;       // (T, T, T, kParams)
  Stack bst, ast;
  unsigned bond_mask, angle_mask;  // bit f: func f evaluated
  float* force;                    // (n, 3) out
  float* energy;                   // (kChannels,) out
  float* entry_f;                  // (2 bl.rows + 3 al.rows, 3) scratch
  int* head;                       // (n,) scratch, -1 = empty list
  int* next;                       // (2 bl.rows + 3 al.rows,) scratch
  float* partial;                  // (blocks of kernels 2 and 3, kPartial)
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ V3 add3(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}

__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float wrap(float d, float b) {
  return d - b * rintf(d / b);
}

// min_image(a - b): the displacement's round is a constant
__device__ __forceinline__ V3 min_image(V3 a, V3 b, const float* box) {
  return {wrap(a.x - b.x, box[0]), wrap(a.y - b.y, box[1]),
          wrap(a.z - b.z, box[2])};
}

// tables.interpolate: (E, F) of table clamp(par0) at x
__device__ void lookup(const Stack& s, float par0, float x, float& e,
                       float& f) {
  const int ti = static_cast<int>(
      clampf(par0, 0.0f, static_cast<float>(s.n_tab - 1)));
  const float umax = static_cast<float>(static_cast<double>(s.n_bins)
                                        - 1.000001);
  const float u = clampf((x - s.r0[ti]) / s.dr[ti], 0.0f, umax);
  const int i0 = static_cast<int>(u);
  const float frac = u - static_cast<float>(i0);
  const int i1 = min(i0 + 1, s.n_bins - 1);
  const float* lo = s.ef + 2 * (static_cast<size_t>(ti) * s.n_bins + i0);
  const float* hi = s.ef + 2 * (static_cast<size_t>(ti) * s.n_bins + i1);
  const float w = 1.0f - frac;
  e = lo[0] * w + hi[0] * frac;
  f = lo[1] * w + hi[1] * frac;
}

__device__ __forceinline__ bool evaluated(unsigned mask, int func) {
  return func >= 0 && func < 32 && ((mask >> func) & 1u);
}

// Bond `row` of table t between particles i and j: false where it adds
// nothing; else its energy times lambda (e, in channel ch) and fi, the force
// on i (j takes -fi)
__device__ bool bond_term(const Args& a, const Table& t, int row, int i,
                          int j, V3& fi, float& e, int& ch) {
  int func = t.func[row];
  const float* par = t.params + static_cast<size_t>(row) * kParams;
  if (t.typelookup[row]) {
    const int k = a.type_id[i] * a.n_types + a.type_id[j];
    const int g = a.bond_func_tt[k];
    if (g > 0) {
      func = g;
      par = a.bond_par_tt + static_cast<size_t>(k) * kParams;
    }
  }
  if (!evaluated(a.bond_mask, func)) return false;
  const V3 d = min_image(load3(a.pos, i), load3(a.pos, j), a.box);
  const float r = sqrtf(dot3(d, d));
  float en, dedr;  // U and dU/dr before lambda
  if (func == 1) {
    const float x = r - par[1];
    en = par[0] * (x * x);
    dedr = par[0] * (2.0f * x);
    ch = 0;
  } else if (func == 8) {
    float f;
    lookup(a.bst, par[0], r, en, f);
    dedr = -f;
    ch = 2;
  } else {  // 7 and 9: FENE
    const float rm = fmaxf(par[2], kTiny);
    const float x = (r - par[1]) / rm;
    const float a0 = 1.0f - x * x;
    const float arg = clampf(a0, kArgLo, 1.0f);
    const float c = (-0.5f * par[0]) * (par[2] * par[2]);
    en = c * logf(arg);
    const float garg = (a0 >= kArgLo && a0 <= 1.0f) ? c / arg : 0.0f;
    dedr = (-garg * (2.0f * x)) / rm;
    ch = 1;
    if (func == 9) {  // + WCA-shifted LJ below 2^(1/6) sigma
      const float sig = par[3], eps = par[4];
      if (r < kWcaCut * sig) {
        const float u = sig / r;
        const float s6 = powf(u, 6.0f);
        en = en + ((4.0f * eps) * (s6 * s6 - s6) + eps);
        const float ds6 = 6.0f * powf(u, 5.0f);
        dedr = dedr + ((4.0f * eps) * (2.0f * s6 - 1.0f)) * ds6 * (-u / r);
      }
      ch = 3;
    }
  }
  const float lam = t.lam[row];
  e = en * lam;
  const float s = (dedr * lam) / r;
  fi = {-(s * d.x), -(s * d.y), -(s * d.z)};
  return true;
}

// Angle `row` of table t at vertex j between i and k: as bond_term, with
// the forces on i and k (j takes -(fi + fk))
__device__ bool angle_term(const Args& a, const Table& t, int row, int i,
                           int j, int k, V3& fi, V3& fk, float& e, int& ch) {
  int func = t.func[row];
  const float* par = t.params + static_cast<size_t>(row) * kParams;
  if (t.typelookup[row]) {
    const int m = (a.type_id[i] * a.n_types + a.type_id[j]) * a.n_types
                  + a.type_id[k];
    const int g = a.angle_func_tt[m];
    if (g > 0) {
      func = g;
      par = a.angle_par_tt + static_cast<size_t>(m) * kParams;
    }
  }
  if (!evaluated(a.angle_mask, func)) return false;
  const V3 pj = load3(a.pos, j);
  const V3 rij = min_image(load3(a.pos, i), pj, a.box);
  const V3 rkj = min_image(load3(a.pos, k), pj, a.box);
  const float nij = sqrtf(dot3(rij, rij));
  const float nkj = sqrtf(dot3(rkj, rkj));
  const float dot = dot3(rij, rkj);
  const float den = nij * nkj;
  const float c0 = dot / den;
  const float c = clampf(c0, kCosLo, kCosHi);
  const float theta = acosf(c);
  float en, dedt;  // U and dU/dtheta before lambda
  if (func == 1) {
    const float x = theta - par[1];
    en = par[0] * (x * x);
    dedt = par[0] * (2.0f * x);
    ch = 4;
  } else if (func == 8) {
    float f;
    lookup(a.ast, par[0], theta, en, f);
    dedt = -f;
    ch = 5;
  } else {  // 11
    const float x = theta - par[1];
    en = par[0] * (1.0f + cosf(x));
    dedt = par[0] * (-sinf(x));
    ch = 6;
  }
  const float lam = t.lam[row];
  e = en * lam;
  const float gc = (c0 >= kCosLo && c0 <= kCosHi)
                       ? (dedt * lam) * -(1.0f / sqrtf(1.0f - c * c))
                       : 0.0f;
  const float gdot = gc / den;
  const float gden = -gc * ((dot / den) / den);
  const float sij = (gden * nkj) / nij;
  const float skj = (gden * nij) / nkj;
  fi = {-(gdot * rkj.x + sij * rij.x), -(gdot * rkj.y + sij * rij.y),
        -(gdot * rkj.z + sij * rij.z)};
  fk = {-(gdot * rij.x + skj * rkj.x), -(gdot * rij.y + skj * rkj.y),
        -(gdot * rij.z + skj * rkj.z)};
  return true;
}

// The block's channel sums, in a fixed tree, into out[0 .. kChannels)
__device__ void block_sum(const float (&ech)[kChannels], float* out) {
  __shared__ float s[kChannels][kThreads];
  for (int c = 0; c < kChannels; ++c) s[c][threadIdx.x] = ech[c];
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w)
      for (int c = 0; c < kChannels; ++c)
        s[c][threadIdx.x] += s[c][threadIdx.x + w];
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) < kChannels)
    out[threadIdx.x] = s[threadIdx.x][0];
}

__device__ __forceinline__ void push(const Args& a, int p, int e) {
  a.next[e] = atomicExch(a.head + p, e);
}

__global__ void __launch_bounds__(kThreads) bonded_listed_kernel(Args a) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  float ech[kChannels] = {};
  V3 fi, fk;
  float e;
  int ch;
  if (s < a.bl.rows) {
    const int* idx = a.bl.idx + 2 * s;
    const int i = idx[0];
    if (i >= 0) {
      const int j = max(idx[1], 0);
      if (bond_term(a, a.bl, s, i, j, fi, e, ch)) {
        ech[ch] = e;
        store3(a.entry_f, 2 * s, fi);
        store3(a.entry_f, 2 * s + 1, neg3(fi));
        push(a, i, 2 * s);
        push(a, j, 2 * s + 1);
      }
    }
  } else if (s < a.bl.rows + a.al.rows) {
    const int r = s - a.bl.rows;
    const int* idx = a.al.idx + 3 * r;
    const int i = idx[0];
    if (i >= 0) {
      const int j = max(idx[1], 0);
      const int k = max(idx[2], 0);
      if (angle_term(a, a.al, r, i, j, k, fi, fk, e, ch)) {
        ech[ch] = e;
        const int e0 = 2 * a.bl.rows + 3 * r;
        store3(a.entry_f, e0, fi);
        store3(a.entry_f, e0 + 1, neg3(add3(fi, fk)));
        store3(a.entry_f, e0 + 2, fk);
        push(a, i, e0);
        push(a, j, e0 + 1);
        push(a, k, e0 + 2);
      }
    }
  }
  block_sum(ech, a.partial + blockIdx.x * kPartial);
}

__device__ __forceinline__ int plus(int p, int k, int n) {
  return p + k < n ? p + k : p + k - n;
}

__device__ __forceinline__ int minus(int p, int k, int n) {
  return p - k >= 0 ? p - k : p - k + n;
}

__global__ void __launch_bounds__(kThreads)
    bonded_particle_kernel(Args a, int partial0) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  float ech[kChannels] = {};
  if (p < a.n) {
    const int n = a.n;
    V3 acc = {0.0f, 0.0f, 0.0f};
    V3 fi, fk;
    float e;
    int ch;
    if (a.bd.rows) {  // rows p (endpoint 0) and p - 1 (endpoint 1)
      if (a.bd.idx[2 * p] >= 0
          && bond_term(a, a.bd, p, p, plus(p, 1, n), fi, e, ch)) {
        acc = add3(acc, fi);
        ech[ch] += e;
      }
      const int b = minus(p, 1, n);
      if (a.bd.idx[2 * b] >= 0 && bond_term(a, a.bd, b, b, p, fi, e, ch))
        acc = add3(acc, neg3(fi));
    }
    if (a.ad.rows) {  // rows p, p - 1, p - 2 (endpoints 0, 1, 2)
      if (a.ad.idx[3 * p] >= 0
          && angle_term(a, a.ad, p, p, plus(p, 1, n), plus(p, 2, n), fi, fk,
                        e, ch)) {
        acc = add3(acc, fi);
        ech[ch] += e;
      }
      const int b1 = minus(p, 1, n);
      if (a.ad.idx[3 * b1] >= 0
          && angle_term(a, a.ad, b1, b1, p, plus(p, 1, n), fi, fk, e, ch))
        acc = add3(acc, neg3(add3(fi, fk)));
      const int b2 = minus(p, 2, n);
      if (a.ad.idx[3 * b2] >= 0
          && angle_term(a, a.ad, b2, b2, minus(p, 1, n), p, fi, fk, e, ch))
        acc = add3(acc, fk);
    }
    if (a.bl.rows + a.al.rows) {  // the listed entries, ascending
      int last = -1;
      for (;;) {
        int buf[kSorted];
        int cnt = 0;
        for (int x = a.head[p]; x >= 0; x = a.next[x]) {
          if (x <= last || (cnt == kSorted && x > buf[kSorted - 1])) continue;
          int q = cnt < kSorted ? cnt++ : kSorted - 1;
          for (; q > 0 && buf[q - 1] > x; --q) buf[q] = buf[q - 1];
          buf[q] = x;
        }
        for (int q = 0; q < cnt; ++q)
          acc = add3(acc, load3(a.entry_f, buf[q]));
        if (cnt < kSorted) break;
        last = buf[kSorted - 1];
      }
    }
    store3(a.force, p, acc);
  }
  block_sum(ech, a.partial + (partial0 + blockIdx.x) * kPartial);
}

__global__ void __launch_bounds__(kThreads)
    bonded_energy_kernel(const float* partial, int rows, float* energy) {
  float ech[kChannels] = {};
  for (int b = threadIdx.x; b < rows; b += kThreads)
    for (int c = 0; c < kChannels; ++c) ech[c] += partial[b * kPartial + c];
  block_sum(ech, energy);
}

Table table(const void* idx, const void* func, const void* params,
            const void* typelookup, const void* lam, int rows) {
  return {static_cast<const int*>(idx), static_cast<const int*>(func),
          static_cast<const float*>(params),
          static_cast<const unsigned char*>(typelookup),
          static_cast<const float*>(lam), rows};
}

Stack stack(const void* ef, const void* r0, const void* dr, int n_tab,
            int n_bins) {
  return {static_cast<const float*>(ef), static_cast<const float*>(r0),
          static_cast<const float*>(dr), n_tab, n_bins};
}

}  // namespace

// One call: forces (n, 3) and the 7 energy channels of the bonds and angles.
// A table of 0 rows is absent (its pointers may be null).  entry_f, next
// and head are scratch of the sizes in Args; partial holds
// ceil(listed / 256) + ceil(n / 256) rows of 8 floats, listed = bl + al rows.
extern "C" int bonded_bond_angle(
    const void* pos, const void* type_id, const void* box, int n,
    int n_types,
    const void* bd_idx, const void* bd_func, const void* bd_params,
    const void* bd_tl, const void* bd_lam, int bd_rows,
    const void* ad_idx, const void* ad_func, const void* ad_params,
    const void* ad_tl, const void* ad_lam, int ad_rows,
    const void* bl_idx, const void* bl_func, const void* bl_params,
    const void* bl_tl, const void* bl_lam, int bl_rows,
    const void* al_idx, const void* al_func, const void* al_params,
    const void* al_tl, const void* al_lam, int al_rows,
    const void* bond_func_tt, const void* bond_par_tt,
    const void* angle_func_tt, const void* angle_par_tt,
    const void* bond_ef, const void* bond_r0, const void* bond_dr,
    int bond_n_tab, int bond_n_bins,
    const void* angle_ef, const void* angle_r0, const void* angle_dr,
    int angle_n_tab, int angle_n_bins,
    unsigned bond_mask, unsigned angle_mask,
    void* force, void* energy, void* entry_f, void* head, void* next,
    void* partial, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pos = static_cast<const float*>(pos);
  a.type_id = static_cast<const int*>(type_id);
  a.box = static_cast<const float*>(box);
  a.n = n;
  a.n_types = n_types;
  a.bd = table(bd_idx, bd_func, bd_params, bd_tl, bd_lam, bd_rows);
  a.ad = table(ad_idx, ad_func, ad_params, ad_tl, ad_lam, ad_rows);
  a.bl = table(bl_idx, bl_func, bl_params, bl_tl, bl_lam, bl_rows);
  a.al = table(al_idx, al_func, al_params, al_tl, al_lam, al_rows);
  a.bond_func_tt = static_cast<const int*>(bond_func_tt);
  a.bond_par_tt = static_cast<const float*>(bond_par_tt);
  a.angle_func_tt = static_cast<const int*>(angle_func_tt);
  a.angle_par_tt = static_cast<const float*>(angle_par_tt);
  a.bst = stack(bond_ef, bond_r0, bond_dr, bond_n_tab, bond_n_bins);
  a.ast = stack(angle_ef, angle_r0, angle_dr, angle_n_tab, angle_n_bins);
  a.bond_mask = bond_mask;
  a.angle_mask = angle_mask;
  a.force = static_cast<float*>(force);
  a.energy = static_cast<float*>(energy);
  a.entry_f = static_cast<float*>(entry_f);
  a.head = static_cast<int*>(head);
  a.next = static_cast<int*>(next);
  a.partial = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int listed = bl_rows + al_rows;
  const int blocks_l = (listed + kThreads - 1) / kThreads;
  const int blocks_p = (n + kThreads - 1) / kThreads;
  if (listed > 0) {
    cudaError_t rc = cudaMemsetAsync(a.head, 0xff, sizeof(int) * n, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    bonded_listed_kernel<<<blocks_l, kThreads, 0, s>>>(a);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  bonded_particle_kernel<<<blocks_p, kThreads, 0, s>>>(a, blocks_l);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  bonded_energy_kernel<<<1, kThreads, 0, s>>>(a.partial, blocks_l + blocks_p,
                                             a.energy);
  return static_cast<int>(cudaGetLastError());
}
