// K graph-form ADMM solves that share A, f and g, except for a per-lane c of
// g (a lambda-sweep) and an optional per-lane b of f (multi-right-hand-side),
// as ONE persistent cooperative CUDA kernel for Hopper (sm_90a) that spreads
// every matrix product over the whole card.
//
// Replaces the Pallas kernel pogs_tpu/ops/fused_admm_batch.py::
// fused_batched_lasso_sweep (body _kernel_body) for sweeps whose A, A^T and
// Ginv do not fit the 50 MB L2, and below it where each group of 32 lanes
// has enough of their elements; fused_admm_batch.cu (one block per chunk of
// lanes) keeps small matrices and sweeps of many lanes (the rule is
// ops/fused_admm_batch.py::route_for).  Its plain version is
// fused_batched_lasso_sweep_ref in pogs_tpu_torch/ops/fused_admm_batch.py.
// Lane for lane it computes what the
// single solve computes (csrc/fused_admm.cu): the prox of the 16-function
// library (prox.cuh) with the lane's c and b, gap and tolerances,
// alpha = 1.7, the projection through the explicit (G + I)^-1 (tall:
// x = Ginv (x0 + A^T y0), y = A x; wide: Woodbury), approximate residuals
// and, when a lane is within 10x of tolerance, its exact residuals, the
// per-lane spectral and balancing rho schedule, and the monotone done /
// converged / NaN latches.  x12, y12 and optval are latched at each lane's
// firing iteration, with its iteration count, status and rho.
//
// What bounds it on this card: per lane and iteration the projection is
// 2 (2mn + k^2) FLOPs (k = min(m, n)), 4mn more when the exact residuals
// run, and the matrices are 4 (2mn + k^2) bytes in f32.  At 5000x2500 f32
// and 32 lanes an iteration streams 125 MB (37 us at 3.35 TB/s) and does
// 2 GFLOP (30 us at 67 TFLOP/s): both limits count, and neither allows a
// design in which each matrix is read more than once per iteration.
//
// Layout.  One block per SM, all co-resident (a cooperative launch), with
// grid syncs between phases.  Up to kLaneTile = 32 lanes are in flight; a
// sweep of more lanes runs them in groups of 32, one group after another,
// in the same launch.  Every per-lane vector is stored lanes innermost
// (element (i, l) at i * 32 + l), so the elementwise phases give each
// thread one fixed lane and all 32 lanes of a row sit in one 128-byte line.
// Every block holds the per-lane scalar state (rho, delta, xi, k, done,
// fire, status, near) in shared memory and derives it from per-lane sums
// reduced over all blocks in one fixed order (coop.cuh), so every block
// takes the same decisions and all leave together.  No atomics.
//
// Matrix products (out[l, c] = sum_r V[l, r] M[r, c]): a work item is a
// column tile (kTC = 256 columns in f32, 128 in f64) times a row slice of
// H rows (split-K).  The blocks walk the items; each streams its item's
// tile of M, and the matching rows of the 32 lane vectors, through a ring
// of kStages stages in dynamic shared memory, filled by 16-byte cp.async
// copies (cp.async.cg: through L2, so vectors written by other blocks
// before the last grid sync are seen) kStages - 1 stages ahead of the
// compute.  Each thread owns 8 lanes x one 16-byte column group and keeps
// their sums in registers, so a matrix element loaded once serves all 32
// lanes.  The block writes one partial per (row slice, column, lane); after
// the grid sync the next phase sums the row slices in a fixed order.  The
// decomposition (kTC, H, the number of slices) depends on m, n, the dtype
// and the grid only, never on K or on a lane's position, so a lane's result
// does not depend on the lanes that ride with it.  Lanes that are done (and
// padding lanes) skip their elementwise work, and a lane group of 8 with no
// live lane skips its FMAs.
//
// Copy route: 16-byte cp.async rather than TMA.  A tile row is 1 KB and the
// rows of a stage are ld apart in memory, which a 2-D TMA descriptor would
// cover too, but the descriptor has to be built on the host for each matrix
// and each padding; cp.async needs nothing beyond the pointer and keeps a
// ragged edge a matter of one predicate (src-size 0 zero-fills).  Plain f32
// or f64 FMA on the CUDA cores: no TF32, no tensor cores (the equilibrated
// Gram needs the precision).

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pogs;

constexpr int kBlock = 256;                 // threads per block
constexpr int kBlockWarps = kBlock / 32;
constexpr int kL = kLaneTile;               // lanes in flight
constexpr int kLG = 8;                      // lanes per thread in a product
constexpr int kGroups = kL / kLG;           // lane groups of a block
constexpr int kColGroups = kBlock / kGroups;  // 16-byte column groups of a tile
constexpr int kTR = 16;                     // matrix rows per ring stage
constexpr int kStages = 4;
// Per-lane sum slots: phase A's six, the residuals' six, the exact
// residuals' two and optval.
constexpr int kSlotS = 0, kSlotR = 6, kSlotE = 12, kSlotO = 14, kSlots = 15;

template <typename T> struct Tile {
  static constexpr int kCPT = 16 / (int)sizeof(T);   // columns per thread
  static constexpr int kTC = kColGroups * kCPT;      // columns per tile
  static constexpr int kStageM = kTR * kTC;          // matrix elements per stage
  static constexpr int kStageElems = kStageM + kTR * kL;
  static constexpr size_t kSmem = (size_t)kStages * kStageElems * sizeof(T);
};

// One product out = V M, split into (column tile, row slice) items.
template <typename T> struct Prod {
  const T* V;   // (R, 32) lanes innermost, written in-kernel
  const T* M;   // (R, ld) row-major, read-only
  T* part;      // (S, C, 32) out: one partial per row slice
  int R, C, ld, H, S, ntc;
};

template <typename T>
__device__ Prod<T> make_prod(const T* V, const T* M, T* part, int R, int C, int ld, int H) {
  Prod<T> p;
  p.V = V;
  p.M = M;
  p.part = part;
  p.R = R;
  p.C = C;
  p.ld = ld;
  p.H = H;
  p.S = (R + H - 1) / H;
  p.ntc = (C + Tile<T>::kTC - 1) / Tile<T>::kTC;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void lds16(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void lds16(const double* p, double* o) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x; o[1] = v.y;
}
__device__ __forceinline__ void st16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st16(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// The product of item `item` of the one or two products of a phase.
template <typename T>
__device__ __forceinline__ const Prod<T>& item_of(const Prod<T>* pr, int np, int item, int& ct,
                                                  int& s) {
  int p = 0;
  const int n0 = pr[0].S * pr[0].ntc;
  if (np > 1 && item >= n0) {
    p = 1;
    item -= n0;
  }
  ct = item % pr[p].ntc;
  s = item / pr[p].ntc;
  return pr[p];
}

// Copy rows chunk * kTR .. + kTR of slice s, column tile ct, of M and of the
// lane vectors into a ring stage.  Rows past the slice are zero-filled.
template <typename T>
__device__ void load_chunk(const Prod<T>& P, int ct, int s, int chunk, T* stage) {
  using TL = Tile<T>;
  const int r0 = s * P.H + chunk * kTR;
  const int rend = min(s * P.H + P.H, P.R);
  const int c0 = ct * TL::kTC;
  for (int e = threadIdx.x; e < kTR * kColGroups; e += kBlock) {
    const int r = e / kColGroups, q = e % kColGroups;
    const int row = r0 + r, col = c0 + q * TL::kCPT;
    const bool ok = row < rend && col < P.ld;
    cp_async16(stage + r * TL::kTC + q * TL::kCPT, ok ? P.M + (size_t)row * P.ld + col : P.M, ok);
  }
  constexpr int kVP = kL * (int)sizeof(T) / 16;  // 16-byte pieces of a lane row
  T* vs = stage + TL::kStageM;
  for (int e = threadIdx.x; e < kTR * kVP; e += kBlock) {
    const int r = e / kVP, q = e % kVP;
    const int row = r0 + r;
    const bool ok = row < rend;
    cp_async16(vs + r * kL + q * TL::kCPT, ok ? P.V + (size_t)row * kL + q * TL::kCPT : P.V, ok);
  }
}

// acc[l][c] += V[r][lg * 8 + l] * M[r][cgp * kCPT + c] over the stage's rows,
// in row order.
template <typename T>
__device__ __forceinline__ void compute_chunk(const T* stage, T (&acc)[kLG][Tile<T>::kCPT]) {
  using TL = Tile<T>;
  const int cgp = threadIdx.x % kColGroups, lg = threadIdx.x / kColGroups;
  const T* ms = stage + cgp * TL::kCPT;
  const T* vs = stage + TL::kStageM + lg * kLG;
#pragma unroll 4
  for (int r = 0; r < kTR; ++r) {
    T mv[TL::kCPT], vv[kLG];
    lds16(ms + r * TL::kTC, mv);
#pragma unroll
    for (int q = 0; q < kLG; q += TL::kCPT) lds16(vs + r * kL + q, vv + q);
#pragma unroll
    for (int l = 0; l < kLG; ++l)
#pragma unroll
      for (int c = 0; c < TL::kCPT; ++c) acc[l][c] += vv[l] * mv[c];
  }
}

// Run the items of np (1 or 2) products over the grid: block b takes items
// b, b + G, ...; its chunks stream through the ring.  `live` has bit g set
// when lane group g has a lane whose result is used.  Every thread must
// call it; it returns with the ring drained.
template <typename T>
__device__ void run_products(const Prod<T>* pr, int np, unsigned live, T* ring) {
  using TL = Tile<T>;
  const int cgp = threadIdx.x % kColGroups, lg = threadIdx.x / kColGroups;
  const bool mine = (live >> lg) & 1u;
  int n_items = 0;
  for (int p = 0; p < np; ++p) n_items += pr[p].S * pr[p].ntc;

  int pi = blockIdx.x, pc = 0;  // producer: item, chunk
  int ci = blockIdx.x, cc = 0;  // consumer
  int ct, s;
  for (int st = 0; st < kStages - 1; ++st) {
    if (pi < n_items) {
      const Prod<T>& P = item_of(pr, np, pi, ct, s);
      load_chunk(P, ct, s, pc, ring + st * TL::kStageElems);
      if (++pc == P.H / kTR) { pc = 0; pi += gridDim.x; }
    }
    cp_async_commit();
  }
  int stage_c = 0, stage_p = kStages - 1;
  T acc[kLG][TL::kCPT];
#pragma unroll
  for (int l = 0; l < kLG; ++l)
#pragma unroll
    for (int c = 0; c < TL::kCPT; ++c) acc[l][c] = T(0);
  while (ci < n_items) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the stage is complete, and the one refilled next is consumed
    if (pi < n_items) {
      const Prod<T>& P = item_of(pr, np, pi, ct, s);
      load_chunk(P, ct, s, pc, ring + stage_p * TL::kStageElems);
      if (++pc == P.H / kTR) { pc = 0; pi += gridDim.x; }
    }
    cp_async_commit();
    stage_p = stage_p + 1 == kStages ? 0 : stage_p + 1;
    if (mine) compute_chunk(ring + stage_c * TL::kStageElems, acc);
    stage_c = stage_c + 1 == kStages ? 0 : stage_c + 1;
    const Prod<T>& P = item_of(pr, np, ci, ct, s);
    if (++cc == P.H / kTR) {
      if (mine) {
        const int l0 = lg * kLG;
#pragma unroll
        for (int c = 0; c < TL::kCPT; ++c) {
          const int col = ct * TL::kTC + cgp * TL::kCPT + c;
          if (col < P.C) {
            T* dst = P.part + ((size_t)s * P.C + col) * kL + l0;
#pragma unroll
            for (int q = 0; q < kLG; q += TL::kCPT) {
              T v[TL::kCPT];
#pragma unroll
              for (int u = 0; u < TL::kCPT; ++u) v[u] = acc[q + u][c];
              st16(dst + q, v);
            }
          }
        }
      }
#pragma unroll
      for (int l = 0; l < kLG; ++l)
#pragma unroll
        for (int c = 0; c < TL::kCPT; ++c) acc[l][c] = T(0);
      cc = 0;
      ci += gridDim.x;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// sum over the row slices, in order, of element e (= c * 32 + l) of a product.
template <typename T>
__device__ __forceinline__ T slice_sum(const T* part, int S, int C, size_t e) {
  T acc = __ldcg(part + e);
  for (int s = 1; s < S; ++s) acc += __ldcg(part + (size_t)s * C * kL + e);
  return acc;
}

template <typename T> struct Params {
  const T* A;      // (m, ldA) row-major, equilibrated; columns n .. ldA are zero
  const T* At;     // (n, ldAt), A transposed
  const T* Ginv;   // (k, ldG), k = min(m, n), symmetric
  const int* hf;   // (m) function codes of f
  const T* fp;     // (5, m) a, b, c, d, e of the scaled f
  const int* hg;   // (n)
  const T* gp;     // (5, n) a, b, -, d, e of the scaled g (c is per lane)
  const T* cb;     // (groups, n, 32) per-lane c of g, lanes innermost
  const T* fbb;    // (groups, m, 32) per-lane b of f, or null: fp's b
  const T* scal;   // [rho0, norm_A]
  T* x12;          // (K, n) out
  T* y12;          // (K, m) out
  T* stats;        // (K, 4) out: optval, iterations, status, rho
  T* work;         // pogs_sweep_work_elems elements
  int m, n, K, ldA, ldAt, ldG;
  int H_mn, H_nm, H_kk;  // row-slice heights of the products over A, A^T, Ginv
  T abs_tol, rel_tol;
  int max_iter, gap_stop, adaptive_rho;
};

// Offsets of the work buffer: the vectors of the 32 lanes in flight, two
// partial-product buffers and the per-lane partial sums.
struct Work {
  size_t NL, z, zt, p, zor, zn, rhs, w, sdual, part1, part2, partials, total;
  int S_mn, S_nm, S_kk;
  __host__ __device__ Work(int m, int n, int H_mn, int H_nm, int H_kk, int grid) {
    const size_t N = (size_t)m + n, k = m < n ? m : n;
    S_mn = (m + H_mn - 1) / H_mn;  // products over A: m rows, n columns
    S_nm = (n + H_nm - 1) / H_nm;  // over A^T: n rows, m columns
    S_kk = ((int)k + H_kk - 1) / H_kk;
    NL = N * kL;
    z = 0;
    zt = NL;
    p = 2 * NL;
    zor = 3 * NL;
    zn = 4 * NL;
    rhs = 5 * NL;
    w = rhs + k * kL;
    sdual = w + k * kL;
    part1 = sdual + (size_t)m * kL;
    size_t p1 = (size_t)S_mn * n;
    if ((size_t)S_nm * m > p1) p1 = (size_t)S_nm * m;
    if ((size_t)S_kk * k > p1) p1 = (size_t)S_kk * k;
    part2 = part1 + p1 * kL;
    partials = part2 + (size_t)S_mn * n * kL;
    total = partials + (size_t)kSlots * kL * grid;
  }
};

template <typename T>
__global__ void __launch_bounds__(kBlock, 1) sweep_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dyn[];
  T* const ring = reinterpret_cast<T*>(dyn);
  __shared__ T red_smem[6 * kBlockWarps * kL];
  __shared__ T sums[kSlots * kL];
  __shared__ T rho_s[kL], delta_s[kL], xi_s[kL], kd_s[kL], ku_s[kL];
  __shared__ T zt_scale_s[kL], nrm_r_a_s[kL], nrm_s_a_s[kL];
  __shared__ int k_s[kL], active[kL], fire[kL], status_s[kL], near_s[kL];

  const int m = P.m, n = P.n;
  const bool tall = m >= n;
  const Work W(m, n, P.H_mn, P.H_nm, P.H_kk, gridDim.x);
  const size_t NL = W.NL;
  T* const z = P.work + W.z;
  T* const zt = P.work + W.zt;
  T* const pp = P.work + W.p;
  T* const zor = P.work + W.zor;
  T* const zn = P.work + W.zn;
  T* const rhs = P.work + W.rhs;
  T* const wv = P.work + W.w;
  T* const sdual = P.work + W.sdual;
  T* const part1 = P.work + W.part1;
  T* const part2 = P.work + W.part2;
  T* const partials = P.work + W.partials;
  const size_t xL = (size_t)n * kL;  // offset of the y part of an N-vector

  const int tid = threadIdx.x, lane = tid & 31;
  const size_t gtid = (size_t)blockIdx.x * kBlock + tid, nthr = (size_t)gridDim.x * kBlock;
  const T one = T(1), alpha = T(1.7);
  const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
  const T sqrtn_atol = m_sqrt(T(n)) * abs_tol;
  const T sqrtm_atol = m_sqrt(T(m)) * abs_tol;
  const T sqrtmn_atol = m_sqrt(T(m + n)) * abs_tol;
  const T norm_A = P.scal[1];
  const int groups = (P.K + kL - 1) / kL;

  for (int g = 0; g < groups; ++g) {
    const int lane0 = g * kL;
    const T* const cbg = P.cb + (size_t)g * n * kL;
    const T* const fbg = P.fbb ? P.fbb + (size_t)g * m * kL : nullptr;
    // Cold start: z = z~ = 0.
    for (size_t e = gtid; e < 2 * NL; e += nthr) z[e] = T(0);
    if (tid < kL) {
      rho_s[tid] = P.scal[0];
      delta_s[tid] = T(K_DELTA_MIN);
      xi_s[tid] = one;
      kd_s[tid] = T(0);
      ku_s[tid] = T(0);
      k_s[tid] = 0;
      active[tid] = lane0 + tid < P.K;
    }
    grid.sync();

    for (;;) {
      unsigned live = 0;
      for (int l = 0; l < kL; ++l)
        if (active[l]) live |= 1u << (l / kLG);

      // --- Phase A: prox, gap sums, over-relaxed projection input. ------
      {
        T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
        if (active[lane]) {
          const T rho = rho_s[lane];
          for (size_t e = gtid; e < NL; e += nthr) {
            const int idx = (int)(e / kL);
            const T cz = __ldcg(z + e), czt = __ldcg(zt + e);
            const T in = cz - czt;
            T p;
            int o;
            if (idx < n) {
              const int j = idx;
              p = prox_full(P.hg[j], P.gp[j], P.gp[n + j], cbg[e], P.gp[3 * n + j],
                            P.gp[4 * n + j], in, rho);
              o = 0;
            } else {
              const int i = idx - n;
              const T b = fbg ? fbg[e - xL] : P.fp[m + i];
              p = prox_full(P.hf[i], P.fp[i], b, P.fp[2 * m + i], P.fp[3 * m + i],
                            P.fp[4 * m + i], in, rho);
              o = 3;
            }
            const T zm = in - p;
            pp[e] = p;
            zor[e] = czt + alpha * p + (one - alpha) * cz;
            v[o] += zm * p;
            v[o + 1] += zm * zm;
            v[o + 2] += p * p;
          }
        }
        lane_block_partials<T, 6, kBlockWarps>(v, partials, kSlotS, red_smem);
      }
      grid.sync();
      // Reduce phase A's sums here, not with the residuals' below: the
      // projection's grid syncs then part every block's read of these slots
      // from the next iteration's writes, which no grid sync precedes when
      // no lane is near tolerance or fires.
      lane_grid_partials<T, kBlockWarps>(partials, kSlotS, 6, sums);

      // --- The projection: three products, each followed by the phase that
      // sums its row slices. ----------------------------------------------
      if (tall) {
        // rhs = x0 + A^T y0
        Prod<T> p1 = make_prod(zor + xL, P.A, part1, m, n, P.ldA, P.H_mn);
        run_products(&p1, 1, live, ring);
        grid.sync();
        if (active[lane])
          for (size_t e = gtid; e < xL; e += nthr)
            rhs[e] = __ldcg(zor + e) + slice_sum(part1, W.S_mn, n, e);
        grid.sync();
        // x = Ginv rhs
        Prod<T> p2 = make_prod((const T*)rhs, P.Ginv, part1, n, n, P.ldG, P.H_kk);
        run_products(&p2, 1, live, ring);
        grid.sync();
        if (active[lane])
          for (size_t e = gtid; e < xL; e += nthr) zn[e] = slice_sum(part1, W.S_kk, n, e);
        grid.sync();
        // y = A x
        Prod<T> p3 = make_prod((const T*)zn, P.At, part1, n, m, P.ldAt, P.H_nm);
        run_products(&p3, 1, live, ring);
      } else {
        // rhs = A x0 - y0
        Prod<T> p1 = make_prod((const T*)zor, P.At, part1, n, m, P.ldAt, P.H_nm);
        run_products(&p1, 1, live, ring);
        grid.sync();
        if (active[lane])
          for (size_t e = gtid; e < (size_t)m * kL; e += nthr)
            rhs[e] = slice_sum(part1, W.S_nm, m, e) - __ldcg(zor + xL + e);
        grid.sync();
        // w = Ginv rhs, y = y0 + w
        Prod<T> p2 = make_prod((const T*)rhs, P.Ginv, part1, m, m, P.ldG, P.H_kk);
        run_products(&p2, 1, live, ring);
        grid.sync();
        if (active[lane])
          for (size_t e = gtid; e < (size_t)m * kL; e += nthr) {
            const T s = slice_sum(part1, W.S_kk, m, e);
            wv[e] = s;
            zn[xL + e] = __ldcg(zor + xL + e) + s;
          }
        grid.sync();
        // x = x0 - A^T w
        Prod<T> p3 = make_prod((const T*)wv, P.A, part1, m, n, P.ldA, P.H_mn);
        run_products(&p3, 1, live, ring);
      }
      grid.sync();

      // --- The last projected segment; residual sums; the input of the
      // exact dual residual. ---------------------------------------------
      // R = [|dy_prev|^2, |dy12|^2, sum y_new, |dx_prev|^2, |dx12|^2, sum x_new]
      {
        T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
        if (active[lane])
          for (size_t e = gtid; e < NL; e += nthr) {
            const bool is_x = e < xL;
            T znv;
            if (tall == is_x) {
              znv = __ldcg(zn + e);
            } else {
              znv = tall ? slice_sum(part1, W.S_nm, m, e - xL)
                         : __ldcg(zor + e) - slice_sum(part1, W.S_mn, n, e);
              zn[e] = znv;
            }
            const T cz = __ldcg(z + e), ph = __ldcg(pp + e);
            const T dp = cz - znv, d12 = ph - znv;
            const int o = is_x ? 3 : 0;
            v[o] += dp * dp;
            v[o + 1] += d12 * d12;
            v[o + 2] += znv;
            if (!is_x) sdual[e - xL] = ph + __ldcg(zt + e) - cz;
          }
        lane_block_partials<T, 6, kBlockWarps>(v, partials, kSlotR, red_smem);
      }
      grid.sync();
      lane_grid_partials<T, kBlockWarps>(partials, kSlotR, 6, sums);

      // --- Per-lane approximate residuals and the near-tolerance test. --
      if (tid < kL) {
        const int l = tid;
        near_s[l] = 0;
        if (active[l]) {
          const T rho = rho_s[l];
          const T S1 = sums[(kSlotS + 1) * kL + l], S5 = sums[(kSlotS + 5) * kL + l];
          const T R0 = sums[(kSlotR + 0) * kL + l], R1 = sums[(kSlotR + 1) * kL + l];
          const T R3 = sums[(kSlotR + 3) * kL + l], R4 = sums[(kSlotR + 4) * kL + l];
          const T eps_pri = sqrtm_atol + rel_tol * m_sqrt(S5);
          const T eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(S1));
          const T nrm_s_a = rho * (norm_A * m_sqrt(R0) + m_sqrt(R3));
          const T nrm_r_a = norm_A * m_sqrt(R4) + m_sqrt(R1);
          nrm_s_a_s[l] = nrm_s_a;
          nrm_r_a_s[l] = nrm_r_a;
          near_s[l] = nrm_r_a < T(10) * eps_pri && nrm_s_a < T(10) * eps_dua;
        }
      }
      __syncthreads();
      unsigned near_live = 0;
      for (int l = 0; l < kL; ++l)
        if (near_s[l]) near_live |= 1u << (l / kLG);

      // --- Exact residuals r = A x12 - y12, s = A^T(...) + (...), for the
      // lanes near tolerance: both products in one pass over the grid. ---
      if (near_live) {
        Prod<T> pr[2] = {make_prod((const T*)pp, P.At, part1, n, m, P.ldAt, P.H_nm),
                         make_prod((const T*)sdual, P.A, part2, m, n, P.ldA, P.H_mn)};
        run_products(pr, 2, near_live, ring);
        grid.sync();
        T v[2] = {T(0), T(0)};
        if (near_s[lane])
          for (size_t e = gtid; e < NL; e += nthr) {
            if (e < (size_t)m * kL) {
              const T r = slice_sum(part1, W.S_nm, m, e) - __ldcg(pp + xL + e);
              v[0] += r * r;
            } else {
              const size_t ex = e - (size_t)m * kL;
              const T s = slice_sum(part2, W.S_mn, n, ex) +
                          (__ldcg(pp + ex) + __ldcg(zt + ex) - __ldcg(z + ex));
              v[1] += s * s;
            }
          }
        lane_block_partials<T, 2, kBlockWarps>(v, partials, kSlotE, red_smem);
        grid.sync();
        lane_grid_partials<T, kBlockWarps>(partials, kSlotE, 2, sums);
      }

      // --- Per-lane decisions: converged, NaN, done; the rho schedule. --
      if (tid < kL) {
        const int l = tid;
        fire[l] = 0;
        if (active[l]) {
          T S[6], R[6];
          for (int q = 0; q < 6; ++q) {
            S[q] = sums[(kSlotS + q) * kL + l];
            R[q] = sums[(kSlotR + q) * kL + l];
          }
          const T rho = rho_s[l];
          const T gap = m_fabs(S[0] + S[3]);
          const T eps_gap =
              sqrtmn_atol + rel_tol * m_sqrt(S[1] + S[4]) * m_sqrt(S[2] + S[5]);
          const T eps_pri = sqrtm_atol + rel_tol * m_sqrt(S[5]);
          const T eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(S[1]));
          const bool near = near_s[l];
          const T nrm_r = near ? m_sqrt(sums[kSlotE * kL + l]) : nrm_r_a_s[l];
          const T nrm_s = near ? rho * m_sqrt(sums[(kSlotE + 1) * kL + l]) : nrm_s_a_s[l];
          bool conv_now = near && nrm_r < eps_pri && nrm_s < eps_dua;
          if (P.gap_stop) conv_now = conv_now && gap < eps_gap;
          const bool nan_now = !(m_finite(nrm_r) && m_finite(R[2] + R[5]));
          const int kit = k_s[l];
          const bool done_now = conv_now || nan_now || kit >= P.max_iter - 1;
          fire[l] = done_now;
          T zt_scale = one;
          if (done_now) {
            status_s[l] = conv_now ? kSuccess : (nan_now ? kNanFound : kMaxIter);
          } else {
            if (P.adaptive_rho)
              zt_scale = rho_schedule_step(kit, nrm_r, nrm_s, eps_pri, eps_dua, rho_s[l],
                                           delta_s[l], xi_s[l], kd_s[l], ku_s[l]);
            k_s[l] = kit + 1;
          }
          zt_scale_s[l] = zt_scale;
        }
      }
      __syncthreads();
      bool any_fire = false;
      for (int l = 0; l < kL; ++l) any_fire = any_fire || fire[l];

      // --- Phase F: latch a firing lane's results; otherwise the dual
      // update with the rho rescale and z <- z_new.  Same index mapping as
      // phase A, so no grid sync is needed between them. -----------------
      {
        T v[1] = {T(0)};
        if (active[lane]) {
          const int gl = lane0 + lane;
          if (fire[lane]) {
            for (size_t e = gtid; e < NL; e += nthr) {
              const int idx = (int)(e / kL);
              const T x = __ldcg(pp + e);
              T a, b, c, d, ee;
              int h;
              if (idx < n) {
                const int j = idx;
                h = P.hg[j];
                a = P.gp[j]; b = P.gp[n + j]; c = cbg[e];
                d = P.gp[3 * n + j]; ee = P.gp[4 * n + j];
                P.x12[(size_t)gl * n + j] = x;
              } else {
                const int i = idx - n;
                h = P.hf[i];
                a = P.fp[i]; b = fbg ? fbg[e - xL] : P.fp[m + i];
                c = P.fp[2 * m + i]; d = P.fp[3 * m + i]; ee = P.fp[4 * m + i];
                P.y12[(size_t)gl * m + i] = x;
              }
              v[0] += c * func_base(h, a * x - b) + d * x + T(0.5) * ee * x * x;
            }
          } else {
            const T scale = zt_scale_s[lane];
            for (size_t e = gtid; e < NL; e += nthr) {
              const T cz = __ldcg(z + e), znv = __ldcg(zn + e);
              const T ztv = __ldcg(zt + e) + alpha * __ldcg(pp + e) + (one - alpha) * cz - znv;
              zt[e] = ztv * scale;
              z[e] = znv;
            }
          }
        }
        if (any_fire) {
          lane_block_partials<T, 1, kBlockWarps>(v, partials, kSlotO, red_smem);
          grid.sync();
          lane_grid_partials<T, kBlockWarps>(partials, kSlotO, 1, sums);
          if (blockIdx.x == 0 && tid < kL && fire[tid]) {
            T* st = P.stats + (size_t)(lane0 + tid) * 4;
            st[0] = sums[kSlotO * kL + tid];
            st[1] = T(k_s[tid]);
            st[2] = T(status_s[tid]);
            st[3] = rho_s[tid];
          }
        }
      }
      __syncthreads();
      if (tid < kL && fire[tid]) active[tid] = 0;
      __syncthreads();
      bool any_active = false;
      for (int l = 0; l < kL; ++l) any_active = any_active || active[l];
      if (!any_active) break;
    }
    grid.sync();  // the group's last reads are done before the next group's writes
  }
}

template <typename T>
int grid_size(int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<T>::kSmem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sweep_kernel<T>, kBlock,
                                                      Tile<T>::kSmem);
  if (err != cudaSuccess) return (int)err;
  // One block per SM; zero means the block does not fit an SM at all.
  *grid = per_sm >= 1 ? sms : 0;
  return 0;
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Ginv, const int* hf,
           const void* fp, const int* hg, const void* gp, const void* cb, const void* fbb,
           const void* scal, void* x12, void* y12, void* stats, void* work, int m, int n,
           int K, int ldA, int ldAt, int ldG, int H_mn, int H_nm, int H_kk, double abs_tol,
           double rel_tol, int max_iter, int gap_stop, int adaptive_rho, int grid,
           void* stream) {
  constexpr int cpt = Tile<T>::kCPT;
  const int k = m < n ? m : n;
  if (grid < 1 || K < 1 || m < 1 || n < 1 || H_mn < kTR || H_nm < kTR || H_kk < kTR ||
      H_mn % kTR || H_nm % kTR || H_kk % kTR || ldA < n || ldAt < m || ldG < k ||
      ldA % cpt || ldAt % cpt || ldG % cpt)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tile<T>::kSmem);
  if (err != cudaSuccess) return (int)err;
  Params<T> P;
  P.A = static_cast<const T*>(A);
  P.At = static_cast<const T*>(At);
  P.Ginv = static_cast<const T*>(Ginv);
  P.hf = hf;
  P.fp = static_cast<const T*>(fp);
  P.hg = hg;
  P.gp = static_cast<const T*>(gp);
  P.cb = static_cast<const T*>(cb);
  P.fbb = static_cast<const T*>(fbb);
  P.scal = static_cast<const T*>(scal);
  P.x12 = static_cast<T*>(x12);
  P.y12 = static_cast<T*>(y12);
  P.stats = static_cast<T*>(stats);
  P.work = static_cast<T*>(work);
  P.m = m;
  P.n = n;
  P.K = K;
  P.ldA = ldA;
  P.ldAt = ldAt;
  P.ldG = ldG;
  P.H_mn = H_mn;
  P.H_nm = H_nm;
  P.H_kk = H_kk;
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  P.gap_stop = gap_stop;
  P.adaptive_rho = adaptive_rho;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)sweep_kernel<T>, dim3(grid), dim3(kBlock), args,
                                    Tile<T>::kSmem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The decomposition constants the wrapper plans with: [lanes in flight,
// columns per tile, rows per ring stage, ring stages, dynamic shared bytes].
void pogs_sweep_constants(int is_double, long long* out) {
  out[0] = kL;
  out[1] = is_double ? Tile<double>::kTC : Tile<float>::kTC;
  out[2] = kTR;
  out[3] = kStages;
  out[4] = (long long)(is_double ? Tile<double>::kSmem : Tile<float>::kSmem);
}

// Elements of the work buffer the launch needs.
long long pogs_sweep_work_elems(int m, int n, int H_mn, int H_nm, int H_kk, int grid) {
  return (long long)Work(m, n, H_mn, H_nm, H_kk, grid).total;
}

// The cooperative grid size (blocks) on this device; 0 if the kernel cannot
// be made co-resident.  Returns a cudaError_t code.
int pogs_sweep_grid(int is_double, int device, int* grid) {
  return is_double ? grid_size<double>(device, grid) : grid_size<float>(device, grid);
}

// Launch the sweep on `stream`; does not synchronise.  Returns the
// cudaError_t of the launch (0 on success).
int pogs_sweep(int is_double, int device, const void* A, const void* At, const void* Ginv,
               const int* hf, const void* fp, const int* hg, const void* gp, const void* cb,
               const void* fbb, const void* scal, void* x12, void* y12, void* stats,
               void* work, int m, int n, int K, int ldA, int ldAt, int ldG, int H_mn, int H_nm,
               int H_kk, double abs_tol, double rel_tol, int max_iter, int gap_stop,
               int adaptive_rho, int grid, void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats,
                          work, m, n, K, ldA, ldAt, ldG, H_mn, H_nm, H_kk, abs_tol, rel_tol,
                          max_iter, gap_stop, adaptive_rho, grid, stream);
  return launch<float>(device, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats,
                       work, m, n, K, ldA, ldAt, ldG, H_mn, H_nm, H_kk, abs_tol, rel_tol,
                       max_iter, gap_stop, adaptive_rho, grid, stream);
}

const char* pogs_sweep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
