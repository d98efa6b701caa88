// The whole HSDE Douglas-Rachford cone solve for a dense A as ONE persistent
// cooperative CUDA kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pogs_tpu/ops/fused_hsde.py::fused_hsde_solve
// (body _kernel_body).  Same algorithm and constants as the eager loop in
// pogs_tpu_torch/solver/hsde.py with the SMW linear solve, which is this
// kernel's plain version: per iteration the SMW solve of (I + Q) w = u
// through the Gram inverse (tall: Kinv = (I + A^T A)^-1; wide: Woodbury
// through the m x m (I + A A^T)^-1), the projection of 2w - u onto
// R^n x K_y* x R_+ (Zero rows free, NonNeg / NonPos rows clamped, up to 16
// contiguous SOC / exponential segments), the relaxed update with alpha in
// [1, 1.7]; every 10th iteration (and the last) the primal / dual / gap test
// on w / tau with adaptive alpha, or, where tau ~ 0, the infeasibility and
// unboundedness certificates with dominance and the confirmation firing.
//
// What bounds it on this card (tools/k3_split.py times every barrier phase;
// NVIDIA H100 80GB HBM3, 700 W).  A barrier costs about 1.1 us alone at any
// grid from 1 to 132 blocks, 1.7 to 2.2 us with the reduction of 5 partial
// sums after it, 0.8 us as a one-block __syncthreads.
//   * Small problems (up to hsde_plan's ONE_BLOCK_ELEMS): latency.  One
//     block, 6 to 13 us per iteration without a cone segment, 12 to 32
//     with exponential cones, whose warp projection (about 7 us in f32) is
//     the longest phase.
//   * Mid sizes (90x60 to 300x200): latency, 11 to 16 us per iteration on
//     8 to 66 blocks; more blocks add barrier wait, fewer stream too little.
//   * socp_ball 804x200, lp_ineq 1100x300 (A, A^T and Kinv in L2): latency,
//     17 to 19 us per iteration on 132 blocks: 4 barriers (5 to 7 us with
//     the waits), 2 reductions (2 us), and products of a few L2 round trips
//     each (2 to 4 us per phase).
//   * 8004x2000 f32 (144 MB per iteration, 43 us at 3.35 TB/s): the
//     products, about 80 us per iteration; A^T u_y and A p_x take 24 us
//     each (64 MB: 2.6 TB/s), Kinv r 8 us (16 MB).
//
// What the design does about it:
//   * Launch plan (ops/fused_hsde.py::hsde_plan): the grid is sized to the
//     problem (one block up to ONE_BLOCK_ELEMS matrix elements, whose
//     barriers are __syncthreads; else the fewest of 132, 66, 33, ...
//     blocks that leave each about 8 rows of the longest product, at most
//     the occupancy limit), and each segment has one owner block.  The plan
//     depends only on the problem and the SM count.
//   * Barriers: 4 per ordinary iteration tall (A^T u_y | Kinv r | A p_x |
//     projection), 6 wide (A r and Kinv q before A^T), and 2 more on a
//     check, 1 when there is no segment.  Each owner block sums its SOC
//     segment's tail norm itself (fixed order) and projects the segment in
//     the phase of the separable rows, so no segment needs a grid-wide sum.
//     A check computes x_s = w_x / tau and y_s = w_y / tau where it reads
//     them (the same division), so its products, its sums and the dual
//     distances share one phase; the primal distances of the segments
//     (their tail norms need s_s = b - A x_s in full) take the second.
//     The reductions after a barrier cover only that phase's slots: 2 after
//     the solve, 5 after the projection, 11 and 2 on a check.
//   * Products: every matrix-vector product spreads its rows over all
//     blocks (row r to block r % G), one warp per row.  Each block stages
//     the vector operand in shared memory, by column tiles when it is
//     long; the warp streams its row with 16-byte loads, 4 per lane issued
//     before any is used (32 KB in flight per SM).  Copy route: plain
//     16-byte loads into registers, no cp.async ring or TMA: each matrix
//     row is read once per product by one warp, and nothing of it is
//     reused that shared memory would have to hold.  A check's four
//     products go as one paired pass over A (x_s, w_x) and one over A^T
//     (y_s, w_y).
//   * Precision: products, sums and scalar tests in the working type, as
//     the plain version.  In f32 a long solve's trajectory is sensitive to
//     roundoff: lp_ineq 1100x300 at tol 1e-4 ends after about 2070 or 2260
//     iterations by which way one adaptive-alpha test falls, so the f32
//     outcome depends on the summation order and with it on the grid
//     (chip_smoke.py's phase 10 holds such runs to the f64 solve).
//   * Exponential cones: one warp of the owner block projects a cone.  The
//     2 x 65 scan points are split over the lanes, each lane's right
//     neighbour gives it the sign at its last point (a shuffle), a ballot
//     marks the sign changes, each of six lanes takes the first, second or
//     third change of a branch in scan order and bisects it (50 steps
//     primal, 80 dual), and every lane takes the closest valid candidate in
//     the plain version's order with strict <.  The values are those of the
//     serial projection, step for step.  A check's two projections per
//     cone run on two warps at once.  Precise expf / exp, no fast math.
//   * Every scalar decision (the check slot, the tau branch, the
//     certificate latch, done) is identical in every block: fixed-order
//     sums (coop.cuh), no float atomics.

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pogs;

constexpr int kMaxSeg = 16;
constexpr int kGrid = 65;   // exp-cone scan points per branch
constexpr int kKeep = 3;    // brackets kept per branch
constexpr unsigned kFull = 0xffffffffu;

// Row codes: 0 free (in no cone), the separable kinds, or kSegRow + the
// segment's index.
constexpr int kZero = 1, kNonNeg = 2, kNonPos = 3, kSegRow = 16;
// Segment kinds: the values of pogs_tpu_torch.types.Cone.
constexpr int kSOC = 3, kExpPrimal = 5, kExpDual = 6;
constexpr int kInfeasible = 1, kUnbounded = 2;

// Constants of solver/hsde.py.
constexpr double K_ALPHA_MIN = 1.0, K_ALPHA_MAX = 1.7, K_ALPHA_GROW = 1.02;
constexpr double K_TAU_TOL = 1e-8, K_TAU_REL = 1e-6, K_KAPPA_TOL = 1e-6;
constexpr int K_CHECK_EVERY = 10;
constexpr double K_CERT_CROSS = 0.1, K_CERT_CONFIRM = 0.25;

// Partial-sum slots, by the phase that writes them.
enum Slot {
  S_CPX = 0, S_BPY,                                         // the solve: 2
  S_FP, S_CWX, S_BWY, S_WX2, S_WY2,                         // projection: 5
  S_CXS, S_BYS, S_YS2, S_RDC, S_YCH, S_SS2, S_RPRI, S_AXD,  // check 1: 11
  S_RDUA, S_ATY2, S_ATYH2,
  S_RPRI2, S_AXD2,                                          // check 2: 2
  kSlots
};
constexpr int kProjSlots = S_CXS - S_FP, kCheckSlots = S_RPRI2 - S_CXS;

// The exponential projection's tolerance and exponent bound, and the
// largest finite value (finfo.max), by type.
template <typename T> struct ExpC;
template <> struct ExpC<float> {
  static __device__ float tol() { return 1e-6f; }
  static __device__ float U() { return 22.0f; }
  static __device__ float big() { return FLT_MAX; }
};
template <> struct ExpC<double> {
  static __device__ double tol() { return 1e-8; }
  static __device__ double U() { return 50.0; }
  static __device__ double big() { return DBL_MAX; }
};

template <typename T> struct V3 { T x, y, z; };

// jnp.sign: 0 at 0, NaN at NaN.
template <typename T> __device__ __forceinline__ T sgn(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : (x == T(0) ? T(0) : x));
}
// max(v, 0) and min(v, 0) that keep a NaN, as jnp.maximum / jnp.minimum.
template <typename T> __device__ __forceinline__ T pos(T v) { return v < T(0) ? T(0) : v; }
template <typename T> __device__ __forceinline__ T neg(T v) { return v > T(0) ? T(0) : v; }

template <typename T> __device__ __forceinline__ T safe_exp(T x) {
  const T U3 = T(3) * ExpC<T>::U();
  return m_exp(x < -U3 ? -U3 : (x > U3 ? U3 : x));
}

template <typename T> struct ExpPoint {
  T r, s, t;
  __device__ T sign_F(T u) const {
    const T w = safe_exp(u);
    const T w2 = w * w;
    const T G = w2 * (s - r * (T(1) - u)) + u * (s + t * w * (T(1) - u)) - t * w - r;
    return sgn(G) * sgn(w2 + u);
  }
  __device__ T bisect(T lo, T hi, int iters) const {
    const T slo = sign_F(lo);
    for (int i = 0; i < iters; ++i) {
      const T mid = T(0.5) * (lo + hi);
      if (sign_F(mid) == slo) lo = mid; else hi = mid;
    }
    return T(0.5) * (lo + hi);
  }
};

// Bit l of x to bit 2l.
__device__ __forceinline__ unsigned long long spread(unsigned x) {
  unsigned long long v = x;
  v = (v | (v << 16)) & 0x0000FFFF0000FFFFull;
  v = (v | (v << 8)) & 0x00FF00FF00FF00FFull;
  v = (v | (v << 4)) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | (v << 2)) & 0x3333333333333333ull;
  v = (v | (v << 1)) & 0x5555555555555555ull;
  return v;
}

// Projection of (r, s, t) onto the exponential cone (cones/projections.py:
// _project_exp_primal_impl) by one warp; every lane must call it and every
// lane receives the result.  grid: the (2, 65) scan points.  Lane l scans
// points 2l and 2l + 1 of each branch and takes the sign at 2l + 2 from
// lane l + 1 (lane 31 computes point 64), so interval i (points i, i + 1)
// is bit i of a branch's 64-bit change mask.  Lanes 0-5 bisect the first
// three changes of branch 0, then of branch 1, as the serial scan keeps
// them; the candidates are then taken in the serial order.
template <typename T>
__device__ __forceinline__ V3<T> exp_project_warp(T r, T s, T t, int iters, const T* grid,
                                               int lane) {
  const ExpPoint<T> P{r, s, t};
  const T tol = ExpC<T>::tol();
  const T INF = ExpC<T>::big();
  unsigned long long flips0 = 0, flips1 = 0;
#pragma unroll
  for (int br = 0; br < 2; ++br) {
    const T* us = grid + br * kGrid;
    const T s0 = P.sign_F(us[2 * lane]), s1 = P.sign_F(us[2 * lane + 1]);
    T s2 = __shfl_down_sync(kFull, s0, 1);
    if (lane == 31) s2 = P.sign_F(us[2 * lane + 2]);
    const unsigned a = __ballot_sync(kFull, s0 * s1 <= T(0));
    const unsigned b = __ballot_sync(kFull, s1 * s2 <= T(0));
    const unsigned long long f = spread(a) | (spread(b) << 1);
    if (br == 0) flips0 = f; else flips1 = f;
  }
  V3<T> c{T(0), T(0), T(0)};
  int ok = 0;
  if (lane < 2 * kKeep) {
    const int br = lane / kKeep;
    unsigned long long f = br == 0 ? flips0 : flips1;
    for (int j = 0; j < lane % kKeep; ++j) f &= f - 1;  // drop the earlier changes
    if (f != 0) {
      const int i = __ffsll((long long)f) - 1;
      const T* us = grid + br * kGrid;
      const T u = P.bisect(us[i], us[i + 1], iters);
      const T w = safe_exp(u);
      T denom = w * w + u;
      if (m_fabs(denom) < T(1e-30)) denom = T(1e-30);
      const T num = (r + t * w) / denom;
      const T z = w * num;
      ok = z > T(0) && z - t >= -tol * (T(1) + m_fabs(t));
      c = V3<T>{u * num, num, z};
    }
  }
  // Candidates in the order of the plain version: v, ray, 0, six roots.
  V3<T> best{r, s, t};
  const T spos = tmax(s, Lim<T>::tiny());
  const bool in_cone = (s > tol && spos * safe_exp(r / spos) <= t + tol) ||
                       (m_fabs(s) <= tol && r <= tol && t >= -tol);
  T best_d = in_cone ? T(0) : INF;  // d2(v) = 0
  auto consider = [&](const V3<T>& v, bool valid) {
    const T dx = v.x - r, dy = v.y - s, dz = v.z - t;
    const T d = valid ? (dx * dx + dy * dy) + dz * dz : INF;
    if (d < best_d) { best = v; best_d = d; }
  };
  consider(V3<T>{neg(r), T(0), pos(t)}, true);
  consider(V3<T>{T(0), T(0), T(0)}, true);
  for (int j = 0; j < 2 * kKeep; ++j) {
    const V3<T> cj{__shfl_sync(kFull, c.x, j), __shfl_sync(kFull, c.y, j),
                   __shfl_sync(kFull, c.z, j)};
    consider(cj, __shfl_sync(kFull, ok, j) != 0);  // an invalid candidate is never taken
  }
  return best;
}

// Projection of a 3-element segment onto the cone of `kind`, by one warp.
template <typename T>
__device__ V3<T> exp_segment(int kind, T a, T b, T c, const T* grid, int lane) {
  if (kind == kExpPrimal) return exp_project_warp(a, b, c, 50, grid, lane);
  const V3<T> p = exp_project_warp(-a, -b, -c, 80, grid, lane);  // Moreau
  return V3<T>{a + p.x, b + p.y, c + p.z};
}

__device__ __forceinline__ int dual_kind(int kind) {
  return kind == kExpPrimal ? kExpDual : (kind == kExpDual ? kExpPrimal : kind);
}

// Separable projection of one row: the primal cone, or the dual (Zero free).
template <typename T> __device__ __forceinline__ T proj_sep(int code, T v, bool dual) {
  switch (code) {
    case kZero: return dual ? v : T(0);
    case kNonNeg: return pos(v);
    case kNonPos: return neg(v);
    default: return v;
  }
}

// SOC projection of one row of a segment, from its head p and tail norm.
template <typename T> __device__ __forceinline__ T soc_row(bool head, T v, T p, T nrm) {
  const T scale = T(0.5) * (T(1) + p / tmax(nrm, Lim<T>::tiny()));
  const bool polar = nrm <= -p, general = nrm >= m_fabs(p);
  if (head) return polar ? T(0) : (general ? scale * nrm : p);
  return v * (polar ? T(0) : (general ? scale : T(1)));
}

// The squared distances of two vectors' rows [h, h + len) of one SOC
// segment from the cone (self-dual), by the owner block: val(i, 0 | 1)
// gives row i of each; both are added to acc0 / acc1 of the calling thread.
template <typename T, typename Val>
__device__ __forceinline__ void soc_dist2(int h, int len, Val val, T* smem, T& acc0, T& acc1) {
  const T p0 = val(h, 0), p1 = val(h, 1);
  T tail[2] = {T(0), T(0)};
  for (int i = h + 1 + threadIdx.x; i < h + len; i += blockDim.x) {
    const T a = val(i, 0), b = val(i, 1);
    tail[0] += a * a;
    tail[1] += b * b;
  }
  block_sum<T, 2>(tail, smem);
  const T n0 = m_sqrt(tail[0]), n1 = m_sqrt(tail[1]);
  for (int i = h + threadIdx.x; i < h + len; i += blockDim.x) {
    const T a = val(i, 0), b = val(i, 1);
    const T da = a - soc_row(i == h, a, p0, n0), db = b - soc_row(i == h, b, p1, n1);
    acc0 += da * da;
    acc1 += db * db;
  }
}

template <typename T> struct Params {
  const T* A;       // (m, n) row-major, equilibrated
  const T* At;      // (n, m) row-major, A transposed
  const T* Kinv;    // (k, k) symmetric: n x n tall, m x m wide
  const T* b;       // (m) scaled
  const T* c;       // (n) scaled
  const T* tx;      // (n) SMW t_x
  const T* ty;      // (m) SMW t_y
  const int* code;  // (m) row codes
  const T* grid;    // (2, 65) exp-cone scan points
  const T* scal;    // [s_den, ||b||, ||c||, ut0]
  T* ux;            // (n) in: u0_x; state; out: final u_x
  T* uy;            // (m)
  T* wx;            // (n) out: final w_x
  T* wy;            // (m)
  T* stats;         // (8) out: wt, k, status, fp, r_pri, r_dua, gap, ut
  T* r;             // (n) work: ux - A^T uy
  T* px;            // (n) work
  T* py;            // (m) work
  T* q;             // (m) work (wide): A r
  T* q2;            // (m) work (wide): Kinv A r
  T* ss;            // (m) work (check): b - A xs
  T* nax;           // (m) work (check): -A wx
  T* part;          // (2 max(m, n)) work: row sums between column tiles
  T* partials;      // (kSlots, grid) work: partial sums
  int m, n, nseg, smem_bytes;
  int seg_kind[kMaxSeg], seg_start[kMaxSeg], seg_len[kMaxSeg];  // primal kinds
  int seg_owner[kMaxSeg];                                       // owner block
  T abs_tol, rel_tol;
  int max_iter;
};

// Run task(s, q) for q < ntask on each exponential cone s this block owns:
// the e-th such cone's task q on warp (e * ntask + q) % kWarps.  Warp-uniform.
template <typename T, typename Task>
__device__ __forceinline__ void exp_tasks(const Params<T>& P, int ntask, Task task) {
  const int warp = threadIdx.x >> 5;
  int e = 0;
  for (int s = 0; s < P.nseg; ++s) {
    if (P.seg_owner[s] != (int)blockIdx.x || P.seg_kind[s] == kSOC) continue;
    for (int q = 0; q < ntask; ++q)
      if ((e * ntask + q) % kWarps == warp) task(s, q);
    ++e;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_hsde_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dyn[];
  T* const xs = reinterpret_cast<T*>(dyn);  // staged vector operands
  __shared__ T smem[kCheckSlots * kWarps];
  __shared__ T red[kSlots];
  T* const part = P.part;
  T* const partials = P.partials;

  const int m = P.m, n = P.n, nseg = P.nseg, cap = P.smem_bytes / (int)sizeof(T);
  const bool tall = m >= n;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;

  const T one = T(1), zero = T(0);
  const T abs_tol = T(P.abs_tol), rel_tol = T(P.rel_tol);
  const T s_den = P.scal[0], b_norm = P.scal[1], c_norm = P.scal[2];
  const T sqm = m_sqrt(T(m)), sqn = m_sqrt(T(n));
  const T fp_tol = abs_tol * m_sqrt(T(m + n + 1)) + rel_tol;
  const T cert_tol = abs_tol + rel_tol;
  const T eps_d = T(1e-12);

  T ut = P.scal[3], wt = zero, alpha = T(K_ALPHA_MIN), fp = one;
  T prev_resid = ExpC<T>::big();
  T r_pri = zero, r_dua = zero, gap = zero;
  int k = 0, status = kMaxIter, cert_pending = 0;

  // wy and vy = 2 wy - uy of row i from this iteration's solve (one formula
  // for every place that needs them).
  auto wy_at = [&](int i, T u_tau) { return __ldcg(P.py + i) - P.ty[i] * u_tau; };
  auto vy_at = [&](int i, T u_tau) { return T(2) * wy_at(i, u_tau) - __ldcg(P.uy + i); };
  auto ld = [](const T* v) { return [v](int c, T (&o)[1]) { o[0] = __ldcg(v + c); }; };
  auto sq = [](T x) { return x * x; };

  for (;;) {
    // --- The SMW solve: px = Kinv (ux - A^T uy), py = uy + A px. --------
    products<T, 1>(P.At, n, m, xs, cap, part, ld(P.uy), [&](int rr, const T (&d)[1]) {
      if (lane == 0) P.r[rr] = __ldcg(P.ux + rr) - d[0];
    });
    grid_sync(grid);
    {
      T v[1] = {T(0)};
      if (tall) {
        products<T, 1>(P.Kinv, n, n, xs, cap, part, ld(P.r), [&](int rr, const T (&d)[1]) {
          if (lane == 0) {
            const T p = d[0];
            P.px[rr] = p;
            v[0] += P.c[rr] * p;
          }
        });
      } else {
        // Woodbury: px = r - A^T Kinv (A r), Kinv the m x m inverse.
        products<T, 1>(P.A, m, n, xs, cap, part, ld(P.r), [&](int i, const T (&d)[1]) {
          if (lane == 0) P.q[i] = d[0];
        });
        grid_sync(grid);
        products<T, 1>(P.Kinv, m, m, xs, cap, part, ld(P.q), [&](int i, const T (&d)[1]) {
          if (lane == 0) P.q2[i] = d[0];
        });
        grid_sync(grid);
        products<T, 1>(P.At, n, m, xs, cap, part, ld(P.q2), [&](int rr, const T (&d)[1]) {
          if (lane == 0) {
            const T p = __ldcg(P.r + rr) - d[0];
            P.px[rr] = p;
            v[0] += P.c[rr] * p;
          }
        });
      }
      block_partials<T, 1>(v, partials, S_CPX, smem);
    }
    grid_sync(grid);
    {
      T v[1] = {T(0)};
      products<T, 1>(P.A, m, n, xs, cap, part, ld(P.px), [&](int i, const T (&d)[1]) {
        if (lane == 0) {
          const T p = __ldcg(P.uy + i) + d[0];
          P.py[i] = p;
          v[0] += P.b[i] * p;
        }
      });
      block_partials<T, 1>(v, partials, S_BPY, smem);
    }
    grid_sync(grid);
    grid_partials(partials, S_CPX, 2, red);
    const T u_tau = (ut + (red[S_CPX] + red[S_BPY])) / s_den;
    wt = u_tau;
    const T vt = T(2) * wt - ut;
    const T zt = pos(vt);

    // --- w, v = 2w - u, the projection and the relaxed update. ------------
    {
      T v[kProjSlots] = {T(0), T(0), T(0), T(0), T(0)};  // fp, c.wx, b.wy, |wx|^2, |wy|^2
      for (int j = tid; j < n; j += nthreads) {
        const T cu = __ldcg(P.ux + j);
        const T w = __ldcg(P.px + j) - P.tx[j] * u_tau;
        const T vx = T(2) * w - cu;
        P.ux[j] = cu + alpha * (vx - w);
        P.wx[j] = w;
        v[0] += sq(vx - w);
        v[1] += P.c[j] * w;
        v[3] += sq(w);
      }
      for (int i = tid; i < m; i += nthreads) {
        const T cu = __ldcg(P.uy + i);
        const T w = wy_at(i, u_tau);
        P.wy[i] = w;
        v[2] += P.b[i] * w;
        v[4] += sq(w);
        const int code = P.code[i];
        if (code < kSegRow) {
          const T z = proj_sep(code, T(2) * w - cu, true);
          P.uy[i] = cu + alpha * (z - w);
          v[0] += sq(z - w);
        }
      }
      // The segments this block owns: an SOC segment by the whole block
      // (its tail norm summed here), an exponential cone by one warp.
      for (int s = 0; s < nseg; ++s) {
        if (P.seg_owner[s] != (int)blockIdx.x || P.seg_kind[s] != kSOC) continue;
        const int h = P.seg_start[s], end = h + P.seg_len[s];
        const T p = vy_at(h, u_tau);  // read by every thread before any write
        T tail[1] = {T(0)};
        for (int i = h + 1 + threadIdx.x; i < end; i += blockDim.x) tail[0] += sq(vy_at(i, u_tau));
        block_sum<T, 1>(tail, smem);
        const T nrm = m_sqrt(tail[0]);
        for (int i = h + threadIdx.x; i < end; i += blockDim.x) {
          const T cu = __ldcg(P.uy + i);
          const T w = wy_at(i, u_tau);
          const T z = soc_row(i == h, T(2) * w - cu, p, nrm);
          P.uy[i] = cu + alpha * (z - w);
          v[0] += sq(z - w);
        }
      }
      exp_tasks(P, 1, [&](int s, int) {
        const int h = P.seg_start[s];
        const T a = vy_at(h, u_tau), b = vy_at(h + 1, u_tau), c = vy_at(h + 2, u_tau);
        const V3<T> z = exp_segment(dual_kind(P.seg_kind[s]), a, b, c, P.grid, lane);
        if (lane < 3) {
          const T ze = lane == 0 ? z.x : (lane == 1 ? z.y : z.z);
          const T w = wy_at(h + lane, u_tau);
          P.uy[h + lane] = __ldcg(P.uy + h + lane) + alpha * (ze - w);
          v[0] += sq(ze - w);
        }
      });
      block_partials<T, kProjSlots>(v, partials, S_FP, smem);
    }
    grid_sync(grid);
    grid_partials(partials, S_FP, kProjSlots, red);
    fp = m_sqrt(red[S_FP] + sq(zt - wt));
    ut = ut + alpha * (zt - wt);

    bool done_new = false;
    if (k % K_CHECK_EVERY == 0 || k >= P.max_iter - 1) {
      // --- The check: both tau branches, selected. -------------------------
      const T cwx = red[S_CWX], bwy = red[S_BWY], wx2 = red[S_WX2], wy2 = red[S_WY2];
      const T w_norm = m_sqrt(wx2 + wy2 + sq(wt));
      const bool tau_ok = wt > tmax(T(K_TAU_TOL), T(K_TAU_REL) * w_norm);
      const T tau = tau_ok ? wt : one;

      // C1: one paired pass over A (A x_s, A w_x) and one over A^T (A^T y_s,
      // A^T w_y), x_s = w_x / tau and y_s = w_y / tau computed where read;
      // the dual distances of y_s and w_y, the separable rows' primal
      // distances of s_s and -A w_x.
      {
        T v[kCheckSlots];
#pragma unroll
        for (int s = 0; s < kCheckSlots; ++s) v[s] = T(0);
        auto vc = [&](int slot) -> T& { return v[slot - S_CXS]; };  // constant slots only
        products<T, 2>(P.A, m, n, xs, cap, part,
                          [&](int c, T (&o)[2]) {
                            const T w = __ldcg(P.wx + c);
                            o[0] = w / tau;
                            o[1] = w;
                          },
                          [&](int i, const T (&d)[2]) {
                            if (lane == 0) {
                              const T s = P.b[i] - d[0], na = -d[1];
                              P.ss[i] = s;
                              P.nax[i] = na;
                              vc(S_SS2) += sq(s);
                              const int code = P.code[i];
                              if (code < kSegRow) {
                                vc(S_RPRI) += sq(s - proj_sep(code, s, false));
                                vc(S_AXD) += sq(na - proj_sep(code, na, false));
                              }
                            }
                          });
        products<T, 2>(P.At, n, m, xs, cap, part,
                          [&](int c, T (&o)[2]) {
                            const T w = __ldcg(P.wy + c);
                            o[0] = w / tau;
                            o[1] = w;
                          },
                          [&](int j, const T (&d)[2]) {
                            if (lane == 0) {
                              const T aty = d[0], atyh = d[1];
                              vc(S_RDUA) += sq(aty + P.c[j]);
                              vc(S_ATY2) += sq(aty);
                              vc(S_ATYH2) += sq(atyh);
                            }
                          });
        for (int j = tid; j < n; j += nthreads)
          vc(S_CXS) += P.c[j] * (__ldcg(P.wx + j) / tau);
        for (int i = tid; i < m; i += nthreads) {
          const T w = __ldcg(P.wy + i);
          const T y = w / tau;
          vc(S_BYS) += P.b[i] * y;
          vc(S_YS2) += sq(y);
          const int code = P.code[i];
          if (code < kSegRow) {
            vc(S_RDC) += sq(y - proj_sep(code, y, true));
            vc(S_YCH) += sq(w - proj_sep(code, w, true));
          }
        }
        for (int s = 0; s < nseg; ++s) {
          if (P.seg_owner[s] != (int)blockIdx.x || P.seg_kind[s] != kSOC) continue;
          soc_dist2<T>(P.seg_start[s], P.seg_len[s], [&](int i, int q) {
            const T w = __ldcg(P.wy + i);
            return q == 0 ? w / tau : w;
          }, smem, vc(S_RDC), vc(S_YCH));
        }
        exp_tasks(P, 2, [&](int s, int q) {
          const int h = P.seg_start[s];
          T a = __ldcg(P.wy + h), b = __ldcg(P.wy + h + 1), c = __ldcg(P.wy + h + 2);
          if (q == 0) { a = a / tau; b = b / tau; c = c / tau; }
          const V3<T> z = exp_segment(dual_kind(P.seg_kind[s]), a, b, c, P.grid, lane);
          const T d = (sq(a - z.x) + sq(b - z.y)) + sq(c - z.z);
          if (lane == 0 && q == 0) vc(S_RDC) += d;
          if (lane == 0 && q == 1) vc(S_YCH) += d;
        });
        block_partials<T, kCheckSlots>(v, partials, S_CXS, smem);
      }
      grid_sync(grid);
      grid_partials(partials, S_CXS, kCheckSlots, red);

      // C2: the segments' primal distances of s_s and -A w_x (their SOC
      // tail norms need every row of the products).
      T rpri2 = T(0), axd2 = T(0);
      if (nseg > 0) {
        T v[2] = {T(0), T(0)};
        for (int s = 0; s < nseg; ++s) {
          if (P.seg_owner[s] != (int)blockIdx.x || P.seg_kind[s] != kSOC) continue;
          soc_dist2<T>(P.seg_start[s], P.seg_len[s], [&](int i, int q) {
            return __ldcg((q == 0 ? P.ss : P.nax) + i);
          }, smem, v[0], v[1]);
        }
        exp_tasks(P, 2, [&](int s, int q) {
          const T* src = q == 0 ? P.ss : P.nax;
          const int h = P.seg_start[s];
          const T a = __ldcg(src + h), b = __ldcg(src + h + 1), c = __ldcg(src + h + 2);
          const V3<T> z = exp_segment(P.seg_kind[s], a, b, c, P.grid, lane);
          const T d = (sq(a - z.x) + sq(b - z.y)) + sq(c - z.z);
          if (lane == 0 && q == 0) v[0] += d;
          if (lane == 0 && q == 1) v[1] += d;
        });
        block_partials<T, 2>(v, partials, S_RPRI2, smem);
        grid_sync(grid);
        grid_partials(partials, S_RPRI2, 2, red);
        rpri2 = red[S_RPRI2];
        axd2 = red[S_AXD2];
      }

      // --- Scalars: identical in every block. --------------------------
      // tau > 0: the primal, dual and gap test.
      const T rp = m_sqrt(red[S_RPRI] + rpri2);
      const T rd = m_sqrt(red[S_RDUA]);
      const T r_dua_cone = m_sqrt(red[S_RDC]);
      const T eps_pri = sqm * abs_tol + rel_tol * tmax(b_norm, m_sqrt(red[S_SS2]));
      const T eps_dua = sqn * abs_tol + rel_tol * tmax(m_sqrt(red[S_ATY2]), c_norm);
      const T eps_cone = sqm * abs_tol + rel_tol * tmax(T(1), m_sqrt(red[S_YS2]));
      const T cx = red[S_CXS], by = red[S_BYS];
      const T g = m_fabs(cx + by);
      const T eps_gap = abs_tol + rel_tol * tmax(tmax(T(1), g), tmax(m_fabs(cx), m_fabs(by)));
      const T curr = rp + rd + r_dua_cone + g;
      const bool converged = rp <= eps_pri && rd <= eps_dua && r_dua_cone <= eps_cone &&
                             g <= eps_gap;

      // tau ~ 0: the certificates, by dominance, confirmed on a second firing.
      const T kappa = -cwx - bwy;
      const bool firm = kappa > T(K_KAPPA_TOL) && fp <= fp_tol;
      const T ax_dist = m_sqrt(red[S_AXD] + axd2);
      const T aty_h = m_sqrt(red[S_ATYH2]);
      const T y_cone_h = m_sqrt(red[S_YCH]);
      const T b_neg = -bwy, c_neg = -cwx;
      const bool infeas_sup = firm && b_neg > cert_tol && aty_h <= cert_tol * b_neg &&
                              y_cone_h <= cert_tol * b_neg;
      const bool unbdd_sup = firm && c_neg > cert_tol && ax_dist <= cert_tol * c_neg;
      const T joint = m_sqrt(wx2 + wy2) + eps_d;
      const T beta = b_neg / (joint * tmax(b_norm, eps_d));
      const T gamma = c_neg / (joint * tmax(c_norm, eps_d));
      const bool both = infeas_sup && unbdd_sup;
      const T cross = T(K_CERT_CROSS);
      const bool infeas = infeas_sup && (gamma <= cross * beta || (both && beta >= gamma));
      const bool unbdd = unbdd_sup && !infeas &&
                         (beta <= cross * gamma || (both && gamma > beta));
      const int fired = infeas ? 1 : (unbdd ? 2 : 0);
      const bool confirm = fired > 0 && fired == cert_pending &&
                           fp <= T(K_CERT_CONFIRM) * fp_tol;

      if (tau_ok) {
        alpha = curr <= prev_resid * T(0.99) ? tmin(T(K_ALPHA_MAX), alpha * T(K_ALPHA_GROW))
                                             : T(K_ALPHA_MIN);
        prev_resid = curr;
        done_new = converged;
        if (converged) status = kSuccess;
        r_pri = rp;
        r_dua = rd;
        gap = g;
        cert_pending = 0;
      } else {
        done_new = confirm;
        if (confirm && infeas) status = kInfeasible;
        else if (confirm && unbdd) status = kUnbounded;
        cert_pending = fired;
      }
    }
    const bool stop = done_new || k >= P.max_iter - 1 || !m_finite(fp);
    if (!done_new) ++k;
    if (stop) break;
  }

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    T* st = P.stats;
    st[0] = wt;
    st[1] = T(k);
    st[2] = T(status);
    st[3] = fp;
    st[4] = r_pri;
    st[5] = r_dua;
    st[6] = gap;
    st[7] = ut;
  }
}

// The work buffer: the vectors r, px | py, q, q2, ss, nax, the row sums
// between column tiles (2 max(m, n)) and the partial sums (kSlots x grid).
long long work_elems(int m, int n, int grid) {
  const long long mx = m > n ? m : n;
  return 2LL * n + 5LL * m + 2 * mx + (long long)kSlots * grid;
}

template <typename T>
cudaError_t set_smem(int bytes) {
  return cudaFuncSetAttribute(fused_hsde_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <typename T>
int blocks_per_sm(int device, int smem_bytes, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = set_smem<T>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fused_hsde_kernel<T>,
                                                            kThreads, smem_bytes);
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Kinv, const void* b,
           const void* c, const void* tx, const void* ty, const int* code,
           const void* egrid, const void* scal, void* ux, void* uy, void* wx, void* wy,
           void* stats, void* work, int m, int n, int nseg, const int* segs,
           double abs_tol, double rel_tol, int max_iter, int grid, int smem_bytes,
           void* stream) {
  if (nseg < 0 || nseg > kMaxSeg || grid < 1 || m < 1 || n < 1 ||
      smem_bytes < 2 * 16 || smem_bytes % (2 * 16))
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < nseg; ++s)
    if (segs[4 * s + 3] < 0 || segs[4 * s + 3] >= grid) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = set_smem<T>(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  T* wk = static_cast<T*>(work);
  Params<T> P;
  P.A = static_cast<const T*>(A);
  P.At = static_cast<const T*>(At);
  P.Kinv = static_cast<const T*>(Kinv);
  P.b = static_cast<const T*>(b);
  P.c = static_cast<const T*>(c);
  P.tx = static_cast<const T*>(tx);
  P.ty = static_cast<const T*>(ty);
  P.code = code;
  P.grid = static_cast<const T*>(egrid);
  P.scal = static_cast<const T*>(scal);
  P.ux = static_cast<T*>(ux);
  P.uy = static_cast<T*>(uy);
  P.wx = static_cast<T*>(wx);
  P.wy = static_cast<T*>(wy);
  P.stats = static_cast<T*>(stats);
  P.r = wk;
  P.px = wk + n;
  P.py = wk + 2 * n;
  P.q = P.py + m;
  P.q2 = P.q + m;
  P.ss = P.q2 + m;
  P.nax = P.ss + m;
  P.part = P.nax + m;
  P.partials = P.part + 2 * (m > n ? m : n);
  P.m = m;
  P.n = n;
  P.nseg = nseg;
  P.smem_bytes = smem_bytes;
  for (int s = 0; s < kMaxSeg; ++s) {
    P.seg_kind[s] = s < nseg ? segs[4 * s] : 0;
    P.seg_start[s] = s < nseg ? segs[4 * s + 1] : 0;
    P.seg_len[s] = s < nseg ? segs[4 * s + 2] : 0;
    P.seg_owner[s] = s < nseg ? segs[4 * s + 3] : 0;
  }
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_hsde_kernel<T>, dim3(grid),
                                    dim3(kThreads), args, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements (of the working type) of the work buffer the launch needs for a
// given grid.
long long pogs_fused_hsde_work_elems(int m, int n, int grid) {
  return work_elems(m, n, grid);
}

// The blocks of the kernel an SM holds at once with `smem_bytes` of dynamic
// shared memory (0: it does not fit).  Returns a cudaError_t code.
int pogs_fused_hsde_blocks_per_sm(int is_double, int device, int smem_bytes, int* per_sm) {
  return is_double ? blocks_per_sm<double>(device, smem_bytes, per_sm)
                   : blocks_per_sm<float>(device, smem_bytes, per_sm);
}

// Launch the whole solve on `stream` with `grid` blocks and `smem_bytes` of
// dynamic shared memory; does not synchronise.  segs holds (kind, start,
// length, owner block) of each of the nseg SOC / exponential segments, in
// host memory.  Returns the cudaError_t of the launch (0 on success).
int pogs_fused_hsde(int is_double, int device, const void* A, const void* At,
                    const void* Kinv, const void* b, const void* c, const void* tx,
                    const void* ty, const int* code, const void* egrid,
                    const void* scal, void* ux, void* uy, void* wx, void* wy,
                    void* stats, void* work, int m, int n, int nseg, const int* segs,
                    double abs_tol, double rel_tol, int max_iter, int grid, int smem_bytes,
                    void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Kinv, b, c, tx, ty, code, egrid, scal, ux, uy,
                          wx, wy, stats, work, m, n, nseg, segs, abs_tol, rel_tol,
                          max_iter, grid, smem_bytes, stream);
  return launch<float>(device, A, At, Kinv, b, c, tx, ty, code, egrid, scal, ux, uy, wx,
                       wy, stats, work, m, n, nseg, segs, abs_tol, rel_tol, max_iter,
                       grid, smem_bytes, stream);
}

const char* pogs_fused_hsde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
