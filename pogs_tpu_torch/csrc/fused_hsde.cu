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
// unboundedness certificates with dominance and the confirmation burst.
//
// What bounds it on this card: every iteration reads A, A^T and Kinv once
// ((2mn + k^2) elements; a check iteration reads A and A^T once more).  At
// 804x200 that is 0.8 MB in f32, which stays in the 50 MB L2, so the solve
// is bound by latency: the grid-wide barriers between phases (5 per
// iteration tall, 7 wide, 4 more on a check) and the short per-warp dot
// products.  At 8004x2000 it is 144 MB per iteration, beyond L2, so the
// solve streams from HBM and is bound by memory bandwidth.
//
// What the design does about it: one launch runs every iteration (no launch
// or host round trip per iteration); A and A^T come as two row-major copies,
// so every matrix-vector product is one warp per output row with coalesced
// loads; a check's four extra products go as one paired pass over A and one
// over A^T, two dot products per row; the fixed-order reductions of
// coop.cuh keep every scalar decision (the check slot, the tau branch, the
// certificate latch, done) identical in every block.
//
// Second-order cones: a segment can be as long as m, so its tail norm is a
// grid-wide sum, one partial slot per segment, reduced before the scale
// step.  Exponential cones: one thread per 3-element segment runs the whole
// projection (the 65-point sign scan per branch, three brackets, 50 or 80
// bisection steps, the closest valid candidate), in __noinline__ device
// code; the scan points come from the caller, the same table the plain
// version uses.  Precise expf / exp, no fast math.

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

// Partial-sum slots.
enum Slot {
  S_CPX = 0, S_BPY,                                            // lin solve
  S_FPX, S_CWX, S_BWY, S_WX2, S_WY2,                           // x part
  S_SEG_V, S_FPY = S_SEG_V + kMaxSeg,                          // y part
  S_CXS, S_BYS, S_YS2, S_RDC, S_YCH,                           // check 1
  S_SEG_YS, S_SEG_WY = S_SEG_YS + kMaxSeg,
  S_SS2 = S_SEG_WY + kMaxSeg, S_RPRI, S_AXD, S_RDUA, S_ATY2,   // check 2
  S_ATYH2, S_RDC2, S_YCH2,
  S_SEG_SS, S_SEG_NAX = S_SEG_SS + kMaxSeg,                    // check 3
  S_RPRI2 = S_SEG_NAX + kMaxSeg, S_AXD2,                       // check 4
  kSlots
};

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

// Projection of (r, s, t) onto the exponential cone (cones/projections.py:
// _project_exp_primal_impl).  grid: the (2, 65) scan points.
template <typename T>
__device__ __noinline__ V3<T> exp_project(T r, T s, T t, int iters, const T* grid) {
  const ExpPoint<T> P{r, s, t};
  const T tol = ExpC<T>::tol();
  const T INF = ExpC<T>::big();
  // Candidates in the order of the plain version: v, ray, 0, six roots.
  V3<T> best{r, s, t};
  const T spos = tmax(s, Lim<T>::tiny());
  const bool in_cone = (s > tol && spos * safe_exp(r / spos) <= t + tol) ||
                       (m_fabs(s) <= tol && r <= tol && t >= -tol);
  T best_d = in_cone ? T(0) : INF;  // d2(v) = 0
  auto consider = [&](const V3<T>& c, bool valid) {
    const T dx = c.x - r, dy = c.y - s, dz = c.z - t;
    const T d = valid ? (dx * dx + dy * dy) + dz * dz : INF;
    if (d < best_d) { best = c; best_d = d; }
  };
  consider(V3<T>{neg(r), T(0), pos(t)}, true);
  consider(V3<T>{T(0), T(0), T(0)}, true);
  for (int br = 0; br < 2; ++br) {
    const T* us = grid + br * kGrid;
    T lo[kKeep], hi[kKeep];
    bool has[kKeep];
    for (int j = 0; j < kKeep; ++j) { lo[j] = us[0]; hi[j] = us[0]; has[j] = false; }
    T prev_u = us[0], prev_s = P.sign_F(prev_u);
    int count = 0;
    for (int g = 1; g < kGrid; ++g) {
      const T cur_u = us[g], cur_s = P.sign_F(cur_u);
      if (prev_s * cur_s <= T(0)) {
        if (count < kKeep) { lo[count] = prev_u; hi[count] = cur_u; has[count] = true; }
        ++count;
      }
      prev_u = cur_u;
      prev_s = cur_s;
    }
    for (int j = 0; j < kKeep; ++j) {
      if (!has[j]) continue;  // an invalid candidate is never taken
      const T u = P.bisect(lo[j], hi[j], iters);
      const T w = safe_exp(u);
      T denom = w * w + u;
      if (m_fabs(denom) < T(1e-30)) denom = T(1e-30);
      const T num = (r + t * w) / denom;
      const T z = w * num;
      const bool feas = z > T(0) && z - t >= -tol * (T(1) + m_fabs(t));
      consider(V3<T>{u * num, num, z}, feas);
    }
  }
  return best;
}

// Projection of a 3-element segment onto the cone of `kind`.
template <typename T>
__device__ V3<T> exp_segment(int kind, T a, T b, T c, const T* grid) {
  if (kind == kExpPrimal) return exp_project(a, b, c, 50, grid);
  const V3<T> p = exp_project(-a, -b, -c, 80, grid);  // Moreau
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
  T* q;             // (m) work (wide): A r, then Kinv A r
  T* q2;            // (m) work (wide)
  T* vy;            // (m) work: 2 wy - uy
  T* xs;            // (n) work (check): wx / tau
  T* ys;            // (m) work (check): wy / tau
  T* ss;            // (m) work (check): b - A xs
  T* nax;           // (m) work (check): -A wx
  T* partials;      // (kSlots, grid) work
  int m, n, nseg;
  int seg_kind[kMaxSeg], seg_start[kMaxSeg], seg_len[kMaxSeg];  // primal kinds
  T abs_tol, rel_tol;
  int max_iter;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_hsde_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T smem[2 * kMaxSeg * kWarps];
  __shared__ T red[kSlots];

  const int m = P.m, n = P.n, nseg = P.nseg;
  const bool tall = m >= n;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int gwarp = tid >> 5;
  const int nwarps = nthreads >> 5;
  // Exponential segment s is projected by lane 0 of warp s of block 0.
  const int my_seg = (blockIdx.x == 0 && lane == 0) ? (int)(threadIdx.x >> 5) : -1;
  const bool exp_thread = my_seg >= 0 && my_seg < nseg && P.seg_kind[my_seg] != kSOC;

  const T one = T(1), zero = T(0);
  const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
  const T s_den = P.scal[0], b_norm = P.scal[1], c_norm = P.scal[2];
  const T sqm = m_sqrt(T(m)), sqn = m_sqrt(T(n));
  const T fp_tol = abs_tol * m_sqrt(T(m + n + 1)) + rel_tol;
  const T cert_tol = abs_tol + rel_tol;
  const T eps_d = T(1e-12);

  T ut = P.scal[3], wt = zero, alpha = T(K_ALPHA_MIN), fp = one, prev_resid = ExpC<T>::big();
  T r_pri = zero, r_dua = zero, gap = zero;
  int k = 0, status = kMaxIter, cert_pending = 0;

  // wy and vy of row i from this iteration's solve (one formula for every
  // place that needs them).
  auto wy_at = [&](int i, T u_tau) { return __ldcg(P.py + i) - P.ty[i] * u_tau; };

  for (;;) {
    // --- The SMW solve: px = Kinv (ux - A^T uy), py = uy + A px. --------
    for (int rr = gwarp; rr < n; rr += nwarps) {
      const T s = warp_dot(P.At + (size_t)rr * m, P.uy, m, lane);
      if (lane == 0) P.r[rr] = __ldcg(P.ux + rr) - s;
    }
    grid.sync();
    {
      T v[1] = {zero};
      if (tall) {
        for (int rr = gwarp; rr < n; rr += nwarps) {
          const T s = warp_dot(P.Kinv + (size_t)rr * n, P.r, n, lane);
          if (lane == 0) { P.px[rr] = s; v[0] += P.c[rr] * s; }
        }
      } else {
        // Woodbury: px = r - A^T Kinv (A r), Kinv the m x m inverse.
        for (int i = gwarp; i < m; i += nwarps) {
          const T s = warp_dot(P.A + (size_t)i * n, P.r, n, lane);
          if (lane == 0) P.q[i] = s;
        }
        grid.sync();
        for (int i = gwarp; i < m; i += nwarps) {
          const T s = warp_dot(P.Kinv + (size_t)i * m, P.q, m, lane);
          if (lane == 0) P.q2[i] = s;
        }
        grid.sync();
        for (int rr = gwarp; rr < n; rr += nwarps) {
          const T s = warp_dot(P.At + (size_t)rr * m, P.q2, m, lane);
          if (lane == 0) {
            const T p = __ldcg(P.r + rr) - s;
            P.px[rr] = p;
            v[0] += P.c[rr] * p;
          }
        }
      }
      block_partials<T, 1>(v, P.partials, S_CPX, smem);
    }
    grid.sync();
    {
      T v[1] = {zero};
      for (int i = gwarp; i < m; i += nwarps) {
        const T s = warp_dot(P.A + (size_t)i * n, P.px, n, lane);
        if (lane == 0) {
          const T p = __ldcg(P.uy + i) + s;
          P.py[i] = p;
          v[0] += P.b[i] * p;
        }
      }
      block_partials<T, 1>(v, P.partials, S_BPY, smem);
    }
    grid.sync();
    grid_partials(P.partials, S_CPX, 2, red);
    const T u_tau = (ut + (red[S_CPX] + red[S_BPY])) / s_den;
    wt = u_tau;
    const T vt = T(2) * wt - ut;
    const T zt = pos(vt);

    // --- w, v = 2w - u, and the update of the x part and the separable rows.
    {
      T v[5] = {zero, zero, zero, zero, zero};  // fp_x, c.wx, b.wy, |wx|^2, |wy|^2
      for (int j = tid; j < n; j += nthreads) {
        const T cu = __ldcg(P.ux + j);
        const T w = __ldcg(P.px + j) - P.tx[j] * u_tau;
        const T vx = T(2) * w - cu;
        P.ux[j] = cu + alpha * (vx - w);
        P.wx[j] = w;
        v[0] += (vx - w) * (vx - w);
        v[1] += P.c[j] * w;
        v[3] += w * w;
      }
      for (int i = tid; i < m; i += nthreads) {
        const T cu = __ldcg(P.uy + i);
        const T w = wy_at(i, u_tau);
        const T vy = T(2) * w - cu;
        P.wy[i] = w;
        P.vy[i] = vy;
        v[2] += P.b[i] * w;
        v[4] += w * w;
        const int code = P.code[i];
        if (code < kSegRow) {
          const T z = proj_sep(code, vy, true);
          P.uy[i] = cu + alpha * (z - w);
          v[0] += (z - w) * (z - w);
        }
      }
      block_partials<T, 5>(v, P.partials, S_FPX, smem);
      // SOC tail norms of vy, one slot per segment.
      T sv[kMaxSeg];
#pragma unroll
      for (int s = 0; s < kMaxSeg; ++s) {
        sv[s] = zero;
        if (s < nseg && P.seg_kind[s] == kSOC) {
          const int end = P.seg_start[s] + P.seg_len[s];
          for (int i = P.seg_start[s] + 1 + tid; i < end; i += nthreads) {
            const T vy = T(2) * wy_at(i, u_tau) - __ldcg(P.uy + i);
            sv[s] += vy * vy;
          }
        }
      }
      block_partials<T, kMaxSeg>(sv, P.partials, S_SEG_V, smem);
    }
    grid.sync();
    grid_partials(P.partials, S_FPX, 5 + kMaxSeg, red);

    // --- The segment rows of the dual projection, and the fixed-point residual.
    {
      T v[1] = {zero};
      for (int i = tid; i < m; i += nthreads) {
        const int code = P.code[i];
        if (code < kSegRow) continue;
        const int s = code - kSegRow;
        if (P.seg_kind[s] != kSOC) continue;
        const int h = P.seg_start[s];
        const T vy = __ldcg(P.vy + i), w = __ldcg(P.wy + i);
        const T z = soc_row(i == h, vy, __ldcg(P.vy + h), m_sqrt(red[S_SEG_V + s]));
        P.uy[i] = __ldcg(P.uy + i) + alpha * (z - w);
        v[0] += (z - w) * (z - w);
      }
      if (exp_thread) {
        const int h = P.seg_start[my_seg];
        const V3<T> z = exp_segment(dual_kind(P.seg_kind[my_seg]), __ldcg(P.vy + h),
                                    __ldcg(P.vy + h + 1), __ldcg(P.vy + h + 2), P.grid);
        const T zz[3] = {z.x, z.y, z.z};
        for (int e = 0; e < 3; ++e) {
          const T w = __ldcg(P.wy + h + e);
          P.uy[h + e] = __ldcg(P.uy + h + e) + alpha * (zz[e] - w);
          v[0] += (zz[e] - w) * (zz[e] - w);
        }
      }
      block_partials<T, 1>(v, P.partials, S_FPY, smem);
    }
    grid.sync();
    grid_partials(P.partials, S_FPY, 1, red);
    fp = m_sqrt((red[S_FPX] + red[S_FPY]) + (zt - wt) * (zt - wt));
    ut = ut + alpha * (zt - wt);

    bool done_new = false;
    if (k % K_CHECK_EVERY == 0 || k >= P.max_iter - 1) {
      // --- The check: both tau branches, selected. -------------------------
      const T cwx = red[S_CWX], bwy = red[S_BWY], wx2 = red[S_WX2], wy2 = red[S_WY2];
      const T w_norm = m_sqrt(wx2 + wy2 + wt * wt);
      const bool tau_ok = wt > tmax(T(K_TAU_TOL), T(K_TAU_REL) * w_norm);
      const T tau = tau_ok ? wt : one;

      // C1: x_s, y_s; the separable rows of the dual distances of y_s and w_y.
      {
        T v[5] = {zero, zero, zero, zero, zero};  // c.xs, b.ys, |ys|^2, rdc, ych
        for (int j = tid; j < n; j += nthreads) {
          const T x = __ldcg(P.wx + j) / tau;
          P.xs[j] = x;
          v[0] += P.c[j] * x;
        }
        for (int i = tid; i < m; i += nthreads) {
          const T w = __ldcg(P.wy + i);
          const T y = w / tau;
          P.ys[i] = y;
          v[1] += P.b[i] * y;
          v[2] += y * y;
          const int code = P.code[i];
          if (code < kSegRow) {
            const T dy = y - proj_sep(code, y, true), dw = w - proj_sep(code, w, true);
            v[3] += dy * dy;
            v[4] += dw * dw;
          }
        }
        block_partials<T, 5>(v, P.partials, S_CXS, smem);
        T sy[kMaxSeg], sw[kMaxSeg];
#pragma unroll
        for (int s = 0; s < kMaxSeg; ++s) {
          sy[s] = zero;
          sw[s] = zero;
          if (s < nseg && P.seg_kind[s] == kSOC) {
            const int end = P.seg_start[s] + P.seg_len[s];
            for (int i = P.seg_start[s] + 1 + tid; i < end; i += nthreads) {
              const T w = __ldcg(P.wy + i);
              const T y = w / tau;
              sy[s] += y * y;
              sw[s] += w * w;
            }
          }
        }
        block_partials<T, kMaxSeg>(sy, P.partials, S_SEG_YS, smem);
        block_partials<T, kMaxSeg>(sw, P.partials, S_SEG_WY, smem);
      }
      grid.sync();
      grid_partials(P.partials, S_CXS, 5 + 2 * kMaxSeg, red);

      // C2: one paired pass over A (A x_s, A w_x) and one over A^T (A^T y_s,
      // A^T w_y); the segment rows of the dual distances.
      {
        T v[8] = {zero, zero, zero, zero, zero, zero, zero, zero};
        // |ss|^2, r_pri, ax_dist, r_dua, |aty|^2, |aty_h|^2, rdc, ych
        for (int rr = gwarp; rr < m + n; rr += nwarps) {
          if (rr < m) {
            T ax, axh;
            warp_dot2(P.A + (size_t)rr * n, P.xs, P.wx, n, lane, ax, axh);
            if (lane == 0) {
              const T s = P.b[rr] - ax, na = -axh;
              P.ss[rr] = s;
              P.nax[rr] = na;
              v[0] += s * s;
              const int code = P.code[rr];
              if (code < kSegRow) {
                const T ds = s - proj_sep(code, s, false), dn = na - proj_sep(code, na, false);
                v[1] += ds * ds;
                v[2] += dn * dn;
              }
            }
          } else {
            const int j = rr - m;
            T aty, atyh;
            warp_dot2(P.At + (size_t)j * m, P.ys, P.wy, m, lane, aty, atyh);
            if (lane == 0) {
              v[3] += (aty + P.c[j]) * (aty + P.c[j]);
              v[4] += aty * aty;
              v[5] += atyh * atyh;
            }
          }
        }
        for (int i = tid; i < m; i += nthreads) {
          const int code = P.code[i];
          if (code < kSegRow) continue;
          const int s = code - kSegRow;
          if (P.seg_kind[s] != kSOC) continue;
          const int h = P.seg_start[s];
          const T y = __ldcg(P.ys + i), w = __ldcg(P.wy + i);
          const T dy = y - soc_row(i == h, y, __ldcg(P.ys + h), m_sqrt(red[S_SEG_YS + s]));
          const T dw = w - soc_row(i == h, w, __ldcg(P.wy + h), m_sqrt(red[S_SEG_WY + s]));
          v[6] += dy * dy;
          v[7] += dw * dw;
        }
        if (exp_thread) {
          const int h = P.seg_start[my_seg], kind = dual_kind(P.seg_kind[my_seg]);
          const T* src[2] = {P.ys, P.wy};
          for (int q = 0; q < 2; ++q) {
            const T a = __ldcg(src[q] + h), b = __ldcg(src[q] + h + 1), c = __ldcg(src[q] + h + 2);
            const V3<T> z = exp_segment(kind, a, b, c, P.grid);
            v[6 + q] += ((a - z.x) * (a - z.x) + (b - z.y) * (b - z.y)) + (c - z.z) * (c - z.z);
          }
        }
        block_partials<T, 8>(v, P.partials, S_SS2, smem);
      }
      grid.sync();
      grid_partials(P.partials, S_SS2, 8, red);

      // C3: the SOC tail norms of s_s and -A w_x.
      {
        T ss[kMaxSeg], sn[kMaxSeg];
#pragma unroll
        for (int s = 0; s < kMaxSeg; ++s) {
          ss[s] = zero;
          sn[s] = zero;
          if (s < nseg && P.seg_kind[s] == kSOC) {
            const int end = P.seg_start[s] + P.seg_len[s];
            for (int i = P.seg_start[s] + 1 + tid; i < end; i += nthreads) {
              const T a = __ldcg(P.ss + i), b = __ldcg(P.nax + i);
              ss[s] += a * a;
              sn[s] += b * b;
            }
          }
        }
        block_partials<T, kMaxSeg>(ss, P.partials, S_SEG_SS, smem);
        block_partials<T, kMaxSeg>(sn, P.partials, S_SEG_NAX, smem);
      }
      grid.sync();
      grid_partials(P.partials, S_SEG_SS, 2 * kMaxSeg, red);

      // C4: the segment rows of the primal distances of s_s and -A w_x.
      {
        T v[2] = {zero, zero};
        for (int i = tid; i < m; i += nthreads) {
          const int code = P.code[i];
          if (code < kSegRow) continue;
          const int s = code - kSegRow;
          if (P.seg_kind[s] != kSOC) continue;
          const int h = P.seg_start[s];
          const T a = __ldcg(P.ss + i), b = __ldcg(P.nax + i);
          const T da = a - soc_row(i == h, a, __ldcg(P.ss + h), m_sqrt(red[S_SEG_SS + s]));
          const T db = b - soc_row(i == h, b, __ldcg(P.nax + h), m_sqrt(red[S_SEG_NAX + s]));
          v[0] += da * da;
          v[1] += db * db;
        }
        if (exp_thread) {
          const int h = P.seg_start[my_seg], kind = P.seg_kind[my_seg];
          const T* src[2] = {P.ss, P.nax};
          for (int q = 0; q < 2; ++q) {
            const T a = __ldcg(src[q] + h), b = __ldcg(src[q] + h + 1), c = __ldcg(src[q] + h + 2);
            const V3<T> z = exp_segment(kind, a, b, c, P.grid);
            v[q] += ((a - z.x) * (a - z.x) + (b - z.y) * (b - z.y)) + (c - z.z) * (c - z.z);
          }
        }
        block_partials<T, 2>(v, P.partials, S_RPRI2, smem);
      }
      grid.sync();
      grid_partials(P.partials, S_RPRI2, 2, red);

      // --- Scalars: identical in every block. --------------------------
      // tau > 0: the primal, dual and gap test.
      const T rp = m_sqrt(red[S_RPRI] + red[S_RPRI2]);
      const T rd = m_sqrt(red[S_RDUA]);
      const T r_dua_cone = m_sqrt(red[S_RDC] + red[S_RDC2]);
      const T eps_pri = sqm * abs_tol + rel_tol * tmax(b_norm, m_sqrt(red[S_SS2]));
      const T eps_dua = sqn * abs_tol + rel_tol * tmax(m_sqrt(red[S_ATY2]), c_norm);
      const T eps_cone = sqm * abs_tol + rel_tol * tmax(one, m_sqrt(red[S_YS2]));
      const T cx = red[S_CXS], by = red[S_BYS];
      const T g = m_fabs(cx + by);
      const T eps_gap = abs_tol + rel_tol * tmax(tmax(one, g), tmax(m_fabs(cx), m_fabs(by)));
      const T curr = rp + rd + r_dua_cone + g;
      const bool converged = rp <= eps_pri && rd <= eps_dua && r_dua_cone <= eps_cone &&
                             g <= eps_gap;

      // tau ~ 0: the certificates, by dominance, confirmed on a second firing.
      const T kappa = -cwx - bwy;
      const bool firm = kappa > T(K_KAPPA_TOL) && fp <= fp_tol;
      const T ax_dist = m_sqrt(red[S_AXD] + red[S_AXD2]);
      const T aty_h = m_sqrt(red[S_ATYH2]);
      const T y_cone_h = m_sqrt(red[S_YCH] + red[S_YCH2]);
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

template <typename T>
int grid_size(int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_hsde_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // One block per SM; zero means the block does not fit an SM at all.
  *grid = per_sm >= 1 ? sms : 0;
  return 0;
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Kinv, const void* b,
           const void* c, const void* tx, const void* ty, const int* code,
           const void* egrid, const void* scal, void* ux, void* uy, void* wx, void* wy,
           void* stats, void* work, int m, int n, int nseg, const int* segs,
           double abs_tol, double rel_tol, int max_iter, int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nseg < 0 || nseg > kMaxSeg) return (int)cudaErrorInvalidValue;
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
  P.xs = wk + 2 * n;
  P.py = wk + 3 * n;
  P.q = P.py + m;
  P.q2 = P.q + m;
  P.vy = P.q2 + m;
  P.ys = P.vy + m;
  P.ss = P.ys + m;
  P.nax = P.ss + m;
  P.partials = P.nax + m;
  P.m = m;
  P.n = n;
  P.nseg = nseg;
  for (int s = 0; s < kMaxSeg; ++s) {
    P.seg_kind[s] = s < nseg ? segs[3 * s] : 0;
    P.seg_start[s] = s < nseg ? segs[3 * s + 1] : 0;
    P.seg_len[s] = s < nseg ? segs[3 * s + 2] : 0;
  }
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_hsde_kernel<T>, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the work buffer the launch needs for a given grid.
long long pogs_fused_hsde_work_elems(int m, int n, int grid) {
  return 3LL * n + 7LL * m + (long long)kSlots * grid;
}

// The cooperative grid size (blocks) for the kernel on this device; 0 if the
// kernel cannot be made co-resident.  Returns a cudaError_t code.
int pogs_fused_hsde_grid(int is_double, int device, int* grid) {
  return is_double ? grid_size<double>(device, grid) : grid_size<float>(device, grid);
}

// Launch the whole solve on `stream`; does not synchronise.  segs holds
// (kind, start, length) of each of the nseg SOC / exponential segments, in
// host memory.  Returns the cudaError_t of the launch (0 on success).
int pogs_fused_hsde(int is_double, int device, const void* A, const void* At,
                    const void* Kinv, const void* b, const void* c, const void* tx,
                    const void* ty, const int* code, const void* egrid,
                    const void* scal, void* ux, void* uy, void* wx, void* wy,
                    void* stats, void* work, int m, int n, int nseg, const int* segs,
                    double abs_tol, double rel_tol, int max_iter, int grid,
                    void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Kinv, b, c, tx, ty, code, egrid, scal, ux, uy,
                          wx, wy, stats, work, m, n, nseg, segs, abs_tol, rel_tol,
                          max_iter, grid, stream);
  return launch<float>(device, A, At, Kinv, b, c, tx, ty, code, egrid, scal, ux, uy, wx,
                       wy, stats, work, m, n, nseg, segs, abs_tol, rel_tol, max_iter,
                       grid, stream);
}

const char* pogs_fused_hsde_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
