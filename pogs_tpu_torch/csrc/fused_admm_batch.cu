// K graph-form ADMM solves that share A, f and g, except for a per-lane c of
// g (a lambda-sweep) and an optional per-lane b of f (multi-right-hand-side),
// as ONE CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel pogs_tpu/ops/fused_admm_batch.py::
// fused_batched_lasso_sweep (body _kernel_body).  Its plain version is
// fused_batched_lasso_sweep_ref in pogs_tpu_torch/ops/fused_admm_batch.py,
// and both compute, lane for lane, what the single solve computes
// (csrc/fused_admm.cu): the prox of the 16-function library (prox.cuh) with
// the lane's c and b, gap and tolerances, alpha = 1.7, the projection
// through the explicit (G + I)^-1 (tall: x = Ginv (x0 + A^T y0), y = A x;
// wide: Woodbury), approximate residuals and, when a lane is within 10x of
// tolerance, its exact residuals, the per-lane spectral and balancing rho
// schedule, and the monotone done / converged / NaN latches.  x12, y12 and
// optval are latched at each lane's firing iteration, with its iteration
// count, status and rho.
//
// Layout: lanes are independent, so there is no grid-wide sync.  Block b
// owns lanes [b Kc, b Kc + Kc) (the last block fewer: no lane is padding)
// and runs the whole while-loop for them; it leaves when its last lane is
// done.  A lane's results do not depend on Kc or on its place in the block:
// every sum over a lane's vector runs in the same fixed order (block
// reductions by thread, then warp butterfly, then warps in order; matrix
// products by row group, then the row groups in order), and there are no
// atomics.  The caller allocates all state and scratch (the per-lane
// vectors live in `work`); the kernel allocates nothing.
//
// What bounds it on this card: per lane and iteration the projection is
// 2 (2mn + k^2) FLOPs (k = min(m, n)), and 4mn more when the exact
// residuals run.  The block reads A, A^T and Ginv once per iteration and
// applies every element to all its lanes: (2mn + k^2) elements per block and
// iteration, whatever Kc is.  At 500x300 f32 that is 1.5 MB, which stays in
// the 50 MB L2; at 5000x2500 it is 125 MB, which does not, and every block
// would stream it from HBM alone.  So this kernel is the route for sweeps
// whose matrices fit the L2 and are small, or carry many lanes
// (ops/fused_admm_batch.py::route_for); otherwise fused_admm_sweep.cu
// streams each matrix once per iteration over the whole card.  Below L2 a block is bound by the bytes it can keep in flight from
// L2 and by its slowest lane, not by FLOPs (8 lanes make 8 FMAs per element
// loaded), and it needs no grid sync.  So the wrapper takes the smallest Kc
// (1, 2, 4 or 8) whose blocks all fit the card in one wave: more blocks
// stream more bytes at once, and a block of few lanes waits less for its
// slowest lane.
//
// Matrix products: the block's lane vectors are staged through shared
// memory in tiles of kTR rows; each thread owns one column of a kTX-wide
// tile and a quarter of the rows, loads each matrix element once (coalesced,
// through the read-only path) and applies it to every lane in registers.
// Plain f32 or f64 FMA on the CUDA cores: no TF32, no tensor cores (wgmma is
// for a later change).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "prox.cuh"

namespace {

using namespace pogs;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLanes = 8;           // Kc is 1, 2, 4 or 8
constexpr int kTX = 128;               // columns of a product tile
constexpr int kTY = kThreads / kTX;    // row groups of a product tile
constexpr int kTR = 128;               // rows of a staged lane-vector tile
constexpr int kSums = 6;               // sums per lane and reduction, at most

template <typename T> struct Shared {
  T vs[kMaxLanes][kTR];             // a tile of the block's lane vectors
  T part[kTY][kMaxLanes][kTX];      // per-row-group partial products
  T wsum[kSums][kWarps];            // warp sums of a block reduction
  T sums[kMaxLanes][kSums];         // phase A sums per lane
  T rsums[kMaxLanes][kSums];        // residual sums per lane
  T esums[kMaxLanes][2];            // exact-residual sums per lane
  T osum[kMaxLanes];                // optval per lane
  // Per-lane scalar state, owned by thread l for lane l.
  T rho[kMaxLanes], delta[kMaxLanes], xi[kMaxLanes], kd[kMaxLanes], ku[kMaxLanes];
  T zt_scale[kMaxLanes], nrm_r_a[kMaxLanes], nrm_s_a[kMaxLanes];
  int k[kMaxLanes], done[kMaxLanes], fire[kMaxLanes], status[kMaxLanes];
  int near[kMaxLanes];
};

template <typename T> struct Params {
  const T* A;      // (m, n) row-major, equilibrated
  const T* At;     // (n, m) row-major, A transposed
  const T* Ginv;   // (k, k), k = min(m, n), symmetric
  const int* hf;   // (m) function codes of f
  const T* fp;     // (5, m) a, b, c, d, e of the scaled f
  const int* hg;   // (n)
  const T* gp;     // (5, n) a, b, -, d, e of the scaled g (c is per lane)
  const T* cb;     // (K, n) per-lane c of g
  const T* fbb;    // (K, m) per-lane b of f, or null: fp's b for every lane
  const T* scal;   // [rho0, norm_A]
  T* x12;          // (K, n) out
  T* y12;          // (K, m) out
  T* stats;        // (K, 4) out: optval, iterations, status, rho
  T* work;         // (K, lane_elems) per-lane vectors
  int m, n, K, kc;
  T abs_tol, rel_tol;
  int max_iter, gap_stop, adaptive_rho;
};

// Offsets of the per-lane vectors in a lane's slice of `work`.
struct Layout {
  size_t N, k, m;
  __host__ __device__ Layout(int m_, int n_)
      : N((size_t)m_ + n_), k(m_ < n_ ? m_ : n_), m(m_) {}
  __host__ __device__ size_t z() const { return 0; }          // (N) iterate [x; y]
  __host__ __device__ size_t zt() const { return N; }         // (N) scaled dual
  __host__ __device__ size_t p() const { return 2 * N; }      // (N) prox [x12; y12]
  __host__ __device__ size_t zor() const { return 3 * N; }    // (N) projection input
  __host__ __device__ size_t zn() const { return 4 * N; }     // (N) projected iterate
  __host__ __device__ size_t rhs() const { return 5 * N; }    // (k)
  __host__ __device__ size_t w() const { return 5 * N + k; }  // (k)
  __host__ __device__ size_t sdual() const { return 5 * N + 2 * k; }  // (m) y12 + zt_y - z_y
  __host__ __device__ size_t res() const { return 5 * N + 2 * k + m; }  // (N) [r; s]
  __host__ __device__ size_t elems() const { return 6 * N + 2 * k + m; }
};

// Block sum of NS per-thread values into out[0..NS): warp butterflies, then
// the warps in order.  Every thread must call it.
template <typename T, int NS>
__device__ void block_sums(const T (&v)[NS], T* out, Shared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T w = warp_sum(v[s]);
    if (lane == 0) sh.wsum[s][warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    T acc = T(0);
    for (int w = 0; w < kWarps; ++w) acc += sh.wsum[threadIdx.x][w];
    out[threadIdx.x] = acc;
  }
  __syncthreads();
}

// out[l, c] = sum_r V[l, r] M[r, c] for the block's nl <= KC lanes, handed
// to epi(l, c, value).  V rows are lane vectors in global memory (stride
// ldv), written earlier by this block; M is a read-only (R, C) row-major
// matrix.  Every thread must call it; it ends with a block barrier.
template <typename T, int KC, typename Epi>
__device__ void lanes_times(const T* V, size_t ldv, int nl, int R,
                            const T* __restrict__ M, int C, Shared<T>& sh, Epi epi) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  for (int c0 = 0; c0 < C; c0 += kTX) {
    const int c = c0 + tx;
    T acc[KC];
#pragma unroll
    for (int l = 0; l < KC; ++l) acc[l] = T(0);
    for (int r0 = 0; r0 < R; r0 += kTR) {
      const int rn = R - r0 < kTR ? R - r0 : kTR;
      __syncthreads();  // the previous tile is consumed
      for (int e = threadIdx.x; e < KC * kTR; e += kThreads) {
        const int l = e / kTR, r = e % kTR;
        sh.vs[l][r] = (l < nl && r < rn) ? V[l * ldv + r0 + r] : T(0);
      }
      __syncthreads();
      if (c < C) {
        const T* mp = M + (size_t)(r0 + ty) * C + c;
#pragma unroll 4
        for (int r = ty; r < rn; r += kTY) {
          const T mv = __ldg(mp);
          mp += (size_t)kTY * C;
#pragma unroll
          for (int l = 0; l < KC; ++l) acc[l] += sh.vs[l][r] * mv;
        }
      }
    }
#pragma unroll
    for (int l = 0; l < KC; ++l) sh.part[ty][l][tx] = acc[l];
    __syncthreads();
    for (int e = threadIdx.x; e < nl * kTX; e += kThreads) {
      const int l = e / kTX, x = e % kTX, cc = c0 + x;
      if (cc < C) {
        T s = sh.part[0][l][x];
#pragma unroll
        for (int y = 1; y < kTY; ++y) s += sh.part[y][l][x];
        epi(l, cc, s);
      }
    }
  }
  __syncthreads();
}

// The product above for the block's Kc, a launch constant.
template <typename T, typename Epi>
__device__ void product(int kc, const T* V, size_t ldv, int nl, int R, const T* M, int C,
                        Shared<T>& sh, Epi epi) {
  switch (kc) {
    case 1: lanes_times<T, 1>(V, ldv, nl, R, M, C, sh, epi); break;
    case 2: lanes_times<T, 2>(V, ldv, nl, R, M, C, sh, epi); break;
    case 4: lanes_times<T, 4>(V, ldv, nl, R, M, C, sh, epi); break;
    default: lanes_times<T, 8>(V, ldv, nl, R, M, C, sh, epi); break;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) batch_kernel(Params<T> P) {
  __shared__ Shared<T> sh;
  const int m = P.m, n = P.n, N = m + n, tid = threadIdx.x;
  const bool tall = m >= n;
  const Layout L(m, n);
  const size_t W = L.elems();
  const int lane0 = blockIdx.x * P.kc;
  const int nl = P.kc < P.K - lane0 ? P.kc : P.K - lane0;
  T* const base = P.work + (size_t)lane0 * W;

  const T one = T(1), alpha = T(1.7);
  const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
  const T sqrtn_atol = m_sqrt(T(n)) * abs_tol;
  const T sqrtm_atol = m_sqrt(T(m)) * abs_tol;
  const T sqrtmn_atol = m_sqrt(T(m + n)) * abs_tol;
  const T norm_A = P.scal[1];

  // Cold start: z = z~ = 0.
  for (int l = 0; l < nl; ++l)
    for (int i = tid; i < 2 * N; i += kThreads) base[l * W + i] = T(0);
  if (tid < nl) {
    sh.rho[tid] = P.scal[0];
    sh.delta[tid] = T(K_DELTA_MIN);
    sh.xi[tid] = one;
    sh.kd[tid] = T(0);
    sh.ku[tid] = T(0);
    sh.k[tid] = 0;
    sh.done[tid] = 0;
  }
  __syncthreads();

  for (;;) {
    // --- Phase A: prox, gap sums, over-relaxed projection input. --------
    for (int l = 0; l < nl; ++l) {
      if (sh.done[l]) continue;
      T* const V = base + l * W;
      const int g = lane0 + l;
      const T rho = sh.rho[l];
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int idx = tid; idx < N; idx += kThreads) {
        const T cz = V[L.z() + idx], czt = V[L.zt() + idx];
        const T in = cz - czt;
        T p;
        int o;
        if (idx < n) {
          const int j = idx;
          p = prox_full(P.hg[j], P.gp[j], P.gp[n + j], P.cb[(size_t)g * n + j],
                        P.gp[3 * n + j], P.gp[4 * n + j], in, rho);
          o = 0;
        } else {
          const int i = idx - n;
          const T b = P.fbb ? P.fbb[(size_t)g * m + i] : P.fp[m + i];
          p = prox_full(P.hf[i], P.fp[i], b, P.fp[2 * m + i], P.fp[3 * m + i],
                        P.fp[4 * m + i], in, rho);
          o = 3;
        }
        const T zm = in - p;
        V[L.p() + idx] = p;
        V[L.zor() + idx] = czt + alpha * p + (one - alpha) * cz;
        v[o] += zm * p;
        v[o + 1] += zm * zm;
        v[o + 2] += p * p;
      }
      block_sums<T, 6>(v, sh.sums[l], sh);
    }

    // --- Phases B, C, D: the projection, one product per phase. ---------
    const int kc = P.kc;
    if (tall) {
      // rhs = x0 + A^T y0
      product(kc, base + L.zor() + n, W, nl, m, P.A, n, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.rhs() + c] = V[L.zor() + c] + s;
      });
      // x = Ginv rhs
      product(kc, base + L.rhs(), W, nl, n, P.Ginv, n, sh, [&](int l, int c, T s) {
        base[l * W + L.zn() + c] = s;
      });
      // y = A x
      product(kc, base + L.zn(), W, nl, n, P.At, m, sh, [&](int l, int c, T s) {
        base[l * W + L.zn() + n + c] = s;
      });
    } else {
      // rhs = A x0 - y0
      product(kc, base + L.zor(), W, nl, n, P.At, m, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.rhs() + c] = s - V[L.zor() + n + c];
      });
      // w = Ginv rhs, y = y0 + w
      product(kc, base + L.rhs(), W, nl, m, P.Ginv, m, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.w() + c] = s;
        V[L.zn() + n + c] = V[L.zor() + n + c] + s;
      });
      // x = x0 - A^T w
      product(kc, base + L.w(), W, nl, m, P.A, n, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.zn() + c] = V[L.zor() + c] - s;
      });
    }

    // --- Residual sums; the input of the exact dual residual. -----------
    // rsums = [|dy_prev|^2, |dy12|^2, sum y_new, |dx_prev|^2, |dx12|^2, sum x_new]
    for (int l = 0; l < nl; ++l) {
      if (sh.done[l]) continue;
      T* const V = base + l * W;
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int idx = tid; idx < N; idx += kThreads) {
        const T zn = V[L.zn() + idx], cz = V[L.z() + idx], ph = V[L.p() + idx];
        const T dp = cz - zn, d12 = ph - zn;
        const int o = idx < n ? 3 : 0;
        v[o] += dp * dp;
        v[o + 1] += d12 * d12;
        v[o + 2] += zn;
        if (idx >= n) V[L.sdual() + idx - n] = ph + V[L.zt() + idx] - cz;
      }
      block_sums<T, 6>(v, sh.rsums[l], sh);
    }

    // --- Per-lane approximate residuals and the near-tolerance test. ----
    if (tid < nl && !sh.done[tid]) {
      const int l = tid;
      const T* S = sh.sums[l];
      const T* R = sh.rsums[l];
      const T rho = sh.rho[l];
      const T eps_pri = sqrtm_atol + rel_tol * m_sqrt(S[5]);
      const T eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(S[1]));
      const T nrm_s_a = rho * (norm_A * m_sqrt(R[0]) + m_sqrt(R[3]));
      const T nrm_r_a = norm_A * m_sqrt(R[4]) + m_sqrt(R[1]);
      sh.nrm_s_a[l] = nrm_s_a;
      sh.nrm_r_a[l] = nrm_r_a;
      sh.near[l] = nrm_r_a < T(10) * eps_pri && nrm_s_a < T(10) * eps_dua;
    }
    __syncthreads();
    bool any_near = false;
    for (int l = 0; l < nl; ++l) any_near = any_near || (!sh.done[l] && sh.near[l]);

    // --- Phase E: exact residuals r = A x12 - y12, s = A^T(...) + (...),
    // for the whole block when one of its lanes is near tolerance. -------
    if (any_near) {
      product(kc, base + L.p(), W, nl, n, P.At, m, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.res() + c] = s - V[L.p() + n + c];
      });
      product(kc, base + L.sdual(), W, nl, m, P.A, n, sh, [&](int l, int c, T s) {
        T* V = base + l * W;
        V[L.res() + m + c] = s + (V[L.p() + c] + V[L.zt() + c] - V[L.z() + c]);
      });
      for (int l = 0; l < nl; ++l) {
        if (sh.done[l] || !sh.near[l]) continue;
        const T* V = base + l * W;
        T v[2] = {T(0), T(0)};
        for (int i = tid; i < N; i += kThreads) {
          const T x = V[L.res() + i];
          v[i < m ? 0 : 1] += x * x;
        }
        block_sums<T, 2>(v, sh.esums[l], sh);
      }
    }

    // --- Per-lane decisions: converged, NaN, done; the rho schedule. ----
    if (tid < nl && !sh.done[tid]) {
      const int l = tid;
      const T* S = sh.sums[l];
      const T* R = sh.rsums[l];
      const T rho = sh.rho[l];
      const T gap = m_fabs(S[0] + S[3]);
      const T eps_gap = sqrtmn_atol + rel_tol * m_sqrt(S[1] + S[4]) * m_sqrt(S[2] + S[5]);
      const T eps_pri = sqrtm_atol + rel_tol * m_sqrt(S[5]);
      const T eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(S[1]));
      const bool near = sh.near[l];
      const T nrm_r = near ? m_sqrt(sh.esums[l][0]) : sh.nrm_r_a[l];
      const T nrm_s = near ? rho * m_sqrt(sh.esums[l][1]) : sh.nrm_s_a[l];
      bool conv_now = near && nrm_r < eps_pri && nrm_s < eps_dua;
      if (P.gap_stop) conv_now = conv_now && gap < eps_gap;
      const bool nan_now = !(m_finite(nrm_r) && m_finite(R[2] + R[5]));
      const int k = sh.k[l];
      const bool done_now = conv_now || nan_now || k >= P.max_iter - 1;
      sh.fire[l] = done_now;
      T zt_scale = one;
      if (done_now) {
        sh.status[l] = conv_now ? kSuccess : (nan_now ? kNanFound : kMaxIter);
      } else {
        if (P.adaptive_rho)
          zt_scale = rho_schedule_step(k, nrm_r, nrm_s, eps_pri, eps_dua, sh.rho[l],
                                       sh.delta[l], sh.xi[l], sh.kd[l], sh.ku[l]);
        sh.k[l] = k + 1;
      }
      sh.zt_scale[l] = zt_scale;
    }
    __syncthreads();

    // --- Phase F: latch a firing lane's results; otherwise the dual update
    // with the rho rescale and z <- z_new. -------------------------------
    for (int l = 0; l < nl; ++l) {
      if (sh.done[l]) continue;
      T* const V = base + l * W;
      const int g = lane0 + l;
      if (sh.fire[l]) {
        T v[1] = {T(0)};
        for (int idx = tid; idx < N; idx += kThreads) {
          const T x = V[L.p() + idx];
          T a, b, c, d, e;
          int h;
          if (idx < n) {
            const int j = idx;
            h = P.hg[j];
            a = P.gp[j]; b = P.gp[n + j]; c = P.cb[(size_t)g * n + j];
            d = P.gp[3 * n + j]; e = P.gp[4 * n + j];
            P.x12[(size_t)g * n + j] = x;
          } else {
            const int i = idx - n;
            h = P.hf[i];
            a = P.fp[i]; b = P.fbb ? P.fbb[(size_t)g * m + i] : P.fp[m + i];
            c = P.fp[2 * m + i]; d = P.fp[3 * m + i]; e = P.fp[4 * m + i];
            P.y12[(size_t)g * m + i] = x;
          }
          v[0] += c * func_base(h, a * x - b) + d * x + T(0.5) * e * x * x;
        }
        block_sums<T, 1>(v, &sh.osum[l], sh);
        if (tid == 0) {
          T* st = P.stats + (size_t)g * 4;
          st[0] = sh.osum[l];
          st[1] = T(sh.k[l]);
          st[2] = T(sh.status[l]);
          st[3] = sh.rho[l];
        }
      } else {
        const T scale = sh.zt_scale[l];
        for (int idx = tid; idx < N; idx += kThreads) {
          const T cz = V[L.z() + idx], zn = V[L.zn() + idx];
          const T zt = V[L.zt() + idx] + alpha * V[L.p() + idx] + (one - alpha) * cz - zn;
          V[L.zt() + idx] = zt * scale;
          V[L.z() + idx] = zn;
        }
      }
    }
    __syncthreads();
    if (tid < nl && sh.fire[tid]) sh.done[tid] = 1;
    __syncthreads();
    bool all_done = true;
    for (int l = 0; l < nl; ++l) all_done = all_done && sh.done[l];
    if (all_done) break;
  }
}

template <typename T>
int slots(int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, batch_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Ginv, const int* hf,
           const void* fp, const int* hg, const void* gp, const void* cb, const void* fbb,
           const void* scal, void* x12, void* y12, void* stats, void* work, int m, int n,
           int K, int kc, double abs_tol, double rel_tol, int max_iter, int gap_stop,
           int adaptive_rho, void* stream) {
  if (kc != 1 && kc != 2 && kc != 4 && kc != kMaxLanes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
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
  P.kc = kc;
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  P.gap_stop = gap_stop;
  P.adaptive_rho = adaptive_rho;
  const int grid = (K + kc - 1) / kc;
  batch_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the per-lane scratch the launch needs for K lanes.
long long pogs_batch_work_elems(int m, int n, int K) {
  return (long long)Layout(m, n).elems() * K;
}

// Blocks of the kernel the device holds at once (SMs x resident blocks per
// SM).  Returns a cudaError_t code.
int pogs_batch_slots(int is_double, int device, int* out) {
  return is_double ? slots<double>(device, out) : slots<float>(device, out);
}

// Launch the sweep on `stream` with Kc = kc lanes per block; does not
// synchronise.  Returns the cudaError_t of the launch (0 on success).
int pogs_batch_sweep(int is_double, int device, const void* A, const void* At,
                     const void* Ginv, const int* hf, const void* fp, const int* hg,
                     const void* gp, const void* cb, const void* fbb, const void* scal,
                     void* x12, void* y12, void* stats, void* work, int m, int n, int K,
                     int kc, double abs_tol, double rel_tol, int max_iter, int gap_stop,
                     int adaptive_rho, void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats,
                          work, m, n, K, kc, abs_tol, rel_tol, max_iter, gap_stop,
                          adaptive_rho, stream);
  return launch<float>(device, A, At, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats,
                       work, m, n, K, kc, abs_tol, rel_tol, max_iter, gap_stop, adaptive_rho,
                       stream);
}

const char* pogs_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
