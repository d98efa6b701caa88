// The whole graph-form ADMM solve for a dense A as ONE persistent
// cooperative CUDA kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pogs_tpu/ops/fused_admm.py::fused_admm_loop
// (body _kernel_body).  Same algorithm and constants as the eager loop in
// pogs_tpu_torch/solver/admm.py, which is this kernel's plain version:
// prox of the 16-function library under the (a,b,c,d,e) transform (in the
// shared header prox.cuh), gap and tolerances, alpha = 1.7 over-relaxation,
// projection through the explicit (G + I)^-1 (tall: x = Ginv (x0 + A^T y0),
// y = A x; wide: Woodbury),
// approximate residuals, exact residuals (two more matvecs) only within 10x
// of tolerance, spectral and balancing adaptive rho with the z~ rescale, the
// done / converged / NaN latches, and at exit optval, the scaled duals, the
// warm-start z / z~ and a stats vector.
//
// What bounds it on this card: every iteration re-reads A, A^T and Ginv
// (4 (2mn + k^2) bytes in f32).  At 500x300 that is about 1.5 MB, which
// stays in the 50 MB L2, so the solve is bound by latency: the grid-wide
// barriers between phases (4 per iteration, 5 when the exact residuals
// run) and the short per-warp dot products.  At 5000x2500 it is about
// 125 MB per iteration, which streams from HBM at 3.35 TB/s, so the solve
// is bound by memory bandwidth.
//
// What the design does about it: one launch runs every iteration, so there
// is no launch or host round trip per iteration, and the vectors stay in
// L2 between phases.  A and A^T come as two row-major copies, so each
// matvec is one warp per output row with coalesced loads of the row and of
// the vector; Ginv is symmetric, so its rows serve as its columns.  The
// grid is one block per SM (all co-resident, checked with the occupancy
// API), and phases are separated by cooperative_groups grid syncs.
//
// Determinism across blocks: every scalar decision (near, converged, the
// rho update, done) must be identical in every block; the fixed-order
// reductions of coop.cuh (shared with the cone kernel, fused_hsde.cu) give
// every block bit-identical scalars, so all leave the loop on the same
// iteration.  All state and scratch are allocated by the caller; the kernel
// allocates nothing.

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pogs;

constexpr int kSlots = 16;  // partial-sum slots per block

template <typename T> struct Params {
  const T* A;      // (m, n) row-major, equilibrated
  const T* At;     // (n, m) row-major, A transposed
  const T* Ginv;   // (k, k), k = min(m, n), symmetric
  const int* hf;   // (m) function codes of f
  const T* fp;     // (5, m) a, b, c, d, e of the scaled f
  const int* hg;   // (n)
  const T* gp;     // (5, n)
  const T* scal;   // [rho0, norm_A]
  T* xy12;         // (n + m) out: [x12; y12]
  T* munu;         // (n + m) out: scaled [mu; nu]
  T* z;            // (n + m) in: warm-start z0; state; out: last complete z
  T* zt;           // (n + m) in: zt0; state; out: zt
  T* znew;         // (n + m) work: projected iterate
  T* zor;          // (n + m) work: over-relaxed projection input
  T* rhs;          // (k) work
  T* w;            // (k) work (wide case)
  T* sin;          // (m) work: y12 + zt_y - z_y for the exact dual residual
  T* partials;     // (kSlots, grid) work
  T* stats;        // (9) out: optval, iters, status, rho, nrm_r, nrm_s, gap, eps_pri, eps_dua
  int m, n;
  T abs_tol, rel_tol;
  int max_iter;
  int gap_stop;
  int adaptive_rho;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fused_admm_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  __shared__ T smem[8 * kWarps];
  __shared__ T red[kSlots];

  const int m = P.m, n = P.n, N = m + n;
  const bool tall = m >= n;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31;
  const int gwarp = tid >> 5;
  const int nwarps = nthreads >> 5;

  const T one = T(1), alpha = T(1.7);
  const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
  const T sqrtn_atol = m_sqrt(T(n)) * abs_tol;
  const T sqrtm_atol = m_sqrt(T(m)) * abs_tol;
  const T sqrtmn_atol = m_sqrt(T(m + n)) * abs_tol;

  T rho = P.scal[0];
  const T norm_A = P.scal[1];
  T delta = T(K_DELTA_MIN), xi = T(1), kd = T(0), ku = T(0);
  int k = 0;
  bool converged = false, nan_found = false;
  T nrm_r, nrm_s, gap, eps_pri, eps_dua;

  T* const x12 = P.xy12;
  T* const y12 = P.xy12 + n;

  for (;;) {
    // --- Phase A: prox, gap sums, over-relaxed projection input. --------
    {
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      for (int idx = tid; idx < N; idx += nthreads) {
        const bool is_x = idx < n;
        const int i = is_x ? idx : idx - n;
        const T* pp = is_x ? P.gp : P.fp;
        const int len = is_x ? n : m;
        const int h = is_x ? P.hg[i] : P.hf[i];
        const T cz = P.z[idx], czt = P.zt[idx];
        const T in = cz - czt;
        const T p = prox_full(h, pp[i], pp[len + i], pp[2 * len + i],
                              pp[3 * len + i], pp[4 * len + i], in, rho);
        const T zm = in - p;
        P.xy12[idx] = p;
        P.zor[idx] = czt + alpha * p + (one - alpha) * cz;
        const int o = is_x ? 0 : 3;
        v[o] += zm * p;
        v[o + 1] += zm * zm;
        v[o + 2] += p * p;
      }
      block_partials<T, 6>(v, P.partials, 0, smem);
    }
    grid.sync();
    grid_partials(P.partials, 0, 6, red);

    // --- Phases B, C: the projection through Ginv. ---------------------
    if (tall) {
      // rhs = x0 + A^T y0  (rows of A^T)
      for (int r = gwarp; r < n; r += nwarps) {
        T s = warp_dot(P.At + (size_t)r * m, P.zor + n, m, lane);
        if (lane == 0) P.rhs[r] = __ldcg(P.zor + r) + s;
      }
      grid.sync();
      // x = Ginv rhs
      for (int r = gwarp; r < n; r += nwarps) {
        T s = warp_dot(P.Ginv + (size_t)r * n, P.rhs, n, lane);
        if (lane == 0) P.znew[r] = s;
      }
    } else {
      // rhs = A x0 - y0
      for (int r = gwarp; r < m; r += nwarps) {
        T s = warp_dot(P.A + (size_t)r * n, P.zor, n, lane);
        if (lane == 0) P.rhs[r] = s - __ldcg(P.zor + n + r);
      }
      grid.sync();
      // w = Ginv rhs, y = y0 + w
      for (int r = gwarp; r < m; r += nwarps) {
        T s = warp_dot(P.Ginv + (size_t)r * m, P.rhs, m, lane);
        if (lane == 0) {
          P.w[r] = s;
          P.znew[n + r] = __ldcg(P.zor + n + r) + s;
        }
      }
    }
    grid.sync();

    // --- Phase D: the other half of the projection + residual sums. ----
    // v = [|dy_prev|^2, |dy12|^2, sum y_new, |dx_prev|^2, |dx12|^2, sum x_new]
    {
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (tall) {
        // y = A x, one warp per row; the y-part sums in lane 0.
        for (int r = gwarp; r < m; r += nwarps) {
          T s = warp_dot(P.A + (size_t)r * n, P.znew, n, lane);
          if (lane == 0) {
            P.znew[n + r] = s;
            const T cy = __ldcg(P.z + n + r), yh = __ldcg(y12 + r);
            const T dp = cy - s, d12 = yh - s;
            v[0] += dp * dp; v[1] += d12 * d12; v[2] += s;
            P.sin[r] = yh + __ldcg(P.zt + n + r) - cy;
          }
        }
        for (int j = tid; j < n; j += nthreads) {
          const T xn = __ldcg(P.znew + j);
          const T dp = __ldcg(P.z + j) - xn, d12 = __ldcg(x12 + j) - xn;
          v[3] += dp * dp; v[4] += d12 * d12; v[5] += xn;
        }
      } else {
        // x = x0 - A^T w, one warp per row of A^T; the x-part sums in lane 0.
        for (int r = gwarp; r < n; r += nwarps) {
          T s = warp_dot(P.At + (size_t)r * m, P.w, m, lane);
          if (lane == 0) {
            const T xn = __ldcg(P.zor + r) - s;
            P.znew[r] = xn;
            const T dp = __ldcg(P.z + r) - xn, d12 = __ldcg(x12 + r) - xn;
            v[3] += dp * dp; v[4] += d12 * d12; v[5] += xn;
          }
        }
        for (int i = tid; i < m; i += nthreads) {
          const T yn = __ldcg(P.znew + n + i);
          const T cy = __ldcg(P.z + n + i), yh = __ldcg(y12 + i);
          const T dp = cy - yn, d12 = yh - yn;
          v[0] += dp * dp; v[1] += d12 * d12; v[2] += yn;
          P.sin[i] = yh + __ldcg(P.zt + n + i) - cy;
        }
      }
      block_partials<T, 6>(v, P.partials, 6, smem);
    }
    grid.sync();
    grid_partials(P.partials, 6, 6, red);

    // --- Scalars: identical in every block. ----------------------------
    const T zmx_x12 = red[0], zmx2 = red[1], x12_2 = red[2];
    const T zmy_y12 = red[3], zmy2 = red[4], y12_2 = red[5];
    gap = m_fabs(zmx_x12 + zmy_y12);
    const T eps_gap = sqrtmn_atol + rel_tol * m_sqrt(zmx2 + zmy2) * m_sqrt(x12_2 + y12_2);
    eps_pri = sqrtm_atol + rel_tol * m_sqrt(y12_2);
    eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(zmx2));
    nrm_s = rho * (norm_A * m_sqrt(red[6]) + m_sqrt(red[9]));
    nrm_r = norm_A * m_sqrt(red[10]) + m_sqrt(red[7]);
    const T new_sum = red[8] + red[11];

    const bool near = nrm_r < T(10) * eps_pri && nrm_s < T(10) * eps_dua;
    if (near) {
      // --- Phase E: exact residuals r = A x12 - y12, s = A^T(...) + (...).
      T v[2] = {T(0), T(0)};
      for (int r = gwarp; r < N; r += nwarps) {
        if (r < m) {
          T s = warp_dot(P.A + (size_t)r * n, x12, n, lane);
          if (lane == 0) {
            const T rv = s - __ldcg(y12 + r);
            v[0] += rv * rv;
          }
        } else {
          const int j = r - m;
          T s = warp_dot(P.At + (size_t)j * m, P.sin, m, lane);
          if (lane == 0) {
            const T sv = s + (__ldcg(x12 + j) + __ldcg(P.zt + j) - __ldcg(P.z + j));
            v[1] += sv * sv;
          }
        }
      }
      block_partials<T, 2>(v, P.partials, 12, smem);
      grid.sync();
      grid_partials(P.partials, 12, 2, red);
      nrm_r = m_sqrt(red[12]);
      nrm_s = rho * m_sqrt(red[13]);
    }

    bool conv_now = near && nrm_r < eps_pri && nrm_s < eps_dua;
    if (P.gap_stop) conv_now = conv_now && gap < eps_gap;
    const bool nan_now = !(m_finite(nrm_r) && m_finite(new_sum));
    const bool done = conv_now || nan_now || k >= P.max_iter - 1;
    if (done) {
      converged = conv_now;
      nan_found = nan_now;
      break;
    }

    // --- Adaptive rho (pogs.cpp:401-466). ------------------------------
    T zt_scale = one;
    if (P.adaptive_rho)
      zt_scale = rho_schedule_step(k, nrm_r, nrm_s, eps_pri, eps_dua, rho, delta, xi, kd, ku);

    // --- Phase F: dual update with the rho rescale; z <- z_new. -------
    // Same index mapping as phase A, so no grid sync is needed between them.
    for (int idx = tid; idx < N; idx += nthreads) {
      const T cz = P.z[idx], zn = __ldcg(P.znew + idx);
      P.zt[idx] = (P.zt[idx] + alpha * P.xy12[idx] + (one - alpha) * cz - zn) * zt_scale;
      P.z[idx] = zn;
    }
    ++k;
  }

  // --- Exit: optval, scaled duals, stats. ------------------------------
  {
    T v[1] = {T(0)};
    for (int idx = tid; idx < N; idx += nthreads) {
      const bool is_x = idx < n;
      const int i = is_x ? idx : idx - n;
      const T* pp = is_x ? P.gp : P.fp;
      const int len = is_x ? n : m;
      const int h = is_x ? P.hg[i] : P.hf[i];
      const T a = pp[i], b = pp[len + i], c = pp[2 * len + i];
      const T d = pp[3 * len + i], e = pp[4 * len + i];
      const T x = P.xy12[idx];
      v[0] += c * func_base(h, a * x - b) + d * x + T(0.5) * e * x * x;
      P.munu[idx] = -rho * (P.zt[idx] - P.z[idx] + x);
    }
    block_partials<T, 1>(v, P.partials, 14, smem);
  }
  grid.sync();
  grid_partials(P.partials, 14, 1, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int status = converged ? kSuccess : (nan_found ? kNanFound : kMaxIter);
    T* st = P.stats;
    st[0] = red[14];
    st[1] = T(k);
    st[2] = T(status);
    st[3] = rho;
    st[4] = nrm_r;
    st[5] = nrm_s;
    st[6] = gap;
    st[7] = eps_pri;
    st[8] = eps_dua;
  }
}

template <typename T>
int grid_size(int device, int* grid) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_admm_kernel<T>, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  // One block per SM; zero means the block does not fit an SM at all.
  *grid = per_sm >= 1 ? sms : 0;
  return 0;
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Ginv,
           const int* hf, const void* fp, const int* hg, const void* gp,
           const void* scal, void* xy12, void* munu, void* z, void* zt,
           void* work, void* stats, int m, int n, double abs_tol,
           double rel_tol, int max_iter, int gap_stop, int adaptive_rho,
           int grid, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int N = m + n, k = m < n ? m : n;
  T* wk = static_cast<T*>(work);
  Params<T> P;
  P.A = static_cast<const T*>(A);
  P.At = static_cast<const T*>(At);
  P.Ginv = static_cast<const T*>(Ginv);
  P.hf = hf;
  P.fp = static_cast<const T*>(fp);
  P.hg = hg;
  P.gp = static_cast<const T*>(gp);
  P.scal = static_cast<const T*>(scal);
  P.xy12 = static_cast<T*>(xy12);
  P.munu = static_cast<T*>(munu);
  P.z = static_cast<T*>(z);
  P.zt = static_cast<T*>(zt);
  P.znew = wk;
  P.zor = wk + N;
  P.rhs = wk + 2 * N;
  P.w = wk + 2 * N + k;
  P.sin = wk + 2 * N + 2 * k;
  P.partials = wk + 2 * N + 2 * k + m;
  P.stats = static_cast<T*>(stats);
  P.m = m;
  P.n = n;
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  P.gap_stop = gap_stop;
  P.adaptive_rho = adaptive_rho;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel((const void*)fused_admm_kernel<T>, dim3(grid),
                                    dim3(kThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the work buffer the launch needs for a given grid.
long long pogs_fused_admm_work_elems(int m, int n, int grid) {
  const long long N = (long long)m + n, k = m < n ? m : n;
  return 2 * N + 2 * k + m + (long long)kSlots * grid;
}

// The cooperative grid size (blocks) for the kernel on this device; 0 if the
// kernel cannot be made co-resident.  Returns a cudaError_t code.
int pogs_fused_admm_grid(int is_double, int device, int* grid) {
  return is_double ? grid_size<double>(device, grid) : grid_size<float>(device, grid);
}

// Launch the whole solve on `stream`; does not synchronise.  Returns the
// cudaError_t of the launch (0 on success).
int pogs_fused_admm(int is_double, int device, const void* A, const void* At,
                    const void* Ginv, const int* hf, const void* fp,
                    const int* hg, const void* gp, const void* scal,
                    void* xy12, void* munu, void* z, void* zt, void* work,
                    void* stats, int m, int n, double abs_tol, double rel_tol,
                    int max_iter, int gap_stop, int adaptive_rho, int grid,
                    void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Ginv, hf, fp, hg, gp, scal, xy12, munu, z,
                          zt, work, stats, m, n, abs_tol, rel_tol, max_iter,
                          gap_stop, adaptive_rho, grid, stream);
  return launch<float>(device, A, At, Ginv, hf, fp, hg, gp, scal, xy12, munu, z,
                       zt, work, stats, m, n, abs_tol, rel_tol, max_iter,
                       gap_stop, adaptive_rho, grid, stream);
}

const char* pogs_fused_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
