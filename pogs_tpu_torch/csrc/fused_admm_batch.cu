// K graph-form ADMM solves that share A, f and g, except for a per-lane c of
// g (a lambda-sweep) and an optional per-lane b of f (multi-right-hand-side),
// as ONE CUDA kernel for Hopper (sm_90a): the route for matrices below the
// L2 cache (ops/fused_admm_batch.py::route_for).
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
// Layout: one thread block cluster of C blocks (C = 1, 2, 4, 8 or 16; 256
// threads a block) runs the whole while-loop of a chunk of Kc lanes (Kc =
// 1, 2, 4 or 8).  Block r of a cluster owns rows [r HA, (r+1) HA) of A (its
// y elements), elements [r HX, (r+1) HX) of x, and the matching rows of
// Ginv (those of x when tall, of y when wide).  It loads its row slices of
// A and Ginv into its dynamic shared memory once per launch and never reads
// A^T: A^T v is each block's partial over its own rows, summed over the
// cluster through distributed shared memory (DSMEM) in block order 0..C-1
// by the owner of each x element.  A v and Ginv v run row by row over the
// owner's slice, on the whole input vector, which each block gathers from
// its peers' shared memory.  A one-block cluster (C = 1) reads its own
// vectors in place instead: no gathers, no DSMEM sums, and rhs (tall) or
// x (wide) in the epilogue of the A^T product, without barriers 1 and 2
// (tall) or 3 (wide).  The lanes' state on the owned elements (z, z~,
// the prox value, the projection input, the projected iterate) and their
// prox parameters live in shared memory too; global memory is read only for
// the slices and parameters at the start and written only when a lane
// fires.  Per iteration (tall; wide alike, in another order):
//   P1  part = (own rows of A)^T y0                    -- barrier 1
//   R1  rhs = x0 + sum_q part_q on the owned x         -- barrier 2
//   G1  gather rhs; x = (own rows of Ginv) rhs         -- barrier 3
//   G2  gather x;   y = (own rows of A) x; residual sums  -- barrier 4
//   F   the dual update and, in the same pass, the next iteration's prox
//       on the owned elements, then its per-lane gap sums (the first
//       iteration's prox runs before the loop)
// After barrier 4 every block sums the C blocks' per-lane partial sums in
// block order, so all blocks of a cluster hold bit-identical sums and take
// the same decisions (rho, done, exits) without another exchange.  The exact
// residuals add one barrier: r on the owned rows, and A^T s-partials that
// every block sums whole.  A cluster leaves when its last lane is done,
// through two final barriers (rank 0 reads the optval partials between
// them), so no block exits while a peer reads its shared memory.  Buffers
// a peer reads are not written again before the next barrier that orders
// the read; the per-lane gap sums, read after barrier 4, alternate between
// two slots by iteration.  No grid sync and no atomics; a one-block
// cluster's barriers are block barriers.
//
// A lane's arithmetic does not depend on Kc or on its place in the chunk:
// every sum over a lane's elements runs in one order fixed by (m, n, dtype)
// -- by element in each thread, the thread's 4 partners in its warp
// (butterfly), the 8 warps, then the C blocks in order; a product by output
// over its inner index, in splits set by the output and inner sizes, then
// the splits in order -- and the plan (C, HA, HX) depends on m, n and the
// dtype, never on K.  The sums of an elementwise pass run in that order,
// thread t on lane t % 8 and every 32nd element; a chunk of fewer than 8
// lanes computes the pass's values (prox, dual update) first, by (element,
// lane) pair over all threads, so that no thread idles for a missing lane.
//
// The plan (pogs_batch_cluster_plan, twin of ops/fused_admm_batch.py::
// cluster_plan): the smallest C whose slices of A and Ginv, plus the vector
// staging and state for 8 lanes, fit 232,448 bytes of shared memory.  Where
// no C <= 16 fits, C = 16 runs the same loop with its slices read from
// global memory (the L2), each block 1/C of the matrices.  The card holds
// at most 15 clusters of 8 and 7 of 16 (cudaOccupancyMaxActiveClusters on
// an H100 SXM: a cluster lives in one GPC), so a sweep of 128 lanes on
// clusters of 8 runs in two waves.
//
// What bounds it on this card: per lane and iteration the projection is
// 2 (2mn + k^2) FLOPs, and 4mn more when the exact residuals run; in plain
// f32 or f64 FMA on the CUDA cores (no TF32, no tensor cores).  With the
// slices in shared memory a block applies each element it holds to its Kc
// lanes: at the bench sweep (500x300 f32, clusters of 8) about 0.39 M FMAs
// per block and iteration, 1.5 us at the SM's peak.  The iteration costs
// more than that, about 22 us on a block of that sweep: the three products
// 8.3 us, the 4 cluster barriers 2.5, the gathers and the cluster sum of
// A^T y0 2.7, the exact residuals 2.7 on average, the dual update with the
// next prox 3.3, the cluster's per-lane sums and decisions 1.6; a
// one-block cluster at 120x80 takes about 10 us.  tools/k2_split.py splits
// an iteration by phase, and PERF.md keeps the split.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "prox.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pogs;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kL = 8;                       // lane stride of a staged vector; Kc <= 8
constexpr int kEStride = kThreads / kL;     // elements in flight per lane, elementwise
constexpr int kMaxCluster = 16;
constexpr long long kSmemLimit = 232448;    // dynamic shared memory a block may use
constexpr int kVecs = 5;                    // state vectors per owned element and lane
constexpr int kScratch = kWarps * 32 * kL;  // partials of a product split over warps
constexpr int kSums = 7;                    // per-lane sums of one elementwise pass, at most
// The small per-lane state: gap sums (2 slots), residual sums, r^2 and
// optval partials, the reduced sums S, R, E, 8 scalars and the warp sums.
constexpr int kSmallT = 2 * kL * 6 + kL * 6 + kL + kL + kL * 6 + kL * 6 + kL * 2 + 8 * kL
                        + kWarps * kL * kSums;
constexpr int kSmallInts = 5 * kL;

template <typename T> struct Params {
  const T* A;      // (m, n) row-major, equilibrated
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
  int m, n, K;
  T abs_tol, rel_tol;
  int max_iter, gap_stop, adaptive_rho;
};

// The launch plan: cluster size, owned heights, shared memory.
struct Plan {
  int C, in_smem, HA, HX, HG, ldA, ldG;
  long long nA, nG;  // elements of the slices in shared memory (0 from global)
  long long smem;    // bytes of dynamic shared memory
};

__host__ __device__ inline long long al4(long long x) { return (x + 3) & ~3LL; }

__host__ __device__ inline Plan make_plan(int m, int n, int itemsize, int C, int in_smem) {
  Plan p;
  p.C = C;
  p.in_smem = in_smem;
  p.HA = (m + C - 1) / C;
  p.HX = (n + C - 1) / C;
  p.HG = m >= n ? p.HX : p.HA;
  const int k = m < n ? m : n;
  // Odd row strides: a warp reading one column of 32 consecutive rows hits
  // 32 banks.
  p.ldA = n | 1;
  p.ldG = k | 1;
  p.nA = in_smem ? al4((long long)p.HA * p.ldA) : 0;
  p.nG = in_smem ? al4((long long)p.HG * p.ldG) : 0;
  // The slices; full, part and spart; per owned element the state, two
  // exchanged vectors and the prox parameters (5 shared, one per lane, the
  // function code); the split partials; the per-lane sums and scalars.
  const long long owned = p.HA + p.HX;
  const long long t = p.nA + p.nG + 3LL * n * kL + (kVecs + 2LL) * owned * kL + kScratch +
                      kSmallT + owned * (5 + kL);
  p.smem = t * itemsize + 4LL * (kSmallInts + owned);
  return p;
}

// The rule: the smallest C whose slices sit in shared memory, else C = 16
// reading them from global memory; C = 0 when even that does not fit.
inline Plan pick_plan(int m, int n, int itemsize) {
  for (int C = 1; C <= kMaxCluster; C *= 2) {
    const Plan p = make_plan(m, n, itemsize, C, 1);
    if (p.smem <= kSmemLimit) return p;
  }
  Plan p = make_plan(m, n, itemsize, kMaxCluster, 0);
  if (p.smem > kSmemLimit) p.C = 0;
  return p;
}

// The lanes' state on the owned elements, (owned, kL) each: z, z~, the prox
// value, the projection input and the projected iterate.
enum Vec { Z = 0, ZT = 1, PX = 2, ZOR = 3, ZN = 4 };

// The block's view of its dynamic shared memory.
template <typename T> struct Sh {
  T *As, *Gs;                   // row slices of A and Ginv
  T *full, *part, *spart;       // (n, kL): a gathered vector; A^T partials
  T *sx, *sy;                   // (kVecs, HX or HA, kL): the state
  T *ownA, *ownT;               // (HX, kL): rhs (tall), x-terms of s
  T *ownB, *ownU;               // (HA, kL): rhs (wide) or r; w or s's input
  T* scr;                       // product split partials
  T *psum, *rsum, *esum, *osum; // partial sums peers read
  T *S, *R, *E;                 // the cluster's sums per lane
  T *rho, *delta, *xi, *kd, *ku, *zt_scale, *nrm_r_a, *nrm_s_a;
  T* wsum;                      // (kWarps, kL, kSums) warp sums
  T *prm, *prl;                 // (owned, 5), (owned, kL): the prox parameters
  int *k, *done, *fire, *status, *near, *ph;
  int HX, HA;
  __device__ Sh(unsigned char* raw, const Plan& pl, int n) : HX(pl.HX), HA(pl.HA) {
    T* t = reinterpret_cast<T*>(raw);
    As = t; t += pl.nA;
    Gs = t; t += pl.nG;
    full = t; t += (size_t)n * kL;
    part = t; t += (size_t)n * kL;
    spart = t; t += (size_t)n * kL;
    sx = t; t += (size_t)kVecs * HX * kL;
    sy = t; t += (size_t)kVecs * HA * kL;
    ownA = t; t += (size_t)HX * kL;
    ownT = t; t += (size_t)HX * kL;
    ownB = t; t += (size_t)HA * kL;
    ownU = t; t += (size_t)HA * kL;
    scr = t; t += kScratch;
    psum = t; t += 2 * kL * 6;
    rsum = t; t += kL * 6;
    esum = t; t += kL;
    osum = t; t += kL;
    S = t; t += kL * 6;
    R = t; t += kL * 6;
    E = t; t += kL * 2;
    rho = t; t += kL;
    delta = t; t += kL;
    xi = t; t += kL;
    kd = t; t += kL;
    ku = t; t += kL;
    zt_scale = t; t += kL;
    nrm_r_a = t; t += kL;
    nrm_s_a = t; t += kL;
    wsum = t; t += kWarps * kL * kSums;
    prm = t; t += (size_t)(HX + HA) * 5;
    prl = t; t += (size_t)(HX + HA) * kL;
    int* i = reinterpret_cast<int*>(t);
    k = i; i += kL;
    done = i; i += kL;
    fire = i; i += kL;
    status = i; i += kL;
    near = i; i += kL;
    ph = i;
  }
  __device__ T* x(int v) const { return sx + (size_t)v * HX * kL; }
  __device__ T* y(int v) const { return sy + (size_t)v * HA * kL; }
};

// 16 bytes of T.
template <typename T> struct V16;
template <> struct V16<float> {
  using t = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void put(float* w, float4 v) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  }
  static __device__ __forceinline__ float4 make(const float* w) {
    return make_float4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct V16<double> {
  using t = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void put(double* w, double2 v) { w[0] = v.x; w[1] = v.y; }
  static __device__ __forceinline__ double2 make(const double* w) {
    return make_double2(w[0], w[1]);
  }
};

// The KC lanes of a staged vector's row (16-byte aligned).
template <typename T, int KC>
__device__ __forceinline__ void load_lanes(const T* p, T (&w)[KC]) {
  if constexpr (KC % V16<T>::n == 0) {
    const typename V16<T>::t* v = reinterpret_cast<const typename V16<T>::t*>(p);
#pragma unroll
    for (int u = 0; u < KC / V16<T>::n; ++u) V16<T>::put(w + u * V16<T>::n, v[u]);
  } else {
#pragma unroll
    for (int l = 0; l < KC; ++l) w[l] = p[l];
  }
}

template <typename T, int KC>
__device__ __forceinline__ void store_lanes(T* p, const T (&w)[KC]) {
  if constexpr (KC % V16<T>::n == 0) {
#pragma unroll
    for (int u = 0; u < KC / V16<T>::n; ++u)
      reinterpret_cast<typename V16<T>::t*>(p)[u] = V16<T>::make(w + u * V16<T>::n);
  } else {
#pragma unroll
    for (int l = 0; l < KC; ++l) p[l] = w[l];
  }
}

// Per-lane block sums.  In an elementwise phase thread t works on lane
// t % kL and elements t / kL, t / kL + 32, ...; its partials v are summed
// over the 4 threads of its lane in its warp (butterfly), then over the
// warps in order, into *dst(l, s) for every lane l and slot s where dst
// gives a pointer.  Every thread must call it; without kTrail the caller's
// next barrier orders the results and the warp sums.
template <typename T, int NS, bool kTrail = true, typename Dst>
__device__ __forceinline__ void lane_sums(const T (&v)[NS], T* wsum, Dst dst) {
  const int tid = threadIdx.x, ln = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    T x = v[s];
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (ln < kL) wsum[(warp * kL + ln) * kSums + s] = x;
  }
  __syncthreads();
  if (tid < kL * NS) {
    const int l = tid / NS, s = tid % NS;
    T* const out = dst(l, s);
    if (out) {
      T a = wsum[l * kSums + s];
      for (int w = 1; w < kWarps; ++w) a += wsum[(w * kL + l) * kSums + s];
      *out = a;
    }
  }
  if (kTrail) __syncthreads();
}

// The cluster's barrier; a block barrier when the cluster is one block.
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster, int C) {
  if (C == 1) __syncthreads();
  else cluster.sync();
}

// sum_{q < C} of the value at p in block q's shared memory, in block order;
// the block's own value when the cluster is one block.
template <typename T>
__device__ __forceinline__ T cluster_sum(cg::cluster_group& cluster, const T* p, int C) {
  if (C == 1) return *p;
  T v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) v[q] = *cluster.map_shared_rank(const_cast<T*>(p), q);
  T s = T(0);
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) s += v[q];
  return s;
}

// full[c] = the owner's own[c - q H] for c < len (q = c / H): a vector
// gathered from the cluster's owned pieces.  Ends with a block barrier.
template <typename T, int KC>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, T* full, const T* own,
                                       int len, int H) {
  // Two rows a thread per pass, both loaded before either is stored.
  for (int c0 = threadIdx.x; c0 < len; c0 += 2 * kThreads) {
    T v[2][KC];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads;
      if (c < len) {
        const int q = c / H;
        load_lanes<T, KC>(cluster.map_shared_rank(const_cast<T*>(own), q) +
                              (size_t)(c - q * H) * kL, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c = c0 + u * kThreads;
      if (c < len) store_lanes<T, KC>(full + (size_t)c * kL, v[u]);
    }
  }
  __syncthreads();
}

// The whole vector whose pieces of H rows the cluster's blocks own at own:
// own itself when the cluster is one block, else gathered into full.
template <typename T, int KC>
__device__ __forceinline__ const T* whole(cg::cluster_group& cluster, T* full, const T* own,
                                          int len, int H, int C) {
  if (C == 1) return own;
  gather<T, KC>(cluster, full, own, len, H);
  return full;
}

// A matrix element from shared memory (SM) or, read-only, global memory.
template <typename T, bool SM>
__device__ __forceinline__ T load_m(const T* p) {
  if constexpr (SM) return *p;
  else return __ldg(p);
}

// out[o][l] = sum_{i < I} M(o, i) W[i][l] for o < O and the KC lanes, handed
// to epi(o, l, value) for l < nl: M(o, i) = M[o ld + i] (kRows: A x, Ginv v)
// or M[o + i ld] (A^T v).  W (I rows of kL) is in this block's shared
// memory; M in shared memory (SM) or global memory.  A warp takes 32
// consecutive outputs and a contiguous split of the inner index; the splits
// (a function of O and I only) are summed in order.  Every thread must call
// it; it ends with a block barrier.
template <typename T, int KC, bool SM, bool kRows, typename Epi>
__device__ __forceinline__ void product(const T* M, int ld, int O, int I, const T* W, T* scr,
                                        int nl, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (O > 0) {
    const int Ow = (O + 31) >> 5;
    int S = 1;
    if (Ow < kWarps) {
      S = kWarps / Ow;
      const int maxS = (I + 31) >> 5;
      if (S > maxS) S = maxS > 0 ? maxS : 1;
    }
    const int chunk = (I + S - 1) / S;
    const int items = Ow * S;
    for (int it = warp; it < items; it += kWarps) {
      const int ow = it % Ow, s = it / Ow;
      const int o = ow * 32 + lane;
      T acc[KC];
#pragma unroll
      for (int l = 0; l < KC; ++l) acc[l] = T(0);
      if (o < O) {
        const int i0 = s * chunk;
        const int i1 = I < i0 + chunk ? I : i0 + chunk;
        const T* mp = kRows ? M + (size_t)o * ld + i0 : M + o + (size_t)i0 * ld;
        const size_t step = kRows ? 1 : (size_t)ld;
        const T* wp = W + (size_t)i0 * kL;
        for (int i = i0; i < i1; ++i) {
          const T mv = load_m<T, SM>(mp);
          mp += step;
          T w[KC];
          load_lanes<T, KC>(wp, w);
          wp += kL;
#pragma unroll
          for (int l = 0; l < KC; ++l) acc[l] += mv * w[l];
        }
      }
      if (S == 1) {
        if (o < O)
#pragma unroll
          for (int l = 0; l < KC; ++l)
            if (l < nl) epi(o, l, acc[l]);
      } else {
        store_lanes<T, KC>(scr + (size_t)(it * 32 + lane) * kL, acc);
      }
    }
    if (S > 1) {
      __syncthreads();
      for (int e = threadIdx.x; e < O * nl; e += kThreads) {
        const int o = e / nl, l = e % nl;
        const int ow = o >> 5, ln = o & 31;
        T p[kWarps];
#pragma unroll
        for (int s = 0; s < kWarps; ++s)
          if (s < S) p[s] = scr[(size_t)((s * Ow + ow) * 32 + ln) * kL + l];
        T v = p[0];
#pragma unroll
        for (int s = 1; s < kWarps; ++s)
          if (s < S) v += p[s];
        epi(o, l, v);
      }
    }
  }
  __syncthreads();
}

template <typename T, int KC, bool SM>
__global__ void __launch_bounds__(kThreads, 1) cluster_kernel(const Params<T> P, const Plan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = pl.C;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int m = P.m, n = P.n;
  const bool tall = m >= n;
  const int k = tall ? n : m;
  const int lane0 = (blockIdx.x / C) * KC;
  const int nl = KC < P.K - lane0 ? KC : P.K - lane0;
  Sh<T> sh(smem_raw, pl, n);

  // Owned ranges: y (rows of A), x, and the rows of Ginv.
  const int ya = m < rank * pl.HA ? m : rank * pl.HA;
  const int yb = m < ya + pl.HA ? m : ya + pl.HA;
  const int ny = yb - ya;
  const int xa = n < rank * pl.HX ? n : rank * pl.HX;
  const int xb = n < xa + pl.HX ? n : xa + pl.HX;
  const int nx = xb - xa;
  const int no = nx + ny;  // owned elements: x first, then y
  const int ga = tall ? xa : ya, ng = tall ? nx : ny;
  const T* Am = SM ? sh.As : P.A + (size_t)ya * n;
  const T* Gm = SM ? sh.Gs : P.Ginv + (size_t)ga * k;
  const int ldA = SM ? pl.ldA : n, ldG = SM ? pl.ldG : k;

  const T one = T(1), alpha = T(1.7);
  const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
  const T sqrtn_atol = m_sqrt(T(n)) * abs_tol;
  const T sqrtm_atol = m_sqrt(T(m)) * abs_tol;
  const T sqrtmn_atol = m_sqrt(T(m + n)) * abs_tol;
  const T norm_A = P.scal[1];

  // The slices, once per launch; cold start z = z~ = 0.
  if (SM) {
#pragma unroll 4
    for (int e = tid; e < ny * n; e += kThreads) {
      const int i = e / n, c = e % n;
      sh.As[(size_t)i * pl.ldA + c] = __ldg(P.A + (size_t)(ya + i) * n + c);
    }
#pragma unroll 4
    for (int e = tid; e < ng * k; e += kThreads) {
      const int i = e / k, c = e % k;
      sh.Gs[(size_t)i * pl.ldG + c] = __ldg(P.Ginv + (size_t)(ga + i) * k + c);
    }
  }
  for (int e = tid; e < 2 * pl.HX * kL; e += kThreads) sh.sx[e] = T(0);
  for (int e = tid; e < 2 * pl.HA * kL; e += kThreads) sh.sy[e] = T(0);
  // The prox parameters of the owned elements (x first, then y): the
  // function code, a, b, c, d, e, and per lane g's c or f's b.
  for (int e = tid; e < no; e += kThreads) {
    T* pr = sh.prm + e * 5;
    if (e < nx) {
      const int j = xa + e;
      sh.ph[e] = P.hg[j];
      pr[0] = P.gp[j]; pr[1] = P.gp[n + j]; pr[2] = T(0);
      pr[3] = P.gp[3 * n + j]; pr[4] = P.gp[4 * n + j];
    } else {
      const int i = ya + e - nx;
      sh.ph[e] = P.hf[i];
      pr[0] = P.fp[i]; pr[1] = P.fp[m + i]; pr[2] = P.fp[2 * m + i];
      pr[3] = P.fp[3 * m + i]; pr[4] = P.fp[4 * m + i];
    }
  }
  for (int e = tid; e < no * nl; e += kThreads) {
    const int j = e / nl, l = e % nl, g = lane0 + l;
    sh.prl[j * kL + l] = j < nx ? P.cb[(size_t)g * n + xa + j]
                                : (P.fbb ? P.fbb[(size_t)g * m + ya + j - nx]
                                         : P.fp[m + ya + j - nx]);
  }
  if (tid < kL) {
    sh.rho[tid] = P.scal[0];
    sh.delta[tid] = T(K_DELTA_MIN);
    sh.xi[tid] = one;
    sh.kd[tid] = T(0);
    sh.ku[tid] = T(0);
    sh.k[tid] = 0;
    sh.done[tid] = tid >= nl;
    sh.fire[tid] = 0;
  }
  __syncthreads();

  // Elementwise phases.  The per-lane sums run in the fixed order: thread
  // tid on lane el and the owned elements e0, e0 + kEStride, ... (x first,
  // then y).  A pass computes the values of each (element, lane) pair by
  // f(e, l), then adds its terms to the sums by sum(e, l): in one sweep of
  // that order when a chunk has kL lanes; else f over all threads first,
  // pair by pair, so that a chunk of fewer lanes keeps every thread busy.
  const int el = tid % kL, e0 = tid / kL;
  auto active = [&](int l) { return l < nl && !sh.done[l]; };
  auto element_pass = [&](auto&& f, auto&& sum) {
    if constexpr (KC == kL) {
      if (active(el))
        for (int e = e0; e < no; e += kEStride) {
          f(e, el);
          sum(e, el);
        }
    } else {
      for (int q = tid; q < no * nl; q += kThreads) {
        const int e = q / nl, l = q % nl;
        if (active(l)) f(e, l);
      }
      __syncthreads();
      if (active(el))
        for (int e = e0; e < no; e += kEStride) sum(e, el);
    }
  };
  // The state of owned element e (x first, then y) of lane l, and the
  // stride between its vectors.
  auto state = [&](int e, int l) -> T* {
    return e < nx ? sh.sx + (size_t)e * kL + l : sh.sy + (size_t)(e - nx) * kL + l;
  };
  auto vstride = [&](int e) -> size_t { return (size_t)(e < nx ? pl.HX : pl.HA) * kL; };
  // The prox of owned element e of lane l at rho, from z - z~: the prox
  // value and the over-relaxed projection input.  g's c and f's b are the
  // lane's.
  auto prox_step = [&](int e, int l, T rho) {
    const bool isx = e < nx;
    T* const st = state(e, l);
    const size_t vs = vstride(e);
    const T cz = st[Z * vs], czt = st[ZT * vs];
    const T* pr = sh.prm + e * 5;
    const T lp = sh.prl[e * kL + l];
    const T p = prox_full(sh.ph[e], pr[0], isx ? pr[1] : lp, isx ? lp : pr[2], pr[3], pr[4],
                          cz - czt, rho);
    st[PX * vs] = p;
    st[ZOR * vs] = czt + alpha * p + (one - alpha) * cz;
  };
  // The gap terms of owned element e of lane l, from its state after the
  // prox: to v[0..2] (x) or v[3..5] (y).
  auto gap_terms = [&](int e, int l, T (&v)[7]) {
    const T* st = state(e, l);
    const size_t vs = vstride(e);
    const T p = st[PX * vs];
    const T zm = (st[Z * vs] - st[ZT * vs]) - p;
    // Constant indices keep v in registers.
    if (e < nx) {
      v[0] += zm * p;
      v[1] += zm * zm;
      v[2] += p * p;
    } else {
      v[3] += zm * p;
      v[4] += zm * zm;
      v[5] += p * p;
    }
  };
  int par = 0;
  // --- A: the first iteration's prox, gap sums, projection input. -------
  {
    T v[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    element_pass([&](int e, int l) { prox_step(e, l, sh.rho[l]); },
                 [&](int e, int l) { gap_terms(e, l, v); });
    lane_sums<T, 7, false>(v, sh.wsum, [&](int l, int s) -> T* {
      return s < 6 && active(l) ? sh.psum + par * kL * 6 + l * 6 + s : nullptr;
    });
  }
  for (;;) {
    // --- The projection. ------------------------------------------------
    if (tall) {
      if (C == 1) {
        // The block owns every x: rhs = x0 + A^T y0 in the product.
        product<T, KC, SM, false>(Am, ldA, n, ny, sh.y(ZOR), sh.scr, nl, [&](int c, int l, T s) {
          sh.ownA[(size_t)c * kL + l] = sh.x(ZOR)[(size_t)c * kL + l] + s;
        });
      } else {
        // P1: part = (own rows of A)^T y0, over all n columns.
        product<T, KC, SM, false>(Am, ldA, n, ny, sh.y(ZOR), sh.scr, nl,
                           [&](int c, int l, T s) { sh.part[(size_t)c * kL + l] = s; });
        cluster_barrier(cluster, C);  // barrier 1
        // R1: rhs = x0 + sum_q part_q on the owned x.
        for (int e = tid; e < nx * nl; e += kThreads) {
          const int j = e / nl, l = e % nl;
          const T s = cluster_sum(cluster, sh.part + (size_t)(xa + j) * kL + l, C);
          sh.ownA[j * kL + l] = sh.x(ZOR)[j * kL + l] + s;
        }
        cluster_barrier(cluster, C);  // barrier 2
      }
      // G1: x = (own rows of Ginv) rhs.
      const T* rhs = whole<T, KC>(cluster, sh.full, sh.ownA, n, pl.HX, C);
      product<T, KC, SM, true>(Gm, ldG, nx, n, rhs, sh.scr, nl,
                         [&](int j, int l, T s) { sh.x(ZN)[j * kL + l] = s; });
      cluster_barrier(cluster, C);  // barrier 3
      // G2: y = (own rows of A) x.
      const T* xv = whole<T, KC>(cluster, sh.full, sh.x(ZN), n, pl.HX, C);
      product<T, KC, SM, true>(Am, ldA, ny, n, xv, sh.scr, nl,
                         [&](int i, int l, T s) { sh.y(ZN)[i * kL + l] = s; });
    } else {
      cluster_barrier(cluster, C);  // barrier 1
      // rhs = (own rows of A) x0 - y0.
      const T* x0 = whole<T, KC>(cluster, sh.full, sh.x(ZOR), n, pl.HX, C);
      product<T, KC, SM, true>(Am, ldA, ny, n, x0, sh.scr, nl, [&](int i, int l, T s) {
        sh.ownB[i * kL + l] = s - sh.y(ZOR)[i * kL + l];
      });
      cluster_barrier(cluster, C);  // barrier 2
      // w = (own rows of Ginv) rhs, y = y0 + w.
      const T* rhs = whole<T, KC>(cluster, sh.full, sh.ownB, m, pl.HA, C);
      product<T, KC, SM, true>(Gm, ldG, ny, m, rhs, sh.scr, nl, [&](int i, int l, T s) {
        sh.ownU[i * kL + l] = s;
        sh.y(ZN)[i * kL + l] = sh.y(ZOR)[i * kL + l] + s;
      });
      if (C == 1) {
        // The block owns every x: x = x0 - A^T w in the product.
        product<T, KC, SM, false>(Am, ldA, n, ny, sh.ownU, sh.scr, nl, [&](int c, int l, T s) {
          sh.x(ZN)[(size_t)c * kL + l] = sh.x(ZOR)[(size_t)c * kL + l] - s;
        });
      } else {
        // part = (own rows of A)^T w.
        product<T, KC, SM, false>(Am, ldA, n, ny, sh.ownU, sh.scr, nl,
                           [&](int c, int l, T s) { sh.part[(size_t)c * kL + l] = s; });
        cluster_barrier(cluster, C);  // barrier 3
        // x = x0 - sum_q part_q on the owned x.
        for (int e = tid; e < nx * nl; e += kThreads) {
          const int j = e / nl, l = e % nl;
          const T s = cluster_sum(cluster, sh.part + (size_t)(xa + j) * kL + l, C);
          sh.x(ZN)[j * kL + l] = sh.x(ZOR)[j * kL + l] - s;
        }
        __syncthreads();
      }
    }

    // --- Residual sums on the owned elements. ---------------------------
    // rsum = [|dy_prev|^2, |dy12|^2, sum y_new, |dx_prev|^2, |dx12|^2, sum x_new]
    {
      T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      if (active(el)) {
        for (int e = e0; e < no; e += kEStride) {
          const T* st = state(e, el);
          const size_t vs = vstride(e);
          const T zn = st[ZN * vs], cz = st[Z * vs], ph = st[PX * vs];
          const T dp = cz - zn, d12 = ph - zn;
          if (e < nx) {
            v[3] += dp * dp;
            v[4] += d12 * d12;
            v[5] += zn;
          } else {
            v[0] += dp * dp;
            v[1] += d12 * d12;
            v[2] += zn;
          }
        }
      }
      lane_sums<T, 6, false>(v, sh.wsum, [&](int l, int s) -> T* {
        return active(l) ? sh.rsum + l * 6 + s : nullptr;
      });
    }
    cluster_barrier(cluster, C);  // barrier 4

    // --- The cluster's sums, in block order, in every block. -------------
    {
      const int l = tid >> 4, s = tid & 15;
      if (s < 12 && active(l)) {
        if (s < 6)
          sh.S[l * 6 + s] = cluster_sum(cluster, sh.psum + par * kL * 6 + l * 6 + s, C);
        else
          sh.R[l * 6 + s - 6] = cluster_sum(cluster, sh.rsum + l * 6 + s - 6, C);
      }
    }
    __syncthreads();

    // --- Per-lane approximate residuals and the near-tolerance test. ----
    if (active(tid)) {
      const int l = tid;
      const T* S = sh.S + l * 6;
      const T* R = sh.R + l * 6;
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

    // --- Exact residuals r = A x12 - y12, s = A^T(...) + (...), for the
    // cluster when one of its lanes is near tolerance. ------------------
    if (any_near) {
      // r on the owned rows, from the whole x12.
      const T* x12 = whole<T, KC>(cluster, sh.full, sh.x(PX), n, pl.HX, C);
      product<T, KC, SM, true>(Am, ldA, ny, n, x12, sh.scr, nl, [&](int i, int l, T s) {
        sh.ownB[i * kL + l] = s - sh.y(PX)[i * kL + l];
      });
      // s's input y12 + z~_y - z_y on the owned rows, its x-terms x12 +
      // z~_x - z_x on the owned x.
      for (int e = tid; e < no * nl; e += kThreads) {
        const int j = e / nl, l = e % nl;
        if (j < nx) {
          const int q = j * kL + l;
          sh.ownT[q] = sh.x(PX)[q] + sh.x(ZT)[q] - sh.x(Z)[q];
        } else {
          const int q = (j - nx) * kL + l;
          sh.ownU[q] = sh.y(PX)[q] + sh.y(ZT)[q] - sh.y(Z)[q];
        }
      }
      {
        T v[1] = {T(0)};
        if (active(el))
          for (int i = e0; i < ny; i += kEStride) {
            const T r = sh.ownB[i * kL + el];
            v[0] += r * r;
          }
        lane_sums<T, 1, false>(v, sh.wsum,
                               [&](int l, int) -> T* { return active(l) ? sh.esum + l : nullptr; });
      }
      product<T, KC, SM, false>(Am, ldA, n, ny, sh.ownU, sh.scr, nl,
                         [&](int c, int l, T s) { sh.spart[(size_t)c * kL + l] = s; });
      cluster_barrier(cluster, C);  // barrier 5 (exact residuals only)
      // s = sum_q spart_q + the x-terms, in place when the block owns
      // every x.
      T* const sv = C == 1 ? sh.ownT : sh.full;
      if (C > 1) gather<T, KC>(cluster, sh.full, sh.ownT, n, pl.HX);
      for (int e = tid; e < n * nl; e += kThreads) {
        const int c = e / nl, l = e % nl;
        T* f = sv + (size_t)c * kL + l;
        *f = cluster_sum(cluster, sh.spart + (size_t)c * kL + l, C) + *f;
      }
      __syncthreads();
      {
        T v[1] = {T(0)};
        if (active(el))
          for (int c = e0; c < n; c += kEStride) {
            const T s = sv[(size_t)c * kL + el];
            v[0] += s * s;
          }
        lane_sums<T, 1, false>(v, sh.wsum, [&](int l, int) -> T* {
          return active(l) ? sh.E + l * 2 + 1 : nullptr;
        });
      }
      if (active(tid)) sh.E[tid * 2] = cluster_sum(cluster, sh.esum + tid, C);
      __syncthreads();
    }

    // --- Per-lane decisions: converged, NaN, done; the rho schedule. ----
    if (active(tid)) {
      const int l = tid;
      const T* S = sh.S + l * 6;
      const T* R = sh.R + l * 6;
      const T rho = sh.rho[l];
      const T gap = m_fabs(S[0] + S[3]);
      const T eps_gap = sqrtmn_atol + rel_tol * m_sqrt(S[1] + S[4]) * m_sqrt(S[2] + S[5]);
      const T eps_pri = sqrtm_atol + rel_tol * m_sqrt(S[5]);
      const T eps_dua = rho * (sqrtn_atol + rel_tol * m_sqrt(S[1]));
      const bool near = sh.near[l];
      const T nrm_r = near ? m_sqrt(sh.E[l * 2]) : sh.nrm_r_a[l];
      const T nrm_s = near ? rho * m_sqrt(sh.E[l * 2 + 1]) : sh.nrm_s_a[l];
      bool conv_now = near && nrm_r < eps_pri && nrm_s < eps_dua;
      if (P.gap_stop) conv_now = conv_now && gap < eps_gap;
      const bool nan_now = !(m_finite(nrm_r) && m_finite(R[2] + R[5]));
      const int kk = sh.k[l];
      const bool done_now = conv_now || nan_now || kk >= P.max_iter - 1;
      sh.fire[l] = done_now;
      T zt_scale = one;
      if (done_now) {
        sh.status[l] = conv_now ? kSuccess : (nan_now ? kNanFound : kMaxIter);
      } else {
        if (P.adaptive_rho)
          zt_scale = rho_schedule_step(kk, nrm_r, nrm_s, eps_pri, eps_dua, sh.rho[l],
                                       sh.delta[l], sh.xi[l], sh.kd[l], sh.ku[l]);
        sh.k[l] = kk + 1;
      }
      sh.zt_scale[l] = zt_scale;
    }
    __syncthreads();

    // --- F: latch a firing lane's results on the owned elements (its
    // optval partial for rank 0 at the end); otherwise the dual update with
    // the rho rescale, z <- z_new, and at once the next iteration's prox
    // (its gap sums in the other slot). ----------------------------------
    {
      T v[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
      auto values = [&](int e, int l) {
        T* const st = state(e, l);
        const size_t vs = vstride(e);
        if (sh.fire[l]) {
          const int g = lane0 + l;
          if (e < nx)
            P.x12[(size_t)g * n + xa + e] = st[PX * vs];
          else
            P.y12[(size_t)g * m + ya + e - nx] = st[PX * vs];
        } else {
          const T cz = st[Z * vs], zn = st[ZN * vs];
          const T zt = st[ZT * vs] + alpha * st[PX * vs] + (one - alpha) * cz - zn;
          st[ZT * vs] = zt * sh.zt_scale[l];
          st[Z * vs] = zn;
          prox_step(e, l, sh.rho[l]);
        }
      };
      auto sums = [&](int e, int l) {
        if (sh.fire[l]) {
          const bool isx = e < nx;
          const T x = state(e, l)[PX * vstride(e)];
          const T* pr = sh.prm + e * 5;
          const T lp = sh.prl[e * kL + l];
          const T b = isx ? pr[1] : lp, c = isx ? lp : pr[2];
          v[6] += c * func_base(sh.ph[e], pr[0] * x - b) + pr[3] * x + T(0.5) * pr[4] * x * x;
        } else {
          gap_terms(e, l, v);
        }
      };
      element_pass(values, sums);
      lane_sums<T, 7, false>(v, sh.wsum, [&](int l, int s) -> T* {
        if (!active(l)) return nullptr;
        if (sh.fire[l]) return s == 6 ? sh.osum + l : nullptr;
        return s < 6 ? sh.psum + (par ^ 1) * kL * 6 + l * 6 + s : nullptr;
      });
    }
    if (rank == 0 && active(tid) && sh.fire[tid]) {
      T* st = P.stats + (size_t)(lane0 + tid) * 4;
      st[1] = T(sh.k[tid]);
      st[2] = T(sh.status[tid]);
      st[3] = sh.rho[tid];
    }
    __syncthreads();
    if (tid < nl && sh.fire[tid]) sh.done[tid] = 1;
    __syncthreads();
    bool all_done = true;
    for (int l = 0; l < nl; ++l) all_done = all_done && sh.done[l];
    if (all_done) break;
    par ^= 1;
  }
  // Every lane is done: rank 0 sums the optval partials; no block leaves
  // while a peer may still read its shared memory.
  cluster_barrier(cluster, C);
  if (rank == 0 && tid < nl)
    P.stats[(size_t)(lane0 + tid) * 4] = cluster_sum(cluster, sh.osum + tid, C);
  cluster_barrier(cluster, C);
}

template <typename T>
using KernelFn = void (*)(const Params<T>, const Plan);

template <typename T>
KernelFn<T> kernel_for(int kc, int in_smem) {
  switch (kc) {
    case 1: return in_smem ? cluster_kernel<T, 1, true> : cluster_kernel<T, 1, false>;
    case 2: return in_smem ? cluster_kernel<T, 2, true> : cluster_kernel<T, 2, false>;
    case 4: return in_smem ? cluster_kernel<T, 4, true> : cluster_kernel<T, 4, false>;
    case kL: return in_smem ? cluster_kernel<T, kL, true> : cluster_kernel<T, kL, false>;
    default: return nullptr;
  }
}

// The kernel's attributes for a plan, and its launch configuration.
template <typename T>
cudaError_t configure(KernelFn<T> fn, const Plan& pl, int clusters, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.smem);
  if (err != cudaSuccess) return err;
  if (pl.C > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = pl.C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * pl.C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = pl.smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// The rule picks C from 1, 2, 4, 8 and 16; a forced plan may take any C
// up to 16 (tools/k2_split.py --plan).
bool valid(int m, int n, int C, int in_smem, int itemsize, Plan* pl) {
  if (m < 1 || n < 1 || C < 1 || C > kMaxCluster) return false;
  *pl = make_plan(m, n, itemsize, C, in_smem ? 1 : 0);
  return pl->smem <= kSmemLimit;
}

template <typename T>
int max_clusters(int device, int m, int n, int C, int in_smem, int* out) {
  Plan pl;
  if (!valid(m, n, C, in_smem, sizeof(T), &pl)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  KernelFn<T> fn = kernel_for<T>(kL, pl.in_smem);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<T>(fn, pl, 1, nullptr, &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, fn, &cfg);
}

template <typename T>
int launch(int device, const void* A, const void* Ginv, const int* hf, const void* fp,
           const int* hg, const void* gp, const void* cb, const void* fbb, const void* scal,
           void* x12, void* y12, void* stats, int m, int n, int K, int kc, int C,
           int in_smem, double abs_tol, double rel_tol, int max_iter, int gap_stop,
           int adaptive_rho, void* stream) {
  Plan pl;
  KernelFn<T> fn = kernel_for<T>(kc, in_smem);
  if (K < 1 || fn == nullptr || !valid(m, n, C, in_smem, sizeof(T), &pl))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params<T> P;
  P.A = static_cast<const T*>(A);
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
  P.m = m;
  P.n = n;
  P.K = K;
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  P.gap_stop = gap_stop;
  P.adaptive_rho = adaptive_rho;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  err = configure<T>(fn, pl, (K + kc - 1) / kc, static_cast<cudaStream_t>(stream), &cfg, &attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, fn, P, pl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch plan: C = 0 asks for the rule's (cluster_plan), C > 0 for the
// layout of that cluster size with the slices in shared memory (in_smem) or
// read from global memory.  out = [C, in_smem, HA, HX, HG, shared memory
// bytes]; out[0] = 0 when the rule finds no plan.
void pogs_batch_cluster_plan(int is_double, int m, int n, int C, int in_smem, long long* out) {
  const int itemsize = is_double ? 8 : 4;
  const Plan p = C == 0 ? pick_plan(m, n, itemsize) : make_plan(m, n, itemsize, C, in_smem);
  out[0] = p.C;
  out[1] = p.in_smem;
  out[2] = p.HA;
  out[3] = p.HX;
  out[4] = p.HG;
  out[5] = p.smem;
}

// Clusters of the plan (C, in_smem) the device holds at once.  Returns a
// cudaError_t code.
int pogs_batch_max_clusters(int is_double, int device, int m, int n, int C, int in_smem,
                            int* out) {
  return is_double ? max_clusters<double>(device, m, n, C, in_smem, out)
                   : max_clusters<float>(device, m, n, C, in_smem, out);
}

// Launch the sweep on `stream`: ceil(K / kc) clusters of C blocks, Kc = kc
// lanes each; does not synchronise.  Returns the cudaError_t of the launch
// (0 on success).
int pogs_batch_sweep(int is_double, int device, const void* A, const void* Ginv, const int* hf,
                     const void* fp, const int* hg, const void* gp, const void* cb,
                     const void* fbb, const void* scal, void* x12, void* y12, void* stats,
                     int m, int n, int K, int kc, int C, int in_smem,
                     double abs_tol, double rel_tol, int max_iter, int gap_stop,
                     int adaptive_rho, void* stream) {
  if (is_double)
    return launch<double>(device, A, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats, m, n,
                          K, kc, C, in_smem, abs_tol, rel_tol, max_iter, gap_stop,
                          adaptive_rho, stream);
  return launch<float>(device, A, Ginv, hf, fp, hg, gp, cb, fbb, scal, x12, y12, stats, m, n,
                       K, kc, C, in_smem, abs_tol, rel_tol, max_iter, gap_stop, adaptive_rho,
                       stream);
}

const char* pogs_batch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
