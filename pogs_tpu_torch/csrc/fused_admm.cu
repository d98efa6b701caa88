// The whole graph-form ADMM solve for a dense A as ONE persistent
// cooperative CUDA kernel, for Hopper (sm_90a).
//
// Replaces the Pallas kernel pogs_tpu/ops/fused_admm.py::fused_admm_loop
// (body _kernel_body).  Same algorithm and constants as the eager loop in
// pogs_tpu_torch/solver/admm.py, which is this kernel's plain version:
// prox of the 16-function library under the (a,b,c,d,e) transform (in the
// shared header prox.cuh), gap and tolerances, alpha = 1.7 over-relaxation,
// projection through the explicit (G + I)^-1 (tall: x = Ginv (x0 + A^T y0),
// y = A x; wide: Woodbury, w = Ginv (A x0 - y0), y = y0 + w, x = x0 - A^T w),
// approximate residuals, exact residuals (two more matvecs) only within 10x
// of tolerance, spectral and balancing adaptive rho with the z~ rescale, the
// done / converged / NaN latches, and at exit optval, the scaled duals, the
// warm-start z / z~ and a stats vector.
//
// What bounds it on this card (tools/k1_split.py times every phase;
// NVIDIA H100 80GB HBM3, 700 W).  A barrier costs about 1.1 us alone at any
// grid from 1 to 132 blocks, 1.7 to 2.2 us with a reduction after it.
//   * Up to a few million matrix elements (A, A^T and Ginv in L2; the bench
//     lasso 500x300 is 1.56 MB in f32): latency, about 14 to 21 us per
//     iteration in f32 from 60x40 to 2000x1000 (the parent design: 16 to
//     17 from 120x80 to 500x300): three barriers and one reduction (about
//     5 us with the waits), and per product a staging pass, two block syncs
//     and the row sums (about 2 us each); the prox about 1 to 2 us.
//   * Beyond L2 (5000x2500 f32: 125 MB per iteration, 37.3 us at 3.35
//     TB/s): the products, about 54 us of an iteration of 68 on 132 blocks
//     (55% of the stream; the parent design: 135 us at 1.1 TB/s).
//
// What the design does about it:
//   * Launch plan (ops/fused_admm.py::admm_plan): one block up to 11,000
//     matrix elements (2mn + k^2), whose barriers are __syncthreads; half
//     the SMs up to 32,768; else one block per SM (K1's route table: within
//     5% of the fastest grid in every measured cell), at most the occupancy
//     limit.  Block b owns the rows [b L / G, (b + 1) L / G) of each
//     product (L = m for the rows of A, n for A^T, Ginv's rows with its
//     side) and the x and y elements with the same indices.  The plan depends only on (m, n, the
//     element size, the SM count), so a problem always sums in one order.
//   * Three barriers per ordinary iteration, one more near tolerance.  The
//     projection's three products depend on each other (tall: rhs -> x ->
//     y, wide: rhs -> w -> x), so each needs the whole vector of the one
//     before.  The first product reads one side of the over-relaxed input
//     in full (y, the f side, tall; x, the g side, wide): the "shared" side.
//     Every block computes that whole side for itself (the previous
//     iteration's dual update, the prox, the over-relaxation) straight into
//     its staging buffer, and keeps its own copy of the side's z, z~, prox
//     value and prox parameters in shared memory.  Only the projected z
//     comes from other blocks, written before the last barrier; everything
//     else a block reads of that side it wrote itself, so no block reads a
//     slot another rewrites, and no double buffer is needed.  Same code,
//     same inputs, same order: every block holds bit-identical values, and
//     only the owner adds an element to the gap sums and writes it out.
//     The other side stays with its owners.  Where the shared side would
//     cost more than the barrier it saves (more iterative proxes than a
//     block has threads: logistic, exp, negative entropy) or does not fit
//     in shared memory (beyond about 5,400 elements in f32, 2,700 in f64),
//     the plan keeps four barriers: the owners write that side too, and a
//     barrier comes before the first product.
//   * The state of the x and y elements a block owns (z, z~, prox value,
//     over-relaxed input) stays in the global state and work vectors, read
//     and written by that block alone (a copy in shared memory was measured
//     and removed: no faster); the gap sums ride on the end-of-iteration
//     reduction (12 slots).  The next iteration writes
//     its gap sums before any barrier while a slow block may still read
//     this one's, so an iteration's partial sums alternate between two
//     copies by parity.  On one block the sums go straight to every thread.
//   * Products that stream: each block computes the products of its own
//     rows, 128 rows at a time; the 16 warps split those rows x columns into
//     equal contiguous pieces (a piece may span rows), so no warp waits on a
//     longer share; each warp streams its piece with 16-byte loads (4 per
//     lane in flight) against the vector staged in shared memory (in column
//     tiles when it does not fit), and one thread per row adds the pieces in
//     warp order.  The exact residuals' two products (A x12, A^T s_in) share
//     one staging pass and one barrier.  A route that kept each block's rows
//     in shared memory was measured and removed: at most 9% faster than
//     reading them from L2 in every cell of the route table.
//   * Registers: the block's layout (its sides and rows) lives in a shared
//     memory record read back where used; kept in registers through the
//     loop it pushed the kernel past 128 registers into local memory, which
//     with 512 threads no longer fits in L1 (3 KB of spills, a third of the
//     iteration).
//   * Every scalar decision (near, converged, the rho update, done) is
//     identical in every block: fixed-order sums (coop.cuh), no float
//     atomics.  All state and scratch are allocated by the caller.
//
// The one-pass route (a tall f32 A beyond L2: admm_plan's one_pass).  There
// an iteration is bound by its bytes: A^T y0 over A^T, Ginv rhs, A x over A
// (500 MB an iteration at 10000x5000 f32, and 400 MB more on an iteration
// near tolerance).  The row of A that gives y_i = A_i . x also carries
// A_i^T d_i into the next iteration's A^T y0, where d_i, the next
// over-relaxed input of row i, depends only on row i's state and on the
// rho step, which is decided only after the iteration's sums.  Outside a
// spectral step, that step keeps rho, multiplies it by delta or divides it
// by delta (rho_schedule_step), and delta is known before the pass.  So one
// pass over A's rows computes y = A x and three candidate products A^T d^c,
// one for each step c, and the step decided picks one:
//   * each block streams its rows kPassRows at a time (a step) through a
//     ring of kStages steps in shared memory (after the staged x), each row
//     by one bulk copy of the Tensor Memory Accelerator issued by one
//     thread kStages - 2 steps ahead, which reports to the step's
//     mbarrier; a row stays there from its dot product to its A^T use.
//     The state of the block's rows (z, z~, prox value, prox parameters)
//     is staged after the ring at the start of the pass;
//   * a step: the rows' dot products, one block sync, then on warp 0 the y
//     residual sums and, one thread per candidate, the next dual update
//     and prox (the prox loop's own expressions, dual_prox), whose z~ and
//     prox value go to P.cand, while every warp adds the previous step's
//     A_i^T d_i^c into the block's partial n-vectors for its columns (in
//     registers; written to P.cpart at the end of the pass);
//   * after the decision the owners commit the chosen candidate's y state
//     (stored, not recomputed: the state is what the A^T product saw), run
//     the x side's prox, and form rhs = x0 + the blocks' partials in block
//     order (no float atomics), so the next iteration starts with
//     Ginv rhs: 3 barriers, and one pass over A;
//   * k = 0 and a spectral step that changes rho take the plain A^T pass
//     over At for that iteration; the exact residuals stay two products.
// At 10000x5000 an ordinary iteration takes 137 us against the plain
// route's 194 (K1's route table), the pass streaming at about 2.6 TB/s.
// Measured and left: 16-byte cp.async copies by every thread (3 syncs a
// step: 152 to 155 us), a ring sized at run time (205), one that took all
// of shared memory, rows loaded straight into registers (which spilled:
// 241).  In f64 the pass's registers spill and it was 11 to 20% slower than
// the plain route, so the one pass is built for float alone.
// stats[9] counts the passes over A or A^T (a_passes) on either route, and
// stats[10] the iterations near tolerance (checks), each with its two
// exact-residual passes.

#include <cfloat>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace pogs;

// Partial-sum slots, by the phase that writes them.
enum Slot {
  S_ZMX_X12 = 0, S_ZMX2, S_X12_2, S_ZMY_Y12, S_ZMY2, S_Y12_2,  // prox, gap sums: 6
  S_DY_PREV, S_DY12, S_SUM_Y, S_DX_PREV, S_DX12, S_SUM_X,       // projection: 6
  S_R2, S_S2,                                                   // exact residuals: 2
  S_OPT,                                                        // exit: 1
  kSlots
};
constexpr int kIterSlots = S_R2;  // reduced once per iteration
constexpr int kGroupRows = 128;   // rows of a block's share combined at once
static_assert(kGroupRows <= kThreads, "one thread adds up each row of a group");

// The one-pass route: rows of A a step takes, the state copied with each
// row, the ring's stages (each one step), and the columns each thread keeps
// the candidates' partial sums of (n at most kCols * kThreads).
// ops/fused_admm.py::admm_plan mirrors them.
constexpr int kPassRows = 2;
constexpr int kCands = 3;      // keep, up, down (RhoStep order)
constexpr int kRowState = 9;   // a row's z, z~, prox value, a .. e and function code
constexpr int kStages = 4;
constexpr int kCols = 10;
static_assert(kPassRows * kWarps == 32, "one warp adds up the rows' warp sums");

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
  T* part;         // (max(m, n)) work: row sums between column tiles
  T* partials;     // (kSlots + kIterSlots, grid) work: two copies of an iteration's slots
  T* cpart;        // (kCands, grid, n) work, one pass: each block's A^T d under each candidate
  T* cand;         // (2, kCands, m) work, one pass: z~ and prox value of y under each candidate
  T* stats;        // (11) out: optval, iters, status, rho, nrm_r, nrm_s, gap, eps_pri,
                   // eps_dua, a_passes, checks
  int m, n;
  T abs_tol, rel_tol;
  int max_iter;
  int gap_stop;
  int adaptive_rho;
  int shared_side; // plan: every block computes the first product's side
  int xs_cap;      // plan: elements of the vector staging buffer
};

__host__ __device__ __forceinline__ int rnd16(int x, int v) { return (x + v - 1) / v * v; }

// The first row (or element) of block b's share of L.
__device__ __forceinline__ int share_lo(int L, int b) {
  return (int)((long long)L * b / gridDim.x);
}

// The one pass's shared memory in elements (v per 16 bytes): the ring,
// kStages steps of kPassRows rows of n, each with room to start on 16 bytes,
// then the state of each row of A a block of the grid holds; at least
// kThreads, the scratch of the sum of the blocks' partials.
__host__ __device__ __forceinline__ long long ring_elems(int m, int n, int grid, int v) {
  const long long rows = ((long long)m + grid - 1) / grid;
  const long long r = (long long)kStages * kPassRows * (rnd16(n, v) + v) +
                      rnd16((int)(rows * kRowState), v);
  return r > kThreads ? r : kThreads;
}

// Shared-memory elements the launch needs; ops/fused_admm.py::admm_plan
// computes the same: the staging buffer, the shared side in full (z, z~,
// prox value, and the a, b, c, d, e and function code of its prox), and the
// one pass's ring.
__host__ __device__ __forceinline__ long long smem_elems(int m, int n, int v, int xs_cap,
                                                         int shared_side, int one_pass, int grid) {
  const int R = m >= n ? m : n;
  return xs_cap + (shared_side ? 9LL * rnd16(R, v) : 0LL) +
         (one_pass ? ring_elems(m, n, grid, v) : 0LL);
}

// The one pass's copies: one thread asks the Tensor Memory Accelerator for a
// row's 16-byte-aligned part (cp.async.bulk), which reports the bytes to the
// step's mbarrier in shared memory; every thread waits on that barrier's
// phase.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One element's step: the dual update with the previous projection zn (where
// update; z~ then rescaled by scale), the prox under rho, and the
// over-relaxed input, returned.  z, zt and p (the prox value) in place; zm =
// the prox input less p.
template <typename T>
__device__ __forceinline__ T dual_prox(T& z, T& zt, T& p, T& zm, T zn, bool update, T scale,
                                       int h, T a, T b, T c, T d, T e, T rho) {
  const T alpha = T(1.7), one = T(1);
  if (update) {
    zt = (zt + alpha * p + (one - alpha) * z - zn) * scale;
    z = zn;
  }
  const T in = z - zt;
  p = prox_full(h, a, b, c, d, e, in, rho);
  zm = in - p;
  return zt + alpha * p + (one - alpha) * z;
}

// The elements [0, head) of a row of A before its first 16-byte boundary
// (at most n), and where the row starts in its ring slot so that the rest
// lies on 16 bytes in shared memory too.
template <typename T> __device__ __forceinline__ int row_head(const T* src, int n) {
  const unsigned off = (unsigned)reinterpret_cast<uintptr_t>(src) & 15u;
  const int h = (int)(((16u - off) & 15u) / sizeof(T));
  return h < n ? h : n;
}
template <typename T> __device__ __forceinline__ int row_shift(const T* src, int n) {
  constexpr int V = Vec16<T>::n;
  const int h = row_head(src, n);
  return h ? V - h : 0;
}

// The row sums of rg rows of a row-major matrix, columns [c0, c0 + len):
// row j starts at M + j * C + c0, and the vector is xs[0, len).  The 16 warps split the rows x
// columns into equal contiguous pieces (a piece may span rows), each
// piece's sum for a row goes to slots[row + warp], and thread j (< rg) adds
// the pieces of row j in warp order and returns the sum.  Every thread of
// the block must call it.
template <typename T>
__device__ __forceinline__ T group_sums(const T* M, int rg, int C, int c0, int len, const T* xs,
                                        T* slots) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long L = (long long)rg * len;
  const long long s = L * warp / kWarps, e = L * (warp + 1) / kWarps;
  __syncthreads();  // the last group's sums are read
  if (s < e) {
    int j = L < 0x7fffffff ? (int)((unsigned)s / (unsigned)len) : (int)(s / len);
    int c = (int)(s - (long long)j * len);
    for (long long p = s; p < e; ++j, c = 0) {
      const long long rest = e - (long long)j * len;
      const int ce = rest < len ? (int)rest : len;
      T d[1];
      row_dot<T, 1>(M + (size_t)j * C + c0 + c, xs + c, 0, ce - c, lane, d);
      if (lane == 0) slots[j + warp] = d[0];
      p += ce - c;
    }
  }
  __syncthreads();
  T d = T(0);
  const int j = threadIdx.x;
  if (j < rg) {
    // The pieces that hold part of row j, in warp order.
    const long long lo = (long long)j * len, hi = lo + len;
    long long p0 = 0;
    for (int w = 0; w < kWarps; ++w) {
      const long long p1 = L * (w + 1) / kWarps;
      if (p0 < hi && p1 > lo && p1 > p0) d += slots[j + w];
      p0 = p1;
    }
  }
  return d;
}

// The products d[r] = M[r] . x for the rows r0 <= r < r1 of a row-major
// (. x C) matrix that this block owns; M points at row r0.  The vector is in xs:
// staged by the caller (staged: all C columns), or here through load(c), in
// column tiles of at most cap columns.  The rows go kGroupRows at a time
// through group_sums; between tiles a row's sum waits in part[r].
// epi(r, d) runs on one thread per row.  Every thread of the block must
// call it.
template <typename T, typename Load, typename Epi>
__device__ __forceinline__ void block_mv(const T* M, int r0, int r1, int C, T* xs, int cap,
                                         bool staged, T* part, T* slots, Load load, Epi epi) {
  constexpr int V = Vec16<T>::n;
  const int rows = r1 - r0;
  const int ldx = staged ? C : cap / V * V;
  const int ntiles = staged ? 1 : (C + ldx - 1) / ldx;
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * ldx, len = C - c0 < ldx ? C - c0 : ldx;
    if (!staged) {
      __syncthreads();  // the last readers of xs are done
      for (int j = threadIdx.x; j < len; j += blockDim.x) xs[j] = load(c0 + j);
    }
    for (int g0 = 0; g0 < rows; g0 += kGroupRows) {
      const int rg = rows - g0 < kGroupRows ? rows - g0 : kGroupRows;
      T d = group_sums<T>(M + (size_t)g0 * C, rg, C, c0, len, xs, slots);
      const int j = threadIdx.x;
      if (j < rg) {
        const int r = r0 + g0 + j;
        if (ntiles > 1) {
          if (t > 0) d = part[r] + d;
          if (t + 1 < ntiles) part[r] = d;
        }
        if (t + 1 == ntiles) epi(r, d);
      }
    }
  }
}

// Sum NS per-thread values over a grid of one block into red[slot0 ..]
// (fixed order: each warp's butterfly, then the warps in order).
template <typename T, int NS>
__device__ void block_to_red(const T (&v)[NS], T* smem, T* red, int slot0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T w = warp_sum(v[s]);
    if (lane == 0) smem[s * kWarps + warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    T acc = T(0);
    for (int w = 0; w < kWarps; ++w) acc += smem[threadIdx.x * kWarps + w];
    red[slot0 + threadIdx.x] = acc;
  }
  __syncthreads();
}

// A matrix as the products see it: the rows r0 <= r < r1 this block owns,
// from row r0 on.
template <typename T> struct Rows {
  const T* g;
  int r0, r1, C;
};

// One side's state: z, z~, the prox value and the over-relaxed input,
// indexed by the element's index in the side (valid for the elements this
// block holds: the ones it owns, in global memory, or on the shared side
// all of z, z~ and the prox value, in shared memory; its over-relaxed input
// stays in the staging buffer).
template <typename T> struct Side {
  T *z, *zt, *p12, *zor;
  T* prm;  // the shared side: its a, b, c, d, e and function codes, rnd16(R) apart
};

// A block's layout: its sides (x, y, and the same as R and O), its rows of
// A^T, Ginv and A, and its share of each side.  Kept in shared memory and
// read back (volatile) where a phase uses it: held in registers through
// the loop, these values would push the kernel past 128 registers into
// local memory, which with 512 threads a block no longer fits in L1.
template <typename T> struct Ctx {
  Side<T> x, y, r, o;
  Rows<T> At, G, A;
  int R, O, roff, ooff, rlo, rhi, olo, ohi, rr;
};

// kPass: the one-pass route (a tall A; see the note at the top).
template <typename T, bool kPass>
__global__ void __launch_bounds__(kThreads, 1) fused_admm_kernel(Params<T> P) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ T smem[6 * kWarps];
  __shared__ T red[kSlots];
  __shared__ T slots[kGroupRows + kWarps];
  constexpr int kPassSmem = 2 * kPassRows * kWarps + kPassRows * kCands * 5 + kCands * 3;
  __shared__ T pass_sm[kPass ? kPassSmem : 1];
  __shared__ __align__(8) unsigned long long pass_bar[kPass ? kStages : 1];
  constexpr int V = Vec16<T>::n;

  const int m = P.m, n = P.n;
  const bool tall = m >= n;
  const int b = blockIdx.x, G = gridDim.x;
  const bool shared_side = P.shared_side != 0;
  const int cap = P.xs_cap;

  const T one = T(1);
  T rho = P.scal[0];
  const T norm_A = P.scal[1];
  T delta = T(K_DELTA_MIN), xi = T(1), kd = T(0), ku = T(0);
  T zt_scale = one;
  int k = 0;
  int cand = -1;   // one pass: the candidate the last rho step chose (-1: none)
  int pass_steps = 0;  // one pass: steps this block's passes have made (the barriers' phases)
  int passes = 0;  // passes over A or A^T
  int checks = 0;  // iterations near tolerance
  bool converged = false, nan_found = false;
  T nrm_r, nrm_s, gap, eps_pri, eps_dua;

  // The sides: R, read in full by the first product (y tall, x wide), and
  // O, the other.  [x; y] vectors hold x at 0 and y at n.
  const int R = tall ? m : n, O = tall ? n : m;
  const int roff = tall ? n : 0, ooff = tall ? 0 : n;
  const int rlo = share_lo(R, b), rhi = share_lo(R, b + 1);
  const int olo = share_lo(O, b), ohi = share_lo(O, b + 1);

  // Shared memory: the staging buffer, then the shared side in full.  The
  // owned elements' state is in the global state and work vectors.
  T* const xs = reinterpret_cast<T*>(dyn);
  auto own = [&](int off) {
    Side<T> s;
    s.z = P.z + off;
    s.zt = P.zt + off;
    s.p12 = P.xy12 + off;
    s.zor = P.zor + off;
    s.prm = nullptr;
    return s;
  };
  Side<T> sr = own(roff);
  const Side<T> so = own(ooff);
  const int rr = rnd16(R, V);
  if (shared_side) {
    T* const sp = xs + cap;
    sr.z = sp;
    sr.zt = sp + rr;
    sr.p12 = sp + 2 * rr;
    sr.prm = sp + 3 * rr;
    // The shared side's prox parameters, read by every block every
    // iteration, and its z and z~: copied in once.
    const int* const hR = tall ? P.hf : P.hg;
    const T* const pR = tall ? P.fp : P.gp;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
#pragma unroll
      for (int q = 0; q < 5; ++q) sr.prm[q * rr + i] = pR[q * R + i];
      sr.prm[5 * rr + i] = T(hR[i]);
      sr.z[i] = P.z[roff + i];
      sr.zt[i] = P.zt[roff + i];
    }
  }
  const Side<T> sX = tall ? so : sr, sY = tall ? sr : so;

  auto rows_of = [&](const T* g, int L, int C) {
    Rows<T> M;
    M.r0 = share_lo(L, b);
    M.r1 = share_lo(L, b + 1);
    M.C = C;
    M.g = g + (size_t)M.r0 * C;
    return M;
  };
  const int k_min = m < n ? m : n;
  const Rows<T> MAt = rows_of(P.At, n, m);
  const Rows<T> MG = rows_of(P.Ginv, k_min, k_min);
  const Rows<T> MA = rows_of(P.A, m, n);
  __shared__ Ctx<T> ctx_store;
  if (threadIdx.x == 0) {
    ctx_store.x = sX;
    ctx_store.y = sY;
    ctx_store.r = sr;
    ctx_store.o = so;
    ctx_store.At = MAt;
    ctx_store.G = MG;
    ctx_store.A = MA;
    ctx_store.R = R;
    ctx_store.O = O;
    ctx_store.roff = roff;
    ctx_store.ooff = ooff;
    ctx_store.rlo = rlo;
    ctx_store.rhi = rhi;
    ctx_store.olo = olo;
    ctx_store.ohi = ohi;
    ctx_store.rr = rr;
    if (kPass)
      for (int s = 0; s < kStages; ++s) mbar_init(&pass_bar[s]);
  }
  __syncthreads();
  volatile Ctx<T>& C = ctx_store;

  auto mv = [&](const volatile Rows<T>& M, T* xv, bool staged, auto load, auto epi) {
    block_mv<T>(M.g, M.r0, M.r1, M.C, xv, cap, staged, P.part, slots, load, epi);
  };
  auto from = [](const T* v) { return [v](int c) { return __ldcg(v + c); }; };
  const auto none = [](int) { return T(0); };
  // Slots slot0 .. slot0 + NS - 1: reduced at once on one block; else the
  // block's partial sums in base, added up after the next barrier.  An
  // iteration's 12 slots alternate between two copies by the parity of k:
  // the next iteration writes its gap sums before any barrier, while a slow
  // block may still read this one's.  The exact residuals' and the exit's
  // slots follow them (tail).
  auto partial = [&](auto& v, T* base, int slot0) {
    if (G == 1) block_to_red(v, smem, red, slot0);
    else block_partials(v, base, slot0, smem);
  };
  T* const tail = P.partials + kIterSlots * G;

  // --- The one pass: y = A x over this block's rows, and the next
  // iteration's A^T d under each candidate (the note at the top).  Adds the
  // y residual sums to v.
  T* const ring = xs + cap;
  T* const psm = pass_sm;                        // (2, kPassRows, kWarps) the dots' warp sums
  T* const zsm = psm + 2 * kPassRows * kWarps;   // (2, kPassRows, kCands) over-relaxed inputs
  T* const gsm = zsm + 2 * kPassRows * kCands;   // (kPassRows * kCands, 3) gap sums by thread
  T* const cgap = gsm + kPassRows * kCands * 3;  // (kCands, 3) the block's gap sums
  auto one_pass = [&](T (&v)[6]) {
    constexpr int NC = kCols, S = kStages;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int Ls = rnd16(n, V) + V, Lst = kPassRows * Ls;
    const int r0 = C.A.r0, rows = C.A.r1 - C.A.r0;
    const int steps = (rows + kPassRows - 1) / kPassRows;
    T* const pst = ring + S * Lst;  // (rows, kRowState): each row's state
    // Step g's stage: its kPassRows rows of A, each from its first 16-byte
    // boundary by one bulk copy (the first thread of the last warp, after
    // the stage's bytes are announced to its barrier: warp 0 runs the
    // candidates), the elements before that boundary and after the row's
    // last one by the threads after it.
    constexpr int kIssuer = kThreads - 32;
    auto issue = [&](int g) {
      const int s = (pass_steps + g) % S;
      T* const st = ring + s * Lst;
      const int nr = rows - g * kPassRows < kPassRows ? rows - g * kPassRows : kPassRows;
      if (threadIdx.x == kIssuer) {
        // The stage was last read through the generic proxy; the copies
        // write it through the async one.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        unsigned bytes = 0;
        for (int r = 0; r < nr; ++r) {
          const T* const src = P.A + (size_t)(r0 + g * kPassRows + r) * n;
          bytes += (n - row_head(src, n)) / V * 16;
        }
        mbar_expect(&pass_bar[s], bytes);
        for (int r = 0; r < nr; ++r) {
          const T* const src = P.A + (size_t)(r0 + g * kPassRows + r) * n;
          const int head = row_head(src, n), nv = (n - head) / V;
          if (nv > 0)
            bulk_copy(st + r * Ls + row_shift(src, n) + head, src + head, nv * 16, &pass_bar[s]);
        }
      }
      for (int r = 0; r < nr; ++r) {
        const T* const src = P.A + (size_t)(r0 + g * kPassRows + r) * n;
        const int head = row_head(src, n), t0 = head + (n - head) / V * V;
        const int e = (int)threadIdx.x - kIssuer - 1 - r * 2 * V;
        if (e >= 0 && e < head + n - t0) {
          const int c = e < head ? e : t0 + e - head;
          st[r * Ls + row_shift(src, n) + c] = __ldg(src + c);
        }
      }
    };
    // The ring was last written through the generic proxy (the scratch of
    // commit_rhs) and is written next through the async one.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the last readers of xs and the ring are done
    for (int g = 0; g < S - 2 && g < steps; ++g) issue(g);
    for (int j = threadIdx.x; j < n; j += blockDim.x) xs[j] = __ldcg(P.znew + j);
    for (int t = threadIdx.x; t < rows * kRowState; t += blockDim.x) {
      const int r = t / kRowState, f = t % kRowState, i = r0 + r;
      if (f == kRowState - 1) *reinterpret_cast<int*>(pst + t) = __ldg(P.hf + i);
      else pst[t] = f == 0 ? C.y.z[i] : f == 1 ? C.y.zt[i] : f == 2 ? C.y.p12[i]
                                                         : __ldg(P.fp + (size_t)(f - 3) * m + i);
    }
    T acc[kCands][NC];
#pragma unroll
    for (int c = 0; c < kCands; ++c)
#pragma unroll
      for (int u = 0; u < NC; ++u) acc[c][u] = T(0);
    // Thread q < kPassRows * kCands runs candidate qc of the step's row qr.
    const int q = threadIdx.x, qr = q / kCands, qc = q % kCands;
    const T rho_q = qc == kRhoUp ? rho * delta : qc == kRhoDown ? rho / delta : rho;
    const T scale_q = qc == kRhoUp ? one / delta : qc == kRhoDown ? delta : one;
    T gq[3] = {T(0), T(0), T(0)};
    __syncthreads();  // x, the state and the first steps' edge elements are staged
    // The rows of step g from its stage, the last standing in for rows
    // past the block's.
    auto rows_of = [&](int g, const T* (&row)[kPassRows]) {
      const T* const st = ring + ((pass_steps + g) % S) * Lst;
      const int rg = rows - g * kPassRows < kPassRows ? rows - g * kPassRows : kPassRows;
#pragma unroll
      for (int r = 0; r < kPassRows; ++r) {
        const int rr = r < rg ? r : 0;
        row[r] = st + rr * Ls + row_shift(P.A + (size_t)(r0 + g * kPassRows + rr) * n, n);
      }
      return rg;
    };
    // acc += A_i^T d_i^c for step g's rows.
    auto scatter = [&](int g) {
      const T* row[kPassRows];
      const int rg = rows_of(g, row);
      const T* const zg = zsm + (g & 1) * kPassRows * kCands;
      T wz[kPassRows][kCands];
#pragma unroll
      for (int r = 0; r < kPassRows; ++r)
#pragma unroll
        for (int c = 0; c < kCands; ++c) wz[r][c] = r < rg ? zg[r * kCands + c] : T(0);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < n) {
#pragma unroll
          for (int r = 0; r < kPassRows; ++r) {
            const T a = row[r][j];
#pragma unroll
            for (int c = 0; c < kCands; ++c) acc[c][u] += a * wz[r][c];
          }
        }
      }
    };
    // Step g: its dot products, one block sync, then on warp 0 its
    // candidates while every warp adds step g - 1's A^T products (whose
    // candidates warp 0 ran before that sync), and the copy of step
    // g + S - 2 into the stage step g - 2 used.  The warp sums and the
    // candidates' inputs alternate between two buffers by the parity of g.
    for (int g = 0; g < steps; ++g) {
      const int gs = pass_steps + g;
      mbar_wait(&pass_bar[gs % S], (gs / S) & 1);
      const T* row[kPassRows];
      const int rg = rows_of(g, row);
      T d[kPassRows];
#pragma unroll
      for (int r = 0; r < kPassRows; ++r) d[r] = T(0);
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < n) {
          const T xv = xs[j];
#pragma unroll
          for (int r = 0; r < kPassRows; ++r) d[r] += row[r][j] * xv;
        }
      }
      T* const pg = psm + (g & 1) * kPassRows * kWarps;
#pragma unroll
      for (int r = 0; r < kPassRows; ++r) {
        const T w = warp_sum(d[r]);
        if (lane == 0) pg[r * kWarps + warp] = w;
      }
      __syncthreads();
      if (warp == 0) {
        // Lanes 16 r .. 16 r + 15 add up row r's warp sums (a fixed
        // butterfly); each candidate thread takes its row's.
        T y = pg[lane];
#pragma unroll
        for (int off = kWarps / 2; off > 0; off >>= 1) y += __shfl_xor_sync(0xffffffffu, y, off);
        y = __shfl_sync(0xffffffffu, y, (qr < kPassRows ? qr : 0) * kWarps);
        if (q < kCands * rg) {
          const int i = r0 + g * kPassRows + qr;
          const T* const sv = pst + (g * kPassRows + qr) * kRowState;
          T z = sv[0], zt = sv[1], p = sv[2], zm;
          if (qc == kRhoKeep) {
            P.znew[n + i] = y;
            const T dp = z - y, d12 = p - y;
            v[S_DY_PREV - S_DY_PREV] += dp * dp;
            v[S_DY12 - S_DY_PREV] += d12 * d12;
            v[S_SUM_Y - S_DY_PREV] += y;
            P.sin[i] = p + zt - z;
          }
          zsm[(g & 1) * kPassRows * kCands + q] =
              dual_prox(z, zt, p, zm, y, true, scale_q,
                        *reinterpret_cast<const int*>(sv + kRowState - 1), sv[3], sv[4], sv[5],
                        sv[6], sv[7], rho_q);
          P.cand[(size_t)qc * m + i] = zt;
          P.cand[(size_t)(kCands + qc) * m + i] = p;
          gq[0] += zm * p;
          gq[1] += zm * zm;
          gq[2] += p * p;
        }
      }
      if (g > 0) scatter(g - 1);
      if (g + S - 2 < steps) issue(g + S - 2);
    }
    __syncthreads();
    if (steps > 0) scatter(steps - 1);
    pass_steps += steps;
    // The candidates' gap sums (threads, then rows, in order), and the
    // block's partial products.
    if (q < kPassRows * kCands)
      for (int s = 0; s < 3; ++s) gsm[q * 3 + s] = gq[s];
    __syncthreads();
    if (threadIdx.x < kCands * 3) {
      const int c = threadIdx.x / 3, s = threadIdx.x % 3;
      T t = T(0);
      for (int r = 0; r < kPassRows; ++r) t += gsm[(r * kCands + c) * 3 + s];
      cgap[threadIdx.x] = t;
    }
#pragma unroll
    for (int c = 0; c < kCands; ++c)
#pragma unroll
      for (int u = 0; u < NC; ++u) {
        const int j = threadIdx.x + u * kThreads;
        if (j < n) P.cpart[((size_t)c * G + b) * n + j] = acc[c][u];
      }
  };

  // rhs = x0 + the blocks' A^T d under candidate c, for this block's x
  // elements: the warps split the blocks into ranges and the lanes take 32
  // columns, then each column adds its ranges in order (the ring as
  // scratch).  Every thread of the block calls it.
  auto commit_rhs = [&](int c) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T* const cp = P.cpart + (size_t)c * G * n;
    const int olo = C.olo, no = C.ohi - C.olo, nch = (no + 31) / 32;
    for (int c0 = 0; c0 < nch; c0 += kWarps) {
      const int nc = nch - c0 < kWarps ? nch - c0 : kWarps;  // 32-column chunks this round
      const int ranges = kWarps / nc, rng = warp / nc;
      const int jj = (c0 + warp % nc) * 32 + lane;
      T s = T(0);
      if (rng < ranges && jj < no) {
        const int b0 = (int)((long long)G * rng / ranges);
        const int b1 = (int)((long long)G * (rng + 1) / ranges);
        const T* const p = cp + olo + jj;
#pragma unroll 4
        for (int bb = b0; bb < b1; ++bb) s += __ldcg(p + (size_t)bb * n);
      }
      ring[warp * 32 + lane] = s;
      __syncthreads();
      const int j2 = (c0 + warp) * 32 + lane;
      if (warp < nc && j2 < no) {
        T t = C.x.zor[olo + j2];
        for (int r = 0; r < ranges; ++r) t += ring[(r * nc + warp) * 32 + lane];
        P.rhs[olo + j2] = t;
      }
      __syncthreads();
    }
  };

  for (;;) {
    const bool update = k > 0;
    T* const iter_partials = P.partials + (k & 1) * kIterSlots * G;
    // One pass: the last pass holds this iteration's y side and A^T y0.
    const bool commit = kPass && cand >= 0;

    // --- Prox: both sides, with the previous iteration's dual update. -----
    // Each thread takes its elements kChunk at a time: every load of a chunk
    // is issued before any prox.
    {
      constexpr int kChunk = 2;
      T gR[3] = {T(0), T(0), T(0)}, gO[3] = {T(0), T(0), T(0)};  // gap sums
      const int R = C.R, O = C.O, rlo = C.rlo, rhi = C.rhi, olo = C.olo;
      const int lo = shared_side ? 0 : rlo;
      const int nR = commit ? 0 : (shared_side ? R : rhi) - lo, total = nR + (C.ohi - olo);
      const int* const hR = tall ? P.hf : P.hg;
      const int* const hO = tall ? P.hg : P.hf;
      const T* const pR = tall ? P.fp : P.gp;
      const T* const pO = tall ? P.gp : P.fp;
      for (int e0 = threadIdx.x; e0 < total; e0 += kChunk * blockDim.x) {
        T zn[kChunk], pa[kChunk], pb[kChunk], pc[kChunk], pd[kChunk], pe[kChunk];
        int hh[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int e = e0 + u * (int)blockDim.x;
          if (e < total) {
            const bool isR = e < nR;
            const int i = isR ? lo + e : olo + e - nR;
            zn[u] = update ? __ldcg(P.znew + (isR ? C.roff : C.ooff) + i) : T(0);
            if (isR && shared_side) {
              const T* const q = C.r.prm;
              const int rr = C.rr;
              hh[u] = (int)q[5 * rr + i];
              pa[u] = q[i];
              pb[u] = q[rr + i];
              pc[u] = q[2 * rr + i];
              pd[u] = q[3 * rr + i];
              pe[u] = q[4 * rr + i];
            } else {
              const int len = isR ? R : O;
              const T* pp = isR ? pR : pO;
              hh[u] = __ldg((isR ? hR : hO) + i);
              pa[u] = __ldg(pp + i);
              pb[u] = __ldg(pp + len + i);
              pc[u] = __ldg(pp + 2 * len + i);
              pd[u] = __ldg(pp + 3 * len + i);
              pe[u] = __ldg(pp + 4 * len + i);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int e = e0 + u * (int)blockDim.x;
          if (e < total) {
            const bool isR = e < nR;
            const int i = isR ? lo + e : olo + e - nR;
            T* const sz = isR ? C.r.z : C.o.z;
            T* const szt = isR ? C.r.zt : C.o.zt;
            T* const sp12 = isR ? C.r.p12 : C.o.p12;
            T z = sz[i], zt = szt[i], p = sp12[i], zm;
            const T zor = dual_prox(z, zt, p, zm, zn[u], update, zt_scale, hh[u], pa[u], pb[u],
                                    pc[u], pd[u], pe[u], rho);
            sz[i] = z;
            szt[i] = zt;
            sp12[i] = p;
            if (isR && shared_side) xs[i] = zor;
            if (!isR || (i >= rlo && i < rhi)) {  // an element this block owns
              (isR ? C.r.zor : C.o.zor)[i] = zor;
              if (isR) {
                gR[0] += zm * p;
                gR[1] += zm * zm;
                gR[2] += p * p;
              } else {
                gO[0] += zm * p;
                gO[1] += zm * zm;
                gO[2] += p * p;
              }
              if (isR != tall) P.xy12[i] = p;  // x12, for the exact residuals
            }
          }
        }
      }
      if (commit) {
        // The y side: the chosen candidate's state, as the pass stored it.
        const T* const czt = P.cand + (size_t)cand * m;
        const T* const cp12 = P.cand + (size_t)(kCands + cand) * m;
        for (int i = rlo + (int)threadIdx.x; i < rhi; i += blockDim.x) {
          C.y.z[i] = P.znew[n + i];
          C.y.zt[i] = czt[i];
          C.y.p12[i] = cp12[i];
        }
        if (threadIdx.x == 0)
          for (int s = 0; s < 3; ++s) gR[s] += cgap[cand * 3 + s];
      }
      T g[6];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        g[S_ZMX_X12 + s] = tall ? gO[s] : gR[s];
        g[S_ZMY_Y12 + s] = tall ? gR[s] : gO[s];
      }
      partial(g, iter_partials, S_ZMX_X12);
      if (commit) commit_rhs(cand);
    }
    if (!shared_side) {
      grid_sync(grid);
    }

    // --- The projection: three products, a barrier after each. -----------
    T v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};  // residual sums, from S_DY_PREV
    if (tall) {
      // rhs = x0 + A^T y0 (on the one-pass route only where the last pass
      // holds no candidate for the rho step taken)
      if (!commit) {
        mv(C.At, xs, shared_side, from(P.zor + n), [&](int r, T d) {
          P.rhs[r] = C.x.zor[r] + d;
        });
        grid_sync(grid);
        ++passes;
      }
      // x = Ginv rhs, with the x residual sums
      mv(C.G, xs, false, from(P.rhs), [&](int r, T d) {
        P.znew[r] = d;
        const T dp = C.x.z[r] - d, d12 = C.x.p12[r] - d;
        v[S_DX_PREV - S_DY_PREV] += dp * dp;
        v[S_DX12 - S_DY_PREV] += d12 * d12;
        v[S_SUM_X - S_DY_PREV] += d;
      });
      grid_sync(grid);
      // y = A x, with the y residual sums; on the one-pass route with the
      // next iteration's A^T products
      if (kPass) one_pass(v);
      if (!kPass) mv(C.A, xs, false, from(P.znew), [&](int i, T d) {
        P.znew[n + i] = d;
        const T cy = C.y.z[i], yh = C.y.p12[i];
        const T dp = cy - d, d12 = yh - d;
        v[S_DY_PREV - S_DY_PREV] += dp * dp;
        v[S_DY12 - S_DY_PREV] += d12 * d12;
        v[S_SUM_Y - S_DY_PREV] += d;
        P.sin[i] = yh + C.y.zt[i] - cy;
      });
      ++passes;
    } else {
      // rhs = A x0 - y0
      mv(C.A, xs, shared_side, from(P.zor), [&](int i, T d) {
        P.rhs[i] = d - C.y.zor[i];
      });
      grid_sync(grid);
      // w = Ginv rhs, y = y0 + w, with the y residual sums
      mv(C.G, xs, false, from(P.rhs), [&](int i, T d) {
        P.w[i] = d;
        const T yn = C.y.zor[i] + d;
        P.znew[n + i] = yn;
        const T cy = C.y.z[i], yh = C.y.p12[i];
        const T dp = cy - yn, d12 = yh - yn;
        v[S_DY_PREV - S_DY_PREV] += dp * dp;
        v[S_DY12 - S_DY_PREV] += d12 * d12;
        v[S_SUM_Y - S_DY_PREV] += yn;
        P.sin[i] = yh + C.y.zt[i] - cy;
      });
      grid_sync(grid);
      // x = x0 - A^T w, with the x residual sums
      mv(C.At, xs, false, from(P.w), [&](int r, T d) {
        const T xn = C.x.zor[r] - d;
        P.znew[r] = xn;
        const T dp = C.x.z[r] - xn, d12 = C.x.p12[r] - xn;
        v[S_DX_PREV - S_DY_PREV] += dp * dp;
        v[S_DX12 - S_DY_PREV] += d12 * d12;
        v[S_SUM_X - S_DY_PREV] += xn;
      });
      passes += 2;
    }
    partial(v, iter_partials, S_DY_PREV);
    if (G > 1) {
      grid_sync(grid);
      grid_partials(iter_partials, 0, kIterSlots, red);
    }

    // --- Scalars: identical in every block. ----------------------------
    const T abs_tol = P.abs_tol, rel_tol = P.rel_tol;
    gap = m_fabs(red[S_ZMX_X12] + red[S_ZMY_Y12]);
    const T zm2 = red[S_ZMX2] + red[S_ZMY2];
    const T eps_gap = m_sqrt(T(m + n)) * abs_tol +
                      rel_tol * m_sqrt(zm2) * m_sqrt(red[S_X12_2] + red[S_Y12_2]);
    eps_pri = m_sqrt(T(m)) * abs_tol + rel_tol * m_sqrt(red[S_Y12_2]);
    eps_dua = rho * (m_sqrt(T(n)) * abs_tol + rel_tol * m_sqrt(red[S_ZMX2]));
    nrm_s = rho * (norm_A * m_sqrt(red[S_DY_PREV]) + m_sqrt(red[S_DX_PREV]));
    nrm_r = norm_A * m_sqrt(red[S_DX12]) + m_sqrt(red[S_DY12]);
    const T new_sum = red[S_SUM_Y] + red[S_SUM_X];

    const bool near = nrm_r < T(10) * eps_pri && nrm_s < T(10) * eps_dua;
    if (near) {
      // --- Exact residuals r = A x12 - y12, s = A^T s_in + (x12 + zt_x - z_x).
      T ve[2] = {T(0), T(0)};
      auto r_epi = [&](int i, T d) {
        const T rv = d - C.y.p12[i];
        ve[0] += rv * rv;
      };
      auto s_epi = [&](int j, T d) {
        const T sv = d + (C.x.p12[j] + C.x.zt[j] - C.x.z[j]);
        ve[1] += sv * sv;
      };
      const int nn = rnd16(n, V);
      if (nn + rnd16(m, V) <= cap) {
        // Both vectors staged in one pass.
        __syncthreads();
        for (int c = threadIdx.x; c < n + m; c += blockDim.x)
          xs[c < n ? c : nn + c - n] = c < n ? __ldcg(P.xy12 + c) : __ldcg(P.sin + c - n);
        mv(C.A, xs, true, none, r_epi);
        mv(C.At, xs + nn, true, none, s_epi);
      } else {
        mv(C.A, xs, false, from(P.xy12), r_epi);
        mv(C.At, xs, false, from(P.sin), s_epi);
      }
      passes += 2;
      ++checks;
      partial(ve, tail, S_R2);
      if (G > 1) {
        grid_sync(grid);
        grid_partials(tail, S_R2, 2, red);
      }
      nrm_r = m_sqrt(red[S_R2]);
      nrm_s = rho * m_sqrt(red[S_S2]);
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

    // --- Adaptive rho (pogs.cpp:401-466); z~ is rescaled in the next prox.
    // On the one-pass route the step picks its candidate (none if spectral).
    zt_scale = one;
    int step = kRhoKeep;
    if (P.adaptive_rho)
      zt_scale = rho_schedule_step(k, nrm_r, nrm_s, eps_pri, eps_dua, rho, delta, xi, kd, ku,
                                   kPass ? &step : nullptr);
    cand = kPass && step != kRhoSpectral ? step : -1;
    ++k;
  }

  // --- Exit: optval, scaled duals, z and z~ of the owned elements, stats. -
  {
    T vo[1] = {T(0)};
    auto out = [&](int off, int i, const int* hh, const T* pp, int len,
                   const volatile Side<T>& s) {
      const T a = pp[i], bb = pp[len + i], c = pp[2 * len + i];
      const T d = pp[3 * len + i], e = pp[4 * len + i];
      const T x = s.p12[i], zc = s.z[i], ztc = s.zt[i];
      vo[0] += c * func_base(hh[i], a * x - bb) + d * x + T(0.5) * e * x * x;
      P.xy12[off + i] = x;
      P.munu[off + i] = -rho * (ztc - zc + x);
      P.z[off + i] = zc;
      P.zt[off + i] = ztc;
    };
    for (int j = share_lo(n, b) + (int)threadIdx.x; j < share_lo(n, b + 1); j += blockDim.x)
      out(0, j, P.hg, P.gp, n, C.x);
    for (int i = share_lo(m, b) + (int)threadIdx.x; i < share_lo(m, b + 1); i += blockDim.x)
      out(n, i, P.hf, P.fp, m, C.y);
    partial(vo, tail, S_OPT);
  }
  if (G > 1) {
    grid_sync(grid);
    grid_partials(tail, S_OPT, 1, red);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int status = converged ? kSuccess : (nan_found ? kNanFound : kMaxIter);
    T* st = P.stats;
    st[0] = red[S_OPT];
    st[1] = T(k);
    st[2] = T(status);
    st[3] = rho;
    st[4] = nrm_r;
    st[5] = nrm_s;
    st[6] = gap;
    st[7] = eps_pri;
    st[8] = eps_dua;
    st[9] = T(passes);
    st[10] = T(checks);
  }
}

// The kernel of a route: the one pass (float only) or the plain products;
// null for a double one pass.
template <typename T> const void* kernel_of(int one_pass) {
  if constexpr (sizeof(T) == 4)
    if (one_pass) return (const void*)fused_admm_kernel<T, true>;
  return one_pass ? nullptr : (const void*)fused_admm_kernel<T, false>;
}

template <typename T>
int blocks_per_sm(int device, int smem_bytes, int one_pass, int* per_sm) {
  const void* kernel = kernel_of<T>(one_pass);
  if (!kernel) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads,
                                                            smem_bytes);
}

template <typename T>
int launch(int device, const void* A, const void* At, const void* Ginv,
           const int* hf, const void* fp, const int* hg, const void* gp,
           const void* scal, void* xy12, void* munu, void* z, void* zt,
           void* work, void* stats, int m, int n, double abs_tol,
           double rel_tol, int max_iter, int gap_stop, int adaptive_rho,
           int grid, int smem_bytes, int xs_cap, int shared_side, int one_pass,
           void* stream) {
  constexpr int V = Vec16<T>::n;
  const int R = m >= n ? m : n;
  const void* kernel = kernel_of<T>(one_pass);
  if (!kernel || m < 1 || n < 1 || grid < 1 || xs_cap < V || xs_cap % V ||
      (shared_side && xs_cap < rnd16(R, V)) ||
      (one_pass && (m < n || shared_side || xs_cap < rnd16(n, V) || n > kCols * kThreads)) ||
      (long long)smem_bytes <
          smem_elems(m, n, V, xs_cap, shared_side, one_pass, grid) * (long long)sizeof(T))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
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
  P.w = P.rhs + k;
  P.sin = P.w + k;
  P.part = P.sin + m;
  P.partials = P.part + R;
  T* const pass = P.partials + (size_t)(kSlots + kIterSlots) * grid;
  P.cpart = one_pass ? pass : nullptr;
  P.cand = one_pass ? pass + (size_t)kCands * grid * n : nullptr;
  P.stats = static_cast<T*>(stats);
  P.m = m;
  P.n = n;
  P.abs_tol = T(abs_tol);
  P.rel_tol = T(rel_tol);
  P.max_iter = max_iter;
  P.gap_stop = gap_stop;
  P.adaptive_rho = adaptive_rho;
  P.shared_side = shared_side;
  P.xs_cap = xs_cap;
  void* args[] = {&P};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem_bytes,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Elements of the work buffer the launch needs for a given grid and route.
long long pogs_fused_admm_work_elems(int m, int n, int grid, int one_pass) {
  const long long N = (long long)m + n, k = m < n ? m : n, R = m > n ? m : n;
  const long long pass = one_pass ? (long long)kCands * grid * n + 2LL * kCands * m : 0;
  return 2 * N + 2 * k + m + R + (long long)(kSlots + kIterSlots) * grid + pass;
}

// Shared-memory bytes a launch plan needs (ops/fused_admm.py::admm_plan
// computes the same).
long long pogs_fused_admm_smem_bytes(int is_double, int m, int n, int xs_cap, int shared_side,
                                     int one_pass, int grid) {
  const int size = is_double ? 8 : 4;
  return smem_elems(m, n, 16 / size, xs_cap, shared_side, one_pass, grid) * size;
}

// The blocks of a route's kernel an SM holds at once with `smem_bytes` of
// dynamic shared memory (0: it does not fit).  Returns a cudaError_t code.
int pogs_fused_admm_blocks_per_sm(int is_double, int device, int smem_bytes, int one_pass,
                                  int* per_sm) {
  return is_double ? blocks_per_sm<double>(device, smem_bytes, one_pass, per_sm)
                   : blocks_per_sm<float>(device, smem_bytes, one_pass, per_sm);
}

// Launch the whole solve on `stream` with the launch plan (grid blocks,
// smem_bytes of dynamic shared memory, xs_cap staged elements, the shared
// side on or off, the one pass on (float only) or off); does not
// synchronise.  Returns
// the cudaError_t of the launch (0 on success).
int pogs_fused_admm(int is_double, int device, const void* A, const void* At,
                    const void* Ginv, const int* hf, const void* fp,
                    const int* hg, const void* gp, const void* scal,
                    void* xy12, void* munu, void* z, void* zt, void* work,
                    void* stats, int m, int n, double abs_tol, double rel_tol,
                    int max_iter, int gap_stop, int adaptive_rho, int grid,
                    int smem_bytes, int xs_cap, int shared_side, int one_pass,
                    void* stream) {
  if (is_double)
    return launch<double>(device, A, At, Ginv, hf, fp, hg, gp, scal, xy12, munu, z,
                          zt, work, stats, m, n, abs_tol, rel_tol, max_iter,
                          gap_stop, adaptive_rho, grid, smem_bytes, xs_cap, shared_side,
                          one_pass, stream);
  return launch<float>(device, A, At, Ginv, hf, fp, hg, gp, scal, xy12, munu, z,
                       zt, work, stats, m, n, abs_tol, rel_tol, max_iter,
                       gap_stop, adaptive_rho, grid, smem_bytes, xs_cap, shared_side,
                       one_pass, stream);
}

const char* pogs_fused_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
