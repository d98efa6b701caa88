// Device code shared by the persistent cooperative solve kernels,
// fused_admm.cu (the graph-form solve), fused_hsde.cu (the cone solve) and
// fused_admm_sweep.cu (a batch of graph-form solves): the block shape,
// fixed-order block and grid reductions (per lane for the batch), the
// barrier between phases, block sums, and 16-byte streaming dot products of
// matrix rows with vectors staged in shared memory.
//
// Determinism across blocks: each block writes its partial sums to a global
// scratch array; after a grid sync every block reduces all partials in the
// same fixed order, so every block computes bit-identical scalars and takes
// the same decisions.  No atomics on floats.  Values written by other blocks
// inside the kernel are read with __ldcg (through L2, never a stale L1).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "prox.cuh"

namespace pogs {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

// Reduce NS per-thread values over the block (fixed order) and write them to
// partials[(slot0 + s) * G + blockIdx.x].  smem holds NS * kWarps values.
template <typename T, int NS>
__device__ void block_partials(const T (&v)[NS], T* partials, int slot0, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    T w = warp_sum(v[s]);
    if (lane == 0) smem[s * kWarps + warp] = w;
  }
  __syncthreads();
  if (threadIdx.x < NS) {
    T acc = T(0);
    for (int w = 0; w < kWarps; ++w) acc += smem[threadIdx.x * kWarps + w];
    partials[(slot0 + threadIdx.x) * gridDim.x + blockIdx.x] = acc;
  }
  __syncthreads();
}

// After a grid sync: every block sums slot0..slot0+ns-1 over all blocks, in
// the same order, into red[slot].  Warp w reduces the slots w, w + kWarps, ...
template <typename T>
__device__ void grid_partials(const T* partials, int slot0, int ns, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < ns; s += kWarps) {
    const T* p = partials + (slot0 + s) * gridDim.x;
    T acc = T(0);
    for (int b = lane; b < (int)gridDim.x; b += 32) acc += __ldcg(p + b);
    acc = warp_sum(acc);
    if (lane == 0) red[slot0 + s] = acc;
  }
  __syncthreads();
}

// Per-lane reductions, for a kernel that runs kLaneTile solves at once and
// stores each of their vectors lanes innermost (element (i, l) at
// i * kLaneTile + l).  A loop over such a vector with a stride that is a
// multiple of 32 gives every thread one fixed lane, its lane in the warp.
// Slot s of lane l of block b lives at partials[(s * kLaneTile + l) * G + b].
constexpr int kLaneTile = 32;

// Reduce NS per-thread values over the NW warps of the block, lane by lane
// (the warps in order), and write them to slots slot0 .. slot0 + NS - 1.
// smem holds NS * NW * kLaneTile values.  Every thread must call it.
template <typename T, int NS, int NW>
__device__ void lane_block_partials(const T (&v)[NS], T* partials, int slot0, T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) smem[(s * NW + warp) * kLaneTile + lane] = v[s];
  __syncthreads();
  for (int e = threadIdx.x; e < NS * kLaneTile; e += NW * 32) {
    const int s = e / kLaneTile, l = e % kLaneTile;
    T acc = T(0);
    for (int w = 0; w < NW; ++w) acc += smem[(s * NW + w) * kLaneTile + l];
    partials[((slot0 + s) * kLaneTile + l) * gridDim.x + blockIdx.x] = acc;
  }
  __syncthreads();
}

// After a grid sync: every block sums slots slot0 .. slot0 + ns - 1 of every
// lane over all blocks, in one fixed order (lane j of a warp adds blocks j,
// j + 32, ... in turn, then the warp butterfly), into
// red[slot * kLaneTile + l].  Warp w of NW reduces the (slot, lane) pairs
// w, w + NW, ..., kB pairs at a time with all their loads issued together:
// one pair after another would wait for L2 once per pair.
template <typename T, int NW>
__device__ void lane_grid_partials(const T* partials, int slot0, int ns, T* red) {
  constexpr int kB = 8;  // pairs a warp reduces at once
  constexpr int kU = 5;  // loads per lane and pair at once: 160 blocks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = gridDim.x, np = ns * kLaneTile;
  const T* base = partials + (size_t)slot0 * kLaneTile * G;
  for (int q0 = warp; q0 < np; q0 += NW * kB) {
    T acc[kB];
#pragma unroll
    for (int j = 0; j < kB; ++j) acc[j] = T(0);
    for (int b0 = 0; b0 < G; b0 += 32 * kU) {
      T v[kB][kU];
#pragma unroll
      for (int j = 0; j < kB; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int q = q0 + j * NW, b = b0 + lane + 32 * u;
          v[j][u] = (q < np && b < G) ? __ldcg(base + (size_t)q * G + b) : T(0);
        }
#pragma unroll
      for (int j = 0; j < kB; ++j)
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[j] += v[j][u];
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const T s = warp_sum(acc[j]);
      const int q = q0 + j * NW;
      if (lane == 0 && q < np) red[slot0 * kLaneTile + q] = s;
    }
  }
  __syncthreads();
}

// The barrier between two phases: a grid sync, or __syncthreads() when the
// grid is one block.
template <typename Grid>
__device__ __forceinline__ void grid_sync(Grid& grid) {
  if (gridDim.x == 1) __syncthreads(); else grid.sync();
}

// ---------------------------------------------------------------------------
// Block sums and streaming products (fused_hsde.cu, fused_admm.cu).
// ---------------------------------------------------------------------------

// Sum NS per-thread values over the block in one fixed order (each warp's
// butterfly, then the warps in order); every thread receives the sums.
// smem holds NS * kWarps values.  Every thread must call it.
template <typename T, int NS>
__device__ void block_sum(T (&v)[NS], T* smem) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T w = warp_sum(v[s]);
    if (lane == 0) smem[s * kWarps + warp] = w;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    T acc = T(0);
    for (int w = 0; w < kWarps; ++w) acc += smem[s * kWarps + w];
    v[s] = acc;
  }
  __syncthreads();
}

// 16 bytes of T.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ void get(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ void get(const double2& v, double* o) {
    o[0] = v.x; o[1] = v.y;
  }
};

// Dot products of the columns [0, len) of one read-only row p with NV
// vectors staged in shared memory (xs[q * ldx + j] is column j of vector q;
// ldx a multiple of 16 bytes), by one warp.  The row goes as a scalar head
// up to its first 16-byte boundary, then 16-byte loads, kU per lane issued
// before any is used (kU * 512 bytes in flight per warp), then a scalar
// tail.  Where the staged columns of a 16-byte load start on 16 bytes (xs
// may start anywhere) they are read 16 bytes at a time too.  The sums, in
// one fixed order, are valid in every lane.
template <typename T, int NV, bool kAligned>
__device__ __forceinline__ void row_dot_body(const T* __restrict__ p, const T* xs, int ldx,
                                             int head, int len, int lane, T (&acc)[NV]) {
  using W = Vec16<T>;
  constexpr int V = W::n;
  constexpr int kU = 4;
  const int nv = (len - head) / V;
  const typename W::type* pv = reinterpret_cast<const typename W::type*>(p + head);
  for (int b = 0; b < nv; b += 32 * kU) {
    typename W::type r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = b + u * 32 + lane;
      if (e < nv) r[u] = __ldg(pv + e);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = b + u * 32 + lane;
      if (e < nv) {
        T a[V];
        W::get(r[u], a);
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const T* x = xs + q * ldx + head + e * V;
          T xv[V];
          if (kAligned) W::get(*reinterpret_cast<const typename W::type*>(x), xv);
          else {
#pragma unroll
            for (int c = 0; c < V; ++c) xv[c] = x[c];
          }
#pragma unroll
          for (int c = 0; c < V; ++c) acc[q] += a[c] * xv[c];
        }
      }
    }
  }
}

template <typename T, int NV>
__device__ __forceinline__ void row_dot(const T* __restrict__ p, const T* xs, int ldx, int len,
                                        int lane, T (&out)[NV]) {
  constexpr int V = Vec16<T>::n;
  T acc[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = T(0);
  int head = (int)(((16u - ((unsigned)reinterpret_cast<uintptr_t>(p) & 15u)) & 15u) / sizeof(T));
  if (head > len) head = len;
  if (lane < head) {
    const T a = __ldg(p + lane);
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] += a * xs[q * ldx + lane];
  }
  if ((reinterpret_cast<uintptr_t>(xs + head) & 15u) == 0)
    row_dot_body<T, NV, true>(p, xs, ldx, head, len, lane, acc);
  else
    row_dot_body<T, NV, false>(p, xs, ldx, head, len, lane, acc);
  const int t0 = head + (len - head) / V * V;
  if (lane < len - t0) {
    const T a = __ldg(p + t0 + lane);
#pragma unroll
    for (int q = 0; q < NV; ++q) acc[q] += a * xs[q * ldx + t0 + lane];
  }
#pragma unroll
  for (int q = 0; q < NV; ++q) out[q] = warp_sum(acc[q]);
}

// The products d_q[r] = sum_c M[r][c] x_q[c], q < NV, for the rows of the
// (rows x C) row-major, read-only M, spread over every block of the grid:
// row r goes to block r % G, warp (r / G) % kWarps.  Each block stages the
// vectors in shared memory (xs, `cap` values) one column tile at a time,
// load(c, v) giving the NV values of column c (read with __ldcg where other
// blocks wrote them).  With more than one tile a row's sums wait in
// part[r * NV + q] between tiles and add up in tile order.  epi(r, d) gets
// row r's sums in every lane of its warp.  Every thread must call it.
template <typename T, int NV, typename Load, typename Epi>
__device__ __forceinline__ void products(const T* __restrict__ M, int rows, int C, T* xs, int cap,
                                         T* part, Load load, Epi epi) {
  constexpr int V = Vec16<T>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ldx = cap / NV / V * V;
  const int ntiles = (C + ldx - 1) / ldx;
  const int G = gridDim.x;
  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * ldx, len = C - c0 < ldx ? C - c0 : ldx;
    __syncthreads();  // the last tile's readers are done
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
      T v[NV];
      load(c0 + j, v);
#pragma unroll
      for (int q = 0; q < NV; ++q) xs[q * ldx + j] = v[q];
    }
    __syncthreads();
    for (int r = blockIdx.x + G * warp; r < rows; r += G * kWarps) {
      T d[NV];
      row_dot<T, NV>(M + (size_t)r * C + c0, xs, ldx, len, lane, d);
      if (ntiles > 1) {
#pragma unroll
        for (int q = 0; q < NV; ++q) {
          const T s = (t == 0 ? T(0) : part[(size_t)r * NV + q]) + d[q];
          if (lane == 0 && t + 1 < ntiles) part[(size_t)r * NV + q] = s;
          d[q] = s;
        }
        if (t + 1 < ntiles) continue;
      }
      epi(r, d);
    }
  }
}

}  // namespace pogs
