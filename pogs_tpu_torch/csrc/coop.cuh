// Device code shared by the persistent cooperative solve kernels,
// fused_admm.cu (the graph-form solve) and fused_hsde.cu (the cone solve):
// the block shape, fixed-order block and grid reductions, and a warp dot
// product of a matrix row with a vector written inside the kernel.
//
// Determinism across blocks: each block writes its partial sums to a global
// scratch array; after a grid sync every block reduces all partials in the
// same fixed order, so every block computes bit-identical scalars and takes
// the same decisions.  No atomics on floats.  Values written by other blocks
// inside the kernel are read with __ldcg (through L2, never a stale L1).

#pragma once

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

// Dot product of a read-only matrix row with a vector written in-kernel,
// by one warp; the result is valid in every lane.
template <typename T>
__device__ __forceinline__ T warp_dot(const T* __restrict__ row, const T* vec, int len, int lane) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int j = lane;
  for (; j + 96 < len; j += 128) {
    a0 += row[j] * __ldcg(vec + j);
    a1 += row[j + 32] * __ldcg(vec + j + 32);
    a2 += row[j + 64] * __ldcg(vec + j + 64);
    a3 += row[j + 96] * __ldcg(vec + j + 96);
  }
  for (; j < len; j += 32) a0 += row[j] * __ldcg(vec + j);
  return warp_sum((a0 + a1) + (a2 + a3));
}

// Two dot products of one matrix row, with u and with v, in one pass over
// the row; each sum in the order of warp_dot.
template <typename T>
__device__ __forceinline__ void warp_dot2(const T* __restrict__ row, const T* u, const T* v,
                                          int len, int lane, T& du, T& dv) {
  T a0 = T(0), a1 = T(0), b0 = T(0), b1 = T(0);
  T a2 = T(0), a3 = T(0), b2 = T(0), b3 = T(0);
  int j = lane;
  for (; j + 96 < len; j += 128) {
    const T r0 = row[j], r1 = row[j + 32], r2 = row[j + 64], r3 = row[j + 96];
    a0 += r0 * __ldcg(u + j);
    a1 += r1 * __ldcg(u + j + 32);
    a2 += r2 * __ldcg(u + j + 64);
    a3 += r3 * __ldcg(u + j + 96);
    b0 += r0 * __ldcg(v + j);
    b1 += r1 * __ldcg(v + j + 32);
    b2 += r2 * __ldcg(v + j + 64);
    b3 += r3 * __ldcg(v + j + 96);
  }
  for (; j < len; j += 32) {
    const T r0 = row[j];
    a0 += r0 * __ldcg(u + j);
    b0 += r0 * __ldcg(v + j);
  }
  du = warp_sum((a0 + a1) + (a2 + a3));
  dv = warp_sum((b0 + b1) + (b2 + b3));
}

}  // namespace pogs
