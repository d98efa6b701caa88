// Device code shared by the persistent cooperative solve kernels,
// fused_admm.cu (the graph-form solve), fused_hsde.cu (the cone solve) and
// fused_admm_sweep.cu (a batch of graph-form solves): the block shape,
// fixed-order block and grid reductions (per lane for the batch), and a warp
// dot product of a matrix row with a vector written inside the kernel.
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
