// The cost of one grid-wide barrier, alone and with the fixed-order
// reduction of 5 partial-sum slots that follows it in the cone kernel
// (csrc/coop.cuh), by grid size.  Built and run by tools/k3_split.py.
//
//   mode 0: grid.sync() alone;
//   mode 1: block_partials of 5 slots, grid.sync(), grid_partials of 5;
//   mode 2: the same with __syncthreads() in place of the grid sync (one
//           block: the cone kernel's one-block route).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "coop.cuh"

namespace cg = cooperative_groups;
using namespace pogs;

namespace {

__global__ void __launch_bounds__(kThreads, 1) loop_kernel(float* partials, float* out, int iters,
                                                           int mode) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float smem[5 * kWarps];
  __shared__ float red[5];
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
      grid.sync();
      continue;
    }
    float v[5];
    for (int s = 0; s < 5; ++s) v[s] = float(threadIdx.x + s + it);
    block_partials<float, 5>(v, partials, 0, smem);
    if (mode == 1) grid.sync(); else __syncthreads();
    grid_partials(partials, 0, 5, red);
    acc += red[it % 5];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// Microseconds per loop iteration (CUDA events over `iters` iterations, after
// one untimed launch); negative on a CUDA error.
double barrier_loop_us(int grid, int iters, int mode) {
  float *partials = nullptr, *out = nullptr;
  if (cudaMalloc(&partials, 5 * 132 * 8 * sizeof(float)) != cudaSuccess) return -1.0;
  if (cudaMalloc(&out, 132 * 8 * sizeof(float)) != cudaSuccess) return -1.0;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  void* args[] = {&partials, &out, &iters, &mode};
  double us = -1.0;
  if (cudaLaunchCooperativeKernel((const void*)loop_kernel, dim3(grid), dim3(kThreads), args, 0,
                                  0) == cudaSuccess) {
    cudaEventRecord(a);
    cudaLaunchCooperativeKernel((const void*)loop_kernel, dim3(grid), dim3(kThreads), args, 0, 0);
    cudaEventRecord(b);
    if (cudaEventSynchronize(b) == cudaSuccess && cudaGetLastError() == cudaSuccess) {
      float ms = 0.f;
      cudaEventElapsedTime(&ms, a, b);
      us = 1e3 * ms / iters;
    }
  }
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  cudaFree(partials);
  cudaFree(out);
  return us;
}

}  // extern "C"
