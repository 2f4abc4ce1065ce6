// Helpers shared by the port's kernels: element conversion and block-wide
// reductions. Every exported launcher returns cudaGetLastError() so the
// Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// dtype codes passed from Python (must match ops/cuda/_build.py DTYPE_CODES).
enum DtypeCode { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Sums NV values over the block; every thread gets the totals. `smem` holds
// 32 * NV floats. blockDim.x must be a multiple of 32.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* smem) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = warp_sum(v[j]);
  __syncthreads();  // smem may still be read by a previous reduction
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) smem[wid * NV + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    float t = 0.f;
    for (int w = 0; w < nw; ++w) t += smem[w * NV + j];
    v[j] = t;
  }
}

__device__ __forceinline__ float block_max(float v, float* smem) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) smem[wid] = v;
  __syncthreads();
  float t = -INFINITY;
  for (int w = 0; w < nw; ++w) t = fmaxf(t, smem[w]);
  return t;
}

// Coordinate of pixel i on an n-pixel axis of make_coordinate_grid:
// 2 * (i / (n - 1)) - 1, in that order of operations.
__device__ __forceinline__ float grid_coord(int i, int n) {
  return 2.f * ((float)i / (float)(n - 1)) - 1.f;
}
