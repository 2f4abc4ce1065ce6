// Helpers shared by the port's kernels: element conversion, the bilinear
// taps and corner loads of the three warp kernels, and block-wide
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

// V consecutive channels, loaded and stored as one aligned vector.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Bilinear sampling of an (H, W) plane at grid coordinates (gx, gy) in
// [-1, 1], align_corners=True: the top-left corner (x0, y0) as floats and the
// 1-D weights of the two columns and the two rows. The warp forward and both
// backward kernels, and the plain PyTorch version, form the pixel coordinate
// with this one expression, (g + 1) * 0.5 * (n - 1) evaluated left to right:
// any other order can flip floor() at a near-integer coordinate.
struct Taps {
  float x0, y0, wx0, wx1, wy0, wy1;
};

__device__ __forceinline__ Taps bilinear_taps(float gx, float gy, int H, int W) {
  const float x = (gx + 1.f) * 0.5f * (float)(W - 1);
  const float y = (gy + 1.f) * 0.5f * (float)(H - 1);
  Taps t;
  t.x0 = floorf(x);
  t.y0 = floorf(y);
  t.wx1 = x - t.x0;
  t.wx0 = 1.f - t.wx1;
  t.wy1 = y - t.y0;
  t.wy0 = 1.f - t.wy1;
  return t;
}

// A corner outside the source contributes zero (zeros padding). The test is
// on the float coordinate, so a sample in (-1, 0) keeps its in-range corner.
__device__ __forceinline__ bool corner_in_range(float x, float y, int H, int W) {
  return x >= 0.f && x <= (float)(W - 1) && y >= 0.f && y <= (float)(H - 1);
}

// The four corners of `tp` in the order (x0, y0), (x1, y0), (x0, y1), (x1, y1):
// whether each lies inside the (H, W) plane, and the element offset of its
// first channel in a channels-last plane of C channels (0 for a corner
// outside, which is never read). I is the kernel's index type.
template <typename I>
__device__ __forceinline__ void corner_offsets(const Taps& tp, int H, int W, int C,
                                               bool (&in)[4], I (&off)[4]) {
  const float xs[4] = {tp.x0, tp.x0 + 1.f, tp.x0, tp.x0 + 1.f};
  const float ys[4] = {tp.y0, tp.y0, tp.y0 + 1.f, tp.y0 + 1.f};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    in[t] = corner_in_range(xs[t], ys[t], H, W);
    off[t] = in[t] ? ((I)(int)ys[t] * W + (I)(int)xs[t]) * C : (I)0;
  }
}

// V channels at `off` if `in`, else zeros.
template <typename T, int V, typename I>
__device__ __forceinline__ Pack<T, V> load_pack(const T* __restrict__ base, I off, bool in) {
  Pack<T, V> p;
  if (in) {
    p = *reinterpret_cast<const Pack<T, V>*>(base + off);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p.v[j] = from_float<T>(0.f);
  }
  return p;
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
