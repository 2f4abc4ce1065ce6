// Bilinear warp: sample a (B, H, W, C) channels-last source at a (B, N, 2)
// xy grid in [-1, 1], align_corners=True, zeros padding -> (B, N, C).
//
// Replaces the TPU forward kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_fwd_impl -> _fwd_kernel). That kernel rewrites the gather as two
// separable hat-matrix matmuls because the TPU has no fast vector gather; a
// Hopper SM gathers from L1/L2 directly, so this is the plain four-tap
// gather: one thread per (output point, vector of V channels). Neighbouring
// threads take neighbouring channels of the same corner pixel, so each corner
// read is one coalesced row segment of the channels-last source.
//
// Bound: bytes. Per output point the kernel must read its 8-byte grid entry
// and write C values; the source is read once from DRAM and then mostly hit
// in L2 (50 MB holds every source plane of the main path). Corner weights
// and coordinates are f32 whatever the operand type; accumulation is f32.
#include "common.cuh"

namespace {

template <typename T, int V>
__global__ void warp_fwd_kernel(const T* __restrict__ src, const float* __restrict__ grid,
                                T* __restrict__ out, int H, int W, int C, long long N,
                                long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int CV = C / V;
  const int cv = (int)(i % CV);
  const long long bn = i / CV;  // b * N + n
  const long long b = bn / N;

  const Taps tp = bilinear_taps(grid[2 * bn], grid[2 * bn + 1], H, W);
  const float x0 = tp.x0, y0 = tp.y0, x1 = x0 + 1.f, y1 = y0 + 1.f;

  const T* base = src + b * (long long)H * W * C + (long long)cv * V;
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  const float xs[4] = {x0, x1, x0, x1};
  const float ys[4] = {y0, y0, y1, y1};
  const float ws[4] = {tp.wx0 * tp.wy0, tp.wx1 * tp.wy0, tp.wx0 * tp.wy1, tp.wx1 * tp.wy1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (corner_in_range(xs[t], ys[t], H, W)) {
      const long long pix = (long long)ys[t] * W + (long long)xs[t];
      const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(base + pix * C);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += to_float(p.v[j]) * ws[t];
    }
  }

  Pack<T, V> o;
#pragma unroll
  for (int j = 0; j < V; ++j) o.v[j] = from_float<T>(acc[j]);
  *reinterpret_cast<Pack<T, V>*>(out + bn * C + (long long)cv * V) = o;
}

template <typename T, int V>
void launch(const void* src, const float* grid, void* out, int B, int H, int W, int C,
            long long N, cudaStream_t stream) {
  const long long total = (long long)B * N * (C / V);
  if (total == 0) return;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_fwd_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), grid, static_cast<T*>(out), H, W, C, N, total);
}

}  // namespace

// vec: channels per thread, 4 or 1 (the wrapper picks 4 when C % 4 == 0 and
// both pointers are aligned to 4 elements).
extern "C" int mk_warp_fwd(const void* src, const void* grid, void* out, int B, int H, int W,
                           int C, long long N, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  if (dtype == kFloat32) {
    if (vec == 4) launch<float, 4>(src, g, out, B, H, W, C, N, s);
    else launch<float, 1>(src, g, out, B, H, W, C, N, s);
  } else if (dtype == kBFloat16) {
    if (vec == 4) launch<__nv_bfloat16, 4>(src, g, out, B, H, W, C, N, s);
    else launch<__nv_bfloat16, 1>(src, g, out, B, H, W, C, N, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
