// Warp gradient w.r.t. the source: scatter dout (B, N, C) back to the four
// corners each output point sampled, with the forward's bilinear weights,
// into a channels-last (B, H, W, C) f32 buffer.
//
// Replaces the TPU d_src kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_bwd -> _dsrc_kernel). That kernel has no scatter to use, so it
// rebuilds the hat-weight matrices per tile of 256 points and accumulates
// Z @ Ax into a VMEM-resident source plane over a sequential grid axis.
// Blocks on a GPU run in no order and Hopper has f32 atomics in L2 (also as
// one float4 instruction), so this is the direct form: the launcher zeroes
// the buffer, then one thread per (output point, vector of V channels) adds
// dout * w_corner to every in-range corner with atomicAdd. Accumulation is
// f32 whatever the operand type, as in the TPU kernel; the wrapper casts the
// result to the source's dtype afterwards.
//
// Bound: bytes. The grid and dout are read once and the gradient is written
// once. The zero fill is traffic beyond that bound; the atomics resolve in
// L2, which holds every source plane of the train step. Atomics add in no
// fixed order, so two runs agree only to f32 rounding of the sums.
#include "common.cuh"

namespace {

template <typename T, int V>
__global__ void warp_dsrc_kernel(const float* __restrict__ grid, const T* __restrict__ dout,
                                 float* __restrict__ dsrc, int H, int W, int C, long long N,
                                 long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int CV = C / V;
  const int cv = (int)(i % CV);
  const long long bn = i / CV;  // b * N + n
  const long long b = bn / N;

  const Taps tp = bilinear_taps(grid[2 * bn], grid[2 * bn + 1], H, W);
  const float x0 = tp.x0, y0 = tp.y0, x1 = x0 + 1.f, y1 = y0 + 1.f;
  const Pack<T, V> d =
      *reinterpret_cast<const Pack<T, V>*>(dout + bn * C + (long long)cv * V);
  float g[V];
#pragma unroll
  for (int j = 0; j < V; ++j) g[j] = to_float(d.v[j]);

  float* base = dsrc + b * (long long)H * W * C + (long long)cv * V;
  const float xs[4] = {x0, x1, x0, x1};
  const float ys[4] = {y0, y0, y1, y1};
  const float ws[4] = {tp.wx0 * tp.wy0, tp.wx1 * tp.wy0, tp.wx0 * tp.wy1, tp.wx1 * tp.wy1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (corner_in_range(xs[t], ys[t], H, W)) {
      const long long pix = (long long)ys[t] * W + (long long)xs[t];
      float* p = base + pix * C;
      if constexpr (V == 4) {
        atomicAdd(reinterpret_cast<float4*>(p),
                  make_float4(g[0] * ws[t], g[1] * ws[t], g[2] * ws[t], g[3] * ws[t]));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(p + j, g[j] * ws[t]);
      }
    }
  }
}

template <typename T, int V>
void launch(const float* grid, const void* dout, float* dsrc, int B, int H, int W, int C,
            long long N, cudaStream_t stream) {
  const long long total = (long long)B * N * (C / V);
  if (total == 0) return;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  warp_dsrc_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      grid, static_cast<const T*>(dout), dsrc, H, W, C, N, total);
}

}  // namespace

// dsrc: (B, H, W, C) f32, zeroed here. dtype is dout's. vec: channels per
// thread, 4 or 1 (the wrapper picks 4 when C % 4 == 0 and both pointers are
// aligned to 4 elements; the float4 atomic needs 16-byte alignment).
extern "C" int mk_warp_dsrc(const void* grid, const void* dout, void* dsrc, int B, int H, int W,
                            int C, long long N, int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  float* out = static_cast<float*>(dsrc);
  cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == kFloat32) {
    if (vec == 4) launch<float, 4>(g, dout, out, B, H, W, C, N, s);
    else launch<float, 1>(g, dout, out, B, H, W, C, N, s);
  } else if (dtype == kBFloat16) {
    if (vec == 4) launch<__nv_bfloat16, 4>(g, dout, out, B, H, W, C, N, s);
    else launch<__nv_bfloat16, 1>(g, dout, out, B, H, W, C, N, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
