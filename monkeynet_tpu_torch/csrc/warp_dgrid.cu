// Warp gradient w.r.t. the sampling grid: for each output point,
//   d/dgx = (W-1)/2 * sum_c dout_c * (wy0 * (v01 - v00) + wy1 * (v11 - v10))
//   d/dgy = (H-1)/2 * sum_c dout_c * (wx0 * (v10 - v00) + wx1 * (v11 - v01))
// with v the four corner values of the (B, H, W, C) source, zero where a
// corner lies outside it. The corner is floor(x), so at an integer coordinate
// this is the right difference, the subgradient the corner formulation's
// autograd gives (the identity grid at the start of training sits there).
//
// Replaces the TPU d_grid kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_bwd -> _dgrid_kernel), which has no gather and so contracts the
// whole source plane with one-hot difference matrices on the matrix unit.
// Here the four corners are gathered directly: one warp per output point,
// lanes striding over the channels so every corner read is a coalesced row
// segment, f32 throughout, a shuffle reduction at the end. C runs from 3 to
// 1024 on the train step; at C = 3 most lanes idle, which a later pass can
// repack.
//
// Bound: bytes. The grid and dout are read once, 8 bytes per point are
// written, and the source is read once from DRAM and then hit in L2.
#include "common.cuh"

namespace {

template <typename T>
__global__ void warp_dgrid_kernel(const T* __restrict__ src, const float* __restrict__ grid,
                                  const T* __restrict__ dout, float* __restrict__ dgrid, int H,
                                  int W, int C, long long N, long long points) {
  const long long bn = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // b * N + n
  const int lane = threadIdx.x & 31;
  if (bn >= points) return;  // the whole warp leaves together
  const long long b = bn / N;

  const Taps tp = bilinear_taps(grid[2 * bn], grid[2 * bn + 1], H, W);
  const float x0 = tp.x0, y0 = tp.y0, x1 = x0 + 1.f, y1 = y0 + 1.f;
  const bool in00 = corner_in_range(x0, y0, H, W), in01 = corner_in_range(x1, y0, H, W);
  const bool in10 = corner_in_range(x0, y1, H, W), in11 = corner_in_range(x1, y1, H, W);
  const T* base = src + b * (long long)H * W * C;
  // An out-of-range corner is never read; its pointer stays at the base.
  const T* p00 = in00 ? base + ((long long)y0 * W + (long long)x0) * C : base;
  const T* p01 = in01 ? base + ((long long)y0 * W + (long long)x1) * C : base;
  const T* p10 = in10 ? base + ((long long)y1 * W + (long long)x0) * C : base;
  const T* p11 = in11 ? base + ((long long)y1 * W + (long long)x1) * C : base;
  const T* d = dout + bn * C;

  float gx = 0.f, gy = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float g = to_float(d[c]);
    const float v00 = in00 ? to_float(p00[c]) : 0.f;
    const float v01 = in01 ? to_float(p01[c]) : 0.f;
    const float v10 = in10 ? to_float(p10[c]) : 0.f;
    const float v11 = in11 ? to_float(p11[c]) : 0.f;
    gx += g * (tp.wy0 * (v01 - v00) + tp.wy1 * (v11 - v10));
    gy += g * (tp.wx0 * (v10 - v00) + tp.wx1 * (v11 - v01));
  }
  gx = warp_sum(gx);
  gy = warp_sum(gy);
  if (lane == 0) {
    dgrid[2 * bn] = gx * 0.5f * (float)(W - 1);
    dgrid[2 * bn + 1] = gy * 0.5f * (float)(H - 1);
  }
}

template <typename T>
void launch(const void* src, const float* grid, const void* dout, float* dgrid, int B, int H,
            int W, int C, long long N, cudaStream_t stream) {
  const long long points = (long long)B * N;
  if (points == 0) return;
  const int threads = 256;  // 8 output points per block
  const long long blocks = (points * 32 + threads - 1) / threads;
  warp_dgrid_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(src), grid, static_cast<const T*>(dout), dgrid, H, W, C, N, points);
}

}  // namespace

// src (B, H, W, C) and dout (B, N, C) share `dtype`; grid (B, N, 2) and the
// result dgrid (B, N, 2) are f32.
extern "C" int mk_warp_dgrid(const void* src, const void* grid, const void* dout, void* dgrid,
                             int B, int H, int W, int C, long long N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  float* out = static_cast<float*>(dgrid);
  if (dtype == kFloat32) launch<float>(src, g, dout, out, B, H, W, C, N, s);
  else if (dtype == kBFloat16) launch<__nv_bfloat16>(src, g, dout, out, B, H, W, C, N, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
