// Dense-motion combine: per pixel, softmax over the K+1 mask logits, times
// the frame's (K+1, 2) displacement table, plus the correction, plus the
// identity grid -> the absolute f32 sampling grid.
//
// Replaces the TPU kernel of monkeynet_tpu/ops/pallas/combine.py
// (_forward -> _kernel). The TPU version puts pixels on lanes and tiles them
// to fit VMEM; here one thread owns one pixel and keeps its K+1 logits in
// registers, so nothing but the logits, correction and output crosses DRAM.
//
// Bound: bytes. Per pixel it reads (K+1) + 2 f32 and writes 2 f32; the
// displacement table is (K+1) x 2 per frame and stays in L1.
#include "common.cuh"

namespace {

__global__ void combine_kernel(const float* __restrict__ logits, const float* __restrict__ diff,
                               const float* __restrict__ corr, float* __restrict__ out, int H,
                               int W, int K1, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long hw = (long long)H * W;
  const long long n = i / hw;
  const int p = (int)(i % hw);

  // Three short passes over the pixel's logits (L1-resident after the
  // first) instead of a per-thread array, which would spill to local memory
  // for a run-time K+1.
  const float* l = logits + i * K1;
  float m = -INFINITY;
  for (int k = 0; k < K1; ++k) m = fmaxf(m, l[k]);
  float s = 0.f;
  for (int k = 0; k < K1; ++k) s += expf(l[k] - m);
  const float* d = diff + n * K1 * 2;
  float rx = 0.f, ry = 0.f;
  for (int k = 0; k < K1; ++k) {
    const float pk = expf(l[k] - m) / s;
    rx += pk * d[2 * k];
    ry += pk * d[2 * k + 1];
  }
  rx += corr[2 * i];
  ry += corr[2 * i + 1];
  out[2 * i] = rx + grid_coord(p % W, W);
  out[2 * i + 1] = ry + grid_coord(p / W, H);
}

}  // namespace

extern "C" int mk_combine_fwd(const void* logits, const void* diff, const void* corr, void* out,
                              long long N, int H, int W, int K1, void* stream) {
  if (K1 < 1) return (int)cudaErrorInvalidValue;
  const long long total = N * H * W;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    combine_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logits), static_cast<const float*>(diff),
        static_cast<const float*>(corr), static_cast<float*>(out), H, W, K1, total);
  }
  return (int)cudaGetLastError();
}
