// Soft-argmax: per (frame, keypoint) plane of channels-last heatmap logits
// (N, H*W, K): temperature softmax over the plane, the +1e-7 floor after it
// with no renormalisation, the mean sum p*g, and the centred second moments
// -> five f32 statistics (mx, my, vxx, vxy, vyy) per plane.
//
// Replaces the TPU kernel of monkeynet_tpu/ops/pallas/softargmax.py
// (gaussian2kp_pallas -> _kernel), which needs a host-side transpose to
// (N*K, H, W) planes and one grid step per plane. Here one block owns one
// plane and reads it straight from the channels-last hourglass output: the
// K planes of a frame are consecutive blocks, so the stride-K reads of one
// block share cache lines with its neighbours in L2.
//
// Bound: bytes. The logits are read once from DRAM (four passes, the later
// three from L1/L2) and 20 bytes per plane are written. The passes keep the
// reference's order of operations: max, sum of exp, mean, centred moments.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void softargmax_kernel(const T* __restrict__ logits, float* __restrict__ stats, int H,
                                  int W, int K, float temperature) {
  __shared__ float smem[32 * 3];
  const int plane = blockIdx.x;  // n * K + k
  const int n = plane / K, k = plane % K;
  const int hw = H * W;
  const T* x = logits + (long long)n * hw * K + k;

  float m = -INFINITY;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) m = fmaxf(m, to_float(x[(long long)p * K]) / temperature);
  m = block_max(m, smem);

  float s[1] = {0.f};
  for (int p = threadIdx.x; p < hw; p += blockDim.x)
    s[0] += expf(to_float(x[(long long)p * K]) / temperature - m);
  block_sum<1>(s, smem);
  const float denom = s[0];

  float mean[2] = {0.f, 0.f};
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float pr = expf(to_float(x[(long long)p * K]) / temperature - m) / denom + 1e-7f;
    mean[0] += pr * grid_coord(p % W, W);
    mean[1] += pr * grid_coord(p / W, H);
  }
  block_sum<2>(mean, smem);

  float var[3] = {0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float pr = expf(to_float(x[(long long)p * K]) / temperature - m) / denom + 1e-7f;
    const float dx = grid_coord(p % W, W) - mean[0];
    const float dy = grid_coord(p / W, H) - mean[1];
    var[0] += pr * dx * dx;
    var[1] += pr * dx * dy;
    var[2] += pr * dy * dy;
  }
  block_sum<3>(var, smem);

  if (threadIdx.x == 0) {
    float* o = stats + (long long)plane * 5;
    o[0] = mean[0];
    o[1] = mean[1];
    o[2] = var[0];
    o[3] = var[1];
    o[4] = var[2];
  }
}

}  // namespace

extern "C" int mk_softargmax_fwd(const void* logits, void* stats, long long N, int H, int W, int K,
                                 float temperature, int dtype, void* stream) {
  const long long planes = N * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes > 0) {
    if (dtype == kFloat32) {
      softargmax_kernel<float><<<(unsigned)planes, kThreads, 0, s>>>(
          static_cast<const float*>(logits), static_cast<float*>(stats), H, W, K, temperature);
    } else if (dtype == kBFloat16) {
      softargmax_kernel<__nv_bfloat16><<<(unsigned)planes, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(stats), H, W, K,
          temperature);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
