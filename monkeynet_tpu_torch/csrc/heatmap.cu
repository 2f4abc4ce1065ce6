// Keypoint gaussian heatmaps: per (frame, keypoint) plane, exp(-q/2) on the
// [-1, 1]^2 coordinate grid, q the Mahalanobis form ('matrix' variance) or
// |g - mu|^2 / var ('single' or a scalar variance), then divided by the
// plane's sum or by a constant -> (N*K, H, W) f32.
//
// Replaces the TPU kernel of monkeynet_tpu/ops/pallas/heatmap.py
// (kp2gaussian_pallas -> _kernel). Unlike that kernel, the determinant is
// a*d - b*c as in the plain kp2gaussian, not a*d - (bc/2)^2 from a packed
// b + c: the two agree only for symmetric covariances.
//
// Bound: bytes. It reads a few scalars per plane and writes H*W f32 values;
// the 'sum' normalisation recomputes the plane rather than re-reading it.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

enum VarMode { kMatrix = 0, kSingle = 1, kScalar = 2 };
enum NormMode { kNone = 0, kSum = 1, kConst = 2 };

struct Gauss {
  float mx, my, a, b, c, d, det, v;
  int mode;
  __device__ __forceinline__ float operator()(int p, int H, int W) const {
    const float dx = grid_coord(p % W, W) - mx;
    const float dy = grid_coord(p / W, H) - my;
    float q;
    if (mode == kMatrix) {
      q = (d * dx * dx - (b + c) * dx * dy + a * dy * dy) / det;
    } else {
      q = (dx * dx + dy * dy) / v;
    }
    return expf(-0.5f * q);
  }
};

__global__ void heatmap_kernel(const float* __restrict__ mean, const float* __restrict__ var,
                               float* __restrict__ out, int H, int W, int var_mode,
                               float scalar_var, int norm_mode, float norm_const) {
  __shared__ float smem[32];
  const long long plane = blockIdx.x;
  const int hw = H * W;
  Gauss g;
  g.mode = var_mode;
  g.mx = mean[2 * plane];
  g.my = mean[2 * plane + 1];
  g.a = g.b = g.c = g.d = g.det = g.v = 1.f;
  if (var_mode == kMatrix) {
    const float* v4 = var + 4 * plane;
    g.a = v4[0];
    g.b = v4[1];
    g.c = v4[2];
    g.d = v4[3];
    g.det = g.a * g.d - g.b * g.c;
  } else if (var_mode == kSingle) {
    g.v = var[plane];
  } else {
    g.v = scalar_var;
  }

  float scale = 1.f;
  if (norm_mode == kSum) {
    float s[1] = {0.f};
    for (int p = threadIdx.x; p < hw; p += blockDim.x) s[0] += g(p, H, W);
    block_sum<1>(s, smem);
    scale = s[0];
  } else if (norm_mode == kConst) {
    scale = norm_const;
  }

  float* o = out + plane * hw;
  for (int p = threadIdx.x; p < hw; p += blockDim.x) {
    const float h = g(p, H, W);
    o[p] = norm_mode == kNone ? h : h / scale;
  }
}

}  // namespace

// var: (planes, 4) row-major 2x2 for var_mode 0, (planes,) for var_mode 1,
// unused for var_mode 2 (scalar_var).
extern "C" int mk_heatmap_fwd(const void* mean, const void* var, void* out, long long planes,
                              int H, int W, int var_mode, float scalar_var, int norm_mode,
                              float norm_const, void* stream) {
  if (var_mode < kMatrix || var_mode > kScalar || norm_mode < kNone || norm_mode > kConst)
    return (int)cudaErrorInvalidValue;
  if (planes > 0) {
    heatmap_kernel<<<(unsigned)planes, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(mean), static_cast<const float*>(var),
        static_cast<float*>(out), H, W, var_mode, scalar_var, norm_mode, norm_const);
  }
  return (int)cudaGetLastError();
}
