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
// Bound: bytes. It reads six scalars a plane and writes H*W f32 values, so
// the least time is the store stream's, and the kernel has to spend few
// instructions per byte and keep every SM storing:
//  * a grid sized to the card (two blocks per SM, chosen by the wrapper)
//    walks over the planes, and the next plane's scalars are loaded while
//    this one is stored: no block lives for one plane, no ragged last wave;
//  * coordinates are separable and are made once per block, by the plain
//    version's own division, into two tables in shared memory; a thread
//    keeps its four columns and walks down the rows, so nothing is divided
//    or taken modulo in the loop;
//  * what depends on the plane and the column only ((c_a*dx)*dx, c_u*dx) is
//    made once per plane, what depends on the row only ((c_w*dy)*dy) once
//    per row; an element costs a multiply, a subtract, an add, a multiply,
//    one ex2 and the scale;
//  * stores are 16 bytes a thread (float4) where W % 4 == 0, scalar otherwise;
//  * 'sum' evaluates a plane once and keeps it in registers across the
//    reduction where a thread holds at most kHoldRows rows of it (64x64 with
//    256 threads: 16 values); a larger plane is evaluated twice.
//
// Order of operations: the quadratic form's numerator is built exactly as
// the plain version builds it, term by term with each product and sum
// rounded ((d*dx)*dx - ((b+c)*dx)*dy + (a*dy)*dy; the terms cancel for a
// narrow oblique gaussian, so a fused or reordered numerator would differ by
// far more than an ulp of the result). The division by det, the -1/2 and
// log2(e) are folded into one factor per plane and exp becomes exp2f, and
// the division by the sum or the constant becomes a multiplication by its
// reciprocal: a few ulps of the exponent, under 3e-7 on values <= 1.
//
// On an NVIDIA H100 80GB HBM3 at 700 W a 128-frame chunk of ten 64x64 planes
// (21 MB) takes 0.011 ms, L2-warm or not, against a store bound of 0.0063 ms,
// of which ~3.7 us are the launch itself (ten planes alone take 0.0037 ms):
// the stores run at about 3 TB/s. ptxas: 60 registers with float4 stores, 46
// with scalar ones, no spills. PERF.md has the table.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kHoldRows = 4;

enum VarMode { kMatrix = 0, kSingle = 1, kScalar = 2 };
enum NormMode { kNone = 0, kSum = 1, kConst = 2 };

// One plane's scalars: the mean, the numerator's three coefficients
// (d, b + c, a for 'matrix'; 1, 0, 1 otherwise) and the exponent's factor
// -log2(e) / (2 det) or -log2(e) / (2 var).
struct Plane {
  float mx, my, ca, cu, cw, factor;
};

__device__ __forceinline__ Plane load_plane(const float* __restrict__ mean,
                                            const float* __restrict__ var, long long plane,
                                            int var_mode, float scalar_var) {
  constexpr float kHalfLog2e = 0.72134752044448170368f;
  Plane g;
  g.mx = mean[2 * plane];
  g.my = mean[2 * plane + 1];
  if (var_mode == kMatrix) {
    const float* v = var + 4 * plane;
    const float a = v[0], b = v[1], c = v[2], d = v[3];
    g.ca = d;
    g.cu = __fadd_rn(b, c);
    g.cw = a;
    g.factor = -kHalfLog2e / __fsub_rn(__fmul_rn(a, d), __fmul_rn(b, c));
  } else {
    g.ca = 1.f;
    g.cu = 0.f;
    g.cw = 1.f;
    g.factor = -kHalfLog2e / (var_mode == kSingle ? var[plane] : scalar_var);
  }
  return g;
}

// exp(-q/2) from the column's two terms, the row's dy and its term.
__device__ __forceinline__ float gauss(float t1, float u, float dy, float w, float factor) {
  const float n = __fadd_rn(__fsub_rn(t1, __fmul_rn(u, dy)), w);
  return exp2f(__fmul_rn(n, factor));
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
};
template <>
struct Vec<1> {
  using type = float;
};

// The thread's share of one plane: V adjacent columns starting at column
// V * (col_vec + i * cols_per_sweep), rows row0, row0 + rows_per_sweep, ...
// kStore: write scale * value; else only add the values up.
template <int V, bool kStore>
__device__ __forceinline__ float render(const Plane& g, float* __restrict__ o,
                                        const float* __restrict__ gx, const float* __restrict__ gy,
                                        int H, int W, int col_vec, int row0, int cols_per_sweep,
                                        int rows_per_sweep, float scale) {
  float sum = 0.f;
  for (int cv = col_vec; cv * V < W; cv += cols_per_sweep) {
    float t1[V], u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dx = __fsub_rn(gx[cv * V + j], g.mx);
      t1[j] = __fmul_rn(__fmul_rn(g.ca, dx), dx);
      u[j] = __fmul_rn(g.cu, dx);
    }
    for (int r = row0; r < H; r += rows_per_sweep) {
      const float dy = __fsub_rn(gy[r], g.my);
      const float w = __fmul_rn(__fmul_rn(g.cw, dy), dy);
      float h[V];
#pragma unroll
      for (int j = 0; j < V; ++j) h[j] = gauss(t1[j], u[j], dy, w, g.factor);
      if (kStore) {
        typename Vec<V>::type out;
        float* lanes = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) lanes[j] = h[j] * scale;
        *reinterpret_cast<typename Vec<V>::type*>(o + (long long)r * W + cv * V) = out;
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) sum += h[j];
      }
    }
  }
  return sum;
}

// 'sum' with the plane held in registers: the thread's V columns (one sweep
// of columns covers the width) and at most kHoldRows rows.
template <int V>
__device__ __forceinline__ void render_sum_held(const Plane& g, float* __restrict__ o,
                                                const float* __restrict__ gx,
                                                const float* __restrict__ gy, int H, int W,
                                                int col_vec, int row0, int rows_per_sweep,
                                                float* smem) {
  float h[kHoldRows][V];
  float s[1] = {0.f};
  const bool active = col_vec * V < W;
  if (active) {
    float t1[V], u[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float dx = __fsub_rn(gx[col_vec * V + j], g.mx);
      t1[j] = __fmul_rn(__fmul_rn(g.ca, dx), dx);
      u[j] = __fmul_rn(g.cu, dx);
    }
#pragma unroll
    for (int i = 0; i < kHoldRows; ++i) {
      const int r = row0 + i * rows_per_sweep;
      if (r < H) {
        const float dy = __fsub_rn(gy[r], g.my);
        const float w = __fmul_rn(__fmul_rn(g.cw, dy), dy);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          h[i][j] = gauss(t1[j], u[j], dy, w, g.factor);
          s[0] += h[i][j];
        }
      }
    }
  }
  block_sum<1>(s, smem);
  const float scale = 1.f / s[0];
  if (active) {
#pragma unroll
    for (int i = 0; i < kHoldRows; ++i) {
      const int r = row0 + i * rows_per_sweep;
      if (r < H) {
        typename Vec<V>::type out;
        float* lanes = reinterpret_cast<float*>(&out);
#pragma unroll
        for (int j = 0; j < V; ++j) lanes[j] = h[i][j] * scale;
        *reinterpret_cast<typename Vec<V>::type*>(o + (long long)r * W + col_vec * V) = out;
      }
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
heatmap_kernel(const float* __restrict__ mean, const float* __restrict__ var,
               float* __restrict__ out, long long planes, int H, int W, int var_mode,
               float scalar_var, int norm_mode, float norm_const, int hold_sum) {
  extern __shared__ __align__(16) float coords[];  // gx: W floats, then gy: H floats
  __shared__ float smem[32];
  float* gx = coords;
  float* gy = coords + W;
  for (int i = threadIdx.x; i < W; i += kThreads) gx[i] = grid_coord(i, W);
  for (int i = threadIdx.x; i < H; i += kThreads) gy[i] = grid_coord(i, H);
  __syncthreads();

  // threads side by side along a row, then down the rows; a thread left over
  // when the block is no whole number of rows gets no rows
  const int wv = W / V;
  const int cols_per_sweep = wv < kThreads ? wv : kThreads;
  const int rows_per_sweep = kThreads / cols_per_sweep;
  const int col_vec = threadIdx.x % cols_per_sweep;
  const int trow = threadIdx.x / cols_per_sweep;
  const int row0 = trow < rows_per_sweep ? trow : H;

  const long long hw = (long long)H * W;
  long long plane = blockIdx.x;
  if (plane >= planes) return;
  Plane g = load_plane(mean, var, plane, var_mode, scalar_var);
  while (true) {
    const long long next = plane + gridDim.x;
    Plane g_next = g;
    if (next < planes) g_next = load_plane(mean, var, next, var_mode, scalar_var);
    float* o = out + plane * hw;
    if (norm_mode != kSum) {
      const float scale = norm_mode == kConst ? 1.f / norm_const : 1.f;
      render<V, true>(g, o, gx, gy, H, W, col_vec, row0, cols_per_sweep, rows_per_sweep, scale);
    } else if (hold_sum) {
      render_sum_held<V>(g, o, gx, gy, H, W, col_vec, row0, rows_per_sweep, smem);
    } else {
      float s[1] = {render<V, false>(g, o, gx, gy, H, W, col_vec, row0, cols_per_sweep,
                                     rows_per_sweep, 1.f)};
      block_sum<1>(s, smem);
      render<V, true>(g, o, gx, gy, H, W, col_vec, row0, cols_per_sweep, rows_per_sweep,
                      1.f / s[0]);
    }
    if (next >= planes) break;
    plane = next;
    g = g_next;
  }
}

}  // namespace

// var: (planes, 4) row-major 2x2 for var_mode 0, (planes,) for var_mode 1,
// unused for var_mode 2 (scalar_var). vector, hold_sum and blocks come from
// the wrapper (ops/cuda/heatmap.py: heatmap_plan): vector 4 needs W % 4 == 0;
// hold_sum needs one sweep of columns to cover the width and at most
// kHoldRows rows a thread.
extern "C" int mk_heatmap_fwd(const void* mean, const void* var, void* out, long long planes,
                              int H, int W, int var_mode, float scalar_var, int norm_mode,
                              float norm_const, int vector, int hold_sum, int blocks,
                              void* stream) {
  if (var_mode < kMatrix || var_mode > kScalar || norm_mode < kNone || norm_mode > kConst)
    return (int)cudaErrorInvalidValue;
  if ((vector != 1 && vector != 4) || (vector == 4 && W % 4 != 0) || blocks <= 0 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  if (hold_sum) {
    const int wv = W / vector;
    if (wv > kThreads || (H + kThreads / wv - 1) / (kThreads / wv) > kHoldRows)
      return (int)cudaErrorInvalidValue;
  }
  if (planes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t shared = sizeof(float) * ((size_t)W + H);
    const float* m = static_cast<const float*>(mean);
    const float* v = static_cast<const float*>(var);
    float* o = static_cast<float*>(out);
    if (vector == 4) {
      heatmap_kernel<4><<<blocks, kThreads, shared, s>>>(m, v, o, planes, H, W, var_mode,
                                                         scalar_var, norm_mode, norm_const,
                                                         hold_sum);
    } else {
      heatmap_kernel<1><<<blocks, kThreads, shared, s>>>(m, v, o, planes, H, W, var_mode,
                                                         scalar_var, norm_mode, norm_const,
                                                         hold_sum);
    }
  }
  return (int)cudaGetLastError();
}
