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
// Here the four corners are gathered directly, f32 throughout.
//
// Bound: bytes. The grid and dout are read once, 8 bytes per point are
// written, and the source is read once from DRAM and then hit in L2. The
// first design (one warp per point, lanes striding over channels with scalar
// loads, a 64-bit division per warp) was held back by idle lanes at C = 3
// (29 of 32), by scalar 2-byte loads in bf16, and at C = 512 and 1024 by too
// few points to fill 132 SMs. Three variants, which ops/cuda/warp.py
// `dgrid_plan` chooses between:
//
// - 'small' (C <= 4, the source frame): one thread per point holds every
//   channel of the four corners and of dout in registers; no reduction.
// - 'grouped': `lanes` threads per point, a power of two <= 32; each lane
//   loads 16-byte packs (4 f32 or 8 bf16 channels) of the four corners and
//   of dout, packs lane, lane + lanes, ...; a segmented shuffle tree of
//   log2(lanes) steps (offsets lanes/2, ..., 1) sums the lanes. A scalar
//   instantiation (V = 1) takes a C that is no multiple of the pack or a
//   pointer that is not 16-byte aligned.
// - 'split' (many channels, few points): 64 to 1024 threads per point, so
//   several warps share a point's channels. Each warp sums its lanes with
//   the full shuffle tree, writes its partial to shared memory, and the
//   point's first lane adds the partials in warp order: no atomics, so the
//   result is the same on every run.
// The plan gives a lane two packs of a point where that still leaves 65,536
// threads, else one: measured on an H100, more threads beat more loads in
// flight per thread below that (PERF.md). The launch is 2-D (blockIdx.y =
// batch element), so no thread divides, and index arithmetic is 32-bit
// (I = int) unless the plan finds an offset at or past 2^31 (I = long long).
#include "common.cuh"

namespace {

constexpr int kSmallC = 4;

template <typename T, typename I>
__global__ void __launch_bounds__(256)
warp_dgrid_kernel_small(const T* __restrict__ src, const float* __restrict__ grid,
                        const T* __restrict__ dout, float* __restrict__ dgrid, int H, int W,
                        int C, I N) {
  const I p = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= N) return;
  const I b = blockIdx.y;
  src += b * H * W * C;
  grid += b * N * 2;
  dout += (b * N + p) * C;
  dgrid += (b * N + p) * 2;

  float g[kSmallC];
#pragma unroll
  for (int c = 0; c < kSmallC; ++c) g[c] = c < C ? to_float(dout[c]) : 0.f;
  const Taps tp = bilinear_taps(grid[2 * p], grid[2 * p + 1], H, W);
  bool in[4];
  I off[4];
  corner_offsets<I>(tp, H, W, C, in, off);
  float v[4][kSmallC];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int c = 0; c < kSmallC; ++c)
      v[t][c] = (c < C && in[t]) ? to_float(src[off[t] + c]) : 0.f;

  float gx = 0.f, gy = 0.f;
#pragma unroll
  for (int c = 0; c < kSmallC; ++c) {
    if (c >= C) break;
    gx += g[c] * (tp.wy0 * (v[1][c] - v[0][c]) + tp.wy1 * (v[3][c] - v[2][c]));
    gy += g[c] * (tp.wx0 * (v[2][c] - v[0][c]) + tp.wx1 * (v[3][c] - v[1][c]));
  }
  dgrid[0] = gx * 0.5f * (float)(W - 1);
  dgrid[1] = gy * 0.5f * (float)(H - 1);
}

template <typename T, int V, bool SPLIT, typename I>
__global__ void __launch_bounds__(1024)
warp_dgrid_kernel_packed(const T* __restrict__ src, const float* __restrict__ grid,
                         const T* __restrict__ dout, float* __restrict__ dgrid, int H, int W,
                         int C, I N, int lanes_log2) {
  __shared__ float partial[2][32];  // 'split': one (gx, gy) per warp of the block
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const I p = (I)blockIdx.x * (blockDim.x >> lanes_log2) + (threadIdx.x >> lanes_log2);
  const bool valid = p < N;  // no early return: every lane joins the reduction
  const I b = blockIdx.y;
  src += b * H * W * C;
  grid += b * N * 2;

  float gx = 0.f, gy = 0.f;
  if (valid) {
    const Taps tp = bilinear_taps(grid[2 * p], grid[2 * p + 1], H, W);
    bool in[4];
    I off[4];
    corner_offsets<I>(tp, H, W, C, in, off);
    const T* d = dout + (b * N + p) * C;
    const int packs = C / V;
    for (int k = lane; k < packs; k += lanes) {
      const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(d + k * V);
      Pack<T, V> v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) v[t] = load_pack<T, V, I>(src + k * V, off[t], in[t]);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float v00 = to_float(v[0].v[i]), v01 = to_float(v[1].v[i]);
        const float v10 = to_float(v[2].v[i]), v11 = to_float(v[3].v[i]);
        const float gc = to_float(g.v[i]);
        gx += gc * (tp.wy0 * (v01 - v00) + tp.wy1 * (v11 - v10));
        gy += gc * (tp.wx0 * (v10 - v00) + tp.wx1 * (v11 - v01));
      }
    }
  }

  if (!SPLIT) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      if (o < lanes) {
        gx += __shfl_xor_sync(0xffffffffu, gx, o);
        gy += __shfl_xor_sync(0xffffffffu, gy, o);
      }
    }
  } else {
    gx = warp_sum(gx);
    gy = warp_sum(gy);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      partial[0][warp] = gx;
      partial[1][warp] = gy;
    }
    __syncthreads();
    if (lane == 0) {
      gx = gy = 0.f;
      for (int w = 0; w < (lanes >> 5); ++w) {
        gx += partial[0][warp + w];
        gy += partial[1][warp + w];
      }
    }
  }
  if (lane == 0 && valid) {
    float* out = dgrid + (b * N + p) * 2;
    out[0] = gx * 0.5f * (float)(W - 1);
    out[1] = gy * 0.5f * (float)(H - 1);
  }
}

enum Variant { kSmall = 0, kGrouped = 1, kSplit = 2 };

template <typename T, int V, typename I>
void launch_packed(const T* src, const float* grid, const T* dout, float* dgrid, int H, int W,
                   int C, long long N, bool split, int lanes_log2, dim3 blocks, int threads,
                   cudaStream_t s) {
  if (split) {
    warp_dgrid_kernel_packed<T, V, true, I><<<blocks, threads, 0, s>>>(
        src, grid, dout, dgrid, H, W, C, (I)N, lanes_log2);
  } else {
    warp_dgrid_kernel_packed<T, V, false, I><<<blocks, threads, 0, s>>>(
        src, grid, dout, dgrid, H, W, C, (I)N, lanes_log2);
  }
}

template <typename T, typename I>
int launch(const void* src_, const float* grid, const void* dout_, float* dgrid, int H, int W,
           int C, long long N, int variant, int vector, int lanes_log2, dim3 blocks,
           int threads, cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  const T* src = static_cast<const T*>(src_);
  const T* dout = static_cast<const T*>(dout_);
  const bool split = variant == kSplit;
  if (variant == kSmall && C <= kSmallC) {
    warp_dgrid_kernel_small<T, I><<<blocks, threads, 0, s>>>(src, grid, dout, dgrid, H, W, C,
                                                             (I)N);
  } else if ((variant == kGrouped && lanes_log2 <= 5) || (split && lanes_log2 > 5)) {
    if (vector == kPack && C % kPack == 0) {
      launch_packed<T, kPack, I>(src, grid, dout, dgrid, H, W, C, N, split, lanes_log2,
                                 blocks, threads, s);
    } else if (vector == 1) {
      launch_packed<T, 1, I>(src, grid, dout, dgrid, H, W, C, N, split, lanes_log2, blocks,
                             threads, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// src (B, H, W, C) and dout (B, N, C) share `dtype`; grid (B, N, 2) and the
// result dgrid (B, N, 2) are f32. The plan's fields (ops/cuda/warp.py
// DgridPlan): variant 0 'small', 1 'grouped' or 2 'split', channels a load,
// log2 of the threads per point, threads per block, blocks over one batch
// element's points, and whether offsets need 64 bits.
extern "C" int mk_warp_dgrid(const void* src, const void* grid, const void* dout, void* dgrid,
                             int B, int H, int W, int C, long long N, int dtype, int variant,
                             int vector, int lanes_log2, int threads, long long blocks_x,
                             int index64, void* stream) {
  if (B == 0 || blocks_x == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  float* out = static_cast<float*>(dgrid);
  const dim3 blocks((unsigned)blocks_x, (unsigned)B);
  int status;
  if (dtype == kFloat32) {
    status = index64 ? launch<float, long long>(src, g, dout, out, H, W, C, N, variant, vector,
                                                lanes_log2, blocks, threads, s)
                     : launch<float, int>(src, g, dout, out, H, W, C, N, variant, vector,
                                          lanes_log2, blocks, threads, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch<__nv_bfloat16, long long>(src, g, dout, out, H, W, C, N, variant, vector,
                                           lanes_log2, blocks, threads, s)
        : launch<__nv_bfloat16, int>(src, g, dout, out, H, W, C, N, variant, vector,
                                     lanes_log2, blocks, threads, s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}
