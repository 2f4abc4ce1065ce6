// Bilinear warp: sample a (B, H, W, C) channels-last source at a (B, N, 2)
// xy grid in [-1, 1], align_corners=True, zeros padding -> (B, N, C).
//
// Replaces the TPU forward kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_fwd_impl -> _fwd_kernel). That kernel rewrites the gather as two
// separable hat-matrix matmuls because the TPU has no fast vector gather; a
// Hopper SM gathers from L1/L2 directly, so this is the plain four-tap
// gather.
//
// Bound: bytes. Per output point the kernel must read its 8-byte grid entry
// and write C values; the source is read once from DRAM and then hit in L2
// (50 MB holds every source plane of the main paths). What held the first
// design back was not bytes but issue and latency: 64-bit divisions, 8-byte
// bf16 packs, and at C = 3 three threads per point that each repeated the
// grid read and the range tests. So:
//
// - 'small' (C <= 4, the source frame): one thread per point carries every
//   channel; the grid entry is read and the taps formed once per point.
//   Where the plan stages the source plane (up to 48 KB: the 64 x 64 x 3
//   frame), a block of 1024 threads an SM copies it into shared memory with
//   16-byte loads and walks the points grid-stride, so the twelve scattered
//   gathers of a point come from shared memory, not from L1/L2 sectors.
// - 'vector': `lanes` threads per point (a power of two), each loading
//   16-byte packs (4 f32 or 8 bf16 channels) of the four corners, packs
//   lane, lane + lanes, ...; a scalar instantiation (V = 1) takes a C that
//   is no multiple of the pack or a pointer that is not 16-byte aligned.
// The launch is 2-D (blockIdx.y = batch element), so no thread divides, and
// index arithmetic is 32-bit (I = int) unless the plan finds an offset at or
// past 2^31 (I = long long). More points or more packs in flight per thread
// were tried on an H100 and lost: the registers they take cost more
// occupancy than the loads they overlap win back (PERF.md). What is left at
// C >= 64 is the output stream: at (64, 32) f32 the kernel takes ~1.35x the
// time a zero fill of its output takes.
//
// ops/cuda/warp.py `warp_plan` picks the variant, V, lanes, block, staging
// and launch shape. Coordinates and weights are f32 whatever the operand
// type; accumulation is f32, corner by corner in the order (x0, y0),
// (x1, y0), (x0, y1), (x1, y1), with an outside corner's weight zero as in
// the plain version.
#include "common.cuh"

namespace {

constexpr int kSmallC = 4;

// The taps of output point p: whether each corner is read, its element
// offset, and its weight (zero outside, as in the plain version).
template <typename I>
__device__ __forceinline__ void point_taps(const float* __restrict__ grid, I p, int H, int W,
                                           int C, bool (&in)[4], I (&off)[4], float (&w)[4]) {
  const Taps tp = bilinear_taps(grid[2 * p], grid[2 * p + 1], H, W);
  corner_offsets<I>(tp, H, W, C, in, off);
  const float ws[4] = {tp.wx0 * tp.wy0, tp.wx1 * tp.wy0, tp.wx0 * tp.wy1, tp.wx1 * tp.wy1};
#pragma unroll
  for (int t = 0; t < 4; ++t) w[t] = in[t] ? ws[t] : 0.f;
}

// Copies the batch element's n-element source plane into shared memory, 16
// bytes at a time where the plane starts on 16 bytes, and waits for the block.
template <typename T>
__device__ __forceinline__ const T* stage_plane(const T* __restrict__ src, T* dst, int n) {
  const int vecs = reinterpret_cast<uintptr_t>(src) % 16 == 0 ? n * (int)sizeof(T) / 16 : 0;
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  for (int i = vecs * (16 / (int)sizeof(T)) + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  return dst;
}

// STAGED: the block reads the source plane from shared memory and walks the
// points grid-stride; otherwise the launch has a thread for every point.
template <typename T, bool STAGED, typename I>
__global__ void __launch_bounds__(STAGED ? 1024 : 256)
warp_fwd_kernel_small(const T* __restrict__ src, const float* __restrict__ grid,
                      T* __restrict__ out, int H, int W, int C, I N) {
  extern __shared__ __align__(16) unsigned char shared[];
  const I b = blockIdx.y;
  src += b * H * W * C;
  grid += b * N * 2;
  out += b * N * C;
  const T* plane = STAGED ? stage_plane(src, reinterpret_cast<T*>(shared), H * W * C) : src;
  const I step = (I)gridDim.x * blockDim.x;
  for (I p = (I)blockIdx.x * blockDim.x + threadIdx.x; p < N; p += step) {
    bool in[4];
    I off[4];
    float w[4];
    point_taps<I>(grid, p, H, W, C, in, off, w);
    T v[4][kSmallC];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int c = 0; c < kSmallC; ++c)
        v[t][c] = (c < C && in[t]) ? plane[off[t] + c] : from_float<T>(0.f);
#pragma unroll
    for (int c = 0; c < kSmallC; ++c) {
      if (c >= C) break;
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc += to_float(v[t][c]) * w[t];
      out[p * C + c] = from_float<T>(acc);
    }
  }
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(256)
warp_fwd_kernel_vector(const T* __restrict__ src, const float* __restrict__ grid,
                       T* __restrict__ out, int H, int W, int C, I N, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const I p = (I)blockIdx.x * (blockDim.x >> lanes_log2) + (threadIdx.x >> lanes_log2);
  if (p >= N) return;  // whole groups of lanes leave together
  const I b = blockIdx.y;
  src += b * H * W * C;
  grid += b * N * 2;
  out += (b * N + p) * C;
  bool in[4];
  I off[4];
  float w[4];
  point_taps<I>(grid, p, H, W, C, in, off, w);
  const int packs = C / V;
  for (int k = lane; k < packs; k += lanes) {
    Pack<T, V> v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = load_pack<T, V, I>(src + k * V, off[t], in[t]);
    Pack<T, V> r;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) acc += to_float(v[t].v[i]) * w[t];
      r.v[i] = from_float<T>(acc);
    }
    *reinterpret_cast<Pack<T, V>*>(out + k * V) = r;
  }
}

enum Variant { kSmall = 0, kVector = 1 };

template <typename T, typename I>
int launch(const void* src_, const float* grid, void* out_, int H, int W, int C, long long N,
           int variant, int vector, int lanes_log2, dim3 blocks, int threads, int shared_bytes,
           cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  const T* src = static_cast<const T*>(src_);
  T* out = static_cast<T*>(out_);
  if (variant == kSmall && C <= kSmallC && shared_bytes > 0) {
    if (shared_bytes < (long long)H * W * C * sizeof(T)) return (int)cudaErrorInvalidValue;
    warp_fwd_kernel_small<T, true, I><<<blocks, threads, shared_bytes, s>>>(src, grid, out, H, W,
                                                                          C, (I)N);
  } else if (variant == kSmall && C <= kSmallC) {
    warp_fwd_kernel_small<T, false, I><<<blocks, threads, 0, s>>>(src, grid, out, H, W, C, (I)N);
  } else if (variant == kVector && shared_bytes == 0 && vector == kPack && C % kPack == 0) {
    warp_fwd_kernel_vector<T, kPack, I><<<blocks, threads, 0, s>>>(src, grid, out, H, W, C,
                                                                   (I)N, lanes_log2);
  } else if (variant == kVector && shared_bytes == 0 && vector == 1) {
    warp_fwd_kernel_vector<T, 1, I><<<blocks, threads, 0, s>>>(src, grid, out, H, W, C, (I)N,
                                                               lanes_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// The plan's fields (ops/cuda/warp.py WarpPlan): variant 0 'small' or 1
// 'vector', channels a load, log2 of the threads per point, threads per
// block, blocks over one batch element's points, the dynamic shared memory
// that holds the staged source plane (0: read in place), and whether
// offsets need 64 bits.
extern "C" int mk_warp_fwd(const void* src, const void* grid, void* out, int B, int H, int W,
                           int C, long long N, int dtype, int variant, int vector,
                           int lanes_log2, int threads, long long blocks_x, int shared_bytes,
                           int index64, void* stream) {
  if (B == 0 || blocks_x == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const dim3 blocks((unsigned)blocks_x, (unsigned)B);
  int status;
  if (dtype == kFloat32) {
    status = index64 ? launch<float, long long>(src, g, out, H, W, C, N, variant, vector,
                                                lanes_log2, blocks, threads, shared_bytes, s)
                     : launch<float, int>(src, g, out, H, W, C, N, variant, vector,
                                          lanes_log2, blocks, threads, shared_bytes, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch<__nv_bfloat16, long long>(src, g, out, H, W, C, N, variant, vector,
                                           lanes_log2, blocks, threads, shared_bytes, s)
        : launch<__nv_bfloat16, int>(src, g, out, H, W, C, N, variant, vector, lanes_log2,
                                     blocks, threads, shared_bytes, s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}
