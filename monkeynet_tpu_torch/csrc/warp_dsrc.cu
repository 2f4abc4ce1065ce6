// Warp gradient w.r.t. the source: scatter dout (B, N, C) back to the four
// corners each output point sampled, with the forward's bilinear weights,
// into the channels-last (B, H, W, C) gradient. Accumulation is f32 whatever
// the operand type, as in the TPU kernel; the result is in dout's dtype.
//
// Replaces the TPU d_src kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_bwd -> _dsrc_kernel). That kernel has no scatter to use, so it
// rebuilds the hat-weight matrices per tile of 256 points and accumulates
// Z @ Ax into a VMEM-resident (C*H, W) f32 plane over a sequential grid axis
// of point tiles. Here the resident plane is a slice of channels in one
// block's shared memory, and the loop over point tiles is a loop inside the
// block. Two variants, which ops/cuda/warp.py `dsrc_plan` chooses between:
//
// - 'shared': one block per (channel slice, batch element), blockIdx.y the
//   batch element. The scatter is turned into a gather, so no two threads
//   add to one value and no f32 atomic is needed. For each chunk of up to
//   `chunk` points the block copies the chunk's dout slices into shared
//   memory (cp.async, a group of lanes per point) and, while they are in
//   flight, bins the points by the cell of their top-left corner, (x0, y0)
//   in [-1, W-1] x [-1, H-1]: a counting sort with integer shared-memory
//   atomics, which sm_90 has as one instruction (a count, a block-wide
//   exclusive scan, a placement). Then each thread owns the values of one
//   pack of channels at a tile of pixels, a power-of-two group of `lanes`
//   threads per tile over the slice's packs: it walks the points of the
//   cells whose corners fall in its tile (4 cells for one pixel, 9 for a
//   2 x 2 quad, which reads a point's pack about 2.25 times instead of 4)
//   and adds dout * w_corner from shared memory in f32 registers. With all
//   points in one chunk it writes the sums straight out; otherwise it adds
//   them into its own values of the slice's f32 plane in shared memory and
//   the block writes the plane after the last chunk. The
//   output is in dout's dtype (bf16 by __float2bfloat16, round to nearest
//   even, as a cast of the f32 sum rounds). One launch a call: no fill of
//   device memory, no global atomics, no cast pass. The first form of this
//   variant added into a shared f32 plane with atomicAdd; sm_90 has no f32
//   add on shared memory and runs it as a compare-and-swap loop
//   (ATOMS.CAST.SPIN), which made it slower than the old global scatter at
//   the taichi shapes (PERF.md).
// - 'global': where not even one pack's slice fits the 227 KB a block may
//   use (the 64 x 128^2 skip of the 256^2 configs). The launcher zeroes an f32
//   buffer of the whole gradient, and one thread per (point, V channels)
//   adds to every in-range corner with global atomicAdd, resolved in L2 (one
//   float4 atomic for V = 4); the wrapper casts the buffer to bf16 where dout
//   is bf16.
//
// Order of summation: 'shared' sums a pixel's four cells in a fixed order
// (row by row), but the points within a cell in the order the placement's
// atomics gave them; 'global' adds in no fixed order. So two runs agree to f32 rounding of
// each pixel's sum, not bit for bit. Bound: bytes. The grid and dout are read
// once from device memory and the gradient written once; 'shared' reads the
// grid once per slice (twice per chunk, the second time from L1) and a
// point's dout once per corner from shared memory.
// Index arithmetic is 32-bit (I = int) unless the plan finds an offset at or
// past 2^31 (I = long long); offsets into shared memory are always int.
#include "common.cuh"

namespace {

// The cell of a point's top-left corner, ((int)y0 + 1) * (W + 1) + (int)x0 + 1,
// or -1 where none of its four corners lies inside the plane (a NaN
// coordinate included). `tp` comes from the same bilinear_taps as the forward.
__device__ __forceinline__ int corner_cell(const Taps& tp, int H, int W) {
  const bool inside = tp.x0 >= -1.f && tp.x0 <= (float)(W - 1) && tp.y0 >= -1.f &&
                      tp.y0 <= (float)(H - 1);
  return inside ? ((int)tp.y0 + 1) * (W + 1) + (int)tp.x0 + 1 : -1;
}

// Exclusive scan of count[0, n) into start[0, n] (start[n] = the total) and
// into count itself (the placement's cursors). Each thread scans a
// contiguous run of cells; the runs' totals are scanned across the block.
// `warp_total` holds 32 ints. blockDim.x must be a multiple of 32.
__device__ __forceinline__ void block_exclusive_scan(int* count, int* start, int n,
                                                     int* warp_total) {
  const int per = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min((int)threadIdx.x * per, n), hi = min(lo + per, n);
  int sum = 0;
  for (int c = lo; c < hi; ++c) sum += count[c];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = sum;  // inclusive scan within the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
  for (int c = lo; c < hi; ++c) {
    const int v = count[c];
    start[c] = run;
    count[c] = run;
    run += v;
  }
  if (threadIdx.x == blockDim.x - 1) start[n] = run;
}

// A binned point: its 1-D weights wx1, wy1 and its index in the chunk.
struct alignas(16) Binned {
  float fx, fy;
  int q, pad;
};

// Dynamic shared memory of a 'shared' block, in this order (each part in
// whole 16 bytes): the slice's f32 plane (H*W x channels; only where the
// points take more than one chunk), the chunk's dout slices (chunk x
// channels of T, by point index), the binned points (chunk x 16 bytes), the
// cells' starts ((H+1)(W+1) + 1 ints) and cursors ((H+1)(W+1) ints), 32 warp
// totals. ops/cuda/warp.py dsrc_shared_bytes computes the same.
__host__ __device__ __forceinline__ long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long shared_layout(int H, int W, int channels, int chunk,
                                                            int elem_bytes, bool plane,
                                                            long long (&at)[5]) {
  const long long cells = (long long)(H + 1) * (W + 1);
  at[0] = plane ? round16((long long)H * W * channels * 4) : 0;        // dout slices
  at[1] = at[0] + round16((long long)chunk * channels * elem_bytes);  // binned points
  at[2] = at[1] + (long long)chunk * sizeof(Binned);                  // starts
  at[3] = at[2] + (cells + 1) * 4;                                    // cursors
  at[4] = at[3] + cells * 4;                                          // warp totals
  return round16(at[4] + 32 * 4);
}

constexpr int kBatch = 4;  // points a thread bins at once, their grid loads in flight

template <typename T, int V, typename I, int kTile>
__global__ void __launch_bounds__(512)
warp_dsrc_kernel_shared(const float* __restrict__ grid, const T* __restrict__ dout,
                        T* __restrict__ dsrc, int H, int W, int C, I N, int channels,
                        int lanes_log2, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W;
  const int cells = (H + 1) * (W + 1);
  const bool one_chunk = N <= (I)chunk;  // then the sums go straight to dsrc
  long long at[5];
  shared_layout(H, W, channels, chunk, sizeof(T), !one_chunk, at);
  float* plane = reinterpret_cast<float*>(smem);  // H*W x channels f32, unless one chunk
  Pack<T, V>* stage = reinterpret_cast<Pack<T, V>*>(smem + at[0]);
  Binned* binned = reinterpret_cast<Binned*>(smem + at[1]);
  int* start = reinterpret_cast<int*>(smem + at[2]);
  int* cursor = reinterpret_cast<int*>(smem + at[3]);
  int* warp_total = reinterpret_cast<int*>(smem + at[4]);

  const int c0 = blockIdx.x * channels;
  const int packs = min(channels, C - c0) / V;  // the last slice may be narrower
  const int stride = channels / V;              // packs a staged point takes
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = threadIdx.x >> lanes_log2;
  const int rows = blockDim.x >> lanes_log2;
  // the gather's tiles of kTile x kTile pixels: QW x QH of them, this
  // thread's are row, row + rows, ..., at (x, y) advanced by (rows % QW,
  // rows / QW) without a division per tile
  const int QW = (W + kTile - 1) / kTile, QH = (H + kTile - 1) / kTile;
  const int step_x = rows % QW, step_y = rows / QW;
  const I b = blockIdx.y;
  grid += b * N * 2;
  dout += b * N * C + c0;
  dsrc += b * HW * C + c0;

  if (!one_chunk)
    for (int px = row; px < HW; px += rows)
      for (int k = lane; k < packs; k += lanes)
#pragma unroll
        for (int j = 0; j < V; ++j) plane[px * channels + k * V + j] = 0.f;

  for (I q0 = 0; q0 < N; q0 += chunk) {
    const int n = (int)(N - q0 < (I)chunk ? N - q0 : (I)chunk);
    for (int c = threadIdx.x; c < cells; c += blockDim.x) cursor[c] = 0;
    __syncthreads();  // the previous chunk's gather is done with the bins and slices
    // the chunk's dout slices, by point index: a group of lanes per point, so
    // a point's row of packs is read in one coalesced sweep; 16-byte packs go
    // by cp.async and stay in flight while the points are binned
    for (int q = row; q < n; q += rows) {
      const Pack<T, V>* src = reinterpret_cast<const Pack<T, V>*>(dout + (q0 + q) * C);
      for (int k = lane; k < packs; k += lanes) {
        if constexpr (sizeof(Pack<T, V>) == 16) cp_async_16(stage + q * stride + k, src + k);
        else stage[q * stride + k] = src[k];
      }
    }
    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_commit();
    // count: a thread reads kBatch points' grid entries before it uses any
    for (int q = threadIdx.x; q < n; q += kBatch * blockDim.x) {
      float g[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int qu = min(q + u * (int)blockDim.x, n - 1);
        g[u][0] = grid[2 * (q0 + qu)];
        g[u][1] = grid[2 * (q0 + qu) + 1];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int cell = corner_cell(bilinear_taps(g[u][0], g[u][1], H, W), H, W);
        if (q + u * (int)blockDim.x < n && cell >= 0) atomicAdd(cursor + cell, 1);
      }
    }
    __syncthreads();
    block_exclusive_scan(cursor, start, cells, warp_total);
    __syncthreads();
    // placement: each point's weights and index at its slot in cell order
    for (int q = threadIdx.x; q < n; q += kBatch * blockDim.x) {
      float g[kBatch][2];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int qu = min(q + u * (int)blockDim.x, n - 1);
        g[u][0] = grid[2 * (q0 + qu)];
        g[u][1] = grid[2 * (q0 + qu) + 1];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int qu = q + u * (int)blockDim.x;
        if (qu >= n) break;
        const Taps tp = bilinear_taps(g[u][0], g[u][1], H, W);
        const int cell = corner_cell(tp, H, W);
        if (cell >= 0) binned[atomicAdd(cursor + cell, 1)] = Binned{tp.wx1, tp.wy1, qu, 0};
      }
    }
    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_wait(0);
    __syncthreads();

    // the gather: a thread owns the tile's pixels (kTile x + dx, kTile y + dy)
    // for one pack and walks the (kTile + 1)^2 cells whose points have a
    // corner among them, (x0, y0) = (kTile x - 1 + i, kTile y - 1 + j); each
    // point's pack is read once and added to the pixels (x0 + a, y0 + e) of
    // the tile
    for (int qd = row, x = row % QW, y = row / QW; qd < QW * QH;
         qd += rows, x += step_x, y += step_y) {
      if (x >= QW) x -= QW, ++y;
      for (int k = lane; k < packs; k += lanes) {
        float acc[kTile][kTile][V] = {};
#pragma unroll
        for (int j = 0; j <= kTile; ++j) {
#pragma unroll
          for (int i = 0; i <= kTile; ++i) {
            // cell (x0 + 1, y0 + 1) of the (W + 1) x (H + 1) cells
            if (kTile * x + i > W || kTile * y + j > H) continue;
            const int cell = (kTile * y + j) * (W + 1) + kTile * x + i;
            for (int t = start[cell]; t < start[cell + 1]; ++t) {
              const Binned pt = binned[t];
              const Pack<T, V> v = stage[pt.q * stride + k];
              float g[V];
#pragma unroll
              for (int c = 0; c < V; ++c) g[c] = to_float(v.v[c]);
#pragma unroll
              for (int e = 0; e < 2; ++e) {
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                  const int dx = i + a - 1, dy = j + e - 1;
                  if (dx < 0 || dx >= kTile || dy < 0 || dy >= kTile) continue;
                  const float w = (a ? pt.fx : 1.f - pt.fx) * (e ? pt.fy : 1.f - pt.fy);
#pragma unroll
                  for (int c = 0; c < V; ++c) acc[dy][dx][c] += g[c] * w;
                }
              }
            }
          }
        }
#pragma unroll
        for (int dy = 0; dy < kTile; ++dy) {
#pragma unroll
          for (int dx = 0; dx < kTile; ++dx) {
            if (kTile * x + dx >= W || kTile * y + dy >= H) continue;
            const int px = (kTile * y + dy) * W + kTile * x + dx;
            if (one_chunk) {
              Pack<T, V> o;
#pragma unroll
              for (int c = 0; c < V; ++c) o.v[c] = from_float<T>(acc[dy][dx][c]);
              *reinterpret_cast<Pack<T, V>*>(dsrc + (I)px * C + k * V) = o;
            } else {
#pragma unroll
              for (int c = 0; c < V; ++c) plane[px * channels + k * V + c] += acc[dy][dx][c];
            }
          }
        }
      }
    }
  }
  if (one_chunk && N > 0) return;

  // the plane (or, without points, zeros) out by pixel rows
  __syncthreads();
  for (int px = row; px < HW; px += rows) {
    for (int k = lane; k < packs; k += lanes) {
      Pack<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.v[j] = from_float<T>(one_chunk ? 0.f : plane[px * channels + k * V + j]);
      *reinterpret_cast<Pack<T, V>*>(dsrc + (I)px * C + k * V) = o;
    }
  }
}

template <typename T, int V, typename I>
__global__ void __launch_bounds__(256)
warp_dsrc_kernel_global(const float* __restrict__ grid, const T* __restrict__ dout,
                        float* __restrict__ acc, int H, int W, int C, I N) {
  const int CV = C / V;
  const I i = (I)blockIdx.x * blockDim.x + threadIdx.x;  // over one batch element's N * CV
  if (i >= N * CV) return;
  const I p = i / CV;
  const int cv = (int)(i - p * CV);
  const I b = blockIdx.y;

  const Taps tp = bilinear_taps(grid[2 * (b * N + p)], grid[2 * (b * N + p) + 1], H, W);
  bool in[4];
  I off[4];
  corner_offsets<I>(tp, H, W, C, in, off);
  const float ws[4] = {tp.wx0 * tp.wy0, tp.wx1 * tp.wy0, tp.wx0 * tp.wy1, tp.wx1 * tp.wy1};
  const Pack<T, V> d =
      *reinterpret_cast<const Pack<T, V>*>(dout + (b * N + p) * C + cv * V);
  float g[V];
#pragma unroll
  for (int j = 0; j < V; ++j) g[j] = to_float(d.v[j]);

  float* base = acc + b * H * W * C + cv * V;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (in[t]) {
      float* q = base + off[t];
      if constexpr (V == 4) {
        atomicAdd(reinterpret_cast<float4*>(q),
                  make_float4(g[0] * ws[t], g[1] * ws[t], g[2] * ws[t], g[3] * ws[t]));
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) atomicAdd(q + j, g[j] * ws[t]);
      }
    }
  }
}

enum Variant { kShared = 0, kGlobal = 1 };

template <typename T, int V, typename I, int kTile>
int launch_shared_as(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                     long long N, int channels, int lanes_log2, int chunk, dim3 blocks,
                     int threads, int shared_bytes, cudaStream_t s) {
  if (shared_bytes > 48 * 1024) {
    const int err = opt_in_shared_memory<warp_dsrc_kernel_shared<T, V, I, kTile>>();
    if (err) return err;
  }
  warp_dsrc_kernel_shared<T, V, I, kTile><<<blocks, threads, shared_bytes, s>>>(
      grid, static_cast<const T*>(dout), static_cast<T*>(dsrc), H, W, C, (I)N, channels,
      lanes_log2, chunk);
  return 0;
}

template <typename T, int V, typename I>
int launch_shared(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                  long long N, int channels, int lanes_log2, int chunk, int tile, dim3 blocks,
                  int threads, int shared_bytes, cudaStream_t s) {
  if (tile == 2)
    return launch_shared_as<T, V, I, 2>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, blocks, threads, shared_bytes, s);
  if (tile == 1)
    return launch_shared_as<T, V, I, 1>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, blocks, threads, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename I>
int launch(const float* grid, const void* dout, void* dsrc, int B, int H, int W, int C,
           long long N, int variant, int vector, int channels, int lanes_log2, int chunk,
           int tile, dim3 blocks, int threads, int shared_bytes, cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  if (variant == kShared) {
    // the layout must fit the shared bytes; every thread must belong to a
    // whole group of lanes
    long long at[5];
    const long long need =
        chunk > 0 ? shared_layout(H, W, channels, chunk, sizeof(T), N > chunk, at) : 0;
    if (channels <= 0 || channels % vector != 0 || C % vector != 0 || chunk <= 0 ||
        need > shared_bytes || shared_bytes > kMaxDynamicShared || threads % 32 != 0 ||
        (threads >> lanes_log2) == 0 || threads % (1 << lanes_log2) != 0)
      return (int)cudaErrorInvalidValue;
    if (vector == kPack)
      return launch_shared<T, kPack, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, tile, blocks, threads, shared_bytes, s);
    if (vector == 1)
      return launch_shared<T, 1, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2, chunk,
                                    tile, blocks, threads, shared_bytes, s);
    return (int)cudaErrorInvalidValue;
  }
  if (variant != kGlobal || C % vector != 0) return (int)cudaErrorInvalidValue;
  float* acc = static_cast<float*>(dsrc);
  const cudaError_t err = cudaMemsetAsync(acc, 0, sizeof(float) * (size_t)B * H * W * C, s);
  if (err != cudaSuccess) return (int)err;
  if (blocks.x == 0) return 0;  // no points: the gradient is the zeros
  if (vector == 4) {
    warp_dsrc_kernel_global<T, 4, I><<<blocks, threads, 0, s>>>(
        grid, static_cast<const T*>(dout), acc, H, W, C, (I)N);
  } else if (vector == 1) {
    warp_dsrc_kernel_global<T, 1, I><<<blocks, threads, 0, s>>>(
        grid, static_cast<const T*>(dout), acc, H, W, C, (I)N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// grid (B, N, 2) f32 and dout (B, N, C) of `dtype`. dsrc: (B, H, W, C) of
// dout's dtype for 'shared'; an f32 buffer, zeroed here, for 'global'. The
// plan's fields (ops/cuda/warp.py DsrcPlan): variant 0 'shared' or 1
// 'global', channels a load (a 16-byte pack or 1 for 'shared'; 4 or 1, one
// float4 atomic, for 'global'), channels a block owns, log2 of the threads
// per tile, points binned at a time, the gather's tile (1 or 2 pixels a
// side), threads per block, blocks over the slices ('shared') or over one
// batch element's points ('global'), dynamic shared bytes, and whether
// offsets need 64 bits.
extern "C" int mk_warp_dsrc(const void* grid, const void* dout, void* dsrc, int B, int H, int W,
                            int C, long long N, int dtype, int variant, int vector,
                            int channels, int lanes_log2, int chunk, int tile, int threads,
                            long long blocks_x, int shared_bytes, int index64, void* stream) {
  if (B == 0 || C == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const dim3 blocks((unsigned)blocks_x, (unsigned)B);
  int status;
  if (dtype == kFloat32) {
    status = index64 ? launch<float, long long>(g, dout, dsrc, B, H, W, C, N, variant, vector,
                                                channels, lanes_log2, chunk, tile, blocks,
                                                threads, shared_bytes, s)
                     : launch<float, int>(g, dout, dsrc, B, H, W, C, N, variant, vector,
                                          channels, lanes_log2, chunk, tile, blocks, threads,
                                          shared_bytes, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch<__nv_bfloat16, long long>(g, dout, dsrc, B, H, W, C, N, variant, vector,
                                           channels, lanes_log2, chunk, tile, blocks, threads,
                                           shared_bytes, s)
        : launch<__nv_bfloat16, int>(g, dout, dsrc, B, H, W, C, N, variant, vector, channels,
                                     lanes_log2, chunk, tile, blocks, threads, shared_bytes,
                                     s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}
