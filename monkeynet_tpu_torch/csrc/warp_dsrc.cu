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
// block. One kernel, in two plans that ops/cuda/warp.py `dsrc_plan` chooses
// between:
//
// - 'shared': one block per (channel slice, batch element), blockIdx.y the
//   batch element, owning every pixel row. The scatter is turned into a
//   gather, so no two threads add to one value and no f32 atomic is needed.
//   For each chunk of up to `chunk` points the block bins the points by the
//   cell of their top-left corner, (x0, y0) in [-1, W-1] x [-1, H-1]: a
//   count with integer shared-memory atomics (one instruction on sm_90), a
//   block-wide exclusive scan, and a placement in point order by two warps
//   (place_in_order), while the chunk's dout slices arrive in shared memory
//   by cp.async (a group of lanes per point). Then each thread owns the
//   values of one pack of channels at a tile of pixels, a power-of-two group
//   of `lanes` threads per tile over the slice's packs: it walks the points
//   of the cells whose corners fall in its tile (4 cells for one pixel, 9
//   for a 2 x 2 quad, which reads a point's pack about 2.25 times instead of
//   4) and adds dout * w_corner from shared memory in f32 registers. With
//   all points in one chunk it writes the sums straight out; otherwise it
//   adds them into its own values of the slice's f32 plane in shared memory
//   and the block writes the plane after the last chunk. The output is in
//   dout's dtype (bf16 by __float2bfloat16, round to nearest even, as a cast
//   of the f32 sum rounds). One launch a call: no fill of device memory, no
//   global atomics, no cast pass. The first form of this variant added into
//   a shared f32 plane with atomicAdd; sm_90 has no f32 add on shared memory
//   and runs it as a compare-and-swap loop (ATOMS.CAST.SPIN), which made it
//   slower than a global scatter at the taichi shapes (PERF.md).
// - 'bands': where not even one pack's slice of the whole plane fits the
//   227 KB a block may use (the 64 x 128^2 skip of the 256^2 configs), each
//   block owns a band of `rows` pixel rows of a slice (blockIdx.x = band *
//   slices + slice): it scans all its batch element's points a chunk at a
//   time, bins only those with a corner in its band (cells of rows y_lo - 1
//   to y_lo + rows - 1), skips a chunk that has none, and gathers as
//   'shared' does into the band's plane.
//
// Order of summation, fixed: a pixel's four cells row by row, the points of
// a cell in point order within a chunk, the chunks' sums in chunk order. So
// two runs on the same inputs agree bit for bit (an atomicAdd on the cell's
// cursor would place a cell's points in the order the atomics land). A
// sweep in point order was chosen over sorting each cell's run afterwards:
// it costs n / 64 dependent steps a chunk whatever the cells, where a sort by
// one thread a cell would take ~n^2 steps for a chunk whose points a
// contracting grid puts in one cell (PERF.md times that case).
// Bound: bytes. The grid and dout are read once
// from device memory and the gradient written once; 'shared' reads the grid
// once per slice (twice per chunk, the second time from L1) and a point's
// dout once per corner from shared memory; 'bands' reads the grid once per
// (band, slice) and a chunk's dout once per band that any of its points
// reaches, so it is slow where the points scatter over the whole plane and
// every band meets every chunk (PERF.md: random against near-identity grids).
// Index arithmetic is 32-bit (I = int) unless the plan finds an offset at or
// past 2^31 (I = long long); offsets into shared memory are always int.
#include "common.cuh"

namespace {

// The cell of a point's top-left corner among the cells of a band of pixel
// rows [y_lo, y_lo + Hb): ((int)y0 + 1 - y_lo) * (W + 1) + (int)x0 + 1, for
// x0 in [-1, W - 1] and y0 in [y_lo - 1, y_lo + Hb - 1] (the cells with a
// corner in the band); else -1 (a NaN coordinate included). With y_lo = 0
// and Hb = H, every cell with a corner inside the plane. `tp` comes from
// the same bilinear_taps as the forward.
__device__ __forceinline__ int corner_cell(const Taps& tp, int W, int y_lo, int Hb) {
  const bool inside = tp.x0 >= -1.f && tp.x0 <= (float)(W - 1) &&
                      tp.y0 >= (float)(y_lo - 1) && tp.y0 <= (float)(y_lo + Hb - 1);
  return inside ? ((int)tp.y0 + 1 - y_lo) * (W + 1) + (int)tp.x0 + 1 : -1;
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

constexpr int kSweep = 4;  // steps of 64 points whose cells the placement forms at once

// The two placement warps' barrier (named barrier 1, threads 0-63).
__device__ __forceinline__ void placement_sync() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// The placement of one chunk, by two warps (called by threads 0-63 only):
// the n points of `grid` (already offset to the chunk) in index order, 64 at
// a time, thread t taking point base + t. The threads whose points share a
// cell find each other by an atomicOr of their lane bits into their warp's
// mask of the cell, masks[w * cells + cell] (an OR: the same whatever order
// the lanes land in); they take that cell's next slots in thread order, and
// the highest of them moves the cell's cursor past them and clears both
// masks. cursor[c] starts at the cell's exclusive scan; the masks are zero
// on entry and on exit. So every cell's points lie in point order and the
// gather adds them in that order, run after run: n / 64 dependent steps
// whatever the cells (all n points in one cell included). __match_any_sync
// would find one warp's groups without masks, but took ~0.4 us a step on an
// H100 (scripts/dsrc_phase_probe.py, PERF.md).
__device__ __forceinline__ void place_in_order(const float* __restrict__ grid, int n, int H,
                                               int W, int y_lo, int Hb, int* cursor,
                                               unsigned* masks, int cells, Binned* binned) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned bit = 1u << lane, below = bit - 1u;
  unsigned* lo = masks;
  unsigned* hi = masks + cells;
  unsigned* own = warp ? hi : lo;
  for (int base = 0; base < n; base += 64 * kSweep) {
    float fx[kSweep], fy[kSweep];
    int cell[kSweep];
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      const int q = base + 64 * u + t;
      const int qc = min(q, n - 1);
      const Taps tp = bilinear_taps(grid[2 * qc], grid[2 * qc + 1], H, W);
      fx[u] = tp.wx1;
      fy[u] = tp.wy1;
      cell[u] = q < n ? corner_cell(tp, W, y_lo, Hb) : -1;
    }
#pragma unroll
    for (int u = 0; u < kSweep; ++u) {
      if (base + 64 * u >= n) break;  // the same for every thread
      const int c = cell[u];
      if (c >= 0) atomicOr(own + c, bit);
      placement_sync();
      const unsigned m0 = c >= 0 ? lo[c] : 0u, m1 = c >= 0 ? hi[c] : 0u;
      const int first = c >= 0 ? cursor[c] : 0;
      placement_sync();  // every thread has read its masks and cursor before any moves
      if (c >= 0) {
        const int slot = first + (warp ? __popc(m0) + __popc(m1 & below) : __popc(m0 & below));
        binned[slot] = Binned{fx[u], fy[u], base + 64 * u + t, 0};
        if (warp ? (m1 >> lane) == 1u : m1 == 0u && (m0 >> lane) == 1u) {
          cursor[c] = first + __popc(m0) + __popc(m1);
          lo[c] = 0u;
          hi[c] = 0u;
        }
      }
      placement_sync();
    }
  }
}

// Dynamic shared memory of a block, in this order (each part in whole 16
// bytes): the slice's f32 plane (rows*W x channels; only where the points
// take more than one chunk), the chunk's dout slices (chunk x channels of
// T, by point index), the binned points (chunk x 16 bytes), the cells'
// starts ((rows+1)(W+1) + 1 ints), cursors ((rows+1)(W+1) ints), the
// placement's lane masks (two warps' worth, 2 (rows+1)(W+1) ints), 32 warp
// totals. `rows` is the plan's rows a block owns (H for 'shared').
// ops/cuda/warp.py dsrc_shared_bytes computes the same.
__host__ __device__ __forceinline__ long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ long long shared_layout(int rows, int W, int channels,
                                                            int chunk, int elem_bytes,
                                                            bool plane, long long (&at)[6]) {
  const long long cells = (long long)(rows + 1) * (W + 1);
  at[0] = plane ? round16((long long)rows * W * channels * 4) : 0;     // dout slices
  at[1] = at[0] + round16((long long)chunk * channels * elem_bytes);  // binned points
  at[2] = at[1] + (long long)chunk * sizeof(Binned);                  // starts
  at[3] = at[2] + (cells + 1) * 4;                                    // cursors
  at[4] = at[3] + cells * 4;                                          // lane masks
  at[5] = at[4] + 2 * cells * 4;                                      // warp totals
  return round16(at[5] + 32 * 4);
}

constexpr int kBatch = 4;  // points a thread bins at once, their grid loads in flight

// blockIdx.x = band * slices + slice, blockIdx.y the batch element. A block
// owns pixel rows [band * rows, + rows) (all H rows in 'shared') and the
// channels [slice * channels, + channels).
template <typename T, int V, typename I, int kTile>
__global__ void __launch_bounds__(512)
warp_dsrc_kernel(const float* __restrict__ grid, const T* __restrict__ dout,
                 T* __restrict__ dsrc, int H, int W, int C, I N, int channels, int lanes_log2,
                 int chunk, int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int slices = (C + channels - 1) / channels;
  const int y_lo = (blockIdx.x / slices) * rows_per_block;
  const int Hb = min(rows_per_block, H - y_lo);  // the band's pixel rows
  if (Hb <= 0) return;
  const int HW = Hb * W;
  const int cells = (Hb + 1) * (W + 1);
  const bool one_chunk = N <= (I)chunk;  // then the sums go straight to dsrc
  const bool banded = rows_per_block < H;
  long long at[6];
  shared_layout(rows_per_block, W, channels, chunk, sizeof(T), !one_chunk, at);
  float* plane = reinterpret_cast<float*>(smem);  // HW x channels f32, unless one chunk
  Pack<T, V>* stage = reinterpret_cast<Pack<T, V>*>(smem + at[0]);
  Binned* binned = reinterpret_cast<Binned*>(smem + at[1]);
  int* start = reinterpret_cast<int*>(smem + at[2]);
  int* cursor = reinterpret_cast<int*>(smem + at[3]);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + at[4]);  // zero but inside a placement
  int* warp_total = reinterpret_cast<int*>(smem + at[5]);

  const int c0 = (blockIdx.x % slices) * channels;
  const int packs = min(channels, C - c0) / V;  // the last slice may be narrower
  const int stride = channels / V;              // packs a staged point takes
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int row = threadIdx.x >> lanes_log2;
  const int rows = blockDim.x >> lanes_log2;
  // the gather's tiles of kTile x kTile pixels: QW x QH of them, this
  // thread's are row, row + rows, ..., at (x, y) advanced by (rows % QW,
  // rows / QW) without a division per tile
  const int QW = (W + kTile - 1) / kTile, QH = (Hb + kTile - 1) / kTile;
  const int step_x = rows % QW, step_y = rows / QW;
  const I b = blockIdx.y;
  grid += b * N * 2;
  dout += b * N * C + c0;
  dsrc += (b * H + y_lo) * W * C + c0;

  // the chunk's dout slices, by point index: a group of lanes per point, so
  // a point's row of packs is read in one coalesced sweep; 16-byte packs go
  // by cp.async and stay in flight while the points are binned ('shared':
  // from before the count) or placed ('bands': once the count has found
  // points in the band)
  auto stage_chunk = [&](I q0, int n) {
    for (int q = row; q < n; q += rows) {
      const Pack<T, V>* src = reinterpret_cast<const Pack<T, V>*>(dout + (q0 + q) * C);
      for (int k = lane; k < packs; k += lanes) {
        if constexpr (sizeof(Pack<T, V>) == 16) cp_async_16(stage + q * stride + k, src + k);
        else stage[q * stride + k] = src[k];
      }
    }
    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_commit();
  };

  for (int c = threadIdx.x; c < 2 * cells; c += blockDim.x) masks[c] = 0u;
  if (!one_chunk)
    for (int px = row; px < HW; px += rows)
      for (int k = lane; k < packs; k += lanes)
#pragma unroll
        for (int j = 0; j < V; ++j) plane[px * channels + k * V + j] = 0.f;

  for (I q0 = 0; q0 < N; q0 += chunk) {
    const int n = (int)(N - q0 < (I)chunk ? N - q0 : (I)chunk);
    for (int c = threadIdx.x; c < cells; c += blockDim.x) cursor[c] = 0;
    __syncthreads();  // the previous chunk's gather is done with the bins and slices
    if (!banded) stage_chunk(q0, n);
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
        const int cell = corner_cell(bilinear_taps(g[u][0], g[u][1], H, W), W, y_lo, Hb);
        if (q + u * (int)blockDim.x < n && cell >= 0) atomicAdd(cursor + cell, 1);
      }
    }
    __syncthreads();
    block_exclusive_scan(cursor, start, cells, warp_total);
    __syncthreads();
    // a chunk with no point in the band adds nothing (with one chunk the
    // gather still runs: it writes the band's zeros)
    if (banded && !one_chunk && start[cells] == 0) continue;
    if (banded) stage_chunk(q0, n);
    // placement: each point's weights and index at its cell's next slot,
    // in point order (place_in_order)
    if (threadIdx.x < 64)
      place_in_order(grid + 2 * q0, n, H, W, y_lo, Hb, cursor, masks, cells, binned);
    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_wait(0);
    __syncthreads();

    // the gather: a thread owns the tile's pixels (kTile x + dx, kTile y + dy)
    // for one pack and walks the (kTile + 1)^2 cells whose points have a
    // corner among them, (x0, y0) = (kTile x - 1 + i, kTile y - 1 + j) in the
    // band; each point's pack is read once and added to the pixels
    // (x0 + a, y0 + e) of the tile
    for (int qd = row, x = row % QW, y = row / QW; qd < QW * QH;
         qd += rows, x += step_x, y += step_y) {
      if (x >= QW) x -= QW, ++y;
      for (int k = lane; k < packs; k += lanes) {
        float acc[kTile][kTile][V] = {};
#pragma unroll
        for (int j = 0; j <= kTile; ++j) {
#pragma unroll
          for (int i = 0; i <= kTile; ++i) {
            // cell (x0 + 1, y0 + 1 - y_lo) of the band's (W + 1) x (Hb + 1)
            if (kTile * x + i > W || kTile * y + j > Hb) continue;
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
            if (kTile * x + dx >= W || kTile * y + dy >= Hb) continue;
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

template <typename T, int V, typename I, int kTile>
int launch_as(const float* grid, const void* dout, void* dsrc, int H, int W, int C, long long N,
              int channels, int lanes_log2, int chunk, int rows, dim3 blocks, int threads,
              int shared_bytes, cudaStream_t s) {
  if (shared_bytes > 48 * 1024) {
    const int err = opt_in_shared_memory<warp_dsrc_kernel<T, V, I, kTile>>();
    if (err) return err;
  }
  warp_dsrc_kernel<T, V, I, kTile><<<blocks, threads, shared_bytes, s>>>(
      grid, static_cast<const T*>(dout), static_cast<T*>(dsrc), H, W, C, (I)N, channels,
      lanes_log2, chunk, rows);
  return 0;
}

template <typename T, int V, typename I>
int launch_tiled(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                 long long N, int channels, int lanes_log2, int chunk, int tile, int rows,
                 dim3 blocks, int threads, int shared_bytes, cudaStream_t s) {
  if (tile == 2)
    return launch_as<T, V, I, 2>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2, chunk,
                                 rows, blocks, threads, shared_bytes, s);
  if (tile == 1)
    return launch_as<T, V, I, 1>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2, chunk,
                                 rows, blocks, threads, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename I>
int launch(const float* grid, const void* dout, void* dsrc, int H, int W, int C, long long N,
           int vector, int channels, int lanes_log2, int chunk, int tile, int rows, dim3 blocks,
           int threads, int shared_bytes, cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  // the layout must fit the shared bytes; every thread must belong to a
  // whole group of lanes; the blocks must cover every (band, slice)
  long long at[6];
  const long long need = chunk > 0 && rows > 0
      ? shared_layout(rows, W, channels, chunk, sizeof(T), N > chunk, at) : 0;
  const long long slices = channels > 0 ? (C + channels - 1) / channels : 0;
  if (channels <= 0 || channels % vector != 0 || C % vector != 0 || chunk <= 0 || rows <= 0 ||
      need > shared_bytes || shared_bytes > kMaxDynamicShared || threads % 32 != 0 ||
      threads < 64 || (threads >> lanes_log2) == 0 || threads % (1 << lanes_log2) != 0 ||
      (long long)blocks.x < slices * ((H + rows - 1) / rows))
    return (int)cudaErrorInvalidValue;
  if (vector == kPack)
    return launch_tiled<T, kPack, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2, chunk,
                                     tile, rows, blocks, threads, shared_bytes, s);
  if (vector == 1)
    return launch_tiled<T, 1, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2, chunk,
                                 tile, rows, blocks, threads, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// grid (B, N, 2) f32 and dout (B, N, C) of `dtype`; dsrc (B, H, W, C) of
// dout's dtype. The plan's fields (ops/cuda/warp.py DsrcPlan): channels a
// load (a 16-byte pack or 1), channels a block owns, log2 of the threads per
// tile, points binned at a time, the gather's tile (1 or 2 pixels a side),
// pixel rows a block owns (H, or a band's), threads per block, blocks over
// (band, slice) pairs, dynamic shared bytes, and whether offsets need 64
// bits.
extern "C" int mk_warp_dsrc(const void* grid, const void* dout, void* dsrc, int B, int H, int W,
                            int C, long long N, int dtype, int vector, int channels,
                            int lanes_log2, int chunk, int tile, int rows, int threads,
                            long long blocks_x, int shared_bytes, int index64, void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  const dim3 blocks((unsigned)blocks_x, (unsigned)B);
  int status;
  if (dtype == kFloat32) {
    status = index64 ? launch<float, long long>(g, dout, dsrc, H, W, C, N, vector, channels,
                                                lanes_log2, chunk, tile, rows, blocks, threads,
                                                shared_bytes, s)
                     : launch<float, int>(g, dout, dsrc, H, W, C, N, vector, channels,
                                          lanes_log2, chunk, tile, rows, blocks, threads,
                                          shared_bytes, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch<__nv_bfloat16, long long>(g, dout, dsrc, H, W, C, N, vector, channels,
                                           lanes_log2, chunk, tile, rows, blocks, threads,
                                           shared_bytes, s)
        : launch<__nv_bfloat16, int>(g, dout, dsrc, H, W, C, N, vector, channels, lanes_log2,
                                     chunk, tile, rows, blocks, threads, shared_bytes, s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}
