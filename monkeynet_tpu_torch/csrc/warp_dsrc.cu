// Warp gradient w.r.t. the source: scatter dout (B, N, C) back to the four
// corners each output point sampled, with the forward's bilinear weights,
// into the channels-last (B, H, W, C) gradient. Accumulation is f32 whatever
// the operand type, as in the TPU kernel; the result is in dout's dtype.
//
// Replaces the TPU d_src kernel of monkeynet_tpu/ops/pallas/warp.py
// (_warp_bwd -> _dsrc_kernel). That kernel has no scatter to use, so it
// rebuilds the hat-weight matrices per tile of 256 points and accumulates
// Z @ Ax into a VMEM-resident (C*H, W) f32 plane over a sequential grid axis
// of point tiles. Hopper has no such plane for the larger skips, so the
// scatter is turned into a gather instead: the points are binned by the cell
// of their top-left corner, (x0, y0) in [-1, W-1] x [-1, H-1], and each
// thread sums, for the pixels it owns, dout * w_corner over the points of
// the cells around them, in f32 registers, and writes each value once. No
// two threads add to one value, so no f32 atomic is needed (sm_90 has no
// f32 add on shared memory and runs one as a compare-and-swap loop,
// ATOMS.CAST.SPIN: the first form of 'shared' used it and lost to a global
// scatter, PERF.md). Two plans, which ops/cuda/warp.py `dsrc_plan` chooses
// between:
//
// - 'shared' (warp_dsrc_kernel, one launch): one block per (channel slice,
//   batch element), blockIdx.y the batch element, owning every pixel row of
//   the slice in shared memory. For each chunk of up to `chunk` points the
//   block counts the points by cell with integer shared-memory atomics (one
//   instruction on sm_90), scans the counts, and places the points in point
//   order by two warps (place_in_order), while the chunk's dout slices
//   arrive in shared memory by cp.async (a group of lanes per point). Then
//   each thread owns the values of one pack of channels at a tile of pixels,
//   a power-of-two group of `lanes` threads per tile over the slice's packs:
//   it walks the points of the cells whose corners fall in its tile (4 cells
//   for one pixel, 9 for a 2 x 2 quad, which reads a point's pack about 2.25
//   times instead of 4; tile_sums). With all points in one chunk it writes
//   the sums straight out; otherwise it adds them into its own values of
//   the slice's f32 plane in shared memory and the block writes the plane
//   after the last chunk. No fill of device memory, no global atomics, no
//   cast pass.
// - 'binned' (three launches): where not even one pack's slice of the whole
//   plane fits the 227 KB a block may use (the 64 x 128^2 skip of the 256^2
//   configs), the binning goes to global memory and the gather reads it
//   there. (1) warp_dsrc_bin_kernel, a thread a point, reads every point
//   once and sets its bit in the list of its sort band (`rows` rows of
//   cells: the cell rows y0 + 1 in [band * rows, + rows)), a run of 32-bit
//   words in point order, by shared-memory atomicOr (an OR: the same
//   whatever order the lanes land in), and adds each block's count to the
//   band's total (an integer sum: the same in any order). (2)
//   warp_dsrc_sort_kernel, a block per (sort band, batch element), reads
//   only its band's words, compacts them into its points in point order (a
//   block-wide scan of the words' bit counts, `chunk` points at a time),
//   counts them by cell, scans, and places them in point order as 'shared'
//   does, into the batch element's cell-sorted list in device memory: every
//   cell's points in point order, the cells in order, the start of each
//   cell beside it. (3) warp_dsrc_gather_kernel, a block per strip of 2 x 2
//   quads of pixels along a row of quads, a group of lanes a quad over the
//   channels, stages the strip's points from that list (three runs, one a
//   row of cells) a window at a time, their entries and dout packs, and
//   each thread walks its quad's 9 cells in the window from shared memory.
//   So every point is read a bounded number of times whatever the grid (a
//   gather block that binned the whole plane's points itself would scan all
//   of them for each band it owns), and a cell that a contracting grid
//   fills with thousands of points is staged by a whole block.
//
// Order of summation, fixed: a pixel's four cells row by row and the points
// of a cell in point order, within a chunk ('shared': the points q0 ...
// q0 + chunk - 1, the chunks' sums added in order; 'binned': all the points
// at once). So two runs on the same inputs agree bit for bit (an atomicAdd
// on a cell's cursor would place its points in the order the atomics land),
// and 'binned' sums every pixel as 'shared' does where 'shared' takes all
// points in one chunk. A sweep in point order was chosen over sorting each
// cell's run afterwards: it costs n / 64 dependent steps a chunk whatever
// the cells, where a sort by one thread a cell would take ~n^2 steps for a
// chunk whose points a contracting grid puts in one cell (PERF.md times
// that case). The output is in dout's dtype (bf16 by __float2bfloat16,
// round to nearest even, as a cast of the f32 sum rounds).
// Bound: bytes. The grid and dout are read once from device memory and the
// gradient written once; 'shared' reads the grid once per slice (twice per
// chunk, the second time from L1) and a point's dout once per corner from
// shared memory; 'binned' reads the grid twice (bin and sort), writes and
// reads 16 bytes a point of sorted list, and stages a point's dout row
// about 1.5 times (once per strip whose cells hold it: an even row of cells
// is shared by two rows of quads), from L2 where the rows are recent.
// Index arithmetic is 32-bit (I = int) unless the plan finds an offset at or
// past 2^31 (I = long long); offsets into shared memory and a point's index
// in a batch element are always int (the plan refuses 'binned' past 2^31
// points a batch element), offsets into the band words and cell starts long
// long.
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

// Exclusive scan of one value a thread, in thread order; `total` gets the
// block's sum. `warp_total` holds 32 ints; the caller syncs the block before
// warp_total is written again. blockDim.x must be a multiple of 32.
__device__ __forceinline__ int block_scan_one(int v, int* warp_total, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  int before = inc - v;
  total = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    const int t = warp_total[w];
    if (w < warp) before += t;
    total += t;
  }
  return before;
}

// A binned point: its 1-D weights wx1, wy1 and `q`, its slot in the chunk
// ('shared': the row of the staged dout slices) or its index in the batch
// element ('binned''s sorted list).
struct alignas(16) Binned {
  float fx, fy;
  int q, pad;
};

constexpr int kSweep = 4;  // steps of 64 points whose cells the placement forms at once

// The two placement warps' barrier (named barrier 1, threads 0-63).
__device__ __forceinline__ void placement_sync() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// The placement of one chunk, by two warps (called by threads 0-63 only):
// the chunk's n points in index order, 64 at a time, thread t taking point
// base + t, whose grid pair fetch(point) returns. The threads whose points
// share a cell find each other by an atomicOr of their lane bits into their
// warp's mask of the cell, masks[w * cells + cell] (an OR: the same whatever
// order the lanes land in); they take that cell's next slots in thread
// order, put(slot, wx1, wy1, point) each, and the highest of them moves
// the cell's cursor past them and clears both masks. cursor[c] starts at
// the cell's exclusive scan; the masks are zero on entry and on exit. So
// every cell's points lie in point order and the gather adds them in that
// order, run after run: n / 64 dependent steps whatever the cells (all n
// points in one cell included). __match_any_sync would find one warp's
// groups without masks, but took ~0.4 us a step on an H100
// (scripts/dsrc_phase_probe.py, PERF.md).
template <typename Fetch, typename Put>
__device__ __forceinline__ void place_in_order(Fetch fetch, Put put, int n, int H, int W,
                                               int y_lo, int Hb, int* cursor, unsigned* masks,
                                               int cells) {
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
      const float2 g = fetch(min(q, n - 1));
      const Taps tp = bilinear_taps(g.x, g.y, H, W);
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
        put(slot, fx[u], fy[u], base + 64 * u + t);
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

// The sums of one pack of channels at a kTile x kTile tile of pixels, (kTile
// x + dx, kTile y + dy) of a band of Hb rows: the (kTile + 1)^2 cells whose
// points have a corner among them, (x0, y0) = (kTile x - 1 + i, kTile y - 1
// + j) in the band, walked row by row; each point's pack is read once and
// added to the pixels (x0 + a, y0 + e) of the tile. range(cell) gives a
// cell's [start, end) in the binned points, load(t, pt, v) point t and its
// pack.
template <typename T, int V, int kTile, typename Range, typename Load>
__device__ __forceinline__ void tile_sums(int x, int y, int W, int Hb, Range range, Load load,
                                          float (&acc)[kTile][kTile][V]) {
#pragma unroll
  for (int j = 0; j <= kTile; ++j) {
#pragma unroll
    for (int i = 0; i <= kTile; ++i) {
      // cell (x0 + 1, y0 + 1 - y_lo) of the band's (W + 1) x (Hb + 1)
      if (kTile * x + i > W || kTile * y + j > Hb) continue;
      const int2 run = range((kTile * y + j) * (W + 1) + kTile * x + i);
      for (int t = run.x; t < run.y; ++t) {
        Binned pt;
        Pack<T, V> v;
        load(t, pt, v);
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
}

// Dynamic shared memory of a 'shared' block, in this order (each part in
// whole 16 bytes): the slice's f32 plane (H*W x channels; only where the
// points take more than one chunk), the chunk's dout slices (chunk x
// channels of T, by point index), the binned points (chunk x 16 bytes), the
// cells' starts ((H+1)(W+1) + 1 ints), cursors ((H+1)(W+1) ints), the
// placement's lane masks (two warps' worth, 2 (H+1)(W+1) ints), 32 warp
// totals. ops/cuda/warp.py dsrc_shared_bytes computes the same.
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

// blockIdx.x = slice, blockIdx.y the batch element. A block owns every
// pixel row and the channels [slice * channels, + channels).
template <typename T, int V, typename I, int kTile>
__global__ void __launch_bounds__(512)
warp_dsrc_kernel(const float* __restrict__ grid, const T* __restrict__ dout,
                 T* __restrict__ dsrc, int H, int W, int C, I N, int channels, int lanes_log2,
                 int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int y_lo = 0, Hb = H;
  const int HW = H * W;
  const int cells = (H + 1) * (W + 1);
  const bool one_chunk = N <= (I)chunk;  // then the sums go straight to dsrc
  long long at[6];
  shared_layout(H, W, channels, chunk, sizeof(T), !one_chunk, at);
  float* plane = reinterpret_cast<float*>(smem);  // HW x channels f32, unless one chunk
  Pack<T, V>* stage = reinterpret_cast<Pack<T, V>*>(smem + at[0]);
  Binned* binned = reinterpret_cast<Binned*>(smem + at[1]);
  int* start = reinterpret_cast<int*>(smem + at[2]);
  int* cursor = reinterpret_cast<int*>(smem + at[3]);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + at[4]);  // zero but inside a placement
  int* warp_total = reinterpret_cast<int*>(smem + at[5]);

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
  dsrc += b * H * W * C + c0;

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
    // the chunk's dout slices, by point index: a group of lanes per point,
    // so a point's row of packs is read in one coalesced sweep; 16-byte
    // packs go by cp.async and stay in flight while the points are binned
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
        const int cell = corner_cell(bilinear_taps(g[u][0], g[u][1], H, W), W, y_lo, Hb);
        if (q + u * (int)blockDim.x < n && cell >= 0) atomicAdd(cursor + cell, 1);
      }
    }
    __syncthreads();
    block_exclusive_scan(cursor, start, cells, warp_total);
    __syncthreads();
    // placement: each point's weights and index at its cell's next slot,
    // in point order (place_in_order)
    const float* chunk_grid = grid + 2 * q0;
    if (threadIdx.x < 64)
      place_in_order(
          [&](int q) { return make_float2(chunk_grid[2 * q], chunk_grid[2 * q + 1]); },
          [&](int slot, float fx, float fy, int q) { binned[slot] = Binned{fx, fy, q, 0}; }, n,
          H, W, y_lo, Hb, cursor, masks, cells);
    if constexpr (sizeof(Pack<T, V>) == 16) cp_async_wait(0);
    __syncthreads();

    // the gather: a thread owns a tile of pixels for one pack (tile_sums)
    for (int qd = row, x = row % QW, y = row / QW; qd < QW * QH;
         qd += rows, x += step_x, y += step_y) {
      if (x >= QW) x -= QW, ++y;
      for (int k = lane; k < packs; k += lanes) {
        float acc[kTile][kTile][V] = {};
        tile_sums<T, V, kTile>(
            x, y, W, Hb, [&](int cell) { return make_int2(start[cell], start[cell + 1]); },
            [&](int t, Binned& pt, Pack<T, V>& v) {
              pt = binned[t];
              v = stage[pt.q * stride + k];
            },
            acc);
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

// 'binned', pass 1. blockIdx.x takes the words [blockIdx.x * wpb, + wpb) of
// every sort band's list (wpb = blockDim.x / 32: a thread a point, a warp a
// word), blockIdx.y the batch element. A point whose corner cell lies in
// the plane goes to the band of its cell row y0 + 1 (bands of `rows` cell
// rows, `bands` of them over the plane's H + 1): its bit is ORed into the
// block's copy of that band's word. The block then writes its words of
// every band (band_words is (B, bands, words) and every word of it is
// written here, so it needs no fill) and adds its count of each band's
// points to band_totals (B, bands), which starts at zero.
template <typename I>
__global__ void __launch_bounds__(1024)
warp_dsrc_bin_kernel(const float* __restrict__ grid, unsigned* __restrict__ band_words,
                     int* __restrict__ band_totals, int H, int W, I N, int rows, int bands) {
  extern __shared__ unsigned block_words[];  // bands x wpb
  const int wpb = blockDim.x >> 5;
  for (int i = threadIdx.x; i < bands * wpb; i += blockDim.x) block_words[i] = 0u;
  __syncthreads();
  const I b = blockIdx.y;
  const I q = (I)blockIdx.x * (I)blockDim.x + (I)threadIdx.x;
  if (q < N) {
    const Taps tp = bilinear_taps(grid[(b * N + q) * 2], grid[(b * N + q) * 2 + 1], H, W);
    if (corner_cell(tp, W, 0, H) >= 0)
      atomicOr(block_words + ((int)tp.y0 + 1) / rows * wpb + (threadIdx.x >> 5),
               1u << (threadIdx.x & 31));
  }
  __syncthreads();
  const int words = (int)((N + 31) / 32);
  // every lane of a warp runs every round (the shuffles need them all)
  for (int i0 = 0; i0 < bands * wpb; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const bool own = i < bands * wpb;
    const int w = blockIdx.x * wpb + i % wpb;
    const unsigned bits = own ? block_words[i] : 0u;
    if (own && w < words) band_words[((long long)blockIdx.y * bands + i / wpb) * words + w] = bits;
    // a block's count of a band's points, one atomic a band: each group of
    // wpb lanes holds the block's words of one band (wpb a power of two,
    // at most 32, and i0 a multiple of it)
    int count = __popc(bits);
    for (int o = wpb >> 1; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o, wpb);
    if (own && i % wpb == 0 && count > 0)
      atomicAdd(band_totals + blockIdx.y * bands + i / wpb, count);
  }
}

// The shared memory of a sort block ('binned', pass 2), each part in whole
// 16 bytes: the window's points (chunk ints), the cells' starts (rows (W+1)
// + 1 ints), cursors (rows (W+1) ints), the placement's lane masks (2 rows
// (W+1) ints), 32 warp totals. ops/cuda/warp.py dsrc_sort_bytes computes
// the same.
__host__ __device__ __forceinline__ long long sort_layout(int rows, int W, int chunk,
                                                          long long (&at)[4]) {
  const long long cells = (long long)rows * (W + 1);
  at[0] = round16((long long)chunk * 4);  // starts
  at[1] = at[0] + (cells + 1) * 4;        // cursors
  at[2] = at[1] + cells * 4;              // lane masks
  at[3] = at[2] + 2 * cells * 4;          // warp totals
  return round16(at[3] + 32 * 4);
}

// 'binned', pass 2. blockIdx.x = sort band (cell rows [band * rows, + rows)
// of the H + 1, the last band shorter), blockIdx.y the batch element. The
// band's points come before it in the batch element's sorted list by the
// totals of the bands before it. The block walks its band's words in point
// order, blockDim.x words at a time, and cuts the points into windows of
// `chunk`: a first sweep counts them by cell, a scan turns the counts into
// the cells' starts (written to cell_starts, the batch element's (H + 1)
// (W + 1) + 1), and a second sweep places each window in point order
// (place_in_order) into `sorted` (B, N) at its cell's next slot. With one
// window the second sweep reuses the first one's points.
template <typename I>
__global__ void __launch_bounds__(512)
warp_dsrc_sort_kernel(const float* __restrict__ grid, const unsigned* __restrict__ band_words,
                      const int* __restrict__ band_totals, int* __restrict__ cell_starts,
                      Binned* __restrict__ sorted, int H, int W, I N, int rows, int bands,
                      int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int band = blockIdx.x;
  const int r0 = band * rows;
  if (r0 > H) return;
  // the cells of corner_cell's band of pixel rows [r0, r0 + Hb): cell rows
  // r0 ... r0 + Hb
  const int y_lo = r0, Hb = min(rows, H + 1 - r0) - 1;
  const int cells = (Hb + 1) * (W + 1);
  long long at[4];
  sort_layout(rows, W, chunk, at);
  int* list = reinterpret_cast<int*>(smem);
  int* start = reinterpret_cast<int*>(smem + at[0]);
  int* cursor = reinterpret_cast<int*>(smem + at[1]);
  unsigned* masks = reinterpret_cast<unsigned*>(smem + at[2]);
  int* warp_total = reinterpret_cast<int*>(smem + at[3]);
  const int words = (int)((N + 31) / 32);
  const unsigned* word = band_words + ((long long)blockIdx.y * bands + band) * words;
  const int* totals = band_totals + blockIdx.y * bands;
  int before = 0;  // the points of the bands before this one
  for (int k = 0; k < band; ++k) before += totals[k];
  const int total = totals[band];
  const I b = blockIdx.y;
  grid += b * N * 2;
  sorted += b * N + before;
  int* starts = cell_starts + (long long)blockIdx.y * ((long long)(H + 1) * (W + 1) + 1) +
                (long long)r0 * (W + 1);

  for (int c = threadIdx.x; c < cells; c += blockDim.x) cursor[c] = 0;
  for (int c = threadIdx.x; c < 2 * cells; c += blockDim.x) masks[c] = 0u;
  auto fetch = [&](int i) {
    const int p = list[i];
    return make_float2(grid[2 * p], grid[2 * p + 1]);
  };
  // each window of the band's points in list[0, n), in point order:
  // blockDim.x words at a time, a word a thread; a word's points take the
  // positions [before, before + count) of the words' scan
  auto for_each_window = [&](auto&& fn) {
    int filled = 0;  // points of the current window already in the list
    for (int w0 = 0; w0 < words; w0 += blockDim.x) {
      __syncthreads();  // warp_total and the list are free again
      const int w = w0 + threadIdx.x;
      const unsigned bits = w < words ? word[w] : 0u;
      int tile_total;
      const int at_word = block_scan_one(__popc(bits), warp_total, tile_total);
      for (int done = 0; done < tile_total;) {
        const int take = min(tile_total - done, chunk - filled);
        int pos = at_word;
        for (unsigned rest = bits; rest != 0u; rest &= rest - 1u, ++pos)
          if (pos >= done && pos < done + take) list[filled + pos - done] = w * 32 + __ffs(rest) - 1;
        done += take;
        filled += take;
        if (filled == chunk) {
          __syncthreads();  // the window's points are in the list
          fn(filled);
          __syncthreads();  // the window is done with the list
          filled = 0;
        }
      }
    }
    if (filled > 0) {
      __syncthreads();
      fn(filled);
      __syncthreads();
    }
  };
  // count the band's points by cell, window by window
  for_each_window([&](int n) {
    for (int i = threadIdx.x; i < n; i += kBatch * blockDim.x) {
      float2 g[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) g[u] = fetch(min(i + u * (int)blockDim.x, n - 1));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int cell = corner_cell(bilinear_taps(g[u].x, g[u].y, H, W), W, y_lo, Hb);
        if (i + u * (int)blockDim.x < n && cell >= 0) atomicAdd(cursor + cell, 1);
      }
    }
  });
  __syncthreads();
  block_exclusive_scan(cursor, start, cells, warp_total);
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) starts[c] = before + start[c];
  if (band == bands - 1 && threadIdx.x == 0) starts[cells] = before + start[cells];
  // place each window in point order into the sorted list
  auto place = [&](int n) {
    if (threadIdx.x < 64)
      place_in_order(fetch,
                     [&](int slot, float fx, float fy, int i) {
                       sorted[slot] = Binned{fx, fy, list[i], 0};
                     },
                     n, H, W, y_lo, Hb, cursor, masks, cells);
  };
  if (total <= chunk) place(total);  // one window: its points are still in the list
  else for_each_window(place);
}

// 'binned', pass 3: the most points a gather block stages at a time, and
// the shared memory it may take (no opt-in): a window of `window` sorted
// entries (16 bytes each) and their dout packs, `lanes` packs of
// pack_bytes a point. With at most 32 lanes of 16 bytes, at least 64.
constexpr int kGatherWindow = 128;
constexpr int kGatherShared = 48 * 1024;

__host__ __device__ __forceinline__ int gather_window(int lanes, int pack_bytes) {
  int window = kGatherWindow;
  while (window > 1 && window * (16 + lanes * pack_bytes) > kGatherShared) window >>= 1;
  return window;
}

// 'binned', pass 3. A block owns a strip of `groups` (blockDim.x / lanes)
// 2 x 2 quads of pixels along one row of quads (blockIdx.x = quad row *
// strips + strip), blockIdx.y the batch element; group g owns quad x0 + g,
// lane l its pack l of each pass over the C / V packs, `lanes` a pass. The
// strip's quads take the points of three runs of the sorted list: cell rows
// 2 y, 2 y + 1 and 2 y + 2, columns 2 x0 ... 2 (x0 + groups), one run a
// row. The block stages those runs, one after another, a window of points
// at a time (their entries, then their dout packs of the pass by cp.async),
// and each thread adds, window by window, the points of its quad's 9 cells
// that the window holds (tile_sums), into f32 sums it keeps over the
// windows, and writes its pixels once after the last. A pixel's cells lie
// in the runs in the order tile_sums walks them (row by row, a row's cells
// left to right, each cell's points in point order), so its sum is the one
// 'shared' forms in one chunk, however the windows cut the runs; and a cell
// that a contracting grid fills with thousands of points is staged by the
// whole block and walked from shared memory.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(512)
warp_dsrc_gather_kernel(const Binned* __restrict__ sorted, const int* __restrict__ cell_starts,
                        const T* __restrict__ dout, T* __restrict__ dsrc, int H, int W, int C,
                        I N, int lanes_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x >> lanes_log2;
  const int groups = blockDim.x >> lanes_log2;
  const int window = gather_window(lanes, (int)sizeof(Pack<T, V>));
  Binned* staged = reinterpret_cast<Binned*>(smem);                              // window
  Pack<T, V>* packs_of = reinterpret_cast<Pack<T, V>*>(smem + window * sizeof(Binned));
  const int QW = (W + 1) / 2;
  const int strips = (QW + groups - 1) / groups;
  const int y = blockIdx.x / strips, x0 = (int)(blockIdx.x % strips) * groups;
  const int x = x0 + group;
  const int packs = C / V;
  const I b = blockIdx.y;
  const int* start = cell_starts + (long long)blockIdx.y * ((long long)(H + 1) * (W + 1) + 1);
  sorted += b * N;
  dout += b * N * C;
  dsrc += b * H * W * C;
  // the three runs: run r holds the sorted points [first_r, first_r +
  // (at_{r+1} - at_r)), at positions [at_r, at_{r+1}) of what the block
  // stages
  const int c_lo = 2 * x0, c_hi = min(2 * (x0 + groups), W);
  int first[3], at[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int row = 2 * y + r;
    first[r] = row <= H ? start[row * (W + 1) + c_lo] : 0;
    at[r + 1] = at[r] + (row <= H ? start[row * (W + 1) + c_hi + 1] - first[r] : 0);
  }
  const int total = at[3];

  for (int k0 = 0; k0 < packs; k0 += lanes) {
    const int k = k0 + lane;  // this lane's pack in the pass
    float acc[2][2][V] = {};
    for (int p0 = 0; p0 < total; p0 += window) {
      const int n = min(window, total - p0);
      __syncthreads();  // the previous window is walked
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        const int p = p0 + i;
        staged[i] = sorted[p < at[1] ? first[0] + p
                           : p < at[2] ? first[1] + p - at[1] : first[2] + p - at[2]];
      }
      __syncthreads();
      if (k < packs) {
        for (int i = group; i < n; i += groups) {
          const Pack<T, V>* src =
              reinterpret_cast<const Pack<T, V>*>(dout + (I)staged[i].q * C) + k;
          if constexpr (sizeof(Pack<T, V>) == 16) cp_async_16(packs_of + i * lanes + lane, src);
          else packs_of[i * lanes + lane] = *src;
        }
      }
      if constexpr (sizeof(Pack<T, V>) == 16) {
        cp_async_commit();
        cp_async_wait(0);
      }
      __syncthreads();
      if (x < QW && k < packs)
        tile_sums<T, V, 2>(
            x, y, W, H,
            [&](int cell) {  // the cell's points in this window, as slots of it
              const int r = cell / (W + 1) - 2 * y;
              const int base = r == 0 ? at[0] - first[0] : r == 1 ? at[1] - first[1]
                                                                  : at[2] - first[2];
              const int lo = max(base + start[cell], p0), hi = min(base + start[cell + 1], p0 + n);
              return make_int2(lo - p0, max(lo, hi) - p0);
            },
            [&](int t, Binned& pt, Pack<T, V>& v) {
              pt = staged[t];
              v = packs_of[t * lanes + lane];
            },
            acc);
    }
    if (x < QW && k < packs) {
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          if (2 * x + dx >= W || 2 * y + dy >= H) continue;
          Pack<T, V> o;
#pragma unroll
          for (int c = 0; c < V; ++c) o.v[c] = from_float<T>(acc[dy][dx][c]);
          *reinterpret_cast<Pack<T, V>*>(dsrc + ((I)(2 * y + dy) * W + 2 * x + dx) * C +
                                         k * V) = o;
        }
      }
    }
  }
}

template <typename T, int V, typename I, int kTile>
int launch_shared_as(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                     long long N, int channels, int lanes_log2, int chunk, dim3 blocks,
                     int threads, int shared_bytes, cudaStream_t s) {
  if (shared_bytes > 48 * 1024) {
    const int err = opt_in_shared_memory<warp_dsrc_kernel<T, V, I, kTile>>();
    if (err) return err;
  }
  warp_dsrc_kernel<T, V, I, kTile><<<blocks, threads, shared_bytes, s>>>(
      grid, static_cast<const T*>(dout), static_cast<T*>(dsrc), H, W, C, (I)N, channels,
      lanes_log2, chunk);
  return 0;
}

template <typename T, int V, typename I>
int launch_shared_tiled(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                        long long N, int channels, int lanes_log2, int chunk, int tile,
                        dim3 blocks, int threads, int shared_bytes, cudaStream_t s) {
  if (tile == 2)
    return launch_shared_as<T, V, I, 2>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, blocks, threads, shared_bytes, s);
  if (tile == 1)
    return launch_shared_as<T, V, I, 1>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, blocks, threads, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename I>
int launch_shared(const float* grid, const void* dout, void* dsrc, int H, int W, int C,
                  long long N, int vector, int channels, int lanes_log2, int chunk, int tile,
                  int rows, dim3 blocks, int threads, int shared_bytes, cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  // the layout must fit the shared bytes; every thread must belong to a
  // whole group of lanes; a block owns every row; the blocks must cover
  // every slice
  long long at[6];
  const long long need = chunk > 0 && rows > 0
      ? shared_layout(rows, W, channels, chunk, sizeof(T), N > chunk, at) : 0;
  const long long slices = channels > 0 ? (C + channels - 1) / channels : 0;
  if (channels <= 0 || channels % vector != 0 || C % vector != 0 || chunk <= 0 || rows != H ||
      need > shared_bytes || shared_bytes > kMaxDynamicShared || threads % 32 != 0 ||
      threads < 64 || (threads >> lanes_log2) == 0 || threads % (1 << lanes_log2) != 0 ||
      (long long)blocks.x != slices)
    return (int)cudaErrorInvalidValue;
  if (vector == kPack)
    return launch_shared_tiled<T, kPack, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                            chunk, tile, blocks, threads, shared_bytes, s);
  if (vector == 1)
    return launch_shared_tiled<T, 1, I>(grid, dout, dsrc, H, W, C, N, channels, lanes_log2,
                                        chunk, tile, blocks, threads, shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

constexpr int kSortThreads = 512;

// The three passes of 'binned'. `scratch` holds, in this order: the sorted
// lists (B x N x 16 bytes), the band lists (B x bands x ceil(N / 32) words),
// the band totals (B x bands ints, zeroed here), the cell starts (B x
// ((H + 1)(W + 1) + 1) ints).
template <typename T, typename I>
int launch_binned(const float* grid, const void* dout, void* dsrc, void* scratch, int B, int H,
                  int W, int C, long long N, int vector, int lanes_log2, int chunk, int rows,
                  long long blocks_x, int threads, int shared_bytes, int bin_words,
                  cudaStream_t s) {
  constexpr int kPack = 16 / sizeof(T);
  const long long bands = rows > 0 ? (H + rows) / rows : 0;
  long long at[4];
  const int lanes = 1 << lanes_log2;
  const long long groups = threads / lanes;
  if ((vector != kPack && vector != 1) || C % vector != 0 || chunk <= 0 || rows <= 0 ||
      N >= (1LL << 31) || bin_words <= 0 || bin_words > 32 || (bin_words & (bin_words - 1)) ||
      bands * bin_words * 4 > 48 * 1024 ||
      sort_layout(rows, W, chunk, at) > shared_bytes || shared_bytes > kMaxDynamicShared ||
      threads % 32 != 0 || threads > 512 || lanes > 32 || threads % lanes != 0 ||
      blocks_x != (long long)((H + 1) / 2) * (((W + 1) / 2 + groups - 1) / groups))
    return (int)cudaErrorInvalidValue;
  const int gather_bytes =
      gather_window(lanes, vector * (int)sizeof(T)) * (16 + lanes * vector * (int)sizeof(T));
  const long long words = (N + 31) / 32;
  Binned* sorted = static_cast<Binned*>(scratch);
  unsigned* band_words = reinterpret_cast<unsigned*>(sorted + B * N);
  int* band_totals = reinterpret_cast<int*>(band_words + B * bands * words);
  int* cell_starts = band_totals + B * bands;
  cudaError_t err = cudaMemsetAsync(band_totals, 0, sizeof(int) * B * bands, s);
  if (err != cudaSuccess) return (int)err;
  if (N > 0)
    warp_dsrc_bin_kernel<I><<<dim3((unsigned)((N + 32LL * bin_words - 1) / (32LL * bin_words)),
                                   (unsigned)B),
                              32 * bin_words, (int)(bands * bin_words * 4), s>>>(
        grid, band_words, band_totals, H, W, (I)N, rows, (int)bands);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (shared_bytes > 48 * 1024) {
    const int e = opt_in_shared_memory<warp_dsrc_sort_kernel<I>>();
    if (e) return e;
  }
  warp_dsrc_sort_kernel<I><<<dim3((unsigned)bands, (unsigned)B), kSortThreads, shared_bytes, s>>>(
      grid, band_words, band_totals, cell_starts, sorted, H, W, (I)N, rows, (int)bands, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 blocks((unsigned)blocks_x, (unsigned)B);
  if (vector == kPack)
    warp_dsrc_gather_kernel<T, kPack, I><<<blocks, threads, gather_bytes, s>>>(
        sorted, cell_starts, static_cast<const T*>(dout), static_cast<T*>(dsrc), H, W, C,
        (I)N, lanes_log2);
  else
    warp_dsrc_gather_kernel<T, 1, I><<<blocks, threads, gather_bytes, s>>>(
        sorted, cell_starts, static_cast<const T*>(dout), static_cast<T*>(dsrc), H, W, C,
        (I)N, lanes_log2);
  return 0;
}

}  // namespace

// 'shared': grid (B, N, 2) f32 and dout (B, N, C) of `dtype`; dsrc (B, H,
// W, C) of dout's dtype. The plan's fields (ops/cuda/warp.py DsrcPlan):
// channels a load (a 16-byte pack or 1), channels a block owns, log2 of the
// threads per tile, points binned at a time, the gather's tile (1 or 2
// pixels a side), pixel rows a block owns (H), threads per block, blocks
// over slices, dynamic shared bytes, and whether offsets need 64 bits.
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
    status = index64 ? launch_shared<float, long long>(g, dout, dsrc, H, W, C, N, vector,
                                                       channels, lanes_log2, chunk, tile, rows,
                                                       blocks, threads, shared_bytes, s)
                     : launch_shared<float, int>(g, dout, dsrc, H, W, C, N, vector, channels,
                                                 lanes_log2, chunk, tile, rows, blocks,
                                                 threads, shared_bytes, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch_shared<__nv_bfloat16, long long>(g, dout, dsrc, H, W, C, N, vector, channels,
                                                  lanes_log2, chunk, tile, rows, blocks,
                                                  threads, shared_bytes, s)
        : launch_shared<__nv_bfloat16, int>(g, dout, dsrc, H, W, C, N, vector, channels,
                                            lanes_log2, chunk, tile, rows, blocks, threads,
                                            shared_bytes, s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}

// 'binned': the same grid, dout and dsrc; scratch of
// dsrc_binned_scratch_bytes in ops/cuda/warp.py (16-byte aligned). The
// plan's fields: channels a load, log2 of the lanes a quad, points a sort
// block compacts at a time, cell rows a sort band owns, threads and blocks
// of the gather, the sort block's dynamic shared bytes, whether offsets
// need 64 bits; and the words a block of the binning pass takes
// (dsrc_bin_words: 32 x bin_words threads, bands x bin_words words of
// shared memory, at most 48 KB). Three launches and a memset of the band
// totals, all on `stream`.
extern "C" int mk_warp_dsrc_binned(const void* grid, const void* dout, void* dsrc,
                                   void* scratch, int B, int H, int W, int C, long long N,
                                   int dtype, int vector, int lanes_log2, int chunk, int rows,
                                   int threads, long long blocks_x, int shared_bytes,
                                   int index64, int bin_words, void* stream) {
  if (B == 0 || C == 0 || H == 0 || W == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(grid);
  int status;
  if (dtype == kFloat32) {
    status = index64
        ? launch_binned<float, long long>(g, dout, dsrc, scratch, B, H, W, C, N, vector,
                                          lanes_log2, chunk, rows, blocks_x, threads,
                                          shared_bytes, bin_words, s)
        : launch_binned<float, int>(g, dout, dsrc, scratch, B, H, W, C, N, vector, lanes_log2,
                                    chunk, rows, blocks_x, threads, shared_bytes, bin_words, s);
  } else if (dtype == kBFloat16) {
    status = index64
        ? launch_binned<__nv_bfloat16, long long>(g, dout, dsrc, scratch, B, H, W, C, N, vector,
                                                  lanes_log2, chunk, rows, blocks_x, threads,
                                                  shared_bytes, bin_words, s)
        : launch_binned<__nv_bfloat16, int>(g, dout, dsrc, scratch, B, H, W, C, N, vector,
                                            lanes_log2, chunk, rows, blocks_x, threads,
                                            shared_bytes, bin_words, s);
  } else {
    status = (int)cudaErrorInvalidValue;
  }
  return status ? status : (int)cudaGetLastError();
}
