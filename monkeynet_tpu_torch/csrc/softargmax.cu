// Soft-argmax: per (frame, keypoint) plane of channels-last heatmap logits
// (N, H*W, K): temperature softmax over the plane, the +1e-7 floor after it
// with no renormalisation, the mean sum p*g, and the centred second moments
// -> five f32 statistics (mx, my, vxx, vxy, vyy) per plane.
//
// Replaces the TPU kernel of monkeynet_tpu/ops/pallas/softargmax.py
// (gaussian2kp_pallas -> _kernel), which needs a host-side transpose to
// (N*K, H, W) planes and one grid step per plane.
//
// Bound: bytes, N*H*W*K logits in and 20 bytes a plane out. The K planes of
// a frame are interleaved element by element, so a block that reads one
// plane in place uses 4 bytes (2 in bf16) of every 32-byte sector it pulls
// from L2, K blocks pull the same sectors, and each of four passes pulls
// them again: such a kernel is bound by L2-to-SM sector traffic, many times
// the bytes of the bound. Three variants, chosen in Python from the shape
// (ops/cuda/softargmax.py: softargmax_plan):
//
//  * staged: one block owns one frame and all its K planes. The frame's
//    H*W*K contiguous elements are copied once, 16 bytes a thread with
//    cp.async, into dynamic shared memory (163,840 bytes for a 64x64x10 f32
//    frame; the launcher opts in to more than 48 KB), in four commit groups
//    so that the max pass runs on the first quarter while the rest is in
//    flight (ptxas: 48 to 55 registers, no spills). Every byte crosses L2 once, in full lines, and every later pass
//    reads shared memory. The block size is a multiple of 32 and of K, so
//    in a contiguous sweep thread t always meets keypoint t % K: reads are
//    conflict-free, nothing is indexed per element, and the per-keypoint
//    reduction is a small pass over per-thread partials in shared memory.
//    exp runs once per element: e = exp(x/T - m) is written back over the
//    staged tile in f32. bf16 logits are staged in the upper half of that
//    f32 tile and converted in place, four sweeps at a time, with a block
//    barrier only where a store could reach an element another thread has
//    not read yet (five barriers for a 64-sweep frame). Where the block's
//    pixels per sweep are a multiple of W (640 threads, K = 10, W = 64) a
//    thread stays in one column: its x coordinate is hoisted out of the
//    passes and only the row is walked.
//  * split: for aligned frames too large for one block's shared memory
//    (256x256x10, configs/vox-full.yaml's kp detector). Several blocks share
//    a frame, each a band of rows with all K keypoints, read once from
//    device memory as contiguous vectors of 4 elements, in one pass: each element
//    slot of a thread keeps an online-softmax partial (its largest x / T,
//    and the sums of e, e*g and e*g*g' under it), merged per keypoint over
//    the block and then, in a second tiny kernel, over the frame's bands,
//    always in the same order, so the result does not change from run to
//    run. The +1e-7 floor's terms come from the grid's own sums, which the
//    wrapper computes once for (H, W).
//  * plane: one block per (frame, keypoint) plane, read in place with stride
//    K, for frames whose byte size is no multiple of 16 or that are
//    misaligned, and K with no block size for the other two.
//
// Order of operations where the result hangs on it, as the plain version:
// x / T is a division (at T = 0.1 and logits of +-30 an ulp of the quotient
// moves p by 3e-5), max, then the sum of exp, then p = e / denom + 1e-7 with
// no renormalisation, then the moments centred on the mean. The staged
// variant departs where it costs an ulp or two of a term and no more:
//  * the max is taken over x and divided once (division by a constant is
//    monotonic);
//  * x / T is x * (1/T) corrected by its exact remainder (`divide` below: the
//    rounded quotient but for rare near-ties, never the ulp that x * (1/T)
//    alone is off by);
//  * exp(x/T - m) is ex2.approx(x/T * log2(e) - m * log2(e)), the product and
//    the difference rounded once in a fused multiply-add; the shift's own
//    rounding is the same for the whole plane and cancels in e / denom;
//  * e / denom is e * (1 / denom);
//  * a coordinate is i * (2 / (n - 1)) - 1 in one fused multiply-add;
//  * the mean is (sum e * g) / denom, taken in the pass that forms e: the
//    1e-7 floor adds 1e-7 * sum g to it, and the grid is symmetric about 0.
//    The floor stays in p for the second moments.
// Sums are f32 in another order: per thread over sweeps, then over the
// threads of a keypoint; with a fixed column, sum p * gx is gx * sum p per
// thread. The split variant divides, exponentiates and forms coordinates
// as the staged one does, but each e is exp(x/T - m) against its slot's
// running max m, brought to the frame's max by a factor 2^(m - M) when
// partials merge (exact where m and M are within a factor 2 of each other,
// see Partial); and its second moments come
// from raw sums, E[g g'] - E[g] E[g]', where the staged variant centres
// each term: the difference cancels an ulp or two of E[g g'] <= 1, against
// the kernel checks' 1e-5 (the error on the card is in PERF.md).
//
// On an NVIDIA H100 80GB HBM3 at 700 W the staged kernel takes 0.013 ms on a
// 128-frame chunk of 64x64x10 f32 logits from L2 and 0.017 ms from device
// memory, against a byte bound of 0.0063 ms; one frame alone takes 0.012 ms,
// so what is left is one block's own chain, not bytes: the launch (a kernel
// that does next to nothing takes 0.0038 ms in the same harness), the copy
// with the max pass under it, the exp pass (~11 instructions an element on
// one SM), the moments pass, and three reductions. Nothing overlaps the
// passes after the copy: 128 frames are one wave on 132 SMs. PERF.md has
// the table.
#include "common.cuh"

namespace {

constexpr int kPlaneThreads = 256;
constexpr int kStages = 4;
constexpr int kBatch = 4;  // sweeps of pass 2 read together

// Reduces NV per-thread values over the threads of each keypoint (thread t
// holds keypoint t % K) and hands every thread its keypoint's totals. The
// NV * K (value, keypoint) sums of blockDim.x / K partials are dealt out
// over the warps. `part` holds NV * blockDim.x floats, `res` NV * K. No
// barrier opens it: what a thread reads last here is `res`, after the last
// barrier, and the next reduction writes `res` only after its own first.
template <int NV, bool kMax>
__device__ __forceinline__ void keypoint_reduce(float (&v)[NV], float* part, float* res, int K,
                                                int kp) {
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, nwarps = T >> 5;
  const int per = T / K;
#pragma unroll
  for (int j = 0; j < NV; ++j) part[j * T + t] = v[j];
  __syncthreads();
  for (int task = t >> 5; task < NV * K; task += nwarps) {
    const int j = task / K, k = task - j * K;
    float acc = kMax ? -INFINITY : 0.f;
    for (int i = lane; i < per; i += 32) {
      const float x = part[j * T + k + i * K];
      acc = kMax ? fmaxf(acc, x) : acc + x;
    }
    acc = kMax ? warp_max(acc) : warp_sum(acc);
    if (lane == 0) res[task] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = res[j * K + kp];
}

// Pixel coordinates of a thread's elements as it sweeps the frame: element
// e = s * blockDim.x + t lies at pixel e / K = s * (blockDim.x / K) + t / K,
// so column and row advance by fixed steps and no element is divided.
struct PixelWalk {
  float col, row, step_col, step_row, width;
  __device__ __forceinline__ PixelWalk(int t, int T, int K, int W) {
    const int p0 = t / K, step = T / K;
    col = (float)(p0 % W);
    row = (float)(p0 / W);
    step_col = (float)(step % W);
    step_row = (float)(step / W);
    width = (float)W;
  }
  __device__ __forceinline__ void next() {
    col += step_col;
    row += step_row;
    if (col >= width) {
      col -= width;
      row += 1.f;
    }
  }
};

// x / d, correctly rounded but for the rare near-tie, from r = 1 / d rounded
// once: the quotient x * r is off by up to an ulp, its exact remainder
// (one fused multiply-add) corrects it. Three instructions where a division
// takes about ten and a trip to the special-function unit; x * r alone would
// not do (see the note on the order of operations above).
__device__ __forceinline__ float divide(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

// 2^y for y <= 0, two ulps, results under 2^-126 flushed to zero: one
// instruction. exp(a) = 2^(a * log2 e); rounding that product costs |a| ulps
// of e, which matters only where e is already negligible beside the plane's
// largest term, 1.
constexpr float kLog2e = 1.44269504088896340736f;
__device__ __forceinline__ float exp2_fast(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

// kFixedCol: blockDim.x / K is a multiple of W, so a thread stays in one
// column of the frame and moves down blockDim.x / (K * W) rows a sweep: the
// column's coordinate is the thread's own, x-moments factor into that
// coordinate times the thread's sum of p, and only the row is walked.
template <typename T, bool kFixedCol>
__global__ void __launch_bounds__(1024, 1)
softargmax_staged_kernel(const T* __restrict__ logits, float* __restrict__ stats, int H, int W,
                         int K, float temperature) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int E = H * W * K;
  const int NT = blockDim.x, t = threadIdx.x;
  const int kp = t % K;
  const int sweeps = (E + NT - 1) / NT;
  float* tile = reinterpret_cast<float*>(smem_raw);  // E floats
  float* part = tile + E;                            // 3 * NT floats
  float* res = part + 3 * NT;                        // 3 * K floats
  // f32 logits are staged over the tile itself, bf16 logits in its upper half
  const T* in = reinterpret_cast<const T*>(smem_raw + (size_t)E * (4 - sizeof(T)));

  // stage the frame: kStages commit groups, each a whole number of sweeps
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  const char* g = reinterpret_cast<const char*>(logits + (size_t)blockIdx.x * E);
  char* s = reinterpret_cast<char*>(const_cast<T*>(in));
  int stage_end[kStages];
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    const int e0 = st == 0 ? 0 : stage_end[st - 1];
    const int e1 = min(E, (int)((long long)sweeps * (st + 1) / kStages) * NT);
    stage_end[st] = e1;
    for (int v = e0 / kVec + t; v < e1 / kVec; v += NT)
      cp_async_16(s + 16 * (size_t)v, g + 16 * (size_t)v);
    cp_async_commit();
  }

  // pass 1, on each stage as it lands: the extreme of x that x / T is largest at
  const float sign = temperature > 0.f ? 1.f : -1.f;
  float m[1] = {-INFINITY};
#pragma unroll
  for (int st = 0; st < kStages; ++st) {
    cp_async_wait(kStages - 1 - st);
    __syncthreads();
    // a stage is whole sweeps, but for the frame's ragged end in the last one
    const int e0 = (st == 0 ? 0 : stage_end[st - 1]) + t;
    const int n = (stage_end[st] - e0 + NT - 1) / NT;  // this thread's elements, <= 0: none
#pragma unroll 4
    for (int i = 0; i < n; ++i) m[0] = fmaxf(m[0], sign * to_float(in[e0 + i * NT]));
  }
  keypoint_reduce<1, true>(m, part, res, K, kp);
  const float rcp_t = 1.f / temperature;
  const float top = divide(sign * m[0], temperature, rcp_t);

  // passes 2 and 3 in one: e = exp(x / T - max), once per element, written
  // over the tile, with its sum and first moments. The mean of
  // p = e / denom + 1e-7 is (sum e * g) / denom: the floor adds 1e-7 * sum g,
  // and the grid is symmetric about 0. A batch of sweeps is read, then
  // stored, so that its loads overlap. Whole batches of whole sweeps run
  // without a test per element; the frame's ragged end takes the tested form.
  const float sx = 2.f / (float)(W - 1), sy = 2.f / (float)(H - 1);
  const int p0 = t / K;
  const float gx_own = fmaf((float)(p0 % W), sx, -1.f);  // kFixedCol: the thread's column
  const float row0 = (float)(p0 / W), step_row = (float)(NT / K / W);
  const int whole = E / NT;  // sweeps in which every thread has an element
  float row = row0;
  PixelWalk px(t, NT, K, W);
  float sums[3] = {0.f, 0.f, 0.f};  // sum e, sum e * gy, sum e * gx
  // One shift for the whole plane, so its rounding cancels in e / denom; the
  // fused multiply-add rounds x / T * log2(e) - shift once.
  const float top2 = top * kLog2e;
  int read_by_all = 0;  // sweeps that every thread is known to have read
  auto exp_batch = [&](int sw, bool tested) {
    float x[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = (sw + b) * NT + t;
      x[b] = (!tested || e < E) ? to_float(in[e]) : 0.f;
    }
    if (sizeof(T) < 4) {
      // tile[e] covers the staged elements 2e - E and 2e - E + 1, which lie in
      // this batch or an earlier one. Before storing, every thread must have
      // read the highest one this batch's stores reach.
      const long long reach = 2LL * min((sw + kBatch) * NT, E) - E - 1;
      if (reach >= (long long)read_by_all * NT) {
        __syncthreads();
        read_by_all = sw + kBatch;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int e = (sw + b) * NT + t;
      if (!tested || e < E) {
        const float ex = exp2_fast(fmaf(divide(x[b], temperature, rcp_t), kLog2e, -top2));
        tile[e] = ex;
        sums[0] += ex;
        if (kFixedCol) {
          sums[1] = fmaf(ex, row, sums[1]);  // in rows; brought to [-1, 1] below
          row += step_row;
        } else {
          sums[1] = fmaf(ex, fmaf(px.row, sy, -1.f), sums[1]);
          sums[2] = fmaf(ex, fmaf(px.col, sx, -1.f), sums[2]);
          px.next();
        }
      }
    }
  };
  int sw = 0;
  for (; sw + kBatch <= whole; sw += kBatch) exp_batch(sw, false);
  for (; sw < sweeps; sw += kBatch) exp_batch(sw, true);
  if (kFixedCol) {
    sums[1] = fmaf(sums[1], sy, -sums[0]);
    sums[2] = gx_own * sums[0];
  }
  keypoint_reduce<3, false>(sums, part, res, K, kp);
  const float inv = 1.f / sums[0];
  const float mean[2] = {sums[2] * inv, sums[1] * inv};

  // pass 4: second moments of p = e / denom + 1e-7 centred on that mean
  float var[3] = {0.f, 0.f, 0.f};
  float sum_p = 0.f, sum_pdy = 0.f;
  const float off_y = -1.f - mean[1];
  row = row0;
  px = PixelWalk(t, NT, K, W);
  auto moments = [&](int e) {
    const float p = fmaf(tile[e], inv, 1e-7f);
    if (kFixedCol) {
      const float dy = fmaf(row, sy, off_y);
      const float pdy = p * dy;
      sum_p += p;
      sum_pdy += pdy;
      var[2] = fmaf(pdy, dy, var[2]);
      row += step_row;
    } else {
      const float dx = fmaf(px.col, sx, -1.f) - mean[0];
      const float dy = fmaf(px.row, sy, off_y);
      const float pdx = p * dx;
      var[0] = fmaf(pdx, dx, var[0]);
      var[1] = fmaf(pdx, dy, var[1]);
      var[2] = fmaf(p * dy, dy, var[2]);
      px.next();
    }
  };
#pragma unroll 8
  for (int s4 = 0; s4 < whole; ++s4) moments(s4 * NT + t);
  if (whole * NT + t < E) moments(whole * NT + t);
  if (kFixedCol) {
    const float dx = gx_own - mean[0];
    var[0] = sum_p * dx * dx;
    var[1] = sum_pdy * dx;
  }
  keypoint_reduce<3, false>(var, part, res, K, kp);

  if (t < K) {
    float* o = stats + ((long long)blockIdx.x * K + t) * 5;
    o[0] = mean[0];
    o[1] = mean[1];
    o[2] = var[0];
    o[3] = var[1];
    o[4] = var[2];
  }
}

template <typename T>
__global__ void softargmax_plane_kernel(const T* __restrict__ logits, float* __restrict__ stats,
                                        int H, int W, int K, float temperature) {
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

// ---- split: several blocks a frame, each a band of rows, merged in order --

constexpr int kSplitUnroll = 4;  // vectors a thread loads at once, the next batch in flight
constexpr int kSplitVec = 4;     // elements a vector: 16 bytes of f32, 8 of bf16
constexpr int kSplitMaxThreads = 640;
constexpr int kSplitStats = 7;   // a partial's floats: m and the six sums
constexpr int kMergeWarps = 8;

// One keypoint's online-softmax partial over some elements, in base 2: m,
// the largest y * log2(e) met (y = x / T, the product rounded to f32), and
// with e = 2^(y log2(e) - m) the sums of e, e*gx, e*gy, e*gx*gx, e*gx*gy
// and e*gy*gy. Partials meet at the larger m by factors 2^(m - M) from the
// f32 values of m themselves, so every term ends as 2^(y log2(e) - M) with
// the one rounding of its fused multiply-add, whatever slot or band it was
// summed in (a shift of m rounded apart from the m that merges would give
// each slot's terms its own relative error, up to an ulp of y log2(e):
// 4e-5 at |y| ~ 1000). An empty partial has m = -inf, sums 0.
struct Partial {
  float m, s[6];
};

__device__ __forceinline__ void partial_empty(Partial& p) {
  p.m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 6; ++i) p.s[i] = 0.f;
}

// 2^(from - to) for from <= to, and 1 where both are the same (two empty
// partials included, whose difference would be -inf - -inf).
__device__ __forceinline__ float rescale_factor(float from, float to) {
  return from == to ? 1.f : exp2_fast(from - to);
}

// a <- a merged with b: both brought to the larger m, sums added.
__device__ __forceinline__ void partial_merge(Partial& a, const Partial& b) {
  const float m = fmaxf(a.m, b.m);
  const float fa = rescale_factor(a.m, m), fb = rescale_factor(b.m, m);
#pragma unroll
  for (int i = 0; i < 6; ++i) a.s[i] = a.s[i] * fa + b.s[i] * fb;
  a.m = m;
}

// Merges the lanes' partials in a butterfly of shuffles, a fixed order: lane
// 0 ends with the warp's merge.
__device__ __forceinline__ void partial_warp_merge(Partial& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Partial b;
    b.m = __shfl_xor_sync(0xffffffffu, a.m, off);
#pragma unroll
    for (int i = 0; i < 6; ++i) b.s[i] = __shfl_xor_sync(0xffffffffu, a.s[i], off);
    partial_merge(a, b);
  }
}

// Pass 1 of 'split'. blockIdx.x = frame * bands + band: the band's rows
// [band * rows, + rows) of one frame, all K keypoints, as vectors of V = 4
// elements (16 bytes of f32, 8 of bf16: a partial is 7 registers, and eight
// bf16 slots a thread would take 127 registers and halve the blocks an SM
// holds). Thread t reads vectors t, t + NT, ... of the band (V * NT is a
// multiple of K, so its element j always belongs to keypoint (V t + j) % K),
// kSplitUnroll at a time with the next kSplitUnroll in flight, and keeps one
// partial per element slot j, updated element by element: a y log2(e) above
// the slot's m rescales its sums first. kFixedCol: V * NT / K pixels a
// sweep are a multiple of W (640 threads at K = 10, W = 256), so a slot
// stays in one column; it sums only e, e*gy and e*gy*gy, and its column's
// gx gives the sums with gx at the end (e*gx = gx * sum e, and so on). The block's V * NT partials
// go to shared memory, and a warp per keypoint merges the keypoint's slots:
// lane l those at positions l, l + 32, ... in order, then the butterfly.
// The band's partial of keypoint k goes to partials[(blockIdx.x * K + k) *
// 7]: m and the six sums.
template <typename T, bool kFixedCol>
__global__ void __launch_bounds__(kSplitMaxThreads)
softargmax_split_kernel(const T* __restrict__ logits, float* __restrict__ partials, int H, int W,
                        int K, int rows, int bands, float temperature) {
  constexpr int V = kSplitVec;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);  // V * NT partials of 7 floats
  const int NT = blockDim.x, t = threadIdx.x;
  const long long frame = blockIdx.x / bands;
  const int band = (int)(blockIdx.x - frame * bands);
  const int r0 = band * rows, rb = min(rows, H - r0);
  const int nvec = (int)((long long)rb * W * K / V);
  const Pack<T, V>* in = reinterpret_cast<const Pack<T, V>*>(
      logits + (frame * H + r0) * (long long)W * K);

  // slot j's pixel in sweep s: s * (V NT / K) + (V t + j) / K of the band
  const int step = V * NT / K;
  const float step_col = (float)(step % W), step_row = (float)(step / W), width = (float)W;
  float col[V], row[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int p = (V * t + j) / K;
    col[j] = (float)(p % W);
    row[j] = (float)(r0 + p / W);
  }
  Partial acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) partial_empty(acc[j]);
  const float rcp_t = 1.f / temperature;
  const float sx = 2.f / (float)(W - 1), sy = 2.f / (float)(H - 1);

  const int sweeps = (nvec + NT - 1) / NT;
  auto load = [&](Pack<T, V>(&v)[kSplitUnroll], int s0) {
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      const int i = (s0 + u) * NT + t;
      if (i < nvec) v[u] = in[i];
    }
  };
  Pack<T, V> v[kSplitUnroll];
  load(v, 0);
  for (int s0 = 0; s0 < sweeps; s0 += kSplitUnroll) {
    Pack<T, V> next[kSplitUnroll];
    if (s0 + kSplitUnroll < sweeps) load(next, s0 + kSplitUnroll);
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) {
      if ((s0 + u) * NT + t < nvec) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          Partial& a = acc[j];
          const float y = divide(to_float(v[u].v[j]), temperature, rcp_t);
          const float y2 = y * kLog2e;
          if (y2 > a.m) {  // a new largest term: the sums so far shrink
            const float f = rescale_factor(a.m, y2);
#pragma unroll
            for (int i = 0; i < 6; ++i)
              if (!kFixedCol || i == 0 || i == 2 || i == 5) a.s[i] *= f;
            a.m = y2;
          }
          const float e = exp2_fast(fmaf(y, kLog2e, -a.m));
          const float gy = fmaf(row[j], sy, -1.f), egy = e * gy;
          a.s[0] += e;
          a.s[2] += egy;
          a.s[5] = fmaf(egy, gy, a.s[5]);
          if (!kFixedCol) {
            const float gx = fmaf(col[j], sx, -1.f), egx = e * gx;
            a.s[1] += egx;
            a.s[3] = fmaf(egx, gx, a.s[3]);
            a.s[4] = fmaf(egx, gy, a.s[4]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {  // every slot moves a sweep on
        row[j] += step_row;
        if (!kFixedCol) {
          col[j] += step_col;
          if (col[j] >= width) {
            col[j] -= width;
            row[j] += 1.f;
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSplitUnroll; ++u) v[u] = next[u];
  }
  if (kFixedCol) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float gx = fmaf(col[j], sx, -1.f);
      acc[j].s[1] = gx * acc[j].s[0];
      acc[j].s[3] = gx * acc[j].s[1];
      acc[j].s[4] = gx * acc[j].s[2];
    }
  }

#pragma unroll
  for (int j = 0; j < V; ++j) {
    float* o = part + (V * t + j) * kSplitStats;
    o[0] = acc[j].m;
#pragma unroll
    for (int i = 0; i < 6; ++i) o[1 + i] = acc[j].s[i];
  }
  __syncthreads();
  const int lane = t & 31, per = V * NT / K;  // a keypoint's slots
  for (int k = t >> 5; k < K; k += NT >> 5) {
    Partial a;
    partial_empty(a);
    for (int i = lane; i < per; i += 32) {
      const float* o = part + (k + i * K) * kSplitStats;
      Partial b;
      b.m = o[0];
#pragma unroll
      for (int q = 0; q < 6; ++q) b.s[q] = o[1 + q];
      partial_merge(a, b);
    }
    partial_warp_merge(a);
    if (lane == 0) {
      float* o = partials + ((long long)blockIdx.x * K + k) * kSplitStats;
      o[0] = a.m;
#pragma unroll
      for (int q = 0; q < 6; ++q) o[1 + q] = a.s[q];
    }
  }
}

// The frame's grid sums that the +1e-7 floor brings in, fixed by (H, W):
// sum gx, sum gy, sum gx^2, sum gy^2, sum gx*gy over the pixels, and H*W.
struct GridSums {
  float gx, gy, gxx, gyy, gxy, hw;
};

// Pass 2 of 'split': a warp per (frame, keypoint) merges the frame's band
// partials (lane l bands l, l + 32, ..., then the butterfly) and lane 0
// turns them into the statistics of p = e / S + 1e-7. With E[.] the sums
// over S, whose p sum to 1, the mean is E[g] + 1e-7 sum g and the centred
// moments are E[g g'] - E[g] E[g]' + (E[g] - mean)(E[g] - mean)' plus
// 1e-7 sum (g - mean)(g - mean)', the last from the grid sums: moments
// from raw sums, whose cancellation is an ulp of E[g g'] (PERF.md).
__global__ void __launch_bounds__(32 * kMergeWarps)
softargmax_merge_kernel(const float* __restrict__ partials, float* __restrict__ stats,
                        long long tasks, int bands, int K, GridSums g) {
  const long long task = (long long)blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (task >= tasks) return;
  const long long frame = task / K;
  const int k = (int)(task - frame * K);
  Partial a;
  partial_empty(a);
  for (int b = lane; b < bands; b += 32) {
    const float* o = partials + ((frame * bands + b) * K + k) * kSplitStats;
    Partial p;
    p.m = o[0];
#pragma unroll
    for (int q = 0; q < 6; ++q) p.s[q] = o[1 + q];
    partial_merge(a, p);
  }
  partial_warp_merge(a);
  if (lane != 0) return;
  const float inv = 1.f / a.s[0];
  const float ex = a.s[1] * inv, ey = a.s[2] * inv;
  const float mx = fmaf(1e-7f, g.gx, ex), my = fmaf(1e-7f, g.gy, ey);
  const float cx = ex - mx, cy = ey - my;
  const float vxx = fmaf(-ex, ex, a.s[3] * inv) + cx * cx +
                    1e-7f * (g.gxx - 2.f * mx * g.gx + g.hw * mx * mx);
  const float vxy = fmaf(-ex, ey, a.s[4] * inv) + cx * cy +
                    1e-7f * (g.gxy - mx * g.gy - my * g.gx + g.hw * mx * my);
  const float vyy = fmaf(-ey, ey, a.s[5] * inv) + cy * cy +
                    1e-7f * (g.gyy - 2.f * my * g.gy + g.hw * my * my);
  float* o = stats + task * 5;
  o[0] = mx;
  o[1] = my;
  o[2] = vxx;
  o[3] = vxy;
  o[4] = vyy;
}

template <typename T>
int launch_split(const void* logits, void* partials, void* stats, long long N, int H, int W,
                 int K, float temperature, int threads, int rows, int shared_bytes,
                 GridSums g, cudaStream_t s) {
  constexpr int V = kSplitVec;
  const int bands = (H + rows - 1) / rows;
  if (threads <= 0 || threads > kSplitMaxThreads || threads % 32 != 0 || (V * threads) % K != 0 ||
      rows <= 0 || ((long long)rows * W * K * sizeof(T)) % 16 != 0 ||
      ((long long)H * W * K * sizeof(T)) % 16 != 0 || shared_bytes > kMaxDynamicShared ||
      shared_bytes < V * threads * kSplitStats * 4 || N * bands > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const bool fixed_col = (V * threads / K) % W == 0;
  const int err = fixed_col ? opt_in_shared_memory<softargmax_split_kernel<T, true>>()
                            : opt_in_shared_memory<softargmax_split_kernel<T, false>>();
  if (err) return err;
  if (fixed_col)
    softargmax_split_kernel<T, true><<<(unsigned)(N * bands), threads, shared_bytes, s>>>(
        static_cast<const T*>(logits), static_cast<float*>(partials), H, W, K, rows, bands,
        temperature);
  else
    softargmax_split_kernel<T, false><<<(unsigned)(N * bands), threads, shared_bytes, s>>>(
        static_cast<const T*>(logits), static_cast<float*>(partials), H, W, K, rows, bands,
        temperature);
  const long long tasks = N * K;
  softargmax_merge_kernel<<<(unsigned)((tasks + kMergeWarps - 1) / kMergeWarps),
                            32 * kMergeWarps, 0, s>>>(static_cast<const float*>(partials),
                                                      static_cast<float*>(stats), tasks, bands,
                                                      K, g);
  return (int)cudaGetLastError();
}

template <typename T, bool kFixedCol>
int launch_staged_as(const void* logits, void* stats, long long N, int H, int W, int K,
                  float temperature, int threads, int shared_bytes, cudaStream_t s) {
  const int err = opt_in_shared_memory<softargmax_staged_kernel<T, kFixedCol>>();
  if (err) return err;
  softargmax_staged_kernel<T, kFixedCol><<<(unsigned)N, threads, shared_bytes, s>>>(
      static_cast<const T*>(logits), static_cast<float*>(stats), H, W, K, temperature);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const void* logits, void* stats, long long N, int H, int W, int K,
                  float temperature, int threads, int shared_bytes, cudaStream_t s) {
  if (threads / K % W == 0)
    return launch_staged_as<T, true>(logits, stats, N, H, W, K, temperature, threads,
                                     shared_bytes, s);
  return launch_staged_as<T, false>(logits, stats, N, H, W, K, temperature, threads,
                                    shared_bytes, s);
}

}  // namespace

// threads and shared_bytes come from softargmax_plan (ops/cuda/softargmax.py):
// threads a multiple of 32 and of K, shared_bytes = 4 * (H*W*K + 3*threads + 3*K),
// and H*W*K * sizeof(element) a multiple of 16.
extern "C" int mk_softargmax_staged(const void* logits, void* stats, long long N, int H, int W,
                                    int K, float temperature, int dtype, int threads,
                                    int shared_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads <= 0 || threads > 1024 || threads % 32 != 0 || threads % K != 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  if (dtype == kFloat32)
    return launch_staged<float>(logits, stats, N, H, W, K, temperature, threads, shared_bytes, s);
  if (dtype == kBFloat16)
    return launch_staged<__nv_bfloat16>(logits, stats, N, H, W, K, temperature, threads,
                                        shared_bytes, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mk_softargmax_plane(const void* logits, void* stats, long long N, int H, int W,
                                   int K, float temperature, int dtype, void* stream) {
  const long long planes = N * K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (planes > 0) {
    if (dtype == kFloat32) {
      softargmax_plane_kernel<float><<<(unsigned)planes, kPlaneThreads, 0, s>>>(
          static_cast<const float*>(logits), static_cast<float*>(stats), H, W, K, temperature);
    } else if (dtype == kBFloat16) {
      softargmax_plane_kernel<__nv_bfloat16><<<(unsigned)planes, kPlaneThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(logits), static_cast<float*>(stats), H, W, K,
          temperature);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// partials: an f32 scratch of N * bands * K * 7 floats, bands = ceil(H / rows).
// threads, rows and shared_bytes come from softargmax_plan: threads a
// multiple of 32, at most 640, with 4 * threads a multiple of K (and with
// 4 * threads / K a multiple of W, each slot in one column), rows * W * K elements a
// whole number of 16 bytes, shared_bytes at least 112 * threads. g_*: the
// grid sums of GridSums.
extern "C" int mk_softargmax_split(const void* logits, void* partials, void* stats, long long N,
                                   int H, int W, int K, float temperature, int dtype, int threads,
                                   int rows, int shared_bytes, float g_x, float g_y, float g_xx,
                                   float g_yy, float g_xy, float hw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 0) return (int)cudaGetLastError();
  const GridSums g{g_x, g_y, g_xx, g_yy, g_xy, hw};
  if (dtype == kFloat32)
    return launch_split<float>(logits, partials, stats, N, H, W, K, temperature, threads, rows,
                               shared_bytes, g, s);
  if (dtype == kBFloat16)
    return launch_split<__nv_bfloat16>(logits, partials, stats, N, H, W, K, temperature,
                                       threads, rows, shared_bytes, g, s);
  return (int)cudaErrorInvalidValue;
}
